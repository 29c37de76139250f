"""Checkpointing: atomic, async, keep-N, restore onto any device.

Layout: <dir>/step_<n>/  arrays.npz + manifest.json, committed via
tmp-dir + os.rename (atomic on POSIX). Arrays are saved as full host
arrays (numpy only, keys ``a{i}``), so a step restores onto any device
(``restore(..., device=...)``), and a checkpoint written by the JAX
package restores here and the other way round: leaf names are the JAX
key-path strings (``.x`` for a NamedTuple field, ``['k']`` for a dict
key, ``[i]`` for a list or tuple entry, joined by ``/``).

Trees are NamedTuples (the banks), dicts (in sorted key order), lists
and tuples, with tensors, numpy arrays or scalars as leaves; ``None`` is
an empty subtree.

On a mesh (``ctx`` with a mesh and ``specs`` the tree's spec tree,
``launch/specs.py``) ``save`` gathers the full logical arrays from every
rank's blocks on rank 0, in host memory, and rank 0 writes them, so a
mesh checkpoint is the same files as a one-card one; ``restore`` gives
each rank its blocks of any mesh shape (the elastic restore).

Failure contract (the serving/training loops depend on every clause):

* a crash mid-save leaves only a ``.tmp_step_*`` dir — the committed
  steps are never touched, and the next ``save`` (same step or not)
  sweeps stale tmp dirs and still commits atomically;
* ``restore`` validates the manifest's recorded names/shapes/dtypes
  against the ``like`` tree and raises ``CheckpointMismatchError``
  instead of silently unflattening garbage into the wrong structure;
* ``restore(step=None)`` tolerates a concurrent keep-N GC (another
  process or an in-flight async save) deleting the step it just
  listed: it falls back to the next-newest surviving step;
* ``CheckpointManager.save(blocking=True)`` raises save errors
  immediately (not on the next call), async errors surface on the
  next ``save()``/``wait()``; a successful commit is never failed
  retroactively by a keep-N GC hiccup (GC errors warn, they don't
  raise).
"""
from __future__ import annotations

import io
import json
import os
import shutil
import struct
import threading
import warnings
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


class CheckpointMismatchError(ValueError):
    """The checkpoint's recorded tree (names/shapes/dtypes) does not
    match the ``like`` tree it is being restored into."""


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    """(key string, child) pairs of an inner node, None for a leaf."""
    if node is None:
        return []
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def _flatten(tree, path: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) pairs in the JAX package's flattening order."""
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out.extend(_flatten(child, f"{path}/{key}" if path else key))
    return out


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(node):
        kids = _children(node)
        if kids is None:
            return next(it)
        if node is None:
            return None
        if _is_namedtuple(node):
            return type(node)(*(build(v) for _, v in kids))
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return type(node)(build(v) for _, v in kids)

    return build(like)


def _host(leaf, copy: bool = False) -> np.ndarray:
    """A leaf as a host numpy array (a tensor is copied off its device);
    ``copy`` also copies a leaf already in host memory, so the result
    shares none with the caller's tree."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.device.type != "cpu":
            return leaf.cpu().numpy()
        leaf = leaf.numpy()
    return np.array(leaf) if copy else np.asarray(leaf)


def _dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype (torch.int32 -> 'int32')."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _sweep_stale_tmp(root: Path) -> None:
    """Remove leftover ``.tmp_step_*`` dirs from crashed saves. Only
    called while no save of OURS is in flight (module ``save`` is
    synchronous; the manager holds one in-flight save and joins it
    first), so anything matching is garbage by construction."""
    for p in root.glob(".tmp_step_*"):
        shutil.rmtree(p, ignore_errors=True)


def save(ckpt_dir: str, step: int, state, extra: Optional[Dict] = None,
         ctx=None, specs=None) -> Path:
    """Blocking atomic save of a tree (+ json-serializable extras). With
    a mesh every rank calls it: the full arrays are gathered on rank 0,
    which writes them; every rank returns once the step is committed."""
    if ctx is not None and ctx.mesh is not None:
        import torch.distributed as dist

        from repro_torch.sharding import rules

        full = rules.gather_tree(state, specs, ctx, dst=0)
        final = Path(ckpt_dir) / f"step_{step:08d}"
        if full is not None:
            save(ckpt_dir, step, full, extra)
        del full
        dist.barrier()
        return final
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f".tmp_step_{step:08d}_{os.getpid()}"
    _sweep_stale_tmp(root)  # crashed prior saves (any pid, any step)
    tmp.mkdir(parents=True)
    named = _flatten(state)
    arrays = {f"a{i}": _host(v) for i, (_, v) in enumerate(named)}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "names": [n for n, _ in named],
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def available_steps(ckpt_dir: str) -> List[int]:
    root = Path(ckpt_dir)
    if not root.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                  if (p / "manifest.json").exists())


def _validate(manifest: Dict, like, leaves) -> None:
    """Names/shapes/dtypes of the checkpoint vs the ``like`` tree.
    ``like`` leaves may be tensors, arrays or anything exposing
    shape/dtype; bare leaves without them only get the name/count
    check. Dtypes compare by numpy name, so torch.int32 matches int32."""
    named = _flatten(like)
    want_names = [n for n, _ in named]
    got_names = manifest["names"]
    if want_names != got_names:
        missing = [n for n in want_names if n not in got_names]
        surplus = [n for n in got_names if n not in want_names]
        raise CheckpointMismatchError(
            f"checkpoint tree does not match `like`: checkpoint has "
            f"{len(got_names)} leaves {got_names[:4]}..., `like` wants "
            f"{len(want_names)} {want_names[:4]}...; missing from "
            f"checkpoint: {missing or 'none'}; not in `like`: "
            f"{surplus or 'none'}")
    shapes = manifest.get("shapes")  # absent in pre-shape manifests
    for i, (name, leaf) in enumerate(named):
        got_dtype = np.dtype(manifest["dtypes"][i]).name
        got_shape = tuple(shapes[i]) if shapes else np.shape(leaves[i])
        want_dtype = getattr(leaf, "dtype", None)
        want_shape = getattr(leaf, "shape", None)
        if want_dtype is not None and _dtype_name(want_dtype) != got_dtype:
            raise CheckpointMismatchError(
                f"leaf '{name}': checkpoint dtype {got_dtype} != `like` "
                f"dtype {_dtype_name(want_dtype)}")
        if want_shape is not None and tuple(want_shape) != got_shape:
            raise CheckpointMismatchError(
                f"leaf '{name}': checkpoint shape {got_shape} != `like` "
                f"shape {tuple(want_shape)}")


def _stored(path: Path, n: int) -> List[np.ndarray]:
    """The n arrays of an .npz as read-only memory maps where the zip
    stores them uncompressed (``np.savez`` does), so a rank that restores
    its blocks reads those pages alone; an array stored otherwise, 0-d or
    empty is read whole."""
    out = []
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for i in range(n):
            info = zf.getinfo(f"a{i}.npy")
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if (info.compress_type != zipfile.ZIP_STORED or dtype.hasobject
                    or not shape or 0 in shape):
                out.append(np.load(io.BytesIO(zf.read(info))))
                continue
            out.append(np.memmap(path, dtype=dtype, mode="r",
                                 offset=f.tell(), shape=shape,
                                 order="F" if fortran else "C"))
    return out


def _load_step(d: Path, like, lazy: bool = False):
    manifest = json.loads((d / "manifest.json").read_text())
    n = len(manifest["names"])
    if lazy:
        leaves = _stored(d / "arrays.npz", n)
    else:
        data = np.load(d / "arrays.npz")
        leaves = [data[f"a{i}"] for i in range(n)]
    _validate(manifest, like, leaves)
    return _unflatten(like, leaves), manifest


def _place(arr: np.ndarray, leaf, device):
    """A restored array as the ``like`` leaf holds it: a tensor on the
    leaf's device (or on ``device`` when given), else the array."""
    if device is not None:
        return torch.from_numpy(arr).to(device)
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(arr).to(leaf.device)
    return arr


def restore(ckpt_dir: str, like, step: Optional[int] = None,
            device=None, ctx=None, specs=None) -> Tuple[Any, Dict]:
    """Restore into the structure of `like` (a tree of tensors, arrays
    or anything with shape and dtype).

    The checkpoint's manifest (names, shapes, dtypes) is validated
    against `like` — a mismatched tree raises
    ``CheckpointMismatchError`` instead of unflattening garbage.

    step=None restores the newest step and falls back to older
    surviving steps if the newest vanishes mid-read (a concurrent
    keep-N GC from another process/thread); an explicit ``step`` never
    falls back.

    Each leaf comes back as a tensor on its ``like`` leaf's device when
    that leaf is a tensor (a numpy array otherwise); ``device``, when
    given, puts every leaf there instead (restore onto another device).
    With a mesh (``ctx``; ``like`` the full logical tree and ``specs`` its
    spec tree) each leaf comes back as this rank's block, read from the
    file's memory map (only the block's pages)."""
    explicit = step is not None
    tried: set = set()
    while True:
        steps = [s for s in available_steps(ckpt_dir) if s not in tried]
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
        use = step if explicit else steps[-1]
        d = Path(ckpt_dir) / f"step_{use:08d}"
        try:
            restored, manifest = (
                _load_step(d, like, lazy=True)
                if ctx is not None and ctx.mesh is not None
                else _load_step(d, like))
            break
        except CheckpointMismatchError:
            raise  # a real tree mismatch, not corruption — never retry
        except (FileNotFoundError, zipfile.BadZipFile, KeyError, OSError,
                ValueError):  # ValueError: np.load on a truncated npz
            if explicit:
                raise
            # the step we listed was GC'd (or half-deleted) under us —
            # drop to the next-newest survivor, or give up loudly
            tried.add(use)
            if not [s for s in available_steps(ckpt_dir)
                    if s not in tried]:
                raise
    if ctx is not None and ctx.mesh is not None:
        from repro_torch.sharding import rules

        restored = rules.map_specs(
            lambda spec, a: np.array(a[rules.local_slices(spec, a.shape,
                                                          ctx.mesh)]),
            specs, restored, is_leaf=rules.is_spec)
    placed = [_place(a, leaf, device)
              for (_, a), (_, leaf)
              in zip(_flatten(restored), _flatten(like))]
    return _unflatten(like, placed), manifest["extra"]


class CheckpointManager:
    """Async keep-N manager: save() returns immediately (a background
    thread does the IO + commit + GC); wait() joins outstanding work.
    One in-flight save at a time (the next save waits — backpressure
    beats unbounded queueing on a training loop).

    Error ordering: ``save(blocking=True)`` raises its own failure
    in-call; an async save's failure surfaces on the NEXT ``save()``,
    ``wait()`` or ``restore_latest()`` (whichever comes first, once). A
    keep-N GC failure after a successful commit is a warning, never an
    error — the checkpoint IS on disk."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3):
        self.dir = ckpt_dir
        self.keep_n = keep_n
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        # a crashed predecessor's tmp dirs are garbage; sweep them so
        # they don't sit next to the committed steps forever
        if Path(ckpt_dir).exists():
            _sweep_stale_tmp(Path(ckpt_dir))

    def save(self, step: int, state, extra: Optional[Dict] = None,
             blocking: bool = False) -> None:
        self.wait()  # joins the in-flight save; raises ITS failure here
        # copy to host memory synchronously (the caller's tensors may be
        # changed by the next step)
        host_state = _unflatten(state, [_host(v, copy=True)
                                        for _, v in _flatten(state)])

        def work():
            save(self.dir, step, host_state, extra)
            try:
                self._gc()
            except OSError as e:  # committed fine; GC hygiene can wait
                warnings.warn(f"checkpoint GC under {self.dir} failed "
                              f"(step {step} committed): {e!r}",
                              RuntimeWarning, stacklevel=2)

        if blocking:
            work()  # errors raise HERE, not on the next call
            return

        def guarded():
            try:
                work()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=guarded, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, like, device=None):
        self.wait()  # join in-flight work: no GC can race the listing
        return restore(self.dir, like, device=device)

    def _gc(self) -> None:
        steps = available_steps(self.dir)
        for s in steps[: -self.keep_n]:
            shutil.rmtree(Path(self.dir) / f"step_{s:08d}",
                          ignore_errors=True)
