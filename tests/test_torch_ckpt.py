"""The port's checkpointing (``repro_torch/checkpoint/ckpt.py``), the
twin of ``tests/test_ckpt.py``: the failure contract clause for clause,
each one induced here:

  * restore validates names/dtypes/shapes against the manifest and
    raises ``CheckpointMismatchError`` with a readable message instead
    of unflattening garbage into the wrong tree;
  * a crash mid-save leaves a ``.tmp_step_*`` dir behind and the NEXT
    save still commits atomically (and sweeps the garbage);
  * ``CheckpointManager.save(blocking=True)`` raises its own failure
    immediately; an async failure surfaces on the next call;
  * ``restore(step=None)`` survives a keep-N GC deleting the newest
    step out from under it (falls back to the next-newest survivor);
  * a successful commit is never failed retroactively by a GC hiccup.

Then what the port adds: trees of tensors (the banks), leaf names that
are the JAX package's key paths, a lane bank saved by either package
restoring in the other bit for bit, renamed or reshaped leaves raising
in both directions, each restored leaf on its ``like`` leaf's device,
and a training state (``optim/adamw.py:TrainState``, with and without
the error-feedback residual) saved by either package restoring in the
other bit for bit.
"""
import json
import shutil
import zipfile
from pathlib import Path

import numpy as np
import pytest

import torch

from repro.checkpoint import ckpt as JC
from repro.core import bank as jbank
from repro_torch.checkpoint import ckpt as C
from repro_torch.core import bank as tb

from _torch_parity import models


def _state(seed=0, n=4):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(n, 3)).astype(np.float32),
            "hits": np.arange(n, dtype=np.int32)}


def _roundtrip(tmp_path, state):
    C.save(str(tmp_path), 0, state)
    return C.restore(str(tmp_path), jax_like(state))


def jax_like(state):
    return {k: np.empty_like(v) for k, v in state.items()}


# -------------------------------------------------------------- validation
class TestRestoreValidation:
    def test_roundtrip_is_bitwise(self, tmp_path):
        state = _state()
        got, extra = _roundtrip(tmp_path, state)
        for k in state:
            np.testing.assert_array_equal(got[k], state[k])
        assert extra == {}

    def test_wrong_names_raise_with_both_sides(self, tmp_path):
        C.save(str(tmp_path), 0, _state())
        bad_like = {"x": np.empty((4, 3), np.float32),
                    "age": np.empty((4,), np.int32)}
        with pytest.raises(C.CheckpointMismatchError) as ei:
            C.restore(str(tmp_path), bad_like)
        msg = str(ei.value)
        assert "age" in msg and "hits" in msg  # names both directions

    def test_wrong_dtype_raises_named_leaf(self, tmp_path):
        C.save(str(tmp_path), 0, _state())
        like = _state()
        like["hits"] = like["hits"].astype(np.int64)
        with pytest.raises(C.CheckpointMismatchError, match="hits"):
            C.restore(str(tmp_path), like)

    def test_wrong_shape_raises_named_leaf(self, tmp_path):
        C.save(str(tmp_path), 0, _state(n=4))
        with pytest.raises(C.CheckpointMismatchError, match="hits"):
            C.restore(str(tmp_path), _state(n=8))

    def test_wrong_leaf_count_raises(self, tmp_path):
        C.save(str(tmp_path), 0, _state())
        with pytest.raises(C.CheckpointMismatchError):
            C.restore(str(tmp_path), {"x": np.empty((4, 3), np.float32)})

    def test_old_manifest_without_shapes_still_validates(self, tmp_path):
        d = C.save(str(tmp_path), 0, _state())
        man = json.loads((d / "manifest.json").read_text())
        del man["shapes"]  # manifests from before the shape record
        (d / "manifest.json").write_text(json.dumps(man))
        got, _ = C.restore(str(tmp_path), jax_like(_state()))
        np.testing.assert_array_equal(got["x"], _state()["x"])
        with pytest.raises(C.CheckpointMismatchError):
            C.restore(str(tmp_path), _state(n=8))  # shapes via arrays


# ------------------------------------------------------------- crash paths
class TestCrashMidSave:
    def test_stale_tmp_dir_does_not_block_next_save(self, tmp_path):
        root = Path(tmp_path)
        C.save(str(root), 0, _state(0))
        # a crashed save from another pid left its tmp dir behind
        stale = root / ".tmp_step_00000001_99999"
        stale.mkdir()
        (stale / "arrays.npz").write_bytes(b"half-written garbage")
        C.save(str(root), 1, _state(1))  # must commit atomically
        assert not stale.exists(), "stale tmp dir swept"
        got, _ = C.restore(str(root), jax_like(_state()))
        np.testing.assert_array_equal(got["x"], _state(1)["x"])
        assert C.available_steps(str(root)) == [0, 1]

    def test_tmp_dirs_never_count_as_steps(self, tmp_path):
        root = Path(tmp_path)
        C.save(str(root), 3, _state())
        (root / ".tmp_step_00000007_123").mkdir()
        assert C.available_steps(str(root)) == [3]

    def test_manager_init_sweeps_predecessor_garbage(self, tmp_path):
        root = Path(tmp_path)
        root.mkdir(exist_ok=True)
        (root / ".tmp_step_00000000_42").mkdir()
        C.CheckpointManager(str(root))
        assert list(root.glob(".tmp_step_*")) == []


# ---------------------------------------------------------- error ordering
class TestManagerErrorOrdering:
    def test_blocking_save_raises_immediately(self, tmp_path):
        mgr = C.CheckpointManager(str(tmp_path / "as_file"))
        (tmp_path / "as_file").write_text("not a directory")
        with pytest.raises(OSError):
            mgr.save(0, _state(), blocking=True)

    def test_async_error_surfaces_on_next_call_once(self, tmp_path):
        target = tmp_path / "as_file"
        mgr = C.CheckpointManager(str(target))
        target.write_text("not a directory")
        mgr.save(0, _state())  # async: returns despite doomed IO
        with pytest.raises(OSError):
            mgr.wait()
        mgr.wait()  # the error is raised once, not forever

    def test_async_error_surfaces_on_next_save(self, tmp_path):
        target = tmp_path / "as_file"
        mgr = C.CheckpointManager(str(target))
        target.write_text("not a directory")
        mgr.save(0, _state())
        with pytest.raises(OSError):
            mgr.save(1, _state())  # carries the PREVIOUS failure
        target.unlink()
        mgr.save(1, _state(), blocking=True)  # now healthy
        assert C.available_steps(str(target)) == [1]

    def test_gc_failure_never_fails_a_committed_save(self, tmp_path,
                                                     monkeypatch):
        mgr = C.CheckpointManager(str(tmp_path), keep_n=1)
        mgr.save(0, _state(0), blocking=True)

        def broken_gc():
            raise OSError("induced GC failure")

        monkeypatch.setattr(mgr, "_gc", broken_gc)
        with pytest.warns(RuntimeWarning, match="GC"):
            mgr.save(1, _state(1), blocking=True)  # commit still lands
        got, _ = mgr.restore_latest(jax_like(_state()))
        np.testing.assert_array_equal(got["x"], _state(1)["x"])


# ----------------------------------------------------------------- gc race
class TestRestoreGcRace:
    def test_newest_vanishing_falls_back(self, tmp_path, monkeypatch):
        for s in range(3):
            C.save(str(tmp_path), s, _state(s))
        real = C._load_step
        def racy(d, like):
            if d.name == "step_00000002":
                shutil.rmtree(d)  # GC wins the race on the newest
                raise FileNotFoundError(d)
            return real(d, like)
        monkeypatch.setattr(C, "_load_step", racy)
        got, _ = C.restore(str(tmp_path), jax_like(_state()))
        np.testing.assert_array_equal(got["x"], _state(1)["x"])

    def test_half_deleted_step_falls_back(self, tmp_path):
        for s in range(2):
            C.save(str(tmp_path), s, _state(s))
        # a GC got through the npz but not the manifest: listed, broken
        (Path(tmp_path) / "step_00000001" / "arrays.npz").unlink()
        got, _ = C.restore(str(tmp_path), jax_like(_state()))
        np.testing.assert_array_equal(got["x"], _state(0)["x"])

    def test_corrupt_npz_falls_back(self, tmp_path):
        for s in range(2):
            C.save(str(tmp_path), s, _state(s))
        (Path(tmp_path) / "step_00000001" / "arrays.npz").write_bytes(
            b"ZZ not a zip")
        got, _ = C.restore(str(tmp_path), jax_like(_state()))
        np.testing.assert_array_equal(got["x"], _state(0)["x"])

    def test_explicit_step_never_falls_back(self, tmp_path):
        for s in range(2):
            C.save(str(tmp_path), s, _state(s))
        (Path(tmp_path) / "step_00000001" / "arrays.npz").write_bytes(
            b"ZZ not a zip")
        with pytest.raises((zipfile.BadZipFile, OSError, ValueError)):
            C.restore(str(tmp_path), jax_like(_state()), step=1)

    def test_everything_gone_raises_not_loops(self, tmp_path):
        for s in range(2):
            C.save(str(tmp_path), s, _state(s))
        for s in range(2):
            (Path(tmp_path) / f"step_{s:08d}" / "arrays.npz").unlink()
        with pytest.raises((FileNotFoundError, OSError)):
            C.restore(str(tmp_path), jax_like(_state()))

    def test_no_checkpoints_at_all(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoints"):
            C.restore(str(tmp_path / "empty"), jax_like(_state()))


# ------------------------------------------------------------------ keep-n
def test_keep_n_gc(tmp_path):
    mgr = C.CheckpointManager(str(tmp_path), keep_n=2)
    for s in range(5):
        mgr.save(s, _state(s), blocking=True)
    assert C.available_steps(str(tmp_path)) == [3, 4]
    got, extra = mgr.restore_latest(jax_like(_state()))
    np.testing.assert_array_equal(got["x"], _state(4)["x"])


def test_extra_payload_roundtrips(tmp_path):
    C.save(str(tmp_path), 7, _state(),
           extra={"tenant": "t0", "frame": 7, "ns_base": 1 << 20})
    _, extra = C.restore(str(tmp_path), jax_like(_state()))
    assert extra == {"tenant": "t0", "frame": 7, "ns_base": 1 << 20}


# ------------------------------------------------------- trees of tensors
CAP = 8


def _lane_bank(kind, seed=0, lanes=3, lane=1):
    """Lane ``lane`` of a port stack of ``lanes`` banks whose every leaf
    holds seeded values of the bank's dtype and shape."""
    _, model, _, _ = models(kind)
    init = tb.init_imm_bank if kind == "imm" else tb.init_bank
    one = init(model, CAP, device="cpu")
    rng = np.random.default_rng(seed)

    def fill(leaf):
        shape = tuple(leaf.shape)
        if leaf.dtype == torch.bool:
            return torch.from_numpy(rng.random(shape) < 0.5)
        if leaf.dtype == torch.int32:
            return torch.from_numpy(
                rng.integers(-1, 50, shape).astype(np.int32))
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    stack = tb.stack_sensor_banks(one, lanes)
    stack = type(stack)(*(fill(leaf) for leaf in stack))
    return tb.slice_sensor_bank(stack, lane)


def _j_like(kind):
    jmodel = models(kind)[0]
    init = jbank.init_imm_bank if kind == "imm" else jbank.init_bank
    return init(jmodel, CAP)


def _t_like(kind):
    model = models(kind)[1]
    init = tb.init_imm_bank if kind == "imm" else tb.init_bank
    return init(model, CAP, device="cpu")


NESTED = {"b": {"x": 1, "a": [np.zeros(2, np.float32), (3, None)]},
          "c": np.arange(4, dtype=np.int32)}


@pytest.mark.parametrize("kind", ["imm", "lkf", "nested"])
def test_leaf_names_are_the_reference_key_paths(kind):
    if kind == "nested":
        tree, jtree = NESTED, NESTED
    else:
        tree, jtree = _t_like(kind), _j_like(kind)
    names = [n for n, _ in C._flatten(tree)]
    assert names == [n for n, _ in JC._flatten(jtree)[0]]
    if kind == "imm":
        assert names == [".x", ".P", ".mu", ".active", ".hits", ".misses",
                         ".age", ".track_id", ".next_id"]


@pytest.mark.parametrize("kind", ["imm", "lkf"])
def test_port_lane_bank_restores_in_the_reference_bitwise(tmp_path, kind):
    lane = _lane_bank(kind)
    C.CheckpointManager(str(tmp_path)).save(
        5, lane, extra={"frame": 5}, blocking=True)
    got, extra = JC.restore(str(tmp_path), _j_like(kind))
    assert extra == {"frame": 5}
    assert type(got).__name__ == type(lane).__name__
    for name, a, b in zip(lane._fields, got, lane):
        assert np.asarray(a).dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["imm", "lkf"])
def test_reference_bank_restores_in_the_port_bitwise(tmp_path, kind):
    import jax.numpy as jnp

    lane = _lane_bank(kind, seed=3)
    jlane = type(_j_like(kind))(*(jnp.asarray(leaf.numpy())
                                  for leaf in lane))
    JC.save(str(tmp_path), 2, jlane, extra={"frame": 2})
    like = _t_like(kind)
    got, extra = C.restore(str(tmp_path), like)
    assert extra == {"frame": 2}
    assert type(got) is type(like)
    for name, a, b, w in zip(lane._fields, got, lane, like):
        assert isinstance(a, torch.Tensor) and a.dtype == w.dtype, name
        assert torch.equal(a, b), name


def _renamed(bank):
    fields = [("ages" if f == "age" else f) for f in bank._fields]
    from collections import namedtuple
    return namedtuple(type(bank).__name__, fields)(*bank)


@pytest.mark.parametrize("change", ["rename", "reshape"])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_renamed_or_reshaped_leaf_raises_both_ways(tmp_path, change,
                                                   writer):
    lane = _lane_bank("imm", seed=4)
    if writer == "port":
        C.save(str(tmp_path), 0, lane)
        restore, err = JC.restore, JC.CheckpointMismatchError
        like = _j_like("imm")
    else:
        import jax.numpy as jnp
        JC.save(str(tmp_path), 0, type(_j_like("imm"))(
            *(jnp.asarray(leaf.numpy()) for leaf in lane)))
        restore, err = C.restore, C.CheckpointMismatchError
        like = _t_like("imm")
    if change == "rename":
        like, match = _renamed(like), "age"
    else:
        like = like._replace(hits=like.hits[:CAP - 1])
        match = "hits"
    with pytest.raises(err, match=match):
        restore(str(tmp_path), like)


def test_restore_puts_each_leaf_on_the_like_leafs_device(tmp_path):
    state = {"x": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "n": torch.tensor(3, dtype=torch.int32),
             "host": np.ones(2, np.int64)}
    C.save(str(tmp_path), 0, state)
    like = {"x": torch.empty((2, 3), device="meta"),
            "n": torch.empty((), dtype=torch.int32),
            "host": np.empty(2, np.int64)}
    got, _ = C.restore(str(tmp_path), like)
    assert got["x"].device.type == "meta" and got["x"].shape == (2, 3)
    assert got["n"].device.type == "cpu" and got["n"].dtype == torch.int32
    assert int(got["n"]) == 3
    assert isinstance(got["host"], np.ndarray)
    # an explicit device overrides the like tree, numpy leaves included
    got, _ = C.restore(str(tmp_path), like, device="cpu")
    assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
               for v in got.values())
    assert torch.equal(got["x"], state["x"])
    assert got["host"].dtype == torch.int64


def test_dtype_check_compares_numpy_names(tmp_path):
    C.save(str(tmp_path), 0, {"hits": np.arange(4, dtype=np.int32)})
    got, _ = C.restore(str(tmp_path),
                       {"hits": torch.empty(4, dtype=torch.int32)})
    assert torch.equal(got["hits"], torch.arange(4, dtype=torch.int32))
    with pytest.raises(C.CheckpointMismatchError, match="hits"):
        C.restore(str(tmp_path), {"hits": torch.empty(4,
                                                      dtype=torch.int64)})


def test_async_save_copies_tensors_before_returning(tmp_path):
    """The manager copies every leaf to the host inside ``save``: a
    tensor changed in place right after an async save does not reach
    the checkpoint."""
    x = torch.arange(8, dtype=torch.float32)
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save(0, {"x": x})
    x.add_(100.0)
    mgr.wait()
    got, _ = mgr.restore_latest({"x": torch.empty(8)})
    assert torch.equal(got["x"], torch.arange(8, dtype=torch.float32))


# -- a training state crosses packages ---------------------------------------

def _train_states(compression, arch="h2o-danube-1.8b"):
    """The reference's TrainState of a reduced arch (danube by default;
    one AdamW step taken, so m, v and step are not zero) and the port's
    copy of it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import model as j_model
    from repro.optim import adamw as j_adamw
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import train_state_from_numpy

    jcfg = j_reduced(j_get_config(arch), seq=16)
    cfg = reduced(get_config(arch), seq=16)
    js = j_adamw.init_train_state(j_model.init_params(jcfg,
                                                      jax.random.key(4)),
                                  compression)
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.01), js.master)
    js = j_adamw.adamw_update(js, g, 1e-3)
    if compression:
        js = js._replace(ef=jax.tree.map(lambda p: p * 1e-3, js.master))
    return js, train_state_from_numpy(jax.tree.map(np.asarray, js), cfg,
                                      "cpu"), cfg


def _train_like(cfg, compression):
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw

    return adamw.init_train_state(
        init_params(cfg, torch.Generator().manual_seed(9), "cpu"),
        compression)


@pytest.mark.parametrize("compression", [False, True])
def test_reference_train_state_restores_in_the_port_bitwise(tmp_path,
                                                            compression):
    import jax

    js, _, cfg = _train_states(compression)
    JC.save(str(tmp_path), 7, js, extra={"step": 7})
    got, extra = C.restore(str(tmp_path), _train_like(cfg, compression))
    assert extra == {"step": 7}
    want = jax.tree.leaves(js)
    names = [n for n, _ in C._flatten(got)]
    assert len(names) == len(want)
    for name, (_, a), b in zip(names, C._flatten(got), want):
        assert isinstance(a, torch.Tensor), name
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("compression", [False, True])
def test_port_train_state_restores_in_the_reference_bitwise(tmp_path,
                                                            compression):
    import jax

    js, state, cfg = _train_states(compression)
    C.CheckpointManager(str(tmp_path)).save(3, state, extra={"step": 3},
                                            blocking=True)
    like = jax.tree.map(np.zeros_like, js)
    got, extra = JC.restore(str(tmp_path), like)
    assert extra == {"step": 3}
    assert type(got).__name__ == "TrainState"
    for (name, a), b in zip(C._flatten(state), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(b), a.numpy(), err_msg=name)
        assert np.asarray(b).dtype == a.numpy().dtype, name


def test_moe_train_state_crosses_packages_bitwise(tmp_path):
    """A reduced granite-moe TrainState (the router, w_in, w_gate, w_out of
    every layer among its leaves) saved by either package restores in the
    other bit for bit."""
    import jax

    js, state, cfg = _train_states(False, "granite-moe-1b-a400m")
    names = [n for n, _ in C._flatten(state)]
    assert {n.split("/")[-1] for n in names if "['moe']" in n} == {
        "['router']", "['w_gate']", "['w_in']", "['w_out']"}
    JC.save(str(tmp_path / "ref"), 1, js)
    got, _ = C.restore(str(tmp_path / "ref"), _train_like(cfg, False))
    for (name, a), b in zip(C._flatten(got), jax.tree.leaves(js)):
        assert a.numpy().dtype == np.asarray(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    C.CheckpointManager(str(tmp_path / "port")).save(2, state, blocking=True)
    back, _ = JC.restore(str(tmp_path / "port"),
                         jax.tree.map(np.zeros_like, js))
    for (name, a), b in zip(C._flatten(state), jax.tree.leaves(back)):
        assert np.asarray(b).dtype == a.numpy().dtype, name
        np.testing.assert_array_equal(np.asarray(b), a.numpy(), err_msg=name)
