"""Logical-axis sharding rules: one table maps every logical parameter /
activation axis to mesh axes, for any mesh with ('data', 'model') or
('pod', 'data', 'model') axes. Tensor parallelism over ``model``, FSDP
over the data axes (``fsdp``), as ``repro/sharding/rules.py``.

A spec is a tuple with one entry a dimension: None (replicated), an
axis name, or a tuple of axis names for a dim split over several (one
name stands alone, as ``PartitionSpec`` normalises it), so a spec
compares equal to the reference's ``tuple(PartitionSpec)``. Without a mesh
every spec is ``()`` and nothing is sharded: a context without a mesh is
the one-card path.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``
(``launch/mesh.py``) or, where only the specs are wanted, an
``AbstractMesh`` of names and sizes. ``shard_tree`` cuts each leaf of a
full logical tree to the block this rank holds; ``unshard_tree`` gathers
the blocks back (``distributed/collectives.py``).

The tracking fleet shards by sensor: ``sensor_blocks`` gives each device
of a list its contiguous block of sensors, and ``sensor_specs`` maps the
banks' sensor axis onto the mesh data axes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as coll

ATTN_IMPLS = ("auto", "full", "chunked", "swa", "flash")
MOE_WEIGHT_MODES = ("gather", "tp2d")
# logical axes that shard over the data axes as FSDP (gathered before use)
FSDP_AXES = ("embed", "moe_d")


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names with no process group behind it
    (``jax.sharding.AbstractMesh``'s counterpart): enough for the specs,
    not for a collective."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


@dataclass(frozen=True)
class ShardingContext:
    mesh: Optional[Any] = None
    data_axes: Tuple[str, ...] = ("data",)   # DP/FSDP axes ('pod', 'data')
    model_axis: str = "model"
    fsdp: bool = True
    # attention lowering: auto | full | chunked | swa | flash (prefill on
    # the flash_attention kernel, decode on flash_decode; the others
    # decode on decode_attention, as the reference)
    attn_impl: str = "auto"
    # MoE weights: "gather" = experts over ``model``, the embed dim FSDP
    # over the data axes and gathered per layer; "tp2d" = experts over
    # ``model`` x the FFN dim over the data axes, no weight movement
    moe_weight_mode: str = "gather"

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} not in "
                             f"{ATTN_IMPLS}")
        if self.moe_weight_mode not in MOE_WEIGHT_MODES:
            raise ValueError(f"moe_weight_mode {self.moe_weight_mode!r} not "
                             f"in {MOE_WEIGHT_MODES}")
        if self.mesh is not None:
            names = tuple(self.mesh.mesh_dim_names)
            if names != self.data_axes + (self.model_axis,):
                raise ValueError(f"mesh axes {names} are not the data axes "
                                 f"{self.data_axes} then {self.model_axis!r}")

    @property
    def data_size(self) -> int:
        if self.mesh is None:
            return 1
        return coll.size(self.mesh, self.data_axes)

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return coll.size(self.mesh, self.model_axis)

    @property
    def world(self) -> int:
        return self.data_size * self.model_size


def make_context(mesh, fsdp: bool = True, attn_impl: str = "auto",
                 moe_weight_mode: str = "gather") -> ShardingContext:
    """The context of a mesh: its 'pod' and 'data' axes are the data
    axes, 'model' the model axis."""
    if mesh is None:
        return ShardingContext(None, attn_impl=attn_impl,
                               moe_weight_mode=moe_weight_mode)
    data_axes = tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))
    return ShardingContext(mesh, data_axes, "model", fsdp, attn_impl,
                           moe_weight_mode)


def entry(axes: Sequence[str]):
    """A spec entry for a dim split over ``axes``: one name alone, several
    as a tuple."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def logical_to_spec(axes: Sequence[Optional[str]], shape: Tuple[int, ...],
                    ctx: ShardingContext) -> tuple:
    """The spec of a leaf with logical ``axes`` and ``shape``.

    vocab / heads / mlp / experts / ssm / kv -> 'model' where the dim
    divides the model size; embed -> the data axes (FSDP, once a leaf)
    where ``fsdp`` and it divides; moe_d -> the data axes under "gather"
    with ``fsdp``, moe_f under "tp2d"; the rest replicated. A dim that
    does not divide (MQA kv = 1, a vocab of 49,155 on 2) is replicated,
    as the reference."""
    if ctx.mesh is None:
        return ()
    out: List[Any] = []
    fsdp_used = False
    ds, ms = ctx.data_size, ctx.model_size
    data = entry(ctx.data_axes)
    for name, dim in zip(axes, shape):
        if name in ("vocab", "heads", "mlp", "experts", "ssm", "kv"):
            out.append(ctx.model_axis if _divides(dim, ms) else None)
        elif name == "embed" and ctx.fsdp and not fsdp_used:
            if _divides(dim, ds):
                out.append(data)
                fsdp_used = True
            else:
                out.append(None)
        elif name == "moe_d":
            if (ctx.moe_weight_mode == "gather" and ctx.fsdp
                    and not fsdp_used and _divides(dim, ds)):
                out.append(data)
                fsdp_used = True
            else:
                out.append(None)
        elif name == "moe_f":
            out.append(data if ctx.moe_weight_mode == "tp2d"
                       and _divides(dim, ds) else None)
        else:
            out.append(None)
    return tuple(out)


def is_axes(x) -> bool:
    """A leaf of a logical-axes tree: a plain tuple of names and Nones."""
    return (type(x) is tuple
            and all(a is None or isinstance(a, str) for a in x))


def map_specs(fn: Callable, spec_tree, *trees, is_leaf=is_axes):
    """``fn`` over the leaves of a spec (or logical-axes) tree and the
    matching leaves of ``trees`` (dicts, NamedTuples, lists; None is an
    empty subtree)."""
    if spec_tree is None:
        return None
    if is_leaf(spec_tree):
        return fn(spec_tree, *trees)
    if isinstance(spec_tree, dict):
        return {k: map_specs(fn, spec_tree[k], *(t[k] for t in trees),
                             is_leaf=is_leaf) for k in spec_tree}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(
            map_specs(fn, s, *(getattr(t, f) for t in trees),
                      is_leaf=is_leaf)
            for f, s in zip(spec_tree._fields, spec_tree)))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(
            map_specs(fn, s, *(t[i] for t in trees), is_leaf=is_leaf)
            for i, s in enumerate(spec_tree))
    raise TypeError(f"not a spec tree node: {spec_tree!r}")


def is_spec(x) -> bool:
    """A leaf of a spec tree: a tuple of None, str and tuples of str."""
    return type(x) is tuple and all(
        a is None or isinstance(a, str)
        or (type(a) is tuple and all(isinstance(b, str) for b in a))
        for a in x)


def tree_specs(param_axes, params_shape, ctx: ShardingContext):
    """The spec tree of a logical-axes tree and the matching tree of
    tensors (``meta`` tensors will do) or shapes."""
    return map_specs(lambda axes, t: logical_to_spec(axes, tuple(t.shape),
                                                     ctx),
                     param_axes, params_shape)


def sensor_specs(axes_tree, tree, ctx: ShardingContext):
    """The spec tree of a sensor-stacked tracking bank: each leaf's sensor
    axis (``core.bank.bank_sensor_axes``: 1 for the IMM bank's (K, S, C,
    ...) x and P, 0 elsewhere) on the data axes, the rest replicated."""
    def one(a, x):
        if ctx.mesh is None:
            return ()
        parts: List[Any] = [None] * x.ndim
        parts[a] = entry(ctx.data_axes)
        return tuple(parts)

    return map_specs(one, axes_tree, tree, is_leaf=lambda x: isinstance(
        x, int))


def axes_of(e) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if e is None:
        return ()
    return (e,) if isinstance(e, str) else tuple(e)


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec shards over."""
    return tuple(a for e in spec for a in axes_of(e))


def local_slices(spec, shape, mesh, coord=None) -> Tuple[slice, ...]:
    """The block of a full tensor of ``shape`` that this rank holds (or
    the rank at mesh coordinate ``coord``)."""
    out = []
    for i, dim in enumerate(shape):
        axes = axes_of(spec[i] if i < len(spec) else None)
        if not axes:
            out.append(slice(None))
            continue
        idx, n = coll.index(mesh, axes, coord), coll.size(mesh, axes)
        if dim % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({n})")
        blk = dim // n
        out.append(slice(idx * blk, (idx + 1) * blk))
    return tuple(out)


def shard(t, spec, ctx: ShardingContext):
    """This rank's block of the full tensor ``t`` (a copy)."""
    if ctx.mesh is None or not spec_axes(spec):
        return t
    return t[local_slices(spec, t.shape, ctx.mesh)].clone()


def shard_tree(tree, specs, ctx: ShardingContext):
    """Each leaf of a full logical tree cut to this rank's block."""
    return map_specs(lambda s, t: shard(t, s, ctx), specs, tree,
                     is_leaf=is_spec)


def unshard(t, spec, ctx: ShardingContext):
    """The full logical tensor from every rank's block (a collective:
    every rank of the mesh calls it)."""
    if ctx.mesh is None:
        return t
    for i, e in enumerate(spec):
        axes = axes_of(e)
        if axes:
            t = coll.all_gather(t, ctx.mesh, axes, dim=i)
    return t


def unshard_tree(tree, specs, ctx: ShardingContext):
    """The full logical tree from every rank's blocks (a collective)."""
    return map_specs(lambda s, t: unshard(t, s, ctx), specs, tree,
                     is_leaf=is_spec)


def gather_tree(tree, specs, ctx: ShardingContext, dst: int = 0):
    """The full logical tree on rank ``dst`` alone, in host memory (None
    on every other rank): each rank sends its blocks, which ``dst`` puts
    in place by the senders' mesh coordinates (a collective)."""
    import torch.distributed as dist

    ranks = ctx.mesh.mesh.reshape(-1).tolist()
    coords = {r: [int(c) for c in (ctx.mesh.mesh == r).nonzero()[0]]
              for r in ranks}

    def one(spec, t):
        if t is None:
            return None
        blocks = coll.gather(t, dst)
        if blocks is None:
            return None
        full = torch.empty(_full_shape(spec, t.shape, ctx), dtype=t.dtype)
        for r, b in enumerate(blocks):  # world rank order
            full[local_slices(spec, full.shape, ctx.mesh, coords[r])] = b
        return full

    full = map_specs(one, specs, tree, is_leaf=is_spec)
    return full if dist.get_rank() == dst else None


def _full_shape(spec, block_shape, ctx: ShardingContext):
    return tuple(n * coll.size(ctx.mesh, axes_of(
        spec[i] if i < len(spec) else None))
        for i, n in enumerate(block_shape))


def fsdp_gather(p, axes_tree, spec_tree, ctx: ShardingContext):
    """``p`` (a layer's local blocks, ``spec_tree`` their full layout) with
    every FSDP dim (logical axis embed or moe_d on the data axes)
    gathered, through the autograd gather whose backward reduce-scatters
    the gradient. The model-axis dims stay sharded."""
    if ctx.mesh is None or ctx.data_size == 1:
        return p

    def one(axes, spec, t):
        for i, (name, e) in enumerate(zip(axes, spec)):
            if name in FSDP_AXES and axes_of(e) == ctx.data_axes:
                t = coll.all_gather(t, ctx.mesh, ctx.data_axes, i)
        return t

    return map_specs(one, axes_tree, spec_tree, p)


def sensor_blocks(n_sensors: int, devices: Sequence) -> List[Tuple[Any,
                                                                    slice]]:
    """(device, sensors) of each shard: device i of ``devices`` serves the
    contiguous block i of ``n_sensors // len(devices)`` sensors. A device
    may appear more than once (two shards on one card). Raises
    ValueError when the sensors do not divide over the devices."""
    d = len(devices)
    if d == 0 or n_sensors % d:
        raise ValueError(
            f"n_sensors={n_sensors} must divide over the mesh data axes "
            f"(size {d})")
    per = n_sensors // d
    return [(dev, slice(i * per, (i + 1) * per))
            for i, dev in enumerate(devices)]
