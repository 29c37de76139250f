"""Collectives over one mesh axis or a tuple of axes, with autograd.

The mesh is a ``DeviceMesh`` (``launch/mesh.py``). An axis tuple (the
flattened ('pod', 'data'), or data + model) names the ranks that share
every other coordinate, flattened row-major in the mesh's order: the
tuple must follow the mesh's axis order, so a rank's place in the group
is its flattened index. Its process group is made on first use; every
rank reaches the same collectives in the same order, so every rank makes
the same groups.

Operations: ``all_reduce`` (sum, max), the tiled ``all_gather`` and
``reduce_scatter`` along a dim, ``all_to_all`` (one dim split, another
concatenated) and the ring ``permute``.

Gradients. A tensor replicated over an axis holds, on each rank, a part
of its gradient; the parts sum to the gradient (the adjoint of each
collective is its own linear transpose): ``all_reduce`` is its own
backward, ``all_gather``'s is ``reduce_scatter`` (an FSDP leaf's gather:
its gradient comes back reduce-scattered to the block). So the train step seeds
the loss with one over the ranks that compute it and sums every
replicated leaf's gradient over the axes it is replicated on.

Backends. ``gloo`` takes CUDA tensors for ``all_reduce`` and
``broadcast`` only: on a ``gloo`` group the other operations copy a CUDA
tensor through a host buffer and back, counted in bytes (both ways) in
``STAGED_BYTES``; an NCCL group copies nothing. The choice depends only
on the group's backend and is made before the call.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Axes = Union[str, Sequence[str]]
STAGED_BYTES: Dict[str, int] = {"bytes": 0}
OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
# the tensor forms under their newer names where this torch has them
_GATHER = (getattr(dist, "all_gather_single", None)
           or dist.all_gather_into_tensor)
_SCATTER = (getattr(dist, "reduce_scatter_single", None)
            or dist.reduce_scatter_tensor)


def reset_staged() -> None:
    STAGED_BYTES["bytes"] = 0


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def size(mesh, axes: Axes) -> int:
    """The ranks along ``axes`` (a ``DeviceMesh`` or anything with
    ``mesh_dim_names`` and ``shape``)."""
    names = list(mesh.mesh_dim_names)
    return math.prod(int(mesh.shape[names.index(a)]) for a in _axes(axes))


def group(mesh, axes: Axes):
    """The process group of this rank along ``axes`` (made on first use,
    kept on the mesh)."""
    axes = _axes(axes)
    names = list(mesh.mesh_dim_names)
    pos = [names.index(a) for a in axes]
    if pos != sorted(pos):
        raise ValueError(f"axes {axes} must follow the mesh's order {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_repro_groups", {})
    if axes not in cache:
        ranks = mesh.mesh.permute(
            [i for i in range(len(names)) if i not in pos] + pos)
        ranks = ranks.reshape(-1, math.prod(ranks.shape[-len(pos):]))
        cache[axes], _ = dist.new_subgroups_by_enumeration(
            [r.tolist() for r in ranks])
    return cache[axes]


def _staged(t: torch.Tensor, g) -> bool:
    return t.is_cuda and dist.get_backend(g) == "gloo"


def _host(t: torch.Tensor, g) -> torch.Tensor:
    if _staged(t, g):
        STAGED_BYTES["bytes"] += t.numel() * t.element_size()
        return t.cpu()
    return t


def _back(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if t.device != like.device:
        STAGED_BYTES["bytes"] += t.numel() * t.element_size()
        return t.to(like.device)
    return t


def _all_reduce(x, mesh, axes, op="sum"):
    g = group(mesh, axes)
    if size(mesh, axes) == 1:
        return x
    out = x.contiguous().clone()
    dist.all_reduce(out, op=OPS[op], group=g)
    return out


def _all_gather(x, mesh, axes, dim):
    n = size(mesh, axes)
    if n == 1:
        return x
    g = group(mesh, axes)
    src = _host(x.movedim(dim, 0).contiguous(), g)
    out = torch.empty((n * src.shape[0],) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    _GATHER(out, src, group=g)
    return _back(out, x).movedim(0, dim)


def _reduce_scatter(x, mesh, axes, dim):
    n = size(mesh, axes)
    if n == 1:
        return x
    g = group(mesh, axes)
    src = _host(x.movedim(dim, 0).contiguous(), g)
    if src.shape[0] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    out = torch.empty((src.shape[0] // n,) + src.shape[1:], dtype=src.dtype,
                      device=src.device)
    _SCATTER(out, src, group=g)
    return _back(out, x).movedim(0, dim)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None,
                None)


def all_reduce(x, mesh, axes: Axes, op: str = "sum"):
    """The sum (or max) of ``x`` over ``axes`` on every rank of them. The
    sum is differentiable (its backward is itself); the max is not."""
    axes = _axes(axes)
    if op == "sum" and torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, mesh, axes)
    return _all_reduce(x, mesh, axes, op)


def all_gather(x, mesh, axes: Axes, dim: int = 0):
    """Every rank's ``x`` concatenated along ``dim`` in the flattened
    order of ``axes`` (tiled); backward: ``reduce_scatter``."""
    axes = _axes(axes)
    dim = dim % x.dim()
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, mesh, axes, dim)
    return _all_gather(x, mesh, axes, dim)


def reduce_scatter(x, mesh, axes: Axes, dim: int = 0):
    """The sum of ``x`` over ``axes``, this rank's block of ``dim`` kept
    (``all_gather``'s backward). Forward only."""
    return _reduce_scatter(x, mesh, _axes(axes), dim % x.dim())


def all_to_all(x, mesh, axes: Axes, split_dim: int, cat_dim: int):
    """``split_dim`` cut into one block a rank, block j sent to rank j;
    the blocks received concatenated along ``cat_dim`` in rank order.
    Forward only (the prefill cache's change of layout)."""
    axes = _axes(axes)
    n = size(mesh, axes)
    if n == 1:
        return x
    g = group(mesh, axes)
    src = _host(torch.stack(x.chunk(n, dim=split_dim)).contiguous(), g)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    return torch.cat(list(_back(out, x).unbind(0)), dim=cat_dim)


def permute(x, mesh, axis: str, shift: int = 1):
    """The ring step: rank i's ``x`` goes to rank i + shift along
    ``axis``; returns the tensor rank i - shift sent. Forward only."""
    n = size(mesh, axis)
    if n == 1:
        return x
    g = group(mesh, axis)
    ranks = dist.get_process_group_ranks(g)
    me = ranks.index(dist.get_rank())
    src = _host(x.contiguous(), g)
    buf = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(me + shift) % n], group=g),
           dist.P2POp(dist.irecv, buf, ranks[(me - shift) % n], group=g)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return _back(buf, x)


def gather(x, dst: int = 0):
    """Every rank's ``x`` (of one shape on every rank) to rank ``dst`` of
    the world, in host memory: the list in rank order there, None
    elsewhere. Forward only (a checkpoint's save)."""
    src = x.detach().contiguous()
    if src.is_cuda and dist.get_backend() == "gloo":
        STAGED_BYTES["bytes"] += src.numel() * src.element_size()
        src = src.cpu()
    me = dist.get_rank()
    out = ([torch.empty_like(src) for _ in range(dist.get_world_size())]
           if me == dst else None)
    dist.gather(src, out, dst=dst)
    return None if out is None else [t.cpu() for t in out]


def mesh_order(mesh, axes: Axes) -> Tuple[str, ...]:
    """``axes`` without repeats, in the mesh's order."""
    axes = set(_axes(axes))
    return tuple(a for a in mesh.mesh_dim_names if a in axes)


def index(mesh, axes: Axes, coord=None) -> int:
    """This rank's flattened index along ``axes`` (or that of the rank at
    mesh coordinate ``coord``)."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate() if coord is None else coord
    idx = 0
    for a in _axes(axes):
        i = names.index(a)
        idx = idx * int(mesh.shape[i]) + coord[i]
    return idx
