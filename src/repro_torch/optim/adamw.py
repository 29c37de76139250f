"""AdamW with float32 master weights, global-norm clipping, and optional
int8 error-feedback gradient compression (``distributed/compression.py``).

A port of ``repro/optim/adamw.py``. ``TrainState`` keeps the reference's
fields and pytree layout (dict trees of float32 tensors in the parameter
tree's layout, ``step`` a 0-d int32 tensor), so a checkpoint of either
package's state restores into the other (``checkpoint/ckpt.py``).

The update runs in place, leaf by leaf: at h2o-danube-1.8b's size the
master weights and the two moments take 22 GB, and a functional update
would hold a second copy while it runs. ``adamw_update`` and
``clip_by_global_norm`` therefore write into the tensors they are given;
each keeps the reference's order of operations
(``repro/optim/adamw.py:66-80``).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional

import torch


class TrainState(NamedTuple):
    step: torch.Tensor        # () int32
    master: Any               # float32 param tree (source of truth)
    m: Any                    # float32 first moment
    v: Any                    # float32 second moment
    ef: Optional[Any] = None  # error-feedback residual (compression)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts (sorted keys, the reference's leaf
    order), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of dict / list / tuple trees."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def init_train_state(params, compression: bool = False) -> TrainState:
    """float32 master copies of ``params`` (never aliasing them), zero
    moments, a zero error-feedback residual with ``compression``; on the
    parameters' device."""
    master = tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                      params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(master)[0].device)

    def zeros():
        return tree_map(torch.zeros_like, master)

    return TrainState(step=step, master=master, m=zeros(), v=zeros(),
                      ef=zeros() if compression else None)


def abstract_train_state(abstract_params,
                         compression: bool = False) -> TrainState:
    """``init_train_state``'s tree as ``meta`` tensors (shapes and dtypes
    only) from a parameter tree on any device, e.g.
    ``models.model.abstract_params``."""
    meta = tree_map(lambda p: torch.empty_like(p, device="meta"),
                    abstract_params)
    return init_train_state(meta, compression)


def compute_params(state: TrainState, dtype) -> Any:
    """The compute view of the master weights in ``dtype`` (bf16 for
    training; a float32 view shares the master's memory)."""
    return tree_map(lambda p: p.to(dtype), state.master)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.to(torch.float32)))
              for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float, norm=None):
    """Scale ``grads`` in place to a global norm of at most ``max_norm``.
    Returns (grads, the norm before clipping). ``norm``, when given, is
    that norm (on a mesh: of the full logical gradients,
    ``launch.steps.mesh_global_norm``)."""
    if norm is None:
        norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(grads):
        g.mul_(scale)
    return grads, norm


def warmup_cosine(step, base_lr: float, warmup: int, total: int,
                  floor: float = 0.1):
    """Linear warmup to ``base_lr``, then a cosine decay to
    ``floor * base_lr`` at ``total``; a 0-d float32 tensor."""
    step = step.to(torch.float32)
    warm = base_lr * step / max(1.0, warmup)
    prog = torch.clamp((step - warmup) / max(1.0, total - warmup), 0, 1)
    cos = base_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


@torch.no_grad()
def adamw_update(state: TrainState, grads, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1) -> TrainState:
    """One AdamW step on float32 ``grads`` (a tree matching master).
    master, m and v are updated in place; returns the state with its
    step advanced."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - b1 ** t
    bc2 = 1.0 - b2 ** t
    for p, g, m, v in zip(tree_leaves(state.master), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.to(torch.float32)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p
        p.sub_(lr * upd)
    return state._replace(step=step)
