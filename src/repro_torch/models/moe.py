"""Mixture-of-Experts with static-capacity scatter dispatch, on one card.

A port of ``repro/models/moe.py``'s single-device path. The reference's
layout and shapes are kept:

  * Static shapes everywhere: an (E, C, d) capacity buffer per layer,
    token drops instead of dynamic shapes. ``capacity_mode="full"``
    (prefill and decode) sets C to the token count, so nothing drops;
    ``"factor"`` (train) sizes C by ``capacity_factor``, 8-aligned.
  * Each entry's queue position is the reference's one-hot cumsum,
    computed by a stable sort by expert.
  * Dispatch is a scatter-add into the buffer and a gather back, both
    at clipped (slot, position) indices, with the entries that do not
    fit multiplied by 0 rather than removed: no ``nonzero``, boolean
    indexing or host sync, so every shape is known before the call.
  * The three expert products are batched matrix products over E.

Top-k follows ``jax.lax.top_k``: among equal probabilities the lower
expert index comes first (a stable descending sort, then the first k).
The flat (token, slot) order decides each entry's queue position, and so
which entries drop at ``"factor"`` capacity.

On a mesh (a ``ShardingContext`` from ``sharding.rules.make_context``)
``apply_moe`` takes the reference's choice of path:

  * a model axis of one rank, or experts that do not divide it: the
    one-device path on the whole batch (the tokens gathered over the data
    axes, the rank's block kept), as GSPMD runs the reference's;
  * "gather" (``ShardingContext.moe_weight_mode``): the experts split
    over ``model``, their embed dim FSDP over the data axes and gathered
    here, one sum of the output over ``model``; the capacity comes from
    the rank's own tokens, so at "factor" capacity other entries drop
    than on one device, and the aux is the mean of the data blocks'
    estimates (the reference's pmean);
  * "tp2d" (where the FFN dim divides the data axes): the experts over
    ``model`` x the FFN dim over the data axes, the tokens gathered whole
    and one sum over data + ``model``.

Each rank's part of the output is summed over the ranks in float32 and
rounded to x's dtype once, as the one-device combine rounds once.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.distributed import collectives as coll
from repro_torch.models.layers import randn
from repro_torch.sharding.rules import (ShardingContext, axes_of,
                                        logical_to_spec)


def moe_init(gen, cfg: MoEConfig, d: int, act: str, device, dtype) -> Dict:
    """router (d, E) float32 whatever ``dtype``, as the reference; the
    experts' w_in (E, d, f), w_out (E, f, d) and, for swiglu, w_gate
    (E, d, f) in ``dtype``."""
    E, f = cfg.num_experts, cfg.d_ff_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {"router": randn(gen, (d, E), s_in, device, torch.float32),
         "w_in": randn(gen, (E, d, f), s_in, device, dtype),
         "w_out": randn(gen, (E, f, d), s_out, device, dtype)}
    if act == "swiglu":
        p["w_gate"] = randn(gen, (E, d, f), s_in, device, dtype)
    return p


def moe_spec(act: str) -> Dict:
    """moe_d / moe_f resolve by ``ShardingContext.moe_weight_mode``:
    gather: moe_d -> FSDP data axes, moe_f -> replicated; tp2d: moe_d ->
    replicated, moe_f -> the data axes."""
    p = {"router": (None, None),
         "w_in": ("experts", "moe_d", "moe_f"),
         "w_out": ("experts", "moe_f", "moe_d")}
    if act == "swiglu":
        p["w_gate"] = ("experts", "moe_d", "moe_f")
    return p


def _capacity(cfg: MoEConfig, t_local: int, mode: str) -> int:
    if mode == "full":
        return t_local
    c = int(math.ceil(t_local * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(8, min(t_local, -(-c // 8) * 8))  # 8-aligned, bounded


def _activate(h, g, act: str):
    if act == "swiglu":
        return F.silu(g) * h
    if act == "squared_relu":
        r = F.relu(h)
        return r * r
    if act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h, approximate="tanh")
    raise KeyError(act)


def _route(x, router, k: int):
    """(probs (T, E) float32, topw (T, k) renormalised, topi (T, k)): the
    router in float32 (a bf16 router is widened, as JAX promotes), the
    top k by a stable descending sort (lower index first among ties)."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :k], idx[:, :k]
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)
    return probs, topw, topi


def _dispatch(topi, E: int, capacity: int, e_first: int, e_local: int):
    """Where each (token, slot) entry of the flat (T * k,) routing stream
    goes: (onehot (T*k, E), mine (T*k,) bool: the entry fits its expert's
    queue and the expert is local, slot_c and pos_c: its expert slot and
    queue position, clipped into the buffer)."""
    flat_e = topi.reshape(-1)
    onehot = F.one_hot(flat_e, E)                        # (T*k, E) int64
    # the entries before it with its expert: the reference's one-hot
    # cumsum down the T*k rows, as its rank in a stable sort by expert
    # less its expert's first rank (a scan down (T*k, E) runs on E
    # threads on the card)
    order = torch.argsort(flat_e, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=order.device))
    counts = onehot.sum(dim=0)
    flat_pos = rank - (torch.cumsum(counts, dim=0) - counts)[flat_e]
    keep = flat_pos < capacity
    local_slot = flat_e - e_first
    mine = keep & (local_slot >= 0) & (local_slot < e_local)
    return (onehot, mine, local_slot.clamp(0, e_local - 1),
            flat_pos.clamp(0, capacity - 1))


def _moe_shard(x, p, cfg: MoEConfig, act: str, e_first: int, e_local: int,
               capacity: int, out_dtype=None):
    """MoE over x (T, d) with the experts e_first .. e_first + e_local - 1
    of ``p``. Returns (out (T, d) in x's dtype, or ``out_dtype``: the
    weighted slots summed in it, a part the mesh sums before rounding;
    aux () float32)."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.top_k
    probs, topw, topi = _route(x, p["router"], k)
    onehot, mine, slot_c, pos_c = _dispatch(topi, E, capacity, e_first,
                                            e_local)

    # an entry that does not fit adds an exact 0 at its clipped slot
    updates = (x[:, None].expand(T, k, d).reshape(T * k, d)
               * mine[:, None].to(x.dtype))
    buf = torch.zeros((e_local, capacity, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((slot_c, pos_c), updates, accumulate=True)

    h = torch.bmm(buf, p["w_in"])
    g = torch.bmm(buf, p["w_gate"]) if act == "swiglu" else None
    y = torch.bmm(_activate(h, g, act), p["w_out"])      # (E_loc, C, d)

    gathered = y[slot_c, pos_c]                          # (T*k, d)
    w = (topw.reshape(-1) * mine.float()).to(x.dtype)
    out = (gathered * w[:, None]).reshape(T, k, d)
    out = out.sum(dim=1) if out_dtype is None else out.to(out_dtype).sum(1)

    # load-balance auxiliary (Switch-style): every routed slot counts
    frac = onehot.float().mean(dim=0) * k
    mean_p = probs.mean(dim=0)
    aux = E * torch.sum(frac * mean_p) / k
    return out, aux


def apply_moe(p: Dict, x: torch.Tensor, cfg: MoEConfig, act: str,
              ctx: Optional[ShardingContext] = None,
              capacity_mode: str = "factor", batch_sharded: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), the aux loss, a float32 scalar).

    ctx: a ``ShardingContext`` (``make_context``) or None. With a mesh,
    ``p`` holds this rank's blocks of the leaves (``moe_spec``'s layout)
    and x its block of the batch (``batch_sharded``) or the whole batch;
    the output is x's block. Any other context is refused."""
    if ctx is not None and not isinstance(ctx, ShardingContext):
        raise TypeError(f"apply_moe: ctx must be a ShardingContext "
                        f"(sharding.rules.make_context), got {ctx!r}")
    B, S, d = x.shape
    E = cfg.num_experts
    if ctx is None or ctx.mesh is None:
        cap = _capacity(cfg, B * S, capacity_mode)
        out, aux = _moe_shard(x.reshape(B * S, d), p, cfg, act, 0, E, cap)
        return out.reshape(B, S, d), aux
    mesh, data, model = ctx.mesh, ctx.data_axes, ctx.model_axis
    if ctx.model_size == 1 or E % ctx.model_size:
        # the reference's one-device path runs on the global batch
        xg = coll.all_gather(x, mesh, data, 0) if batch_sharded else x
        p = _gather_data(p, ctx, E, d, cfg.d_ff_expert, ("moe_d", "moe_f"))
        cap = _capacity(cfg, xg.shape[0] * S, capacity_mode)
        out, aux = _moe_shard(xg.reshape(-1, d), p, cfg, act, 0, E, cap)
        return _own_rows(out.reshape(-1, S, d), ctx, batch_sharded), aux
    e_local = E // ctx.model_size
    e_first = coll.index(mesh, model) * e_local
    if (ctx.moe_weight_mode == "tp2d"
            and cfg.d_ff_expert % ctx.data_size == 0 and ctx.data_size > 1):
        # tokens whole on every rank; the output partial over the experts
        # (model) and the FFN dim (data): one sum over the whole mesh
        xg = coll.all_gather(x, mesh, data, 0) if batch_sharded else x
        cap = _capacity(cfg, xg.shape[0] * S, capacity_mode)
        out, aux = _moe_shard(xg.reshape(-1, d), p, cfg, act, e_first,
                              e_local, cap, torch.float32)
        out = coll.all_reduce(out, mesh, data + (model,)).to(x.dtype)
        return _own_rows(out.reshape(-1, S, d), ctx, batch_sharded), aux
    p = _gather_data(p, ctx, E, d, cfg.d_ff_expert, ("moe_d",))
    cap = _capacity(cfg, B * S, capacity_mode)
    out, aux = _moe_shard(x.reshape(B * S, d), p, cfg, act, e_first, e_local,
                          cap, torch.float32)
    out = coll.all_reduce(out, mesh, model).to(x.dtype)
    if batch_sharded:
        # the mean of the data blocks' estimates
        aux = coll.all_reduce(aux, mesh, data) / ctx.data_size
    return out.reshape(B, S, d), aux


def _gather_data(p: Dict, ctx: ShardingContext, E: int, d: int, f: int,
                 names: Tuple[str, ...]):
    """The expert weights with their ``names`` dims (moe_d, moe_f)
    gathered over the data axes where they are split there (the gather's
    backward reduce-scatters)."""
    shapes = {"moe_d": d, "moe_f": f, "experts": E}
    out = dict(p)
    for name, axes in moe_spec("swiglu").items():
        if name not in p or name == "router":
            continue
        spec = logical_to_spec(axes, tuple(shapes[a] for a in axes), ctx)
        for dim, (a, e) in enumerate(zip(axes, spec)):
            if a in names and axes_of(e) == ctx.data_axes:
                out[name] = coll.all_gather(out[name], ctx.mesh,
                                            ctx.data_axes, dim)
    return out


def _own_rows(out, ctx: ShardingContext, batch_sharded: bool):
    """This rank's block of a whole batch's rows."""
    if not batch_sharded:
        return out
    blk = out.shape[0] // ctx.data_size
    i = coll.index(ctx.mesh, ctx.data_axes)
    return out[i * blk:(i + 1) * blk]
