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

The expert-parallel paths of the reference (the shard_map "gather" path
and ``_apply_moe_tp2d``) need a device mesh and are not ported
(ROADMAP.md §1): ``apply_moe`` raises for a context with a mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import randn


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
               capacity: int):
    """MoE over x (T, d) with the experts e_first .. e_first + e_local - 1
    of ``p``. Returns (out (T, d) in x's dtype, aux () float32)."""
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
    out = (gathered * w[:, None]).reshape(T, k, d).sum(dim=1)

    # load-balance auxiliary (Switch-style): every routed slot counts
    frac = onehot.float().mean(dim=0) * k
    mean_p = probs.mean(dim=0)
    aux = E * torch.sum(frac * mean_p) / k
    return out, aux


def apply_moe(p: Dict, x: torch.Tensor, cfg: MoEConfig, act: str,
              ctx: Optional[object] = None,
              capacity_mode: str = "factor"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), the aux loss, a float32 scalar).

    ctx: ``repro_torch.sharding.ShardingContext`` or None. A context with
    a mesh raises: the expert-parallel paths are not ported."""
    if getattr(ctx, "mesh", None) is not None:
        raise NotImplementedError(
            "apply_moe: the expert-parallel paths (a device mesh) are not "
            "ported (ROADMAP.md §1)")
    B, S, d = x.shape
    t_loc = B * S
    cap = _capacity(cfg, t_loc, capacity_mode)
    out, aux = _moe_shard(x.reshape(t_loc, d), p, cfg, act, 0,
                          cfg.num_experts, cap)
    return out.reshape(B, S, d), aux
