"""Attention: GQA/MQA, sliding-window, chunked (memory-bounded) softmax,
and KV-cache decode, on the JAX package's layouts (q (B, S, H, hd),
caches (B, T, KH, hd) at the kv head count; ``wq`` (d, H, hd), ``wo``
(H, hd, d)).

``full``, ``chunked``, ``swa`` and the decode step's ``decode_attention``
are torch ops, as the reference leaves them to XLA; ``flash`` runs the
flash_attention kernel for prefill and the flash_decode kernel for the
decode step (the reference's decode step always takes
``decode_attention``, the kernel's XLA twin: the two compute the same
function).

On a mesh (``ctx`` with a mesh) the q, k and v heads are split over
``model`` where they divide it (kv replicated where ``n_kv_heads`` does
not; each rank then takes the kv heads of its query heads), ``wo`` is
row-parallel and one sum over ``model`` follows (each rank's part in
float32, rounded to the activations' type once after the sum). The
prefill cache leaves in the reference's layout, (B, T, K, hd) with every
kv head, the batch over the data axes and the sequence over ``model``
(over data + ``model`` when the batch does not divide the data axes): one
all-to-all over ``model`` takes the head-split K, V there. Decode follows
``decode_attention``'s math on that cache: q and the new k, v gathered
over ``model`` (one gather); each rank's partial (acc, m, l) of every
head over its sequence block (the flash_decode kernel for
``impl="flash"``, its torch-op plain version otherwise, with ``block_k``
the largest divisor of the local block up to 1024); the partials
gathered over the sequence axes and merged by ``lse_merge`` with the new
token's own term, taken once; the local heads kept for ``wo``. The new
key is written only on the rank that owns its slot.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.kernels.flash_decode.ops import (flash_decode,
                                                  flash_decode_partial,
                                                  lse_merge)
from repro_torch.models.layers import model_split, randn, rope

NEG_INF = -1e30


def attn_init(gen, acfg: AttentionConfig, d: int, device, dtype) -> Dict:
    H, K, hd = acfg.n_heads, acfg.n_kv_heads, acfg.head_dim
    s, so = 1.0 / math.sqrt(d), 1.0 / math.sqrt(H * hd)
    p = {"wq": randn(gen, (d, H, hd), s, device, dtype),
         "wk": randn(gen, (d, K, hd), s, device, dtype),
         "wv": randn(gen, (d, K, hd), s, device, dtype),
         "wo": randn(gen, (H, hd, d), so, device, dtype)}
    if acfg.qkv_bias:
        for name, n in (("bq", H), ("bk", K), ("bv", K)):
            p[name] = torch.zeros((n, hd), device=device, dtype=dtype)
    return p


def attn_spec(acfg: AttentionConfig) -> Dict:
    p = {"wq": ("embed", "heads", None),
         "wk": ("embed", "kv", None),
         "wv": ("embed", "kv", None),
         "wo": ("heads", None, "embed")}
    if acfg.qkv_bias:
        p["bq"] = ("heads", None)
        p["bk"] = ("kv", None)
        p["bv"] = ("kv", None)
    return p


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, K, hd) — roped keys
    v: torch.Tensor  # (B, T, K, hd)


def _scale(acfg: AttentionConfig) -> float:
    return acfg.softmax_scale or 1.0 / math.sqrt(acfg.head_dim)


def _project_qkv(p: Dict, x, acfg: AttentionConfig, positions):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if acfg.use_rope:
        q = rope(q, positions, acfg.rope_theta)
        k = rope(k, positions, acfg.rope_theta)
    return q, k, v


def _broadcast_kv(t, n_heads: int):
    """(B, T, K, hd) -> (B, T, H, hd) by repeating each kv head G times."""
    K = t.shape[2]
    if K == n_heads:
        return t
    return t.repeat_interleave(n_heads // K, dim=2)


def _mask_bias(qpos, kpos, causal: bool, window: Optional[int], dtype):
    """Additive bias (S_q, S_k) from absolute positions."""
    ok = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= qpos[:, None] - kpos[None, :] < window
    zero = torch.zeros((), dtype=dtype, device=qpos.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=dtype,
                                            device=qpos.device))


def full_attention(q, k, v, acfg: AttentionConfig, qpos, kpos):
    """Masked softmax attention over the full S_q x S_k scores.
    q: (B, S, H, hd); k/v: (B, T, K, hd)."""
    H = acfg.n_heads
    kb, vb = _broadcast_kv(k, H), _broadcast_kv(v, H)
    scores = torch.einsum("bshk,bthk->bhst", q, kb).float() * _scale(acfg)
    scores = scores + _mask_bias(qpos, kpos, acfg.causal,
                                 acfg.sliding_window, torch.float32)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, vb)


def chunked_attention(q, k, v, acfg: AttentionConfig, qpos, kpos,
                      q_chunk: int = 1024, kv_chunk: int = 1024):
    """Online-softmax attention, memory O(q_chunk x kv_chunk): the torch
    mirror of the flash_attention kernel's algorithm."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    scale = _scale(acfg)
    kb, vb = _broadcast_kv(k, H), _broadcast_kv(v, H)
    q_chunk, kv_chunk = min(q_chunk, S), min(kv_chunk, T)
    assert S % q_chunk == 0 and T % kv_chunk == 0, (S, T, q_chunk, kv_chunk)
    outs = []
    for q0 in range(0, S, q_chunk):
        qi, qpi = q[:, q0:q0 + q_chunk], qpos[q0:q0 + q_chunk]
        m = torch.full((B, H, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((B, H, q_chunk), device=q.device)
        acc = torch.zeros((B, H, q_chunk, hd), device=q.device)
        for k0 in range(0, T, kv_chunk):
            ki, vi = kb[:, k0:k0 + kv_chunk], vb[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhk,bthk->bhqt", qi, ki).float() * scale
            s = s + _mask_bias(qpi, kpos[k0:k0 + kv_chunk], acfg.causal,
                               acfg.sliding_window, torch.float32)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            pe = torch.exp(s - m_new[..., None])
            l = l * alpha + pe.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqt,bthk->bhqk", pe.to(qi.dtype), vi).float()
            m = m_new
        out = acc / l.clamp_min(1e-30)[..., None]
        outs.append(out.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def swa_attention(q, k, v, acfg: AttentionConfig, qpos, kpos,
                  q_chunk: int = 1024):
    """Banded sliding-window attention: each q chunk attends a (window +
    q_chunk) KV band, S·W work, not S²."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    W = acfg.sliding_window
    band = W + q_chunk
    if T <= band:  # the window covers everything
        return full_attention(q, k, v, acfg, qpos, kpos)
    assert S % q_chunk == 0, (S, q_chunk)
    scale = _scale(acfg)
    kb, vb = _broadcast_kv(k, H), _broadcast_kv(v, H)
    outs = []
    for i in range(S // q_chunk):
        start = min(max(i * q_chunk + q_chunk - band, 0), T - band)
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpi = qpos[i * q_chunk:(i + 1) * q_chunk]
        ki, vi = kb[:, start:start + band], vb[:, start:start + band]
        s = torch.einsum("bqhk,bthk->bhqt", qi, ki).float() * scale
        s = s + _mask_bias(qpi, kpos[start:start + band], acfg.causal, W,
                           torch.float32)
        probs = torch.softmax(s, dim=-1).to(qi.dtype)
        outs.append(torch.einsum("bhqt,bthk->bqhk", probs, vi))
    return torch.cat(outs, dim=1)


def decode_attention(q, cache: KVCache, k_new, v_new, acfg: AttentionConfig,
                     valid_len: int):
    """One-token attention over a KV cache plus the new token.

    q/k_new/v_new: (B, 1, H|K, hd); cache.k/v: (B, T, K, hd). Entries at
    or past ``valid_len`` (and, with a window, before valid_len - window)
    are masked; the model passes the cache length, so nothing is."""
    T = cache.k.shape[1]
    H = acfg.n_heads
    scale = _scale(acfg)
    kb, vb = _broadcast_kv(cache.k, H), _broadcast_kv(cache.v, H)
    s_cache = torch.einsum("bqhk,bthk->bhqt", q, kb).float() * scale
    idx = torch.arange(T, device=q.device)
    ok = idx < valid_len
    if acfg.sliding_window:
        ok &= idx >= valid_len - acfg.sliding_window
    s_cache = s_cache.masked_fill(~ok, NEG_INF)
    s_self = torch.einsum("bqhk,bqhk->bhq", q, _broadcast_kv(k_new, H)
                          ).float()[..., None] * scale           # (B,H,1,1)
    m = torch.maximum(s_cache.amax(dim=-1, keepdim=True), s_self)
    e_cache = torch.exp(s_cache - m)                               # (B,H,1,T)
    e_self = torch.exp(s_self - m)
    denom = e_cache.sum(dim=-1, keepdim=True) + e_self
    # the probabilities round to q's dtype; the product accumulates in
    # float32 (preferred_element_type in the reference)
    o_cache = torch.einsum("bhqt,bthk->bhqk", e_cache.to(q.dtype).float(),
                           vb.float())
    v_self = _broadcast_kv(v_new, H).transpose(1, 2)              # (B,H,1,hd)
    out = (o_cache + e_self * v_self.float()) / denom
    return out.to(q.dtype).transpose(1, 2)                        # (B,1,H,hd)


def seq_axes(ctx, batch_sharded: bool = True) -> Tuple[str, ...]:
    """The mesh axes a KV cache's sequence is split over: ``model``, or
    the data axes and ``model`` when the batch is not split."""
    return ((ctx.model_axis,) if batch_sharded
            else ctx.data_axes + (ctx.model_axis,))


def _kv_of_heads(k, v, acfg: AttentionConfig, ctx):
    """The kv heads that this rank's query heads read (all kv heads on
    every rank, the query heads split): one head a group of local query
    heads where the grouping allows it, else one a query head."""
    Hl = acfg.n_heads // ctx.model_size
    G = acfg.n_heads // acfg.n_kv_heads
    h0 = coll.index(ctx.mesh, ctx.model_axis) * Hl
    idx = [(h0 + j) // G for j in range(Hl)]
    uniq = sorted(set(idx))
    per = Hl // len(uniq)
    if Hl % len(uniq) == 0 and idx == [u for u in uniq for _ in range(per)]:
        idx = uniq
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def _seq_split(t, kv_split: bool, ctx, batch_sharded: bool):
    """A (B, T, K_local, hd) cache tensor to this rank's sequence block
    with every kv head: one all-to-all over ``model`` from kv heads split
    over it, a slice where every rank holds every head."""
    n = coll.size(ctx.mesh, seq_axes(ctx, batch_sharded))
    T = t.shape[1]
    if T % n:
        raise ValueError(f"a cache of {T} positions does not divide over "
                         f"the {n} ranks of its sequence axes")
    if not batch_sharded:
        d = coll.index(ctx.mesh, ctx.data_axes)
        blk = T // ctx.data_size
        t = t[:, d * blk:(d + 1) * blk]
    if kv_split:
        t = coll.all_to_all(t, ctx.mesh, ctx.model_axis, split_dim=1,
                            cat_dim=2)
    else:
        blk = t.shape[1] // ctx.model_size
        m = coll.index(ctx.mesh, ctx.model_axis)
        t = t[:, m * blk:(m + 1) * blk]
    return t.contiguous()


def _decode_on_mesh(q, k, v, cache: KVCache, acfg: AttentionConfig, impl,
                    cache_pos, ctx, batch_sharded: bool):
    """One decode step over the sequence-split cache (the module's
    docstring). q (B, 1, H_local, hd); k, v (B, 1, K_local, hd). Returns
    (out (B, 1, H_local, hd), the cache written in place)."""
    mesh, model = ctx.mesh, ctx.model_axis
    H, KH = acfg.n_heads, acfg.n_kv_heads
    heads_split = model_split(H, ctx)
    if model_split(KH, ctx):
        # q, k and v in one gather: [q | k | v] a rank, heads concatenated
        Hl, KHl = q.shape[2], k.shape[2]
        g = coll.all_gather(torch.cat([q, k, v], dim=2), mesh, model, dim=2)
        parts = g.split(Hl + 2 * KHl, dim=2)
        q, k, v = (torch.cat([t[:, :, a:b] for t in parts], dim=2)
                   for a, b in ((0, Hl), (Hl, Hl + KHl),
                                (Hl + KHl, Hl + 2 * KHl)))
    elif heads_split:
        q = coll.all_gather(q, mesh, model, dim=2)
    axes = seq_axes(ctx, batch_sharded)
    T_l = cache.k.shape[1]
    scale = _scale(acfg)
    if impl == "flash":
        acc, m, l = flash_decode_partial(q[:, 0], cache.k, cache.v,
                                         scale=scale,
                                         block_k=math.gcd(T_l, 1024))
    else:
        acc, m, l = fd_ref.flash_decode_partial_plain(q[:, 0], cache.k,
                                                      cache.v, scale)
    hd = acc.shape[-1]
    parts = coll.all_gather(torch.cat([acc, m, l], dim=-1)[None], mesh,
                            axes, dim=0)
    parts = [(t[..., :hd], t[..., hd:hd + 1], t[..., hd + 1:])
             for t in parts.unbind(0)]
    # the new token's own term, once: (its value, its score, a weight 1)
    rep = H // KH
    knb = k[:, 0].repeat_interleave(rep, dim=1).float()
    vnb = v[:, 0].repeat_interleave(rep, dim=1).float()
    s_self = (q[:, 0].float() * knb).sum(-1, keepdim=True) * scale
    out = lse_merge(parts + [(vnb, s_self, torch.ones_like(s_self))])
    out = out[:, None].to(q.dtype)
    if heads_split:
        Hl = H // ctx.model_size
        h0 = coll.index(mesh, model) * Hl
        out = out[:, :, h0:h0 + Hl]
    T = T_l * coll.size(mesh, axes)
    wpos = int(cache_pos) if cache_pos is not None else T - 1
    slot = wpos % T if acfg.sliding_window else min(max(wpos, 0), T - 1)
    r = coll.index(mesh, axes)
    if slot // T_l == r:
        cache.k[:, slot - r * T_l] = k[:, 0]
        cache.v[:, slot - r * T_l] = v[:, 0]
    return out, cache


def apply_attention(p: Dict, x, acfg: AttentionConfig, positions, mode: str,
                    cache: Optional[KVCache] = None, cache_pos=None,
                    impl: str = "auto", q_chunk: int = 1024, ctx=None,
                    batch_sharded: bool = True
                    ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Unified attention layer.

    mode: "train" | "prefill" | "decode".
      train:   returns (out, None)
      prefill: returns (out, KVCache of the whole sequence, cut to the
               last ``sliding_window`` positions for SWA archs)
      decode:  x is (B, 1, d); ``cache_pos`` (an int) is the position of
               the new token; the new KV is written into ``cache`` in
               place (slot cache_pos % T with a window, else
               clip(cache_pos, 0, T - 1), as the reference) and the cache
               is returned.
    impl: auto | full | chunked | swa | flash. Decode runs the
               flash_decode kernel for "flash", ``decode_attention``
               otherwise.
    ctx: a ``ShardingContext``; with a mesh, ``p`` holds this rank's
               blocks (FSDP dims gathered), x its batch block
               (``batch_sharded``) or the whole batch, and a cache its
               blocks (the module's docstring).
    """
    B, S, _ = x.shape
    mesh = ctx is not None and ctx.mesh is not None
    q, k, v = _project_qkv(p, x, acfg, positions)
    heads_split = mesh and model_split(acfg.n_heads, ctx)
    kv_split = mesh and model_split(acfg.n_kv_heads, ctx)
    if mode in ("train", "prefill"):
        kq, vq = k, v
        if heads_split and not kv_split:
            kq, vq = _kv_of_heads(k, v, acfg, ctx)
        if mesh:
            acfg = dataclasses.replace(acfg, n_heads=q.shape[2],
                                       n_kv_heads=kq.shape[2])
        if impl == "auto":
            if acfg.sliding_window and S > 4 * (acfg.sliding_window + q_chunk):
                impl = "swa"
            elif S > 8192:
                impl = "chunked"
            else:
                impl = "full"
        if impl == "flash":
            out = flash_attention(q, kq, vq, _scale(acfg), acfg.causal,
                                  acfg.sliding_window, min(512, S),
                                  min(512, S))
        elif impl == "full":
            out = full_attention(q, kq, vq, acfg, positions, positions)
        else:
            fn = {"chunked": chunked_attention, "swa": swa_attention}[impl]
            out = fn(q, kq, vq, acfg, positions, positions, q_chunk=q_chunk)
        new_cache = None
        if mode == "prefill":
            W = acfg.sliding_window
            if W and S > W:
                k, v = k[:, S - W:].contiguous(), v[:, S - W:].contiguous()
            if mesh:
                k = _seq_split(k, kv_split, ctx, batch_sharded)
                v = _seq_split(v, kv_split, ctx, batch_sharded)
            new_cache = KVCache(k, v)
    elif mesh:
        assert cache is not None
        out, new_cache = _decode_on_mesh(q, k, v, cache, acfg, impl,
                                         cache_pos, ctx, batch_sharded)
    else:
        assert cache is not None
        T = cache.k.shape[1]
        if impl == "flash":
            out = flash_decode(q, cache.k, cache.v, k, v, scale=_scale(acfg),
                               block_k=math.gcd(T, 1024))
        else:
            out = decode_attention(q, cache, k, v, acfg, valid_len=T)
        wpos = int(cache_pos) if cache_pos is not None else T - 1
        slot = wpos % T if acfg.sliding_window else min(max(wpos, 0), T - 1)
        cache.k[:, slot] = k[:, 0]
        cache.v[:, slot] = v[:, 0]
        new_cache = cache
    if heads_split:
        # each rank's part of the sum in float32, rounded once after the
        # sum over model, as the one-card product rounds once
        y = torch.einsum("bshk,hkd->bsd", out.float(), p["wo"].float())
        y = coll.all_reduce(y, ctx.mesh, ctx.model_axis).to(x.dtype)
    else:
        y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache
