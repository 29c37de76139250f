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
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import AttentionConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_decode.ops import flash_decode
from repro_torch.models.layers import randn, rope

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


def apply_attention(p: Dict, x, acfg: AttentionConfig, positions, mode: str,
                    cache: Optional[KVCache] = None, cache_pos=None,
                    impl: str = "auto", q_chunk: int = 1024
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
    """
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, acfg, positions)
    if mode in ("train", "prefill"):
        if impl == "auto":
            if acfg.sliding_window and S > 4 * (acfg.sliding_window + q_chunk):
                impl = "swa"
            elif S > 8192:
                impl = "chunked"
            else:
                impl = "full"
        if impl == "flash":
            out = flash_attention(q, k, v, _scale(acfg), acfg.causal,
                                  acfg.sliding_window, min(512, S),
                                  min(512, S))
        elif impl == "full":
            out = full_attention(q, k, v, acfg, positions, positions)
        else:
            fn = {"chunked": chunked_attention, "swa": swa_attention}[impl]
            out = fn(q, k, v, acfg, positions, positions, q_chunk=q_chunk)
        new_cache = None
        if mode == "prefill":
            W = acfg.sliding_window
            if W and S > W:
                k, v = k[:, S - W:].contiguous(), v[:, S - W:].contiguous()
            new_cache = KVCache(k, v)
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
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return y, new_cache
