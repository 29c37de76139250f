"""Plain PyTorch versions of the flash_decode kernel.

``flash_decode_partial_plain`` computes what the CUDA kernel
(``csrc/flash_decode.cu``) computes: the un-normalised (acc, m, l) of
one query token over the whole cache, float32, the kv head of query head
h being h / (H / KH). ``flash_decode_partial_split_plain`` cuts the
cache as the kernel does, into splits of a given number of keys, and
merges the per-split partials as the kernel's second pass merges them.
``flash_decode_ref`` is the reference's oracle
(``repro/kernels/flash_decode/ref.py``): the model's ``decode_attention``
on a fully valid cache.
"""
from __future__ import annotations

import torch


def flash_decode_partial_plain(q, k, v, scale: float):
    """q: (B, H, d); k/v: (B, T, KH, d) -> (acc (B, H, d), m (B, H, 1),
    l (B, H, 1)), float32."""
    H, KH = q.shape[1], k.shape[2]
    kb = k.float().repeat_interleave(H // KH, dim=2)        # (B, T, H, d)
    vb = v.float().repeat_interleave(H // KH, dim=2)
    s = torch.einsum("bhd,bthd->bht", q.float(), kb) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    acc = torch.einsum("bht,bthd->bhd", p, vb)
    return acc, m, p.sum(dim=-1, keepdim=True)


def flash_decode_partial_split_plain(q, k, v, scale: float, split: int):
    """The cache cut as the kernel cuts it: splits of ``split`` keys from
    t = 0, the last one ragged (ceil(T / split) splits), each split's
    (acc_s, m_s, l_s) as ``flash_decode_partial_plain``, merged by the
    log-sum-exp algebra of ``ops.lse_merge`` without normalising:
    m = max m_s, l = sum l_s exp(m_s - m), acc = sum acc_s exp(m_s - m).
    Same shapes and types as ``flash_decode_partial_plain``."""
    parts = [flash_decode_partial_plain(q, k[:, t0:t0 + split],
                                        v[:, t0:t0 + split], scale)
             for t0 in range(0, k.shape[1], split)]
    m = torch.stack([p[1] for p in parts]).amax(dim=0)
    w = [torch.exp(p[1] - m) for p in parts]
    acc = sum(p[0] * ws for p, ws in zip(parts, w))
    l = sum(p[2] * ws for p, ws in zip(parts, w))
    return acc, m, l


def flash_decode_ref(q, k_cache, v_cache, k_new, v_new, *, scale: float):
    """Same signature as ops.flash_decode (full-valid cache, no SWA)."""
    from repro_torch.configs.base import AttentionConfig
    from repro_torch.models.attention import KVCache, decode_attention

    H, d = q.shape[2], q.shape[3]
    acfg = AttentionConfig(n_heads=H, n_kv_heads=k_cache.shape[2],
                           head_dim=d, causal=True, softmax_scale=scale)
    return decode_attention(q, KVCache(k_cache, v_cache), k_new, v_new,
                            acfg, valid_len=k_cache.shape[1])
