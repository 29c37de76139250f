"""Wrappers of the flash_decode kernel (``csrc/flash_decode.cu``).

``flash_decode_partial`` is the kernel: the un-normalised (acc, m, l) of
one token over the cache. ``flash_decode`` merges the current token's
own key and value into it and normalises; ``lse_merge`` combines partial
results of cache parts. The merges are one token's worth of algebra and
stay torch ops, as they are jnp in the reference
(``repro/kernels/flash_decode/ops.py``). The cache keeps its KH kv heads:
nothing is repeated to H heads. A CPU tensor runs the plain version
(``ref.flash_decode_partial_plain``); a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

LAUNCHES: Dict[str, int] = {"flash_decode": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_OUTPUTS = 8192  # G * d a block: 32 (head, column) outputs a thread


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def flash_decode_partial(q, k, v, *, scale: float, block_k: int = 1024,
                         interpret: bool = True):
    """q: (B, H, d); k/v: (B, T, KH, d) cache, KH dividing H.

    Returns un-normalised (acc (B, H, d), m (B, H, 1), l (B, H, 1)),
    float32: out = acc / l after any merge. T must be a multiple of
    ``block_k`` (the reference's contract); ``interpret`` is kept for the
    signature."""
    B, H, d = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, d) or v.shape != k.shape or H % KH:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need q (B, H, d), k/v "
                         "(B, T, KH, d) with KH dividing H")
    if T % block_k:
        raise ValueError(f"cache length {T} is not a multiple of block_k "
                         f"{block_k}")
    if not build.on_cuda(q):
        return ref.flash_decode_partial_plain(q, k, v, scale)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_decode takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if (H // KH) * d > MAX_OUTPUTS:
        raise NotImplementedError(
            f"{H // KH} query heads a kv head x head_dim {d} > "
            f"{MAX_OUTPUTS}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, H, d), **f32)
    m = torch.empty((B, H, 1), **f32)
    l = torch.empty((B, H, 1), **f32)
    lib = build.load("flash_decode.cu")
    code = lib.flash_decode_partial_run(
        DTYPES[q.dtype], B, H, KH, T, d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        float(scale), build.stream_of(q.device))
    build.check(lib, code, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return acc, m, l


def flash_decode(q, k_cache, v_cache, k_new, v_new, *, scale: float,
                 block_k: int = 1024, interpret: bool = True):
    """q/k_new/v_new: (B, 1, H|KH, d); cache: (B, T, KH, d).

    Returns (B, 1, H, d) in q's dtype."""
    H = q.shape[2]
    rep = H // k_cache.shape[2]
    acc, m, l = flash_decode_partial(q[:, 0], k_cache, v_cache, scale=scale,
                                     block_k=block_k)
    # merge the current token (self-attention term)
    knb = k_new[:, 0].repeat_interleave(rep, dim=1).float()   # (B, H, d)
    vnb = v_new[:, 0].repeat_interleave(rep, dim=1).float()
    s_self = (q[:, 0].float() * knb).sum(-1, keepdim=True) * scale
    m_tot = torch.maximum(m, s_self)
    alpha = torch.exp(m - m_tot)
    e_self = torch.exp(s_self - m_tot)
    l_tot = l * alpha + e_self
    acc_tot = acc * alpha + e_self * vnb
    return (acc_tot / l_tot)[:, None].to(q.dtype)


def lse_merge(parts):
    """Merge [(acc, m, l), ...] partial results of parts of the cache
    (the distributed flash-decode combiner)."""
    accs, ms, ls = zip(*parts)
    m_tot = torch.stack(ms).amax(dim=0)
    l_tot = sum(l * torch.exp(m - m_tot) for m, l in zip(ms, ls))
    acc_tot = sum(a * torch.exp(m - m_tot) for m, a in zip(ms, accs))
    return acc_tot / l_tot
