"""Wrappers of the flash_decode kernel (``csrc/flash_decode.cu``).

``flash_decode_partial`` is the kernel: the un-normalised (acc, m, l) of
one token over the cache, split over the card's SMs in two launches
(per-split partials, then their merge). ``flash_decode`` merges the
current token's own key and value into it and normalises; ``lse_merge``
combines partial results of cache parts. The merges are one token's
worth of algebra and stay torch ops, as they are jnp in the reference
(``repro/kernels/flash_decode/ops.py``). The cache keeps its KH kv heads:
nothing is repeated to H heads. A CPU tensor runs the plain version
(``ref.flash_decode_partial_plain``); a CUDA tensor launches the kernel
or raises. ``LAUNCHES`` counts the wrapper calls that launched it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ref

LAUNCHES: Dict[str, int] = {"flash_decode": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_OUTPUTS = 8192  # G * d a block: q and the scores stay under 32 KB each
MAX_HEAD_DIM = 128  # 16 chunks of 8 values: one chunk a lane of a half-warp
SPLIT = 512         # keys a block of pass 1


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def choose_split(B: int, KH: int, T: int, G: int, sms: int) -> int:
    """Keys a block of the kernel's first pass takes: ``SPLIT``, halved
    (not below 64) while B x KH x ceil(T / split) blocks would leave more
    than half of the card's ``sms`` SMs without one, and cut so the
    G x split float32 scores stay under ``MAX_OUTPUTS`` values. On the
    H100 (132 SMs) at T=4096, KH=8, G=4, d=80 this keeps 512 keys at
    B=4 (256 blocks) and takes 256 at B=1 (128 blocks): the fastest
    split of each (``scripts/lm_decode_probe.py split``)."""
    split = SPLIT
    while split > 64 and 2 * B * KH * -(-T // split) <= sms:
        split //= 2
    return max(16, min(split, MAX_OUTPUTS // G // 16 * 16))


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def config() -> Dict[str, int]:
    """The first pass's block (read from the built library): threads, key
    rows of a PV step, rows a half-warp takes a PV step, values a chunk,
    shared bytes budgeted for the staged split."""
    out = (ctypes.c_int * 5)()
    build.load("flash_decode.cu").flash_decode_config(out)
    return dict(zip(("threads", "rows", "unroll", "chunk", "smem_budget"),
                    out))


def _check(q, k, v):
    B, H, d = q.shape
    T, KH = k.shape[1], k.shape[2]
    if k.shape != (B, T, KH, d) or v.shape != k.shape or H % KH:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need q (B, H, d), k/v "
                         "(B, T, KH, d) with KH dividing H")


def flash_decode_partial(q, k, v, *, scale: float, block_k: int = 1024,
                         interpret: bool = True):
    """q: (B, H, d); k/v: (B, T, KH, d) cache, KH dividing H.

    Returns un-normalised (acc (B, H, d), m (B, H, 1), l (B, H, 1)),
    float32: out = acc / l after any merge. T must be a multiple of
    ``block_k`` (the reference's contract); ``interpret`` is kept for the
    signature. On the card the cache is cut into splits of
    ``choose_split`` keys."""
    _check(q, k, v)
    T = k.shape[1]
    if T % block_k:
        raise ValueError(f"cache length {T} is not a multiple of block_k "
                         f"{block_k}")
    if not build.on_cuda(q):
        return ref.flash_decode_partial_plain(q, k, v, scale)
    B, H, _ = q.shape
    KH = k.shape[2]
    return _partial_split(q, k, v, scale,
                          choose_split(B, KH, T, H // KH, _sms(q.device)))


def _partial_split(q, k, v, scale: float, split: int):
    """The kernel at a given split: pass 1 writes each block's float32
    partial (acc, m, l) of ``split`` keys (the last split ragged), pass 2
    merges them (both one wrapper call, one count in ``LAUNCHES``). A CPU
    tensor runs ``ref.flash_decode_partial_split_plain``, the same cut."""
    _check(q, k, v)
    B, H, d = q.shape
    T, KH = k.shape[1], k.shape[2]
    if split < 1:
        raise ValueError(f"split must be positive, got {split}")
    n_split = -(-T // split)
    if not build.on_cuda(q):
        return ref.flash_decode_partial_split_plain(q, k, v, scale, split)
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
    if d % 8 or d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {d}: the kernel reads chunks of 8 values, a multiple "
            f"of 8 up to {MAX_HEAD_DIM}")
    q, k, v = (build.aligned16(t) for t in (q, k, v))
    f32 = dict(dtype=torch.float32, device=q.device)
    part = torch.empty((B, H, n_split, d + 2), **f32)
    acc = torch.empty((B, H, d), **f32)
    m = torch.empty((B, H, 1), **f32)
    l = torch.empty((B, H, 1), **f32)
    lib = build.load("flash_decode.cu")
    code = lib.flash_decode_partial_run(
        DTYPES[q.dtype], B, H, KH, T, d, split, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), part.data_ptr(), acc.data_ptr(), m.data_ptr(),
        l.data_ptr(), float(scale), build.stream_of(q.device))
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
