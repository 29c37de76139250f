"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` has the reference's signature
(``repro/kernels/flash_attention/ops.py``), forward only. k/v may carry
the model's KH kv heads (KH dividing H) as well as the broadcast H heads
the reference takes: the kernel reads kv head h / (H / KH) in place, so
nothing is repeated, transposed or padded here. A CPU tensor runs the
plain version (``ref.flash_attention_plain``); a CUDA tensor launches the
kernel of its type (``KERNELS``) or raises. ``LAUNCHES`` counts the
launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each type runs (csrc/flash_attention.cu): bf16 on the tensor
# cores, float32 on the CUDA cores (the tensor cores would round it)
KERNELS = {torch.float32: "flash_fwd_f32", torch.bfloat16: "flash_fwd_wgmma"}
MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def config(dtype, d: int) -> Dict[str, int]:
    """The tiling the CUDA kernel runs for this type and head dim (read
    from the built library): queries a block, keys a tile, K/V stages,
    threads a block, and the PV MMA's N (0: the CUDA-core kernel)."""
    out = (ctypes.c_int * 5)()
    build.load("flash_attention.cu").flash_attention_config(
        DTYPES[dtype], d, out)
    return dict(zip(("block_q", "block_k", "stages", "threads", "pv_mma_n"),
                    out))


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 512, interpret: bool = True):
    """q: (B, Sq, H, d); k/v: (B, Sk, KH, d) with KH dividing H.

    Returns (B, Sq, H, d) in q's dtype. ``block_q``, ``block_k`` and
    ``interpret`` are the reference's tiling and mode arguments, kept for
    the signature: the CUDA kernels use their own tiles (bfloat16: 192
    queries, or 128 for d > 80, x 64 keys on the tensor cores; float32:
    64 x 64 on the CUDA cores, ``config``) and mask the ragged tail by
    the true key length."""
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KH, d) or v.shape != k.shape or H % KH:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, S, H|KH, d) with "
                         "KH dividing H")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if not build.on_cuda(q):
        return ref.flash_attention_plain(q, k, v, scale, causal, window)
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"head_dim {d}: the kernel takes a multiple of 8 up to "
            f"{MAX_HEAD_DIM}")
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise NotImplementedError(
            f"scale {scale}: the bf16 kernel keeps its running max on the "
            "unscaled q.k, which needs scale > 0")
    q, k, v = (build.aligned16(t) for t in (q, k, v))
    o = torch.empty_like(q)
    lib = build.load("flash_attention.cu")
    code = lib.flash_attention_run(
        DTYPES[q.dtype], B, Sq, Sk, H, KH, d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), float(scale), int(bool(causal)),
        int(window or 0), build.stream_of(q.device))
    build.check(lib, code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
