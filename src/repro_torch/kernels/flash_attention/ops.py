"""Wrapper of the flash_attention kernel (``csrc/flash_attention.cu``).

``flash_attention`` has the reference's signature
(``repro/kernels/flash_attention/ops.py``). k/v may carry the model's KH
kv heads (KH dividing H) as well as the broadcast H heads the reference
takes: the kernel reads kv head h / (H / KH) in place, so nothing is
repeated, transposed or padded here. A CPU tensor runs the plain version
(``ref.flash_attention_plain``); a CUDA tensor launches the kernel of its
type (``KERNELS``) or raises. ``LAUNCHES`` counts the launches.

The gradient (``FlashAttention``: the forward above, q, k and v saved)
runs where q lies. On a CUDA tensor its backward is the backward kernel
(``csrc/flash_attention_bwd.cu`` through ``flash_attention_bwd_kernel``:
three passes, dq, dk and dv from the kernel, ``LAUNCHES
["flash_attention_bwd"]`` counts one a backward); a shape it refuses
raises, nothing falls back to torch ops. On a CPU tensor it is
``flash_attention_bwd``, the reference's ``custom_vjp`` backward (``_bwd``,
jnp that recomputes one query block at a time, not a Pallas kernel) as
torch ops: each block's dense float32 scores, masks and softmax, and
``torch.autograd.grad`` of the block's output, O(block_q x Sk) at a time.
Both cover every query row: the reference's loop stops at ``Sq //
block_q`` blocks, so the rows of a ragged tail get no dq there and dk, dv
lose their share. Serving goes through the same ``Function`` (under
``no_grad`` nothing is saved).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ref

LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
NEG_INF = ref.NEG_INF
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel each type runs (csrc/flash_attention.cu): bf16 on wgmma with
# a TMA ring, float32 on the tensor cores by 3xTF32 (mma.sync)
KERNELS = {torch.float32: "flash_fwd_tf32x3",
           torch.bfloat16: "flash_fwd_wgmma"}
# the backward's three kernels of each type by their names' namespaced
# prefix (csrc/flash_attention_bwd.cu): bf16 on wgmma with a TMA ring,
# float32 on the tensor cores by 3xTF32 (mma.sync)
BWD_KERNELS = {
    torch.float32: ("tf32x3::flash_bwd_prep<", "tf32x3::flash_bwd_dkdv<",
                    "tf32x3::flash_bwd_dq<"),
    torch.bfloat16: ("wg::flash_bwd_prep<", "wg::flash_bwd_dkdv<",
                     "wg::flash_bwd_dq<")}
# the products' instruction by the config entries' code
INSTRUCTIONS = {1: "wgmma m64nNk16 bf16", 2: "mma.sync m16n8k8 tf32 x3"}
MAX_HEAD_DIM = 128


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def config(dtype, d: int) -> Dict[str, object]:
    """The tiling the CUDA kernel runs for this type and head dim (read
    from the built library): queries a block, keys a tile, K/V stages,
    threads a block, the PV MMA's N, the products' instruction
    (``INSTRUCTIONS``), whether Q's operand is held in registers (else
    read from shared memory), and whether K and V are split into TF32
    planes once a tile at staging (float32; else as each fragment
    loads)."""
    out = (ctypes.c_int * 8)()
    build.load("flash_attention.cu").flash_attention_config(
        DTYPES[dtype], d, out)
    cfg = dict(zip(("block_q", "block_k", "stages", "threads", "pv_mma_n"),
                   out))
    cfg["instruction"] = INSTRUCTIONS[out[5]]
    cfg["q_in_registers"] = bool(out[6])
    cfg["kv_split_at_staging"] = bool(out[7])
    return cfg


def bwd_config(dtype, d: int) -> Dict[str, object]:
    """The tiling the backward kernels run for this type and head dim:
    queries a block of prep and dq, keys a tile there and threads a block
    there; keys a block of dkdv, queries a tile there and threads a block
    there; the stages of the streamed tiles (bf16: the TMA ring; float32:
    cp.async buffers); and the products' instruction
    (``INSTRUCTIONS``)."""
    out = (ctypes.c_int * 8)()
    build.load("flash_attention_bwd.cu").flash_attention_bwd_config(
        DTYPES[dtype], d, out)
    cfg = dict(zip(("block_q", "block_k", "threads", "dkdv_block_k",
                    "dkdv_block_q", "dkdv_threads", "stages"), out))
    cfg["instruction"] = INSTRUCTIONS[out[7]]
    return cfg


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 512, interpret: bool = True):
    """q: (B, Sq, H, d); k/v: (B, Sk, KH, d) with KH dividing H.

    Returns (B, Sq, H, d) in q's dtype, differentiable in q, k and v.
    ``block_q`` is the backward's query block (the reference's); ``block_k``
    and ``interpret`` are the reference's tiling and mode arguments, kept
    for the signature: the CUDA kernels use their own tiles (bfloat16:
    192 queries, or 128 for d > 80, x 64 keys on wgmma; float32: 64
    queries, or 128 for d > 64, x 64 keys by 3xTF32 on mma.sync,
    ``config``) and mask the ragged tail by the true key length."""
    return FlashAttention.apply(q, k, v, scale, causal, window, block_q,
                                flash_attention_fwd)


class FlashAttention(torch.autograd.Function):
    """``forward`` (``flash_attention_fwd``: the kernel, or the plain
    version for a CPU tensor) with ``flash_attention_bwd_kernel`` (a CUDA
    tensor) or ``flash_attention_bwd`` (a CPU tensor) as its gradient. The
    backward reads q, k and v, never the output, so it is the same
    whichever forward ran."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, block_q, forward):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal, window, block_q)
        return forward(q, k, v, scale, causal, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        if build.on_cuda(q):
            dq, dk, dv = flash_attention_bwd_kernel(q, k, v, do,
                                                    *ctx.args[:3])
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_bwd(q, k, v, do, scale: float, causal: bool = True,
                        window: Optional[int] = None, block_q: int = 512):
    """(dq, dk, dv) of the attention output against ``do`` (B, Sq, H, d),
    in the reference's order: per block of ``min(block_q, Sq)`` query rows
    (the last one ragged), the block's dense float32 scores with the
    causal and window masks (-1e30), softmax, the probabilities cast to
    v's dtype in the PV product, and ``torch.autograd.grad`` of that
    output against q and the H-head broadcast k, v; the broadcast
    gradients add up in float32 over the blocks, are cast to k's dtype
    and then summed over each group of H / KH query heads (head h reads
    kv head h // (H / KH), as ``_broadcast_kv`` repeats), so dk and dv
    keep KH heads."""
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    bq = min(block_q, Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    kb = k.detach().repeat_interleave(G, dim=2).requires_grad_()
    vb = v.detach().repeat_interleave(G, dim=2).requires_grad_()
    dq = torch.empty_like(q)
    dkb = torch.zeros(kb.shape, dtype=torch.float32, device=k.device)
    dvb = torch.zeros(vb.shape, dtype=torch.float32, device=v.device)
    for q0 in range(0, Sq, bq):
        rows = min(bq, Sq - q0)
        qpos = q0 + torch.arange(rows, device=q.device)[:, None]
        ok = torch.ones((rows, Sk), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= qpos - kpos < window
        with torch.enable_grad():
            qq = q[:, q0:q0 + rows].detach().requires_grad_()
            s = torch.einsum("bqhd,bkhd->bhqk", qq.float(), kb.float()) * scale
            p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype), vb)
            dqi, dki, dvi = torch.autograd.grad(
                o, (qq, kb, vb), do[:, q0:q0 + rows])
        dq[:, q0:q0 + rows] = dqi
        dkb += dki
        dvb += dvi
    dk = dkb.to(k.dtype).view(B, Sk, KH, G, d).sum(3)
    dv = dvb.to(v.dtype).view(B, Sk, KH, G, d).sum(3)
    return dq, dk, dv


def flash_attention_fwd(q, k, v, scale: float, causal: bool = True,
                        window: Optional[int] = None):
    """The forward: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor. Shapes and dtypes as ``flash_attention``."""
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    _check_shapes(q, k, v, window)
    if not build.on_cuda(q):
        return ref.flash_attention_plain(q, k, v, scale, causal, window)
    _check_launch(q, scale, k=k, v=v)
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


def flash_attention_bwd_kernel(q, k, v, do, scale: float,
                               causal: bool = True,
                               window: Optional[int] = None):
    """(dq, dk, dv) of attention against ``do`` (B, Sq, H, d), each in its
    input's dtype and layout: the backward kernel
    (``csrc/flash_attention_bwd.cu``: prep, dkdv, dq on the current
    stream, bf16 on wgmma, float32 by 3xTF32; ``BWD_KERNELS``; lse and D
    in a float32 scratch whose rows the library pads) for a CUDA tensor,
    the plain version
    (``ref.flash_attention_bwd_plain``) for a CPU tensor. The forward's
    contract: float32 or bfloat16, d a multiple of 8 up to 128, KH
    dividing H, a positive scale in bfloat16."""
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    _check_shapes(q, k, v, window)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)}: need q's shape "
                         f"{tuple(q.shape)}")
    if not build.on_cuda(q):
        return ref.flash_attention_bwd_plain(q, k, v, do, scale, causal,
                                             window)
    _check_launch(q, scale, k=k, v=v, do=do)
    q, k, v, do = (build.aligned16(t) for t in (q, k, v, do))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    lib = build.load("flash_attention_bwd.cu")
    rows = lib.flash_attention_bwd_lse_rows()  # lse, D rows padded to it
    lse = torch.empty((B, H, -(-Sq // rows) * rows), dtype=torch.float32,
                      device=q.device)
    dsum = torch.empty_like(lse)
    code = lib.flash_attention_bwd_run(
        DTYPES[q.dtype], B, Sq, Sk, H, KH, d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), lse.data_ptr(), dsum.data_ptr(), float(scale),
        int(bool(causal)), int(window or 0), build.stream_of(q.device))
    build.check(lib, code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


def _check_shapes(q, k, v, window):
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if k.shape != (B, Sk, KH, d) or v.shape != k.shape or H % KH:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, S, H|KH, d) with "
                         "KH dividing H")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")


def _check_launch(q, scale, **others):
    """What the kernels take beyond the shapes: one device and dtype,
    float32 or bfloat16, d a multiple of 8 up to MAX_HEAD_DIM, and in
    bfloat16 a positive scale."""
    d = q.shape[-1]
    for name, t in others.items():
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
