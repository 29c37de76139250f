"""Wrapper of the ssd_scan kernel (``csrc/ssd_scan.cu``).

``ssd_scan`` keeps the reference wrapper's signature and layout
(``repro/kernels/ssd_scan/ops.py``: x (B, S, H, P), dt (B, S, H) float32
after softplus, Bm/Cm (B, S, N), A (H,) negative float32) and returns
``(y, state)`` like ``models/ssm.py:ssd_chunked``: the kernel also writes
the final (B, H, P, N) float32 state, which prefill keeps in its cache.
The chunk follows ``ssd_chunked``: Q = min(chunk, S), which must divide
S. The kernels read the model's layout in place: nothing is transposed.
bfloat16 inputs (the serving route) run the tensor-core schedule of four
launches (cum, chunk states, state passing, outputs), with three
scratches allocated here (cum, the chunks' state inputs, the states as
bf16 hi and lo planes); float32 inputs (a check route) run the
CUDA-core kernel, one launch. A CPU tensor runs the plain version
(``ref.ssd_scan_plain``); a CUDA tensor launches the kernel or raises.
``LAUNCHES`` counts the wrapper's kernel calls (one a call either way).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ssd_scan import ref

LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
MAX_STATE = 128   # d_state N: a power of two from 4 to 128
MAX_CHUNK = 256   # Q
P_BLOCKS = (16, 32, 64)  # columns of p a block (float32) or a pass (bf16)
# float32: 32 state columns a block where P allows, the fastest of the
# three at the serving shape on an H100; bf16: the widest pass that
# divides P (chip_smoke.py phase 8 times each)
DEFAULT_P_BLOCK = {torch.float32: 32, torch.bfloat16: 64}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def ssd_scan(x, dt, Bm, Cm, A, chunk: int = 256, state0=None,
             interpret: bool = True):
    """x: (B, S, H, P); dt: (B, S, H) float32; Bm/Cm: (B, S, N); A: (H,)
    negative float32; state0: (B, H, P, N) float32 or None.

    Returns (y (B, S, H, P) in x's dtype, state (B, H, P, N) float32).
    ``interpret`` is the reference's mode argument, kept for the
    signature."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    if (dt.shape != (Bb, S, H) or Bm.shape != (Bb, S, N)
            or Cm.shape != Bm.shape or A.shape != (H,)
            or (state0 is not None and state0.shape != (Bb, H, P, N))):
        raise ValueError(
            f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, Bm "
            f"{tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, A {tuple(A.shape)}: "
            "need x (B, S, H, P), dt (B, S, H), Bm/Cm (B, S, N), A (H,), "
            "state0 (B, H, P, N)")
    Q = ref.chunk_len(S, chunk)
    if not build.on_cuda(x):
        return ref.ssd_scan_plain(x, dt, Bm, Cm, A, chunk, state0)
    return _launch(x, dt, Bm, Cm, A, Q, state0, block_p(P, N, Q, x.dtype))


def block_p(P: int, N: int, Q: int, dtype=torch.float32) -> int:
    """The kernel's columns of p a block (float32: the state columns of
    the CUDA-core kernel) or a pass (bf16: of the tensor-core output
    kernel) for (P, N, Q); raises NotImplementedError for what the
    kernels do not take."""
    if N < 4 or N > MAX_STATE or N & (N - 1):
        raise NotImplementedError(
            f"d_state {N}: the kernel takes a power of two from 4 to "
            f"{MAX_STATE}")
    if Q > MAX_CHUNK:
        raise NotImplementedError(
            f"chunk {Q}: the kernel takes at most {MAX_CHUNK}")
    if dtype not in DEFAULT_P_BLOCK:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {dtype}")
    for pb in sorted(P_BLOCKS, reverse=True):
        if pb <= DEFAULT_P_BLOCK[dtype] and P % pb == 0:
            return pb
    raise NotImplementedError(
        f"head_dim {P}: the kernel takes a multiple of {P_BLOCKS[0]}")


def _launch(x, dt, Bm, Cm, A, Q: int, state0, pb: int):
    """One call of the kernel of x's type at ``pb`` columns of p a block
    (float32) or a pass (bf16)."""
    f32 = dict(dtype=torch.float32, device=x.device)
    for name, t, dtype in (("dt", dt, torch.float32),
                           ("Bm", Bm, x.dtype), ("Cm", Cm, x.dtype),
                           ("A", A, torch.float32),
                           ("state0", state0, torch.float32)):
        if t is not None and (t.device != x.device or t.dtype != dtype):
            raise ValueError(f"{name} is {t.dtype} on {t.device}; need "
                             f"{dtype} on {x.device}")
    if x.dtype not in DEFAULT_P_BLOCK:
        raise TypeError(f"ssd_scan takes float32 or bfloat16, got {x.dtype}")
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    # the bf16 kernels read 16 bytes at a time
    x, dt, Bm, Cm, A = (build.aligned16(t) for t in (x, dt, Bm, Cm, A))
    if state0 is not None:
        state0 = build.aligned16(state0)
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, P, N), **f32)
    lib = build.load("ssd_scan.cu")
    s0 = state0.data_ptr() if state0 is not None else None
    args = (pb, Bb, S, H, P, N, Q, x.data_ptr(), dt.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(), s0, y.data_ptr(),
            state.data_ptr())
    if x.dtype == torch.bfloat16:
        cum = torch.empty((Bb, S, H), **f32)
        inputs = torch.empty((Bb, S // Q, H, P, N), **f32)
        planes = torch.empty((Bb, S // Q, H, 2, P, N), dtype=torch.bfloat16,
                             device=x.device)
        code = lib.ssd_scan_bf16_run(*args, cum.data_ptr(), inputs.data_ptr(),
                                     planes.data_ptr(),
                                     build.stream_of(x.device))
    else:
        code = lib.ssd_scan_f32_run(*args, build.stream_of(x.device))
    build.check(lib, code, "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, state
