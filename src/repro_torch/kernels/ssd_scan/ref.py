"""Plain PyTorch versions of the ssd_scan kernel.

``ssd_scan_plain`` computes what the CUDA kernel (``csrc/ssd_scan.cu``)
computes, on the model's layouts (x (B, S, H, P), dt (B, S, H), B/C
(B, S, N)), chunk by chunk as ``repro/kernels/ssd_scan/kernel.py:_kernel``
does: everything in float32, ``y`` rounded once to x's dtype, the running
state carried in float32 and returned. The decay exp(cum_i - cum_j) is
taken only where i >= j (masked to exp(-inf) = 0 above the diagonal,
where it could overflow). cum is the float32 rounding of the prefix sum
accumulated in float64, as the kernel accumulates it.

``ssd_scan_hilo_plain`` is the same scan rounded as the bf16 tensor-core
kernels round: every float32 operand of a bf16 product enters as hi + lo
(hi = bf16(v), lo = bf16(v - hi)): the weights W = (C B^T) o decay o dt,
the state that C reads, and x o w_end of the state update (the kernels
take x o w_end, not B o w_end, the smaller of the two, so B enters as
it is).

``ssd_naive`` is a copy of the reference's sequential oracle
(``repro/kernels/ssd_scan/ref.py:ssd_naive``): one step at a time, in
float32.
"""
from __future__ import annotations

import torch


def chunk_len(S: int, chunk: int) -> int:
    """Q = min(chunk, S), which must divide S (``models/ssm.py:
    ssd_chunked``'s contract)."""
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {Q}")
    return Q


def hilo(t):
    """t carried by a bf16 pair: bf16(t) + bf16(t - bf16(t)), in
    float32 (exact: 16 significant bits)."""
    hi = t.to(torch.bfloat16).float()
    return hi + (t - hi).to(torch.bfloat16).float()


def ssd_scan_plain(x, dt, Bm, Cm, A, chunk: int, state0=None):
    """x: (B, S, H, P); dt: (B, S, H) (post-softplus); Bm/Cm: (B, S, N);
    A: (H,) negative; state0: (B, H, P, N) or None.

    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N)
    float32)."""
    return _scan(x, dt, Bm, Cm, A, chunk, state0, False)


def ssd_scan_hilo_plain(x, dt, Bm, Cm, A, chunk: int, state0=None):
    """``ssd_scan_plain`` with the bf16 kernels' hi + lo operands (see
    the module docstring); the same arguments and results."""
    return _scan(x, dt, Bm, Cm, A, chunk, state0, True)


def _scan(x, dt, Bm, Cm, A, chunk: int, state0, split: bool):
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk_len(S, chunk)
    A = A.float()
    if state0 is None:
        state = torch.zeros((Bb, H, P, N), dtype=torch.float32,
                            device=x.device)
    else:
        state = state0.float()
    y = torch.empty_like(x)
    below = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                  device=x.device))[None, :, :, None]
    for s0 in range(0, S, Q):
        sl = slice(s0, s0 + Q)
        xc = x[:, sl].float()                                 # (B, Q, H, P)
        dtc = dt[:, sl].float()                               # (B, Q, H)
        Bc, Cc = Bm[:, sl].float(), Cm[:, sl].float()         # (B, Q, N)
        cum = torch.cumsum((dtc * A).double(), dim=1).float()  # (B, Q, H)
        y_inter = (torch.einsum("bqn,bhpn->bqhp", Cc,
                                hilo(state) if split else state)
                   * torch.exp(cum)[..., None])
        G = torch.einsum("bin,bjn->bij", Cc, Bc)               # (B, Q, Q)
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B, i, j, H)
        decay = torch.exp(diff.masked_fill(~below, float("-inf")))
        W = G[..., None] * decay * dtc[:, None, :, :]
        if split:
            W = hilo(W)
        y_intra = torch.einsum("bijh,bjhp->bihp", W, xc)
        y[:, sl] = (y_inter + y_intra).to(x.dtype)
        w_end = torch.exp(cum[:, -1:, :] - cum) * dtc          # (B, Q, H)
        if split:
            S_add = torch.einsum("bqhp,bqn->bhpn",
                                 hilo(xc * w_end[..., None]), Bc)
        else:
            S_add = torch.einsum("bqhp,bqhn->bhpn", xc,
                                 Bc[:, :, None, :] * w_end[..., None])
        state = state * torch.exp(cum[:, -1])[..., None, None] + S_add
    return y, state


def ssd_naive(x, dt, Bm, Cm, A, state0=None):
    """Sequential scan, one step at a time (float32).

    x: (B, S, H, P); dt: (B, S, H); Bm/Cm: (B, S, N); A: (H,) negative.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N))."""
    Bb, S, H, P = x.shape
    N = Bm.shape[-1]
    state = (torch.zeros((Bb, H, P, N), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t].float() * A)                    # (B, H)
        xbar = dt[:, t].float()[..., None] * x[:, t].float()   # (B, H, P)
        state = (state * a[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xbar, Bm[:, t].float()))
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, dim=1).to(x.dtype), state
