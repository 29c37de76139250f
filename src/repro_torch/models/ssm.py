"""Mamba-2 (SSD, state-space duality) block: the chunked scan for
prefill, the O(1)-state step for decode.

A port of ``repro/models/ssm.py`` on its layouts (``wz``/``wx``
(d, H, P), ``wB``/``wC`` (d, N), ``wdt`` (d, H), ``w_out`` (H, P, d);
activations (B, S, H, P)). Prefill runs the SSD scan through the
ssd_scan kernel (``kernels/ssd_scan/ops.py``), which returns the final
state with ``y``. Training runs ``ssd_chunked``, the reference's pure
function (also the kernel's float32 yardstick), under autograd, as the
reference does; the kernel stays forward only. Decode is the
reference's one-step recurrence in torch ops (the reference has no
kernel for it) and writes the cache in place.

On a mesh whose model axis splits the H heads (``ssm_spec``'s "ssm"
axis), ``wz``, ``wx``, ``conv_x``, ``norm_scale`` and ``w_out`` are this
rank's block of heads and the ``ssm_noshard`` leaves (``wdt``, ``A_log``,
``D``, ``dt_bias``) whole: each rank takes its heads of them. ``wB``,
``wC`` and their convolutions are replicated, so every model rank
computes the same B and C. The scan, the per-head norm and the cache run
on the local heads (the state's heads are the rank's block of
``cache_shardings``); ``w_out`` is row-parallel, and one sum over
``model`` (the parts in float32, rounded once) completes the output.
Where H does not divide the model axis every rank computes every head.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.distributed import collectives as coll
from repro_torch.kernels.ssd_scan import ops
from repro_torch.models.layers import model_split, randn


class SSMCache(NamedTuple):
    state: torch.Tensor   # (B, H, P, N) running SSM state, float32
    conv_x: torch.Tensor  # (B, w-1, H, P) conv tail for x
    conv_B: torch.Tensor  # (B, w-1, N)
    conv_C: torch.Tensor  # (B, w-1, N)


def ssm_dims(cfg: SSMConfig, d: int) -> Tuple[int, int, int]:
    d_inner = cfg.expand * d
    H = d_inner // cfg.head_dim
    return d_inner, H, cfg.head_dim


def ssm_init(gen, cfg: SSMConfig, d: int, device, dtype) -> Dict:
    """The reference's leaves and shapes; ``A_log``, ``D`` and ``dt_bias``
    stay float32 in any tree, as in the reference."""
    d_inner, H, Pd = ssm_dims(cfg, d)
    N, w = cfg.d_state, cfg.conv_width
    s = 1.0 / math.sqrt(d)
    f32 = dict(device=device, dtype=torch.float32)
    if torch.device(device).type == "meta":
        dt = torch.empty((H,), **f32)
    else:
        u = torch.rand((H,), generator=gen, device=gen.device,
                       dtype=torch.float32).to(device)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * u)
    return {
        "wz": randn(gen, (d, H, Pd), s, device, dtype),
        "wx": randn(gen, (d, H, Pd), s, device, dtype),
        "wB": randn(gen, (d, N), s, device, dtype),
        "wC": randn(gen, (d, N), s, device, dtype),
        "wdt": randn(gen, (d, H), s, device, dtype),
        "conv_x": randn(gen, (w, H, Pd), 0.1, device, dtype),
        "conv_B": randn(gen, (w, N), 0.1, device, dtype),
        "conv_C": randn(gen, (w, N), 0.1, device, dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_scale": torch.ones((H, Pd), device=device, dtype=dtype),
        "w_out": randn(gen, (H, Pd, d), 1.0 / math.sqrt(d_inner), device,
                       dtype),
    }


def ssm_spec() -> Dict:
    return {"wz": ("embed", "ssm", None),
            "wx": ("embed", "ssm", None),
            "wB": ("embed", None),
            "wC": ("embed", None),
            "wdt": ("embed", "ssm_noshard"),
            "conv_x": (None, "ssm", None),
            "conv_B": (None, None),
            "conv_C": (None, None),
            "A_log": ("ssm_noshard",),
            "D": ("ssm_noshard",),
            "dt_bias": ("ssm_noshard",),
            "norm_scale": ("ssm", None),
            "w_out": ("ssm", None, "embed")}


def _causal_conv(x, w, tail: Optional[torch.Tensor] = None):
    """Depthwise causal conv via shifted adds (width is small), in x's
    dtype: not ``conv1d``, which goes through cuDNN (TF32 by default).

    x: (B, S, ...); w: (width, ...) broadcasting over trailing dims.
    tail: (B, width-1, ...) previous context (decode)."""
    width = w.shape[0]
    if tail is None:
        pad = torch.zeros((x.shape[0], width - 1) + tuple(x.shape[2:]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + S] * w[i]
    return out


def _per_head_norm(y, scale, eps: float = 1e-5):
    """Grouped RMSNorm over the head dim P, in float32."""
    yf = y.float()
    var = (yf * yf).mean(dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def ssd_chunked(x, dt, Bm, Cm, A, chunk: int, state0=None):
    """Chunked SSD scan, the reference's pure function.

    x: (B, S, H, P) fp-any; dt: (B, S, H) fp32 (post-softplus);
    Bm/Cm: (B, S, N); A: (H,) fp32 negative; state0: (B, H, P, N) or None.
    Returns (y (B, S, H, P), final state (B, H, P, N))."""
    Bb, S, H, Pd = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    state = (torch.zeros((Bb, H, Pd, N), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for s0 in range(0, S, Q):
        sl = slice(s0, s0 + Q)
        x_c, dt_c, B_c, C_c = x[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        l = dt_c * A                                      # (B, Q, H)
        cum = torch.cumsum(l, dim=1)
        ydec = torch.exp(cum)
        y_inter = (torch.einsum("bqn,bhpn->bqhp", C_c.to(state.dtype), state)
                   * ydec[..., None])
        G = torch.einsum("bin,bjn->bij", C_c.float(), B_c.float())
        # exp(cum_i - cum_j) above the diagonal (j > i) grows with the
        # chunk and overflows at chunk 256; the where below drops it, but
        # its gradient there would be 0 * inf = NaN. The exponent is
        # masked first, so those entries are exp(-inf) = 0: the same
        # forward bits, a finite gradient (the reference's ssd_chunked
        # takes the NaN)
        lower = mask[None, :, :, None]
        D_ij = torch.exp(torch.where(
            lower, cum[:, :, None, :] - cum[:, None, :, :], -math.inf))
        W = torch.where(lower, G[..., None] * D_ij,
                        torch.zeros((), device=x.device))
        W = W * dt_c[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", W.to(x_c.dtype), x_c)
        w_end = torch.exp(cum[:, -1:, :] - cum) * dt_c
        S_add = torch.einsum("bqh,bqhp,bqn->bhpn", w_end.float(),
                             x_c.float(), B_c.float())
        state = state * torch.exp(cum[:, -1, :])[..., None, None] + S_add
        ys.append(y_inter.to(x_c.dtype) + y_intra)
    return torch.cat(ys, dim=1), state


def apply_ssm(p: Dict, x, cfg: SSMConfig, mode: str,
              cache: Optional[SSMCache] = None, ctx=None):
    """x: (B, S, d). mode: train | prefill | decode (S = 1; ``cache``
    written in place and returned). Returns (out (B, S, d), cache; None
    in train mode). On a mesh (``ctx``) ``p`` and ``cache`` hold this
    rank's heads (the module's docstring)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    B, S, d = x.shape
    w = cfg.conv_width
    split = model_split(ssm_dims(cfg, d)[1], ctx)
    wdt, dt_bias, A_log, D = p["wdt"], p["dt_bias"], p["A_log"], p["D"]
    if split:
        Hl = p["wz"].shape[1]
        h0 = coll.index(ctx.mesh, ctx.model_axis) * Hl
        wdt = wdt[:, h0:h0 + Hl]
        dt_bias, A_log, D = (t[h0:h0 + Hl] for t in (dt_bias, A_log, D))
    z = torch.einsum("bsd,dhp->bshp", x, p["wz"])
    xs = torch.einsum("bsd,dhp->bshp", x, p["wx"])
    Bm = x @ p["wB"]                                      # (B, S, N)
    Cm = x @ p["wC"]
    dt_raw = torch.einsum("bsd,dh->bsh", x, wdt).float()
    dt = F.softplus(dt_raw + dt_bias)
    A = -torch.exp(A_log)                                 # (H,) negative

    if mode == "decode":
        assert cache is not None and S == 1
        xs_c = F.silu(_causal_conv(xs, p["conv_x"], cache.conv_x))
        Bm_c = F.silu(_causal_conv(Bm, p["conv_B"], cache.conv_B))
        Cm_c = F.silu(_causal_conv(Cm, p["conv_C"], cache.conv_C))
        a = torch.exp(dt[:, 0] * A)                       # (B, H)
        xbar = dt[:, 0, :, None] * xs_c[:, 0].float()     # (B, H, P)
        S_new = (cache.state * a[..., None, None]
                 + torch.einsum("bhp,bn->bhpn", xbar, Bm_c[:, 0].float()))
        y = torch.einsum("bn,bhpn->bhp", Cm_c[:, 0].float(), S_new)
        y = y + D[:, None] * xs_c[:, 0].float()
        y = y[:, None].to(x.dtype)                        # (B, 1, H, P)
        # in place, as the KV caches: the tails shift by one (torch.cat
        # builds the new tail before the overlapping copy)
        cache.state.copy_(S_new)
        for tail, new in ((cache.conv_x, xs), (cache.conv_B, Bm),
                          (cache.conv_C, Cm)):
            tail.copy_(torch.cat([tail[:, 1:], new.to(tail.dtype)], dim=1))
        new_cache = cache
    else:
        xs_c = F.silu(_causal_conv(xs, p["conv_x"]))
        Bm_c = F.silu(_causal_conv(Bm, p["conv_B"]))
        Cm_c = F.silu(_causal_conv(Cm, p["conv_C"]))
        scan = ssd_chunked if mode == "train" else ops.ssd_scan
        y, S_fin = scan(xs_c, dt, Bm_c, Cm_c, A, cfg.chunk)
        y = y + (D[:, None] * xs_c.float()).to(y.dtype)
        new_cache = None
        if mode == "prefill":
            # the tails are copies: a view would keep the whole (B, S, ...)
            # projection alive
            new_cache = SSMCache(state=S_fin,
                                 conv_x=xs[:, S - (w - 1):].clone(),
                                 conv_B=Bm[:, S - (w - 1):].clone(),
                                 conv_C=Cm[:, S - (w - 1):].clone())
    y = _per_head_norm(y * F.silu(z.float()).to(y.dtype), p["norm_scale"])
    if split:
        out = coll.all_reduce(torch.einsum(
            "bshp,hpd->bsd", y.to(x.dtype).float(), p["w_out"].float()),
            ctx.mesh, ctx.model_axis)
        return out.to(x.dtype), new_cache
    out = torch.einsum("bshp,hpd->bsd", y.to(x.dtype), p["w_out"])
    return out, new_cache
