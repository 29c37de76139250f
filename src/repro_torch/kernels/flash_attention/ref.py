"""Plain PyTorch versions of the flash_attention kernel.

``attention_ref`` is a copy of the reference's oracle
(``repro/kernels/flash_attention/ref.py``): dense masked softmax on
(BH, S, d), the probabilities cast to v's dtype before the PV product.

``flash_attention_plain`` computes what the CUDA kernel
(``csrc/flash_attention.cu``) computes, on the model's layouts (q
(B, Sq, H, d), k/v (B, Sk, KH, d)): q/k/v in float32, the masked
softmax with -1e30 at masked entries, p float32 in the PV product, the
output cast to q's dtype. It takes heads in slices (``_by_heads``).

``flash_attention_hilo_plain`` repeats the bf16 kernel's PV arithmetic
(``csrc/flash_attention.cu``): the tensor cores multiply bf16 operands,
so the float32 p = exp(s - m) goes in as two bf16 terms, p_hi + p_lo
(``split_bf16``), each product exact and summed in float32, l summed
from the float32 p. With ``lo=False`` it drops p_lo (p rounded to bf16
once, as FlashAttention does), which leaves the one-ulp agreement with
``flash_attention_plain`` on rows with few visible keys.

``flash_attention_tf32x3_plain`` repeats the float32 kernel's products
(``csrc/flash_attention.cu``, 3xTF32 on the tensor cores): q k^T and
p v, each by ``mm_3xtf32``, with p = exp(s - max) unnormalised and the
output divided by max(sum p, 1e-30) afterwards. ``flash_attention_plain``
stays the CPU route; this one holds the kernel to its own arithmetic.

``flash_attention_bwd_plain`` computes what the backward kernel
(``csrc/flash_attention_bwd.cu``) computes: its three passes (each row's
log-sum-exp and D = sum_j P dP; dK and dV summed in float32 over query
tiles and the group's heads; dQ), the same exp (base 2 with the scale
times log2(e) folded in for bfloat16, base e for float32), and the
operands as the kernel feeds them to the tensor cores: in bfloat16, P
rounded to bfloat16 and dS split hi/lo; in float32, every operand of the
five products split into two TF32 terms (``split_tf32``) and each product
taken as three (3xTF32).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
BWD_BLOCK = 64  # query rows a tile, as the backward kernel's prep and dq
# bfloat16 P lying within FLIP_NEAR P of a rounding midpoint may round the
# other way in the kernel: its float32 P (tensor-core sums of exact bf16
# products, ex2.approx) and the plain version's agree to ~2^-18 relative
# at danube's scores (|s| up to ~45 in float32), 2^-14 leaves 16x
FLIP_NEAR = 2.0 ** -14


def mask(Sq: int, Sk: int, causal: bool, window: Optional[int], device):
    """(Sq, Sk) bool: key k is visible from query q (absolute positions
    from 0 on both sides)."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= qpos - kpos < window
    return ok


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: Optional[int] = None):
    """q: (BH, Sq, d); k/v: (BH, Sk, d)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = s.masked_fill(~mask(q.shape[1], k.shape[1], causal, window,
                            q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)


def _by_heads(q, k, v, causal, window, max_scores, attend):
    """(B, Sq, H, d) in q's dtype from ``attend(qh, kh, vh, ok)`` -> (h,
    Sq, d) float32, called on each batch row's heads in slices of h heads
    (qh (h, Sq, d), kh and vh (h, Sk, d) float32, kv head h // (H / KH)
    of each; ok the (Sq, Sk) mask), so that the (h, Sq, Sk) float32
    scores stay under ``max_scores`` entries (the serving shape's whole
    score tensor would be 34 GB)."""
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    ok = mask(Sq, Sk, causal, window, q.device)
    out = torch.empty_like(q)
    step = max(1, min(H, max_scores // (Sq * Sk)))
    for b in range(B):
        for h0 in range(0, H, step):
            heads = torch.arange(h0, min(H, h0 + step), device=q.device)
            qh = q[b][:, heads].float().transpose(0, 1)         # (h, Sq, d)
            kh = k[b][:, heads // G].float().transpose(0, 1)    # (h, Sk, d)
            vh = v[b][:, heads // G].float().transpose(0, 1)
            out[b][:, heads] = attend(qh, kh, vh, ok).transpose(0, 1).to(
                q.dtype)
    return out


def flash_attention_plain(q, k, v, scale: float, causal: bool = True,
                          window: Optional[int] = None,
                          max_scores: int = 1 << 28):
    """q (B, Sq, H, d); k/v (B, Sk, KH, d), KH dividing H -> (B, Sq, H, d)
    in q's dtype."""
    def attend(qh, kh, vh, ok):
        s = torch.matmul(qh, kh.transpose(1, 2)) * scale
        p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
        return torch.matmul(p, vh)

    return _by_heads(q, k, v, causal, window, max_scores, attend)


def split_bf16(p):
    """(p_hi, p_lo), both bfloat16: p_hi = bf16(p), p_lo = bf16(p - p_hi);
    p_hi + p_lo is p to a relative 2^-16 (p_hi alone to 2^-8)."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def flash_attention_hilo_plain(q, k, v, scale: float, causal: bool = True,
                               window: Optional[int] = None,
                               lo: bool = True):
    """q (B, Sq, H, d); k/v (B, Sk, KH, d) bfloat16 -> (B, Sq, H, d)
    bfloat16: s = q k^T * scale in float32, masked -1e30, e = exp(s - max),
    out = (e_hi v + e_lo v) / max(sum e, 1e-30) with each product in
    float32 (without e_lo when ``lo`` is False). Small shapes: the whole
    (B, H, Sq, Sk) score tensor is formed."""
    G = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)                               # (B,H,Sq,d)
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (k, v))
    s = torch.matmul(qf, kf.transpose(2, 3)) * scale
    ok = mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = s.masked_fill(~ok, NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    hi, lo_ = split_bf16(e)
    acc = torch.matmul(hi.float(), vf)
    if lo:
        acc = acc + torch.matmul(lo_.float(), vf)
    out = acc / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def split_tf32(x):
    """(big, small), float32 tensors whose values TF32 holds: big =
    tf32(x), small = tf32(x - big), tf32 the rounding of ``cvt.rna.tf32.f32``
    on the int32 view of a finite x, (bits + 0x1000) & ~0x1fff: the
    mantissa to 10 bits, to nearest, ties away from zero. big + small is x
    to 2^-22 |x|; big carries it to 2^-11."""
    def tf32(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1fff).view(torch.float32)

    big = tf32(x.float())
    return big, tf32(x.float() - big)


def mm_3xtf32(a, b):
    """a @ b in float32 as the float32 backward kernel forms it: each
    operand split by ``split_tf32`` and the product the sum of small.big,
    big.small and big.big (every product of TF32 values exact in float32,
    the sums float32; small.small dropped)."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return torch.matmul(as_, bb) + torch.matmul(ab, bs) + torch.matmul(ab, bb)


def flash_attention_tf32x3_plain(q, k, v, scale: float, causal: bool = True,
                                 window: Optional[int] = None,
                                 max_scores: int = 1 << 28):
    """q (B, Sq, H, d); k/v (B, Sk, KH, d), KH dividing H -> (B, Sq, H, d)
    in q's dtype: s = q k^T * scale by ``mm_3xtf32``, masked -1e30, e =
    exp(s - max), out = (e v by ``mm_3xtf32``) / max(sum e, 1e-30), all
    float32."""
    def attend(qh, kh, vh, ok):
        s = mm_3xtf32(qh, kh.transpose(1, 2)) * scale
        s = s.masked_fill(~ok, NEG_INF)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return mm_3xtf32(e, vh) / e.sum(dim=-1, keepdim=True).clamp_min(1e-30)

    return _by_heads(q, k, v, causal, window, max_scores, attend)


def _flip_ulps(p):
    """The bfloat16 spacing at each float32 ``p`` that lies within
    FLIP_NEAR p of a midpoint between two bfloat16 values (where a P that
    differs in its last float32 bits may round to the other one), else 0."""
    _, e = torch.frexp(p)
    ulp = torch.ldexp(torch.ones_like(p), e - 8)
    r = (p - p.to(torch.bfloat16).float()).abs()
    return torch.where((r - ulp / 2).abs() <= FLIP_NEAR * p, ulp, 0.0)


def flash_attention_bwd_plain(q, k, v, do, scale: float, causal: bool = True,
                              window: Optional[int] = None, *,
                              flips: bool = False):
    """(dq, dk, dv) of attention against ``do``: q, do (B, Sq, H, d); k, v
    (B, Sk, KH, d), KH dividing H; each in its input's dtype. With
    ``flips``, also dV's allowance for P's bf16 roundings (``bwd_excess``):
    sum_q u_qk |dO_q|, u_qk the bf16 spacing at P_qk where it lies near a
    rounding midpoint (``_flip_ulps``), float32 (B, Sk, KH, d), zero in
    float32.

    Pass 1 (``flash_bwd_prep``): x = q.k times scale log2(e) (bfloat16) or
    scale (float32), masked; lse = max x + log(sum exp(x - max x)) and
    D = sum_j exp(x - max x) dP / sum exp(x - max x), dP = dO.v, all
    float32; a row with no visible key gets lse = inf, D = 0. Passes 2
    and 3 (``flash_bwd_dkdv``, ``flash_bwd_dq``): P = exp(x - lse) where
    visible, else 0; dS = P (dP - D); dV = sum P^T dO and dK = scale sum
    dS^T q, accumulated in float32 per BWD_BLOCK query rows and over the
    group's H / KH heads; dQ = scale dS k. In bfloat16 P enters its
    product rounded to bfloat16, and dS as bf16(dS) + bf16(dS - bf16(dS))
    (``split_bf16``), two products summed. In float32 each of the five
    products is ``mm_3xtf32``."""
    B, Sq, H, d = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    f32 = torch.float32
    tc = q.dtype == torch.bfloat16
    exp, log = (torch.exp2, torch.log2) if tc else (torch.exp, torch.log)
    mul = torch.tensor(scale, dtype=f32)
    if tc:
        mul = mul * torch.tensor(LOG2E, dtype=f32)
    mul = mul.to(q.device)

    def mm(a, b):
        """a b: bfloat16 values multiplied in float32 (exact products),
        float32 by 3xTF32"""
        return torch.matmul(a, b) if tc else mm_3xtf32(a, b)

    def split_mm(ds, y):
        """ds y, ds entering as bf16(ds) + bf16(ds - bf16(ds)) in bf16"""
        if not tc:
            return mm(ds, y)
        hi, lo = split_bf16(ds)
        return torch.matmul(hi.float(), y) + torch.matmul(lo.float(), y)

    qf, dof = (t.float().transpose(1, 2) for t in (q, do))   # (B, H, Sq, d)
    kf, vf = (t.float().repeat_interleave(G, dim=2).transpose(1, 2)
              for t in (k, v))                                # (B, H, Sk, d)
    ok = mask(Sq, Sk, causal, window, q.device)
    rows = [slice(q0, min(q0 + BWD_BLOCK, Sq))
            for q0 in range(0, Sq, BWD_BLOCK)]

    def scores(sl):
        x = mm(qf[:, :, sl], kf.transpose(2, 3)) * mul
        return x, mm(dof[:, :, sl], vf.transpose(2, 3))

    lse = torch.empty((B, H, Sq), dtype=f32, device=q.device)
    dsum = torch.empty_like(lse)
    for sl in rows:
        x, dp = scores(sl)
        x = x.masked_fill(~ok[sl], NEG_INF)
        m = x.amax(-1, keepdim=True)
        e = torch.where(ok[sl], exp(x - m), 0.0)
        l = e.sum(-1)
        seen = l > 0
        lse[:, :, sl] = torch.where(seen, m.squeeze(-1) + log(l), math.inf)
        dsum[:, :, sl] = torch.where(seen, (e * dp).sum(-1) / l, 0.0)

    def p_ds(sl):
        x, dp = scores(sl)
        p = torch.where(ok[sl], exp(x - lse[:, :, sl, None]), 0.0)
        return p, p * (dp - dsum[:, :, sl, None])

    dk = torch.zeros((B, KH, Sk, d), dtype=f32, device=q.device)
    dv, dv_flip = torch.zeros_like(dk), torch.zeros_like(dk)
    for sl in rows:
        p, ds = p_ds(sl)
        if tc and flips:
            dv_flip += torch.matmul(_flip_ulps(p).transpose(2, 3),
                                    dof[:, :, sl].abs()).view(
                B, KH, G, Sk, d).sum(2)
        if tc:
            p = p.to(torch.bfloat16).float()
        dv += mm(p.transpose(2, 3), dof[:, :, sl]).view(
            B, KH, G, Sk, d).sum(2)
        dk += split_mm(ds.transpose(2, 3), qf[:, :, sl]).view(
            B, KH, G, Sk, d).sum(2)
    dq = torch.empty((B, H, Sq, d), dtype=f32, device=q.device)
    for sl in rows:
        dq[:, :, sl] = split_mm(p_ds(sl)[1], kf)
    scale32 = torch.tensor(scale, dtype=f32).to(q.device)

    def out(t, like):
        return t.transpose(1, 2).to(like.dtype).contiguous()

    grads = out(dq * scale32, q), out(dk * scale32, k), out(dv, v)
    return (*grads, dv_flip.transpose(1, 2).contiguous()) if flips else grads


def bwd_excess(got, want, flip=0.0) -> float:
    """How far a gradient of the backward kernel lies from its plain
    version, as a share of what the two may differ by: <= 1 passes.

    float32: |got - want| / (2e-5 + 1e-4 |want|), the same arithmetic
    summed in another order. bfloat16: |got - want| / (two bf16 ulps of
    max(|got|, |want|) + ``flip``), magnitudes under 2^-6 of want's
    largest judged there: one ulp for the final rounding of float32 sums
    taken in another order, one to spare. ``flip`` is dV's allowance from
    ``flash_attention_bwd_plain(..., flips=True)``: P enters dV rounded to
    bf16 once, and where the kernel's P and the plain version's straddle a
    rounding midpoint, the rounding falls the other way and moves dV by
    the bf16 spacing at P times |dO|. dS enters dQ and dK split hi/lo, so
    no such flip reaches them (``flip`` 0)."""
    a, b = got.float(), want.float()
    if want.dtype == torch.float32:
        return float(((a - b).abs() / (2e-5 + 1e-4 * b.abs())).max())
    floor = max(float(b.abs().max()), 1e-30) * 2 ** -6
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()).clamp_min(floor))
    return float(((a - b).abs() / (2 * torch.ldexp(torch.ones_like(a), e - 8)
                                   + flip)).max())
