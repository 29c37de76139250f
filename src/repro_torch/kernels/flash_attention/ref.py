"""Plain PyTorch versions of the flash_attention kernel.

``attention_ref`` is a copy of the reference's oracle
(``repro/kernels/flash_attention/ref.py``): dense masked softmax on
(BH, S, d), the probabilities cast to v's dtype before the PV product.

``flash_attention_plain`` computes what the CUDA kernel
(``csrc/flash_attention.cu``) computes, on the model's layouts (q
(B, Sq, H, d), k/v (B, Sk, KH, d)): q/k/v in float32, the masked
softmax with -1e30 at masked entries, p float32 in the PV product, the
output cast to q's dtype. It takes heads in slices so the (heads, Sq,
Sk) float32 scores stay under ``max_scores`` entries (the serving shape's
whole score tensor would be 34 GB).

``flash_attention_hilo_plain`` repeats the bf16 kernel's PV arithmetic
(``csrc/flash_attention.cu``): the tensor cores multiply bf16 operands,
so the float32 p = exp(s - m) goes in as two bf16 terms, p_hi + p_lo
(``split_bf16``), each product exact and summed in float32, l summed
from the float32 p. With ``lo=False`` it drops p_lo (p rounded to bf16
once, as FlashAttention does), which leaves the one-ulp agreement with
``flash_attention_plain`` on rows with few visible keys.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


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


def flash_attention_plain(q, k, v, scale: float, causal: bool = True,
                          window: Optional[int] = None,
                          max_scores: int = 1 << 28):
    """q (B, Sq, H, d); k/v (B, Sk, KH, d), KH dividing H -> (B, Sq, H, d)
    in q's dtype."""
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
            s = torch.matmul(qh, kh.transpose(1, 2)) * scale
            p = torch.softmax(s.masked_fill(~ok, NEG_INF), dim=-1)
            out[b][:, heads] = torch.matmul(p, vh).transpose(0, 1).to(
                q.dtype)
    return out


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
