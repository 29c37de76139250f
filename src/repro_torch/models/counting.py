"""Analytic parameter and MODEL_FLOPS accounting (no materialization).

A copy of ``repro/models/counting.py`` over the port's ``layer_plan`` and
``ssm_dims``: the same numbers, float for float.

MODEL_FLOPS counts only *algorithmically necessary* work:
  matmul params: 6·N·D train / 2·N·D forward (N = active params)
  attention:     causal-necessary score+value FLOPs (S·S/2, or S·W for
                 sliding-window), not the full-mask S² a dense route
                 executes; the flash kernel skips the masked tiles.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.blocks import layer_plan
from repro_torch.models.ssm import ssm_dims


def _act_mults(act: str) -> int:
    return 3 if act == "swiglu" else 2


def count_params(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active) parameter counts."""
    d = cfg.d_model
    total = cfg.vocab * d  # embed
    if not cfg.tie_embeddings:
        total += d * cfg.vocab  # head
    if cfg.frontend:
        total += d * d
    active = total
    for mixer, ffn in layer_plan(cfg):
        t = a = 2 * d  # norms
        if mixer == "attn":
            at = cfg.attention
            qkv = d * at.n_heads * at.head_dim + 2 * d * at.n_kv_heads * at.head_dim
            out = at.n_heads * at.head_dim * d
            t += qkv + out
            a += qkv + out
        else:
            s = cfg.ssm
            d_inner, H, Pd = ssm_dims(s, d)
            N = s.d_state
            w = (2 * d * d_inner + 2 * d * N + d * H
                 + s.conv_width * (d_inner + 2 * N)
                 + 3 * H + H * Pd + d_inner * d)
            t += w
            a += w
        if ffn == "mlp":
            m = _act_mults(cfg.act) * d * cfg.d_ff
            t += m
            a += m
        elif ffn == "moe":
            e = cfg.moe
            per = _act_mults(cfg.act) * d * e.d_ff_expert
            t += e.num_experts * per + d * e.num_experts
            a += e.top_k * per + d * e.num_experts
        total += t
        active += a
    return float(total), float(active)


def attention_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    """Causal-necessary attention score+value FLOPs for the whole stack."""
    a = cfg.attention
    if a is None:
        return 0.0
    plan = layer_plan(cfg)
    n_attn = sum(1 for m, _ in plan if m == "attn")
    n_attn *= cfg.n_layers // len(plan)
    hd_total = a.n_heads * a.head_dim
    if kind == "decode":
        # one token against the cache (window-bounded for SWA)
        eff = min(S, a.sliding_window) if a.sliding_window else S
        per_layer = 4.0 * B * eff * hd_total
        mult = 1.0
    else:
        eff = min(S, a.sliding_window) if a.sliding_window else S
        if a.causal and not a.sliding_window:
            eff = S / 2.0
        per_layer = 4.0 * B * S * eff * hd_total
        mult = 3.0 if kind == "train" else 1.0
    return per_layer * n_attn * mult


def ssm_flops(cfg: ModelConfig, B: int, S: int, kind: str) -> float:
    """SSD-layer FLOPs: O(1)-state recurrence for decode; for scan modes
    the chunked dual form's intra-chunk matmuls (the algorithm's real
    cost: ~2Q(N + H·P) extra per token at chunk length Q)."""
    if cfg.ssm is None:
        return 0.0
    plan = layer_plan(cfg)
    n_ssm = sum(1 for m, _ in plan if m == "ssm") * (cfg.n_layers // len(plan))
    d_inner, H, Pd = ssm_dims(cfg.ssm, cfg.d_model)
    N = cfg.ssm.d_state
    if kind == "decode":
        per_tok = 6.0 * H * Pd * N
        return per_tok * n_ssm * B
    Q = min(cfg.ssm.chunk, S)
    # per token: state path (6 H P N) + intra-chunk dual matmuls
    # (G: 2QN shared; y_intra: 2Q H P; decay/exp small)
    per_tok = 6.0 * H * Pd * N + 2.0 * Q * N + 2.0 * Q * H * Pd
    mult = 3.0 if kind == "train" else 1.0
    return per_tok * n_ssm * B * S * mult


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Total useful FLOPs for one step of this cell (all devices)."""
    total, active = count_params(cfg)
    B, S = shape.global_batch, shape.seq_len
    head = cfg.d_model * cfg.vocab  # unembedding params
    if shape.kind == "train":
        base = 6.0 * active * B * S
    elif shape.kind == "prefill":
        base = 2.0 * active * B * S
        if not cfg.is_encoder_only:
            # decoder prefill emits logits for the LAST position only
            base -= 2.0 * head * B * (S - 1)
    else:
        base = 2.0 * active * B  # one token
    return (base + attention_flops(cfg, B, S, shape.kind)
            + ssm_flops(cfg, B, S, shape.kind))
