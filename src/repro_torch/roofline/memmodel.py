"""Analytic per-device HBM-traffic model (a fused lower bound).

A copy of ``repro/roofline/memmodel.py`` over the port's ``layer_plan``,
``ssm_dims`` and ``counting``: the same numbers, float for float. Every
tensor that must cross HBM when the elementwise chains are fused, once
per crossing:

  train:   weights in (per microbatch) + grad accum r/w + optimizer
           state r/w + saved activations (remat policy) w+r + logits
           + attention-score passes (a dense route materializes S x S)
  prefill: weights + per-layer activations + score passes + cache write
  decode:  weights (active experts only) + full cache read + tiny rest
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models.blocks import layer_plan
from repro_torch.models.counting import count_params
from repro_torch.models.ssm import ssm_dims


def _attn_score_bytes(cfg: ModelConfig, B: int, S: int, heads_loc: float,
                      kind: str, attn_kernel: str = "xla") -> float:
    """(B,H,S,S) score-tensor HBM passes of a dense (non-flash) route.
    3 fwd passes (write scores, softmax r/w, read probs) + 2x on bwd.
    Banded SWA reduces S_k to the window+chunk. The flash kernel keeps
    scores on chip: only O(S) LSE stats cross HBM (negligible)."""
    a = cfg.attention
    if a is None or kind == "decode" or attn_kernel == "flash":
        return 0.0
    plan = layer_plan(cfg)
    n_attn = sum(1 for m, _ in plan if m == "attn") * (cfg.n_layers // len(plan))
    s_k = min(S, (a.sliding_window + 1024)) if a.sliding_window else S
    passes = 3.0 if kind == "prefill" else 9.0  # fwd / fwd+bwd+remat
    elem = 4.0  # fp32 scores
    return n_attn * passes * B * heads_loc * S * s_k * elem


def _saved_act_bytes_per_token(cfg: ModelConfig, remat: str) -> float:
    """bf16 bytes saved per token per layer under the remat policy."""
    d = cfg.d_model
    plan = layer_plan(cfg)
    per_layer = []
    for mixer, ffn in plan:
        if remat == "full":
            per_layer.append(d)  # only the layer boundary
            continue
        saved = 2 * d  # layer input + mixer output at the residual
        if mixer == "attn":
            a = cfg.attention
            saved += a.n_heads * a.head_dim + 2 * a.n_kv_heads * a.head_dim
        else:
            d_inner, H, Pd = ssm_dims(cfg.ssm, cfg.d_model)
            saved += 2 * d_inner + 2 * cfg.ssm.d_state + H
        if ffn == "mlp":
            saved += (2 if cfg.act == "swiglu" else 1) * cfg.d_ff + d
        elif ffn == "moe":
            e = cfg.moe
            saved += e.top_k * ((2 if cfg.act == "swiglu" else 1)
                                * e.d_ff_expert) / 4.0 + d  # capacity-bounded
        per_layer.append(saved)
    mean = sum(per_layer) / len(per_layer)
    return mean * 2.0  # bf16


def analytic_bytes_dev(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                       n_chips: int, model_size: int = 16) -> float:
    """Per-device HBM bytes per step (fused lower bound)."""
    B, S = shape.global_batch, shape.seq_len
    total, active = count_params(cfg)
    p_loc = total / n_chips
    data_size = n_chips // model_size
    tokens_dev = B * S / max(data_size, 1) if B >= data_size else B * S
    heads_loc = (cfg.attention.n_heads / model_size
                 if cfg.attention else 0.0)
    b_loc = max(B / data_size, 1.0)

    if shape.kind == "train":
        mb = run.microbatches
        weights = mb * p_loc * 2.0          # bf16 stream per microbatch
        grads = mb * p_loc * 8.0            # fp32 accum r/w per microbatch
        optim = p_loc * 28.0                # master/m/v r/w + grad read
        acts = (tokens_dev * cfg.n_layers
                * _saved_act_bytes_per_token(cfg, run.remat) * 2.0)  # w+r
        logits = tokens_dev * (cfg.vocab / model_size) * 6.0  # bf16 w + f32 r
        scores = _attn_score_bytes(cfg, b_loc * mb, S, heads_loc, "train",
                                   run.attn_kernel)
        return weights + grads + optim + acts + logits + scores
    if shape.kind == "prefill":
        weights = p_loc * 2.0
        acts = (tokens_dev * cfg.n_layers
                * _saved_act_bytes_per_token(cfg, "none"))
        scores = _attn_score_bytes(cfg, b_loc, S, heads_loc, "prefill",
                                   run.attn_kernel)
        cache = _cache_bytes_dev(cfg, shape, n_chips)
        return weights + acts + scores + cache
    # decode: weights (only routed experts) + cache read + write slot
    frac_active = active / total
    touched = p_loc * max(frac_active, min(1.0, B * (cfg.moe.top_k
                          if cfg.moe else 1) / (cfg.moe.num_experts
                          if cfg.moe else 1)))
    cache = _cache_bytes_dev(cfg, shape, n_chips)
    logits = B / max(data_size, 1) * (cfg.vocab / model_size) * 6.0
    return touched * 2.0 + cache + logits


def _cache_bytes_dev(cfg: ModelConfig, shape: ShapeConfig,
                     n_chips: int) -> float:
    """Full decode-cache bytes per device (read once per step)."""
    B, S = shape.global_batch, shape.seq_len
    plan = layer_plan(cfg)
    reps = cfg.n_layers // len(plan)
    total = 0.0
    for mixer, _ in plan:
        if mixer == "attn":
            a = cfg.attention
            T = min(S, a.sliding_window) if a.sliding_window else S
            total += 2 * B * T * a.n_kv_heads * a.head_dim * 2.0
        else:
            d_inner, H, Pd = ssm_dims(cfg.ssm, cfg.d_model)
            total += B * H * Pd * cfg.ssm.d_state * 4.0
    return total * reps / n_chips
