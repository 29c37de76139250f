"""The full model: embed -> layer stack -> head, with the train,
prefill and decode entry points and the CE loss.

Batch dict convention (the reference's):
  tokens    (B, S) int64/int32        — train, prefill
  labels    (B, S) int64/int32        — train
  token     (B, 1) int64/int32        — decode
  cache_pos int                       — decode: the new token's position
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.sharding.rules import ShardingContext

MAX_LEARNED_POS = 32768
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def needs_learned_pos(cfg: ModelConfig) -> bool:
    a = cfg.attention
    return bool(a and not a.use_rope and not cfg.family == "hybrid")


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", dtype=None) -> Dict:
    """Random parameters in the reference's tree and layouts, drawn from
    ``generator`` (other numbers than ``jax.random`` gives for the same
    seed; carry a reference tree over with
    ``repro_torch.convert.lm_params_from_numpy``). ``dtype`` defaults to
    ``cfg.dtype``; ``device="meta"`` makes the shapes only."""
    if torch.device(device).type != "meta":
        device = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    max_pos = MAX_LEARNED_POS if needs_learned_pos(cfg) else 0
    p: Dict[str, Any] = {
        "embed": L.embed_init(generator, cfg.vocab, cfg.d_model, device,
                              dtype, max_pos),
        "groups": blocks.stack_init(generator, cfg, device, dtype),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device, dtype),
    }
    if not cfg.tie_embeddings:
        p["head"] = L.randn(generator, (cfg.d_model, cfg.vocab),
                            1.0 / math.sqrt(cfg.d_model), device, dtype)
    return p


def _embed_inputs(params, cfg: ModelConfig, batch: Dict, mode: str,
                  pos_offset: int = 0):
    """Returns (x (B, S, d), positions (S,))."""
    tokens = batch["token" if mode == "decode" else "tokens"]
    x = L.apply_embed(params["embed"], tokens)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + pos_offset
    if "positions" in params["embed"]:
        table = params["embed"]["positions"]
        x = x + table[positions.clamp(0, table.shape[0] - 1)]
    return x, positions


def _head(params, cfg: ModelConfig, x):
    w = params["embed"]["tokens"].T if cfg.tie_embeddings else params["head"]
    return torch.einsum("bsd,dv->bsv", x, w)


def forward(params, cfg: ModelConfig, batch: Dict, mode: str,
            ctx: Optional[ShardingContext] = None, caches=None,
            remat: str = "selective"):
    """Returns (logits, caches). mode: "train" (logits (B, S, vocab) of
    every position, no caches; the layer groups recompute as ``remat``
    says), "prefill" (logits (B, 1, vocab) of the last position, caches
    built) or "decode" (S == 1; ``caches`` written in place and
    returned)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    ctx = ctx or ShardingContext()
    cache_pos = batch.get("cache_pos")
    pos_offset = int(cache_pos) if mode == "decode" else 0
    x, positions = _embed_inputs(params, cfg, batch, mode, pos_offset)
    x, new_caches = blocks.stack_apply(params["groups"], x, cfg, mode, ctx,
                                       caches, positions, cache_pos,
                                       remat=remat)
    if mode != "train":
        x = x[:, -1:]  # only the last position feeds sampling
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _head(params, cfg, x), new_caches


def loss_fn(params, cfg: ModelConfig, batch: Dict,
            ctx: Optional[ShardingContext] = None, remat: str = "selective",
            aux_weight: float = 1e-2, z_weight: float = 1e-4):
    """Mean CE over all positions + the MoE aux loss + the z-loss, in
    float32 (the reference's weights). MoE layers are not served, so aux
    is 0. Returns (total, {"ce", "aux", "z"})."""
    logits, _ = forward(params, cfg, batch, "train", ctx, remat=remat)
    logits = logits.float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, S)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    ce = torch.mean(lse - gold)
    zl = torch.mean(lse * lse)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    total = ce + aux_weight * aux + z_weight * zl
    return total, {"ce": ce, "aux": aux, "z": zl}
