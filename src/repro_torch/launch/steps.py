"""The serve steps, prefill and decode: the functions an LM server
drives (the train and encode steps wait for their slices)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.sharding.rules import ShardingContext


def make_prefill_step(cfg: ModelConfig, ctx: Optional[ShardingContext] = None):
    """prefill_step(params, batch) -> (logits (B, 1, vocab), caches)."""

    @torch.no_grad()
    def prefill_step(params, batch):
        return model_lib.forward(params, cfg, batch, "prefill", ctx)

    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: Optional[ShardingContext] = None):
    """decode_step(params, batch, caches) -> (logits, caches): the new
    token's KV is written into ``caches`` in place."""

    @torch.no_grad()
    def decode_step(params, batch, caches):
        return model_lib.forward(params, cfg, batch, "decode", ctx, caches)

    return decode_step
