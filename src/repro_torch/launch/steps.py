"""The steps the launchers and an LM server drive: the train step
(microbatched gradient accumulation, clipping, optional int8
error-feedback compression, AdamW), the serve steps (prefill, decode)
and the encode step of the encoder-only archs."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.compression import ef_compress
from repro_torch.models import blocks
from repro_torch.models import layers as L
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.sharding.rules import ShardingContext


def make_train_step(cfg: ModelConfig, run: RunConfig,
                    ctx: Optional[ShardingContext] = None,
                    compute_dtype=torch.bfloat16):
    """Returns train_step(state, batch) -> (state, metrics).

    ``batch`` leaves (tensors or numpy arrays) are shaped (microbatches,
    mb_batch, ...): tokens and labels (taken as int64) and, for the
    frontend archs, embeds (kept in their dtype). Each microbatch takes
    the gradient of the loss through the ``compute_dtype`` view of the
    master weights; the gradients add
    up in float32, so activation (and logits) memory is bounded by one
    microbatch. Then the reference's order: divide by the microbatch
    count, clip by the global norm, ``ef_compress`` under
    ``run.grad_compression``, the warmup-cosine lr, AdamW (in place on
    the state's tensors). ``metrics``: loss, grad_norm, lr, ce, aux as
    0-d float32 tensors."""

    def train_step(state: adamw.TrainState, batch: Dict[str, Any]):
        dev = adamw.tree_leaves(state.master)[0].device
        batch = {k: _batch_leaf(k, v, dev) for k, v in batch.items()}
        params_c = adamw.tree_map(lambda p: p.detach().requires_grad_(),
                                  adamw.compute_params(state, compute_dtype))
        leaves = adamw.tree_leaves(params_c)
        gsum = adamw.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32, device=dev),
            params_c)
        lsum = torch.zeros((), dtype=torch.float32, device=dev)
        ce, aux = [], []
        nmb = run.microbatches
        for i in range(nmb):
            mb = {k: v[i] for k, v in batch.items()}
            loss, metrics = model_lib.loss_fn(params_c, cfg, mb, ctx,
                                              run.remat)
            # a leaf the batch never reaches (an audio arch's token table)
            # has no gradient: its sum stays 0, as jax.grad gives zeros
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for acc, g in zip(adamw.tree_leaves(gsum), grads):
                if g is not None:
                    acc.add_(g.to(torch.float32))
            del grads
            lsum = lsum + loss.detach().to(torch.float32)
            ce.append(metrics["ce"].detach())
            aux.append(metrics["aux"].detach())
        del params_c, leaves
        for g in adamw.tree_leaves(gsum):
            g.div_(nmb)
        grads, gnorm = adamw.clip_by_global_norm(gsum, run.grad_clip)
        if run.grad_compression:
            grads, new_ef = ef_compress(grads, state.ef)
            state = state._replace(ef=new_ef)
        lr = adamw.warmup_cosine(state.step, run.learning_rate,
                                 run.warmup_steps, run.total_steps)
        state = adamw.adamw_update(state, grads, lr,
                                   weight_decay=run.weight_decay)
        out_metrics = {
            "loss": lsum / nmb,
            "grad_norm": gnorm,
            "lr": lr,
            "ce": torch.stack(ce).mean(),
            "aux": torch.stack(aux).mean(),
        }
        return state, out_metrics

    return train_step


def _batch_leaf(key: str, v, dev) -> torch.Tensor:
    t = torch.as_tensor(v, device=dev)
    return t if key == "embeds" else t.long()


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


def make_encode_step(cfg: ModelConfig, ctx: Optional[ShardingContext] = None):
    """Encoder-only archs (hubert): encode_step(params, batch) -> logits
    (B, S, vocab) of every position, no cache. The stack runs in train
    mode without recompute, under ``no_grad``."""
    ctx = ctx or ShardingContext()

    @torch.no_grad()
    def encode_step(params, batch):
        x, positions = model_lib._embed_inputs(params, cfg, batch, "prefill")
        x, _, _ = blocks.stack_apply(params["groups"], x, cfg, "train", ctx,
                                     None, positions, None, remat="none")
        x = L.apply_norm(params["final_norm"], x, cfg.norm)
        return model_lib._head(params, cfg, x)

    return encode_step
