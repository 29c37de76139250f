"""Input stand-ins and sharding specs for every (arch x shape) cell, as
``repro/launch/specs.py``: ``batch_specs`` and ``cache_specs`` give
``meta`` tensors (shapes and dtypes, nothing allocated); the
``*_shardings`` give spec trees (``sharding/rules.py``: a tuple per leaf,
the reference's ``PartitionSpec`` entries), whose blocks
``rules.shard_tree`` cuts for this rank.

A batch that does not divide the data axes is replicated over them
(long-context decode runs B = 1); its KV caches then split the sequence
over the data axes and ``model`` together.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import blocks
from repro_torch.models import model as model_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache, ssm_dims
from repro_torch.optim import adamw
from repro_torch.sharding.rules import ShardingContext, entry


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_len(cfg: ModelConfig, S: int) -> int:
    if cfg.frontend == "audio":
        return S
    return cfg.frontend_positions if cfg.frontend else 0


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                compute_dtype=torch.bfloat16) -> Dict[str, Any]:
    """The step's inputs as ``meta`` tensors: train (microbatches,
    mb_batch, ...), prefill (B, ...), decode one token and its position."""
    B, S = shape.global_batch, shape.seq_len
    nf = _frontend_len(cfg, S)
    st = S - nf
    if shape.kind == "train":
        mb = run.microbatches
        if B % mb:
            raise ValueError(f"batch {B} does not divide into {mb} "
                             "microbatches")
        bm = B // mb
        batch = {}
        if nf:
            batch["embeds"] = _meta((mb, bm, nf, cfg.d_model), compute_dtype)
        if st > 0:
            batch["tokens"] = _meta((mb, bm, st), torch.int32)
        batch["labels"] = _meta((mb, bm, S), torch.int32)
        return batch
    if shape.kind == "prefill":
        batch = {}
        if nf:
            batch["embeds"] = _meta((B, nf, cfg.d_model), compute_dtype)
        if st > 0:
            batch["tokens"] = _meta((B, st), torch.int32)
        return batch
    return {"token": _meta((B, 1), torch.int32),
            "cache_pos": _meta((), torch.int32)}


def _batch_axes(B: int, ctx: ShardingContext):
    return entry(ctx.data_axes) if B % max(ctx.data_size, 1) == 0 else None


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, run: RunConfig,
                    ctx: ShardingContext) -> Dict[str, Any]:
    """The batch's specs: rows over the data axes where they divide."""
    specs = batch_specs(cfg, shape, run)
    if ctx.mesh is None:
        return {k: () for k in specs}
    b = _batch_axes(shape.global_batch, ctx)
    if shape.kind == "train":
        return {k: (None, b) + (None,) * (v.dim() - 2)
                for k, v in specs.items()}
    if shape.kind == "prefill":
        return {k: (b,) + (None,) * (v.dim() - 1) for k, v in specs.items()}
    return {"token": (b, None), "cache_pos": ()}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype=torch.bfloat16) -> Dict:
    """The decode caches of the cell as ``meta`` tensors (cache length =
    seq_len)."""
    return blocks.init_cache(cfg, shape.global_batch, shape.seq_len, "meta",
                             dtype)


def cache_shardings(cfg: ModelConfig, shape: ShapeConfig,
                    ctx: ShardingContext) -> Dict:
    """KV caches (G, B, T, K, hd): the batch over the data axes where it
    divides and the sequence over ``model`` (the flash-decode merge), or
    the sequence over the data axes and ``model`` for a batch that does
    not divide. SSM states: the batch over the data axes, the heads over
    ``model`` where they divide."""
    out = {}
    for j, (mix, _) in enumerate(blocks.group_plan(cfg)):
        if ctx.mesh is None:
            n = 2 if mix == "attn" else 4
            out[f"layer{j}"] = (KVCache if mix == "attn" else SSMCache)(
                *([()] * n))
            continue
        b = _batch_axes(shape.global_batch, ctx)
        seq = entry((ctx.model_axis,) if b is not None
                    else ctx.data_axes + (ctx.model_axis,))
        if mix == "attn":
            kv = (None, b, seq, None, None)
            out[f"layer{j}"] = KVCache(kv, kv)
        else:
            _, H, _ = ssm_dims(cfg.ssm, cfg.d_model)
            h = ctx.model_axis if H % ctx.model_size == 0 else None
            out[f"layer{j}"] = SSMCache(state=(None, b, h, None, None),
                                        conv_x=(None, b, None, h, None),
                                        conv_B=(None, b, None, None),
                                        conv_C=(None, b, None, None))
    return out


def param_shardings(cfg: ModelConfig, ctx: ShardingContext) -> Dict:
    return model_lib.param_specs(cfg, ctx)


def state_shardings(cfg: ModelConfig, run: RunConfig,
                    ctx: ShardingContext) -> adamw.TrainState:
    """TrainState specs: master, m, v and ef split like the parameters."""
    psh = param_shardings(cfg, ctx)
    return adamw.TrainState(step=(), master=psh, m=psh, v=psh,
                            ef=psh if run.grad_compression else None)
