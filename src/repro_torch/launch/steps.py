"""The steps the launchers and an LM server drive: the train step
(microbatched gradient accumulation, clipping, optional int8
error-feedback compression, AdamW), the serve steps (prefill, decode)
and the encode step of the encoder-only archs.

Under a context with a mesh every rank calls the step (SPMD). The steps
take the global batch and cut this rank's rows (``launch/specs.py``'s
``batch_shardings``); parameters, train state and caches are this rank's
blocks (``rules.shard_tree`` over ``specs.param_shardings``,
``state_shardings``; the prefill makes the cache blocks). The prefill
and decode steps return the global logits on every rank. The train step
runs each microbatch of this rank's rows, seeds the loss with one over
the ranks that compute it, sums each gradient over the mesh axes its
leaf is replicated on (FSDP leaves come back reduce-scattered from the
gather's backward), clips by the norm of the full logical gradients,
takes ``ef_compress``'s scale from each full tensor's max, and updates
the local blocks with AdamW. Its metrics are the global ones.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.compression import ef_compress
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.sharding import rules
from repro_torch.sharding.rules import ShardingContext


def _on_mesh(ctx: Optional[ShardingContext]) -> bool:
    return ctx is not None and ctx.mesh is not None


def _rows(t: torch.Tensor, ctx: ShardingContext, dim: int) -> torch.Tensor:
    """This rank's block of rows (``dim``) of a global batch leaf."""
    blk = t.shape[dim] // ctx.data_size
    i = coll.index(ctx.mesh, ctx.data_axes)
    return t.narrow(dim, i * blk, blk)


def _grad_buckets(specs, ctx: ShardingContext):
    """The parameter leaves grouped by the mesh axes each is replicated
    on, in ``adamw.tree_leaves`` order: {axes: [leaf index, ...]}."""
    out: Dict[tuple, list] = {}
    flat = [rules.spec_axes(s) for s in _spec_leaves(specs)]
    for i, axes in enumerate(flat):
        rep = tuple(a for a in ctx.mesh.mesh_dim_names if a not in axes)
        out.setdefault(rep, []).append(i)
    return out


def _spec_leaves(specs):
    """The specs of a parameter spec tree in ``adamw.tree_leaves`` order
    (sorted keys)."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in _spec_leaves(specs[k])]
    return [specs]


def _sum_replicated(grads, specs, ctx: ShardingContext) -> None:
    """Each gradient summed in place over the axes its leaf is replicated
    on: one sum a group of leaves that share those axes."""
    leaves = adamw.tree_leaves(grads)
    for axes, idx in _grad_buckets(specs, ctx).items():
        if not axes or coll.size(ctx.mesh, axes) == 1:
            continue
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        flat = coll.all_reduce(flat, ctx.mesh, axes)
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            leaves[i].copy_(part.view_as(leaves[i]))


def mesh_global_norm(grads, specs, ctx: ShardingContext) -> torch.Tensor:
    """The global norm of the full logical gradients from this rank's
    blocks: each leaf's sum of squares summed once over the axes it is
    split on (a replicated leaf counted once)."""
    leaves = adamw.tree_leaves(grads)
    dev = leaves[0].device
    by_axes: Dict[tuple, torch.Tensor] = {}
    for g, spec in zip(leaves, _spec_leaves(specs)):
        axes = coll.mesh_order(ctx.mesh, rules.spec_axes(spec))
        sq = torch.sum(torch.square(g.to(torch.float32)))
        by_axes[axes] = by_axes.get(axes, torch.zeros((), device=dev)) + sq
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for axes, sq in by_axes.items():
        total = total + (coll.all_reduce(sq, ctx.mesh, axes) if axes else sq)
    return torch.sqrt(total)


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
    0-d float32 tensors.

    With a mesh the state is this rank's blocks and ``batch`` the global
    batch, whose rows must divide the data axes (the module's
    docstring)."""
    mesh = _on_mesh(ctx)
    if mesh:
        specs = model_lib.param_specs(cfg, ctx)

    def train_step(state: adamw.TrainState, batch: Dict[str, Any]):
        dev = adamw.tree_leaves(state.master)[0].device
        batch = {k: _batch_leaf(k, v, dev) for k, v in batch.items()}
        seed = None
        if mesh:
            rows = next(iter(batch.values())).shape[1]
            if rows % ctx.data_size:
                raise ValueError(f"a microbatch of {rows} rows does not "
                                 f"divide over {ctx.data_size} data ranks")
            batch = {k: _rows(v, ctx, 1) for k, v in batch.items()}
            # every rank holds the loss: its gradient parts sum to one
            seed = torch.full((), 1.0 / ctx.world, device=dev)
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
            grads = torch.autograd.grad(loss, leaves, grad_outputs=seed,
                                        allow_unused=True)
            for acc, g in zip(adamw.tree_leaves(gsum), grads):
                if g is not None:
                    acc.add_(g.to(torch.float32))
            del grads
            lsum = lsum + loss.detach().to(torch.float32)
            ce.append(metrics["ce"].detach())
            aux.append(metrics["aux"].detach())
        del params_c, leaves
        if mesh:
            _sum_replicated(gsum, specs, ctx)
        for g in adamw.tree_leaves(gsum):
            g.div_(nmb)
        grads, gnorm = adamw.clip_by_global_norm(
            gsum, run.grad_clip,
            norm=mesh_global_norm(gsum, specs, ctx) if mesh else None)
        if run.grad_compression:
            grads, new_ef = ef_compress(grads, state.ef, ctx,
                                        specs if mesh else None)
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


def _serve(cfg: ModelConfig, ctx: Optional[ShardingContext], mode: str):
    """The forward of a serve step (``mode`` "train" is the encode step:
    every position, no recompute): on a mesh this rank's rows of the
    batch in, the global logits out (gathered over the data axes)."""
    mesh = _on_mesh(ctx)

    @torch.no_grad()
    def step(params, batch, caches=None):
        if not mesh:
            return model_lib._forward(params, cfg, batch, mode, ctx, caches,
                                      "none")[:2]
        rows = next(v for k, v in batch.items() if k != "cache_pos")
        split = rows.shape[0] % ctx.data_size == 0
        local = {k: (_rows(v, ctx, 0) if split and k != "cache_pos" else v)
                 for k, v in batch.items()}
        logits, caches, _ = model_lib._forward(params, cfg, local, mode, ctx,
                                               caches, "none", split)
        if split:
            logits = coll.all_gather(logits, ctx.mesh, ctx.data_axes, dim=0)
        return logits, caches

    return step


def make_prefill_step(cfg: ModelConfig, ctx: Optional[ShardingContext] = None):
    """prefill_step(params, batch) -> (logits (B, 1, vocab), caches)."""
    step = _serve(cfg, ctx, "prefill")

    def prefill_step(params, batch):
        return step(params, batch)

    return prefill_step


def make_decode_step(cfg: ModelConfig, ctx: Optional[ShardingContext] = None):
    """decode_step(params, batch, caches) -> (logits, caches): the new
    token's KV is written into ``caches`` in place."""
    return _serve(cfg, ctx, "decode")


def make_encode_step(cfg: ModelConfig, ctx: Optional[ShardingContext] = None):
    """Encoder-only archs (hubert): encode_step(params, batch) -> logits
    (B, S, vocab) of every position, no cache: the stack in train mode
    without recompute, under ``no_grad``; on a mesh as the serve steps
    (this rank's rows in, the global logits out)."""
    step = _serve(cfg, ctx, "train")

    def encode_step(params, batch):
        return step(params, batch)[0]

    return encode_step
