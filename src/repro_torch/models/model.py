"""The full model: embed -> layer stack -> head, with the train,
prefill and decode entry points and the CE loss.

Batch dict convention (the reference's):
  tokens    (B, S_text) int64/int32   — train, prefill; absent for audio
  embeds    (B, T_front, d)           — the vision / audio frontend stubs
  labels    (B, S) int64/int32        — train
  token     (B, 1) int64/int32        — decode
  cache_pos int                       — decode: the new token's position

On a mesh (``ctx`` from ``sharding.rules.make_context``) the parameters
are this rank's blocks of ``param_spec``'s layout and the batch is this
rank's block of rows (``batch_sharded``; the whole batch where it does not
divide the data axes; ``launch/steps.py`` cuts it). The logits are the
full vocab on every rank of a data group, vocab-parallel (then gathered
over ``model``) only where the vocab divides. The loss is the mean over
the global batch: local sums, summed over the data axes.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import collectives as coll
from repro_torch.models import blocks, frontends
from repro_torch.models import layers as L
from repro_torch.sharding import rules
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
    if cfg.frontend:
        p["frontend"] = frontends.frontend_init(generator, cfg, device,
                                                dtype)
    return p


def param_spec(cfg: ModelConfig) -> Dict:
    """The parameter tree's logical axes: each leaf's tuple of names, the
    stacked "layers" axis (never sharded) first in ``groups``."""
    max_pos = MAX_LEARNED_POS if needs_learned_pos(cfg) else 0
    gspec = rules.map_specs(lambda axes: ("layers",) + axes,
                            blocks.group_spec(cfg))
    p: Dict[str, Any] = {"embed": L.embed_spec(max_pos), "groups": gspec,
                         "final_norm": L._norm_spec(cfg.norm)}
    if not cfg.tie_embeddings:
        p["head"] = ("embed", "vocab")
    if cfg.frontend:
        p["frontend"] = frontends.frontend_spec(cfg)
    return p


@functools.lru_cache(maxsize=None)
def param_specs(cfg: ModelConfig, ctx: ShardingContext) -> Dict:
    """The spec tree of the parameters on ``ctx``'s mesh."""
    return rules.tree_specs(param_spec(cfg), abstract_params(cfg), ctx)


def abstract_params(cfg: ModelConfig, dtype=None) -> Dict:
    """The parameter tree's shapes and dtypes as ``meta`` tensors: nothing
    is allocated or drawn (the reference's ``jax.eval_shape`` tree)."""
    return init_params(cfg, torch.Generator(), device="meta", dtype=dtype)


def _embed_inputs(params, cfg: ModelConfig, batch: Dict, mode: str,
                  pos_offset: int = 0, ctx: Optional[ShardingContext] = None):
    """Returns (x (B, S, d), positions (S,)): the frontend's projected
    ``embeds`` then the embedded tokens, concatenated on the sequence
    axis (either may be absent). On a mesh ``params["embed"]`` has its
    FSDP dims gathered (``_gathered_embed``)."""
    parts = []
    if "embeds" in batch:
        parts.append(frontends.apply_frontend(params["frontend"],
                                              batch["embeds"], cfg))
    key = "token" if mode == "decode" else "tokens"
    if key in batch:
        parts.append(L.apply_embed(params["embed"], batch[key], ctx=ctx,
                                   vocab=cfg.vocab))
    x = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device) + pos_offset
    if "positions" in params["embed"]:
        table = params["embed"]["positions"]
        x = x + table[positions.clamp(0, table.shape[0] - 1)]
    return x, positions


def _head(params, cfg: ModelConfig, x, ctx: Optional[ShardingContext] = None):
    """Logits (B, S, vocab); on a mesh that splits the vocab, this rank's
    columns then gathered over ``model``."""
    w = params["embed"]["tokens"].T if cfg.tie_embeddings else params["head"]
    logits = torch.einsum("bsd,dv->bsv", x, w)
    if L.model_split(cfg.vocab, ctx):
        logits = coll.all_gather(logits, ctx.mesh, ctx.model_axis, dim=-1)
    return logits


def _gathered_embed(params, cfg: ModelConfig, ctx: ShardingContext):
    """``params`` with the embedding's, an untied head's and the
    frontend's FSDP dims gathered over the data axes."""
    if ctx.mesh is None:
        return params
    axes, specs = param_spec(cfg), param_specs(cfg, ctx)
    out = dict(params)
    for name in ("embed", "head", "frontend"):
        if name in params:
            out[name] = rules.fsdp_gather(params[name], axes[name],
                                          specs[name], ctx)
    return out


def forward(params, cfg: ModelConfig, batch: Dict, mode: str,
            ctx: Optional[ShardingContext] = None, caches=None,
            remat: str = "selective"):
    """Returns (logits, caches). mode: "train" (logits (B, S, vocab) of
    every position, no caches; the layer groups recompute as ``remat``
    says), "prefill" (logits (B, 1, vocab) of the last position, caches
    built) or "decode" (S == 1; ``caches`` written in place and
    returned). The MoE aux loss, the reference's third value, is left
    out here; ``loss_fn`` reads it."""
    logits, new_caches, _ = _forward(params, cfg, batch, mode, ctx, caches,
                                     remat)
    return logits, new_caches


def _forward(params, cfg: ModelConfig, batch: Dict, mode: str,
             ctx: Optional[ShardingContext], caches, remat: str,
             batch_sharded: bool = True):
    """``forward`` with the reference's three values: (logits, caches,
    aux)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    ctx = ctx or ShardingContext()
    params = _gathered_embed(params, cfg, ctx)
    cache_pos = batch.get("cache_pos")
    pos_offset = int(cache_pos) if mode == "decode" else 0
    x, positions = _embed_inputs(params, cfg, batch, mode, pos_offset, ctx)
    x, new_caches, aux = blocks.stack_apply(params["groups"], x, cfg, mode,
                                            ctx, caches, positions,
                                            cache_pos, remat=remat,
                                            batch_sharded=batch_sharded)
    if mode != "train":
        x = x[:, -1:]  # only the last position feeds sampling
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    return _head(params, cfg, x, ctx), new_caches, aux


def loss_fn(params, cfg: ModelConfig, batch: Dict,
            ctx: Optional[ShardingContext] = None, remat: str = "selective",
            aux_weight: float = 1e-2, z_weight: float = 1e-4):
    """Mean CE over all positions + the MoE aux loss + the z-loss, in
    float32 (the reference's weights). Returns (total, {"ce", "aux",
    "z"}); aux is 0 without MoE layers. On a mesh ``batch`` is this
    rank's block of rows, and every rank returns the global values."""
    logits, _, aux = _forward(params, cfg, batch, "train", ctx, None, remat)
    logits = logits.float()
    labels = batch["labels"].long()
    lse = torch.logsumexp(logits, dim=-1)                       # (B, S)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    if ctx is None or ctx.mesh is None:
        ce = torch.mean(lse - gold)
        zl = torch.mean(lse * lse)
    else:
        # the global batch's mean: this rank's sums over its rows, summed
        # over the data axes
        n = lse.numel() * ctx.data_size
        ce = coll.all_reduce(torch.sum(lse - gold), ctx.mesh,
                             ctx.data_axes) / n
        zl = coll.all_reduce(torch.sum(lse * lse), ctx.mesh,
                             ctx.data_axes) / n
    total = ce + aux_weight * aux + z_weight * zl
    return total, {"ce": ce, "aux": aux, "z": zl}
