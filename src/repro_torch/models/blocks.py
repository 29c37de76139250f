"""Block wiring: per-layer (mixer, ffn) composition, the layer stack and
its caches.

Parameters and caches keep the reference's grouped layout: every leaf
of ``groups`` (and of the stacked caches) carries a leading axis over
the n_layers / period groups, so a reference tree carries over as a
copy. The stack is a plain Python loop over the groups (PyTorch runs
eagerly; there is no scan to trace). Attention and SSM (Mamba-2)
mixers with MLP or MoE layers are served and trained; an MoE layer runs
at capacity ``"factor"`` in train mode and ``"full"`` (no drops) in
prefill and decode, and its load-balance aux loss adds up over the
stack.

Training recomputes as the reference's ``remat`` says, a layer group at
a time: ``"none"`` keeps every activation, ``"full"`` wraps each group
in ``torch.utils.checkpoint`` (non-reentrant) and keeps only its input,
``"selective"`` does the same but keeps the outputs of the 2-D matrix
products (``aten.mm``: the projections against the weights), the
counterpart of ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``.

On a mesh each layer's parameters are this rank's blocks; the layer
gathers its FSDP dims first (``rules.fsdp_gather``, inside the recompute
under remat; the SSM mixer's ``embed`` dims too), except the MoE
experts', which ``apply_moe`` gathers. Attention and MoE take whether the
batch is split over the data axes; an SSM layer runs on whatever rows it
is given, so its cache holds the whole batch where it does not divide.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.sharding import rules


def layer_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    """[(mixer, ffn)] per layer: mixer in {attn, ssm}; ffn in {mlp, moe,
    none}."""
    kinds = cfg.layer_kinds()
    moe_mask = cfg.moe_layer_mask()
    plan = []
    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            ffn = "none"  # mamba2: the SSD block is the whole layer
        elif moe_mask[i]:
            ffn = "moe"
        else:
            ffn = "mlp" if cfg.d_ff else "none"
        plan.append((kinds[i], ffn))
    return plan


def group_plan(cfg: ModelConfig) -> List[Tuple[str, str]]:
    p = cfg.interleave_period()
    plan = layer_plan(cfg)
    assert cfg.n_layers % p == 0, (cfg.name, cfg.n_layers, p)
    for g in range(cfg.n_layers // p):
        assert plan[g * p:(g + 1) * p] == plan[:p], "stack not periodic"
    return plan[:p]


def _layer_init(gen, cfg: ModelConfig, mixer: str, ffn: str, device,
                dtype) -> Dict:
    p: Dict[str, Any] = {
        "norm1": L.norm_init(cfg.d_model, cfg.norm, device, dtype)}
    if mixer == "attn":
        p["attn"] = attn_lib.attn_init(gen, cfg.attention, cfg.d_model,
                                       device, dtype)
    else:
        p["ssm"] = ssm_lib.ssm_init(gen, cfg.ssm, cfg.d_model, device, dtype)
    if ffn != "none":
        p["norm2"] = L.norm_init(cfg.d_model, cfg.norm, device, dtype)
    if ffn == "mlp":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, device,
                              dtype)
    elif ffn == "moe":
        p["moe"] = moe_lib.moe_init(gen, cfg.moe, cfg.d_model, cfg.act,
                                    device, dtype)
    return p


def _layer_spec(cfg: ModelConfig, mixer: str, ffn: str) -> Dict:
    p: Dict[str, Any] = {"norm1": L._norm_spec(cfg.norm)}
    if mixer == "attn":
        p["attn"] = attn_lib.attn_spec(cfg.attention)
    else:
        p["ssm"] = ssm_lib.ssm_spec()
    if ffn != "none":
        p["norm2"] = L._norm_spec(cfg.norm)
        p["mlp" if ffn == "mlp" else "moe"] = (
            L.mlp_spec(cfg.act) if ffn == "mlp" else moe_lib.moe_spec(cfg.act))
    return p


def group_spec(cfg: ModelConfig) -> Dict:
    """The logical axes of one layer group (``param_spec`` prepends the
    stacked "layers" axis)."""
    return {f"layer{j}": _layer_spec(cfg, mixer, ffn)
            for j, (mixer, ffn) in enumerate(group_plan(cfg))}


@functools.lru_cache(maxsize=None)
def _layer_specs(cfg: ModelConfig, ctx) -> Tuple[Dict, Dict]:
    """(logical axes, spec) of one group's leaves on ``ctx``'s mesh, from
    the full shapes (``meta`` tensors)."""
    axes = group_spec(cfg)
    full = {f"layer{j}": _layer_init(None, cfg, mixer, ffn, "meta",
                                     torch.float32)
            for j, (mixer, ffn) in enumerate(group_plan(cfg))}
    return axes, rules.tree_specs(axes, full, ctx)


def _gather_layer(pg: Dict, cfg: ModelConfig, ctx) -> Dict:
    """A group's leaves with the FSDP dims gathered, but the experts'."""
    if ctx.mesh is None:
        return pg
    axes, specs = _layer_specs(cfg, ctx)
    out = {}
    for name, layer in pg.items():
        moe = layer.get("moe")
        rest = {k: v for k, v in layer.items() if k != "moe"}
        out[name] = rules.fsdp_gather(
            rest, {k: axes[name][k] for k in rest},
            {k: specs[name][k] for k in rest}, ctx)
        if moe is not None:
            out[name]["moe"] = moe
    return out


_CACHES = (KVCache, SSMCache)


def _stack(trees: List[Any]) -> Any:
    """Stack matching trees (dicts / caches of tensors) on a new axis 0."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    if isinstance(first, _CACHES):
        return type(first)(*(torch.stack(ts) for ts in zip(*trees)))
    return {k: _stack([t[k] for t in trees]) for k in first}


def _unbind(tree: Any, n: int) -> List[Any]:
    """The n groups of a stacked tree (dicts / caches of tensors) at once,
    as views (writes go to the stack). Under autograd a leaf is one
    ``unbind``, whose backward stacks the groups' gradients in one pass
    (a per-group index would zero-fill the whole stack per group)."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    if isinstance(tree, _CACHES):
        return [type(tree)(*ts) for ts in zip(*(_unbind(t, n)
                                                for t in tree))]
    per_key = {k: _unbind(v, n) for k, v in tree.items()}
    return [{k: per_key[k][g] for k in tree} for g in range(n)]


def stack_init(gen, cfg: ModelConfig, device, dtype) -> Dict:
    """{layer<j>: params} with a leading (n_groups,) axis on every leaf."""
    plan = group_plan(cfg)
    n_groups = cfg.n_layers // len(plan)
    groups = [{f"layer{j}": _layer_init(gen, cfg, mixer, ffn, device, dtype)
               for j, (mixer, ffn) in enumerate(plan)}
              for _ in range(n_groups)]
    return _stack(groups)


def _empty_layer_cache(cfg: ModelConfig, mixer: str, n_groups: int, B: int,
                       cache_len: int, device, dtype):
    def zeros(*shape, dtype=dtype):
        return torch.zeros((n_groups,) + shape, device=device, dtype=dtype)

    if mixer == "attn":
        a = cfg.attention
        W = min(cache_len, a.sliding_window) if a.sliding_window else cache_len
        return KVCache(zeros(B, W, a.n_kv_heads, a.head_dim),
                       zeros(B, W, a.n_kv_heads, a.head_dim))
    s = cfg.ssm
    _, H, Pd = ssm_lib.ssm_dims(s, cfg.d_model)
    return SSMCache(state=zeros(B, H, Pd, s.d_state, dtype=torch.float32),
                    conv_x=zeros(B, s.conv_width - 1, H, Pd),
                    conv_B=zeros(B, s.conv_width - 1, s.d_state),
                    conv_C=zeros(B, s.conv_width - 1, s.d_state))


def init_cache(cfg: ModelConfig, B: int, cache_len: int, device,
               dtype) -> Dict:
    """Stacked (n_groups, ...) zero caches: (B, W, K, hd) KV caches with W
    the cache length cut to the sliding window; SSM caches of the float32
    state (B, H, P, N) and the conv tails (B, w-1, ...)."""
    plan = group_plan(cfg)
    n_groups = cfg.n_layers // len(plan)
    return {f"layer{j}": _empty_layer_cache(cfg, mixer, n_groups, B,
                                            cache_len, device, dtype)
            for j, (mixer, _) in enumerate(plan)}


def _layer_apply(p: Dict, x, cfg: ModelConfig, mixer: str, ffn: str,
                 mode: str, ctx, cache, positions, cache_pos,
                 batch_sharded: bool = True):
    h = L.apply_norm(p["norm1"], x, cfg.norm)
    if mixer == "attn":
        out, new_cache = attn_lib.apply_attention(
            p["attn"], h, cfg.attention, positions, mode, cache, cache_pos,
            impl=ctx.attn_impl, ctx=ctx, batch_sharded=batch_sharded)
    else:
        out, new_cache = ssm_lib.apply_ssm(p["ssm"], h, cfg.ssm, mode, cache,
                                           ctx)
    x = x + out
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = L.apply_norm(p["norm2"], x, cfg.norm)
        if ffn == "mlp":
            out = L.apply_mlp(p["mlp"], h, cfg.act, ctx, cfg.d_ff)
        else:
            cap_mode = "factor" if mode == "train" else "full"
            out, aux = moe_lib.apply_moe(p["moe"], h, cfg.moe, cfg.act, ctx,
                                         cap_mode, batch_sharded)
        x = x + out
    return x, new_cache, aux


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective recompute: keep the 2-D matrix products' outputs."""
    if op == torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT = {
    "none": None,
    "full": {},
    "selective": {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_matmuls)},
}


def stack_apply(groups: Dict, x, cfg: ModelConfig, mode: str, ctx,
                caches: Optional[Dict], positions, cache_pos,
                remat: str = "selective", batch_sharded: bool = True):
    """The layer stack. Returns (x, caches | None, aux): prefill stacks
    the layers' new caches; decode writes into ``caches`` in place and
    returns them; train returns None and recomputes each layer group in
    the backward as ``remat`` (none | full | selective) says. aux is the
    MoE layers' load-balance loss summed over the stack (a float32
    scalar, 0 without MoE layers)."""
    plan = group_plan(cfg)
    n_groups = cfg.n_layers // len(plan)
    recompute = REMAT[remat] if mode == "train" else None
    cache_groups = (_unbind(caches, n_groups) if mode == "decode"
                    else [None] * n_groups)
    new = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for pg, cg in zip(_unbind(groups, n_groups), cache_groups):

        def group(x, pg=pg, cg=cg):
            out = {}
            aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
            pg = _gather_layer(pg, cfg, ctx)
            for j, (mixer, ffn) in enumerate(plan):
                name = f"layer{j}"
                x, out[name], a = _layer_apply(
                    pg[name], x, cfg, mixer, ffn, mode, ctx,
                    cg[name] if cg is not None else None, positions,
                    cache_pos, batch_sharded)
                aux_g = aux_g + a
            return x, out, aux_g

        if recompute is None:
            x, out, aux_g = group(x)
        else:
            x, out, aux_g = ckpt.checkpoint(group, x, use_reentrant=False,
                                            **recompute)
        aux = aux + aux_g
        new.append(out)
    if mode == "prefill":
        return x, _stack(new), aux
    return x, (caches if mode == "decode" else None), aux
