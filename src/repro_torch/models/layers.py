"""Shared model layers: norms, embeddings, rotary positions, MLP variants.

Params are plain dicts of tensors in the JAX package's layouts
(``w_in`` (d, d_ff), ``tokens`` (vocab, d), ...), so a parameter tree
carries over as a copy (``repro_torch.convert.lm_params_from_numpy``).
Initializers take an explicit ``torch.Generator``; they give other
numbers than ``jax.random`` from the same seed. Every initializer has a
``*_spec`` giving the same tree with logical-axis tuples, which
``sharding/rules.py`` maps to mesh axes:

  "vocab"   — vocabulary dim            -> model
  "embed"   — residual-stream dim       -> FSDP over the data axes
  "heads"   — attention head dim        -> model
  "kv"      — kv-head dim               -> model if divisible
  "mlp"     — FFN hidden dim            -> model
  "experts" — MoE expert dim            -> model (expert parallel)
  "ssm"     — SSM inner-head dim        -> model if divisible
  None and the *_noshard names          -> replicated

On a mesh a layer gets its local blocks with the FSDP dims already
gathered (``rules.fsdp_gather``): the embedding is vocab-parallel where
the vocab divides the model axis (a masked lookup, one sum over
``model``); the MLP is column-parallel in ``w_in`` / ``w_gate`` and
row-parallel in ``w_out``, then one sum over ``model`` (the layout the
reference's ``pin_h`` asks GSPMD for). A sum over ``model`` adds the
ranks' parts in float32 and rounds to the activations' type once, as the
one-card product does.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll


def randn(gen: torch.Generator, shape, scale: float, device, dtype):
    """Normal(0, scale^2) drawn in float32 on ``gen``'s device, then cast:
    the JAX package draws in float32 and casts to the param dtype. On the
    ``meta`` device only the shape is made (nothing is drawn)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta", dtype=dtype)
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (t * scale).to(device=device, dtype=dtype)


def norm_init(d: int, kind: str, device, dtype) -> Dict:
    p = {"scale": torch.ones((d,), device=device, dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device, dtype=dtype)
    return p


def _norm_spec(kind: str) -> Dict:
    p = {"scale": ("embed_noshard",)}
    if kind == "layernorm":
        p["bias"] = ("embed_noshard",)
    return p


def apply_norm(p: Dict, x: torch.Tensor, kind: str, eps: float = 1e-5):
    """RMSNorm or LayerNorm in float32, cast back to x's dtype."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def embed_init(gen, vocab: int, d: int, device, dtype,
               max_pos: int = 0) -> Dict:
    p = {"tokens": randn(gen, (vocab, d), 0.02, device, dtype)}
    if max_pos:
        p["positions"] = randn(gen, (max_pos, d), 0.02, device, dtype)
    return p


def embed_spec(max_pos: int = 0) -> Dict:
    p = {"tokens": ("vocab", "embed")}
    if max_pos:
        p["positions"] = (None, "embed")
    return p


def model_split(dim: int, ctx) -> bool:
    """Whether a dim of ``dim`` is sharded over the model axis of ``ctx``
    (a mesh, a model axis of more than one rank, and the dim divides)."""
    return (ctx is not None and ctx.mesh is not None and ctx.model_size > 1
            and dim % ctx.model_size == 0)


def apply_embed(p: Dict, tokens: torch.Tensor, positions=None, ctx=None,
                vocab: int = 0):
    """The token (and learned position) embedding. On a mesh whose model
    axis splits ``vocab``, ``p["tokens"]`` is this rank's block of rows:
    ids outside it look up zeros, and one sum over ``model`` completes
    the rows."""
    table = p["tokens"]
    if model_split(vocab, ctx):
        lo = coll.index(ctx.mesh, ctx.model_axis) * table.shape[0]
        local = tokens - lo
        ok = (local >= 0) & (local < table.shape[0])
        x = table[local.clamp(0, table.shape[0] - 1)] * ok[..., None].to(
            table.dtype)
        x = coll.all_reduce(x, ctx.mesh, ctx.model_axis)
    else:
        x = table[tokens]
    if "positions" in p and positions is not None:
        x = x + p["positions"][positions]
    return x


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Split-half rotary embedding. x: (..., S, H, D) with D even;
    positions: (..., S). Math in float32, cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs       # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants: swiglu | squared_relu | gelu
# ---------------------------------------------------------------------------

def mlp_init(gen, d: int, d_ff: int, act: str, device, dtype) -> Dict:
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"w_in": randn(gen, (d, d_ff), s_in, device, dtype),
         "w_out": randn(gen, (d_ff, d), s_out, device, dtype)}
    if act == "swiglu":
        p["w_gate"] = randn(gen, (d, d_ff), s_in, device, dtype)
    return p


def mlp_spec(act: str) -> Dict:
    p = {"w_in": ("embed", "mlp"), "w_out": ("mlp", "embed")}
    if act == "swiglu":
        p["w_gate"] = ("embed", "mlp")
    return p


def apply_mlp(p: Dict, x: torch.Tensor, act: str, ctx=None,
              d_ff: int = 0) -> torch.Tensor:
    """On a mesh whose model axis splits ``d_ff``, ``p`` holds this rank's
    columns of ``w_in`` / ``w_gate`` and rows of ``w_out``, and one sum
    over ``model`` completes the output."""
    h = x @ p["w_in"]
    if act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif act == "squared_relu":
        r = F.relu(h)
        h = r * r
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    else:
        raise KeyError(act)
    if model_split(d_ff, ctx):
        # the parts summed in float32 and rounded once (the attention's
        # output projection does the same)
        y = coll.all_reduce(h.float() @ p["w_out"].float(), ctx.mesh,
                            ctx.model_axis)
        return y.to(x.dtype)
    return h @ p["w_out"]
