"""Modality frontends, stubbed as in the reference
(``repro/models/frontends.py``): the vision and audio encoders are not
part of the backbone; the batch carries precomputed patch or frame
embeddings, and a norm plus a learned (d, d) projection adapts them into
the residual stream, so the adapter still trains.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def frontend_init(gen, cfg: ModelConfig, device, dtype) -> Dict:
    d = cfg.d_model
    return {"proj": L.randn(gen, (d, d), 1.0 / math.sqrt(d), device, dtype),
            "norm": L.norm_init(d, cfg.norm, device, dtype)}


def frontend_spec(cfg: ModelConfig) -> Dict:
    return {"proj": ("embed", None), "norm": L._norm_spec(cfg.norm)}


def apply_frontend(p: Dict, embeds: torch.Tensor, cfg: ModelConfig):
    """embeds: (B, T_front, d) precomputed patch / frame features, in the
    parameters' dtype."""
    h = L.apply_norm(p["norm"], embeds, cfg.norm)
    return h @ p["proj"]
