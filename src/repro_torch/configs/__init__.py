"""Architecture registry: ``get_config(arch_id)`` resolves ``--arch`` flags."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    TRAIN_4K,
    AttentionConfig,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
    cell_supported,
    cells_for,
    reduced,
    sub_quadratic,
)

# arch-id -> module name
_REGISTRY: Dict[str, str] = {
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "command-r-35b": "command_r_35b",
    "granite-20b": "granite_20b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "nemotron-4-15b": "nemotron_4_15b",
    "internvl2-2b": "internvl2_2b",
    "mamba2-130m": "mamba2_130m",
    "hubert-xlarge": "hubert_xlarge",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {list_archs()}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; known: {[s.name for s in ALL_SHAPES]}")
