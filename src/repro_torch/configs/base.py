"""Config system: model architecture + workload shapes + run settings.

A copy of the JAX package's ``configs/base.py`` (plain dataclasses, no
JAX), kept here so the port imports nothing of that package.

Every assigned architecture is a ``ModelConfig`` constant in its own
module under ``repro_torch.configs``; the registry in ``__init__`` resolves
``--arch <id>`` strings. Shape cells (train_4k / prefill_32k / decode_32k
/ long_500k) are ``ShapeConfig``s; ``cells_for(arch)`` yields the
well-defined (arch x shape) cells, honouring the skip rules recorded in
DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # Static capacity factor: tokens routed per expert per batch are
    # bounded (KATANA Opt-2 discipline: no dynamic shapes anywhere).
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # every `period` layers one MoE layer (1 = every layer is MoE)
    period: int = 1


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256  # SSD chunk length
    # d_inner = expand * d_model; n_heads = d_inner // head_dim


@dataclass(frozen=True)
class AttentionConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    causal: bool = True
    sliding_window: Optional[int] = None  # SWA width (h2o-danube)
    rope_theta: float = 10000.0
    use_rope: bool = True  # False => learned absolute positions
    qkv_bias: bool = False
    softmax_scale: Optional[float] = None


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    d_ff: int  # dense FFN width (0 for attn-free / pure-MoE archs)
    attention: Optional[AttentionConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid interleave: one attention layer every `attn_period` layers,
    # remaining layers are SSM (jamba: 1:7).
    attn_period: int = 1
    act: str = "swiglu"  # swiglu | squared_relu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    bidirectional: bool = False  # encoder-only (hubert)
    is_encoder_only: bool = False
    # modality frontend stubs (vlm/audio): inputs are precomputed
    # frame/patch embeddings of this many positions, prepended/replacing
    # token inputs. None => pure token LM.
    frontend: Optional[str] = None  # "vision" | "audio"
    frontend_positions: int = 0
    dtype: str = "bfloat16"
    # citation tier from the assignment table
    source: str = ""

    @property
    def d_head_total(self) -> int:
        a = self.attention
        return a.n_heads * a.head_dim if a else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind string ('attn'|'ssm') honouring attn_period."""
        kinds = []
        for i in range(self.n_layers):
            if self.family in ("ssm",):
                kinds.append("ssm")
            elif self.family == "hybrid":
                # jamba: attention at positions p-1, 2p-1, ... (1 in p)
                kinds.append(
                    "attn" if (i % self.attn_period) == self.attn_period - 1 else "ssm"
                )
            else:
                kinds.append("attn")
        return tuple(kinds)

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        p = self.moe.period
        return tuple((i % p) == p - 1 for i in range(self.n_layers))

    def interleave_period(self) -> int:
        """Smallest homogeneous repeat unit of the layer stack."""
        p = 1
        if self.family == "hybrid":
            p = self.attn_period
        if self.moe is not None:
            p = _lcm(p, self.moe.period)
        return p


def _lcm(a: int, b: int) -> int:
    import math

    return a * b // math.gcd(a, b)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


@dataclass(frozen=True)
class RunConfig:
    """Training/serving run settings, independent of the architecture."""

    microbatches: int = 1  # grad-accumulation chunks per step
    remat: str = "selective"  # none | selective | full
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0
    # int8 error-feedback gradient compression over the DP axis
    grad_compression: bool = False
    # fsdp: shard weights over the data axes in addition to TP
    fsdp: bool = True
    # attention lowering: "xla" materializes (B,H,S,S) scores in HBM;
    # "flash" models the Pallas fused kernel (kernels/flash_attention):
    # scores stay in VMEM, only O(S) stats cross HBM.
    attn_kernel: str = "xla"
    # MoE weight strategy: "gather" (FSDP + per-layer gather, train) |
    # "tp2d" (experts x ffn 2D-resident, decode) — see sharding/rules.py
    moe_weight_mode: str = "gather"
    checkpoint_every: int = 500
    keep_checkpoints: int = 3


def sub_quadratic(cfg: ModelConfig) -> bool:
    """Can this arch decode at 500k context with a bounded working set?"""
    if cfg.family in ("ssm", "hybrid"):
        return True
    a = cfg.attention
    return bool(a and a.sliding_window)


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(supported, reason-if-not) for an (arch x shape) cell."""
    if cfg.is_encoder_only and shape.kind == "decode":
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not sub_quadratic(cfg):
        return False, "full quadratic attention: 500k decode out of scope (DESIGN.md)"
    return True, ""


def cells_for(cfg: ModelConfig) -> Sequence[Tuple[ShapeConfig, bool, str]]:
    return [(s, *cell_supported(cfg, s)) for s in ALL_SHAPES]


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 64,
            vocab: int = 128, seq: int = 32) -> ModelConfig:
    """Smoke-test sized config of the same family (per-arch smoke tests)."""
    scale = d_model / cfg.d_model
    attn = None
    if cfg.attention is not None:
        a = cfg.attention
        heads = max(2, min(4, a.n_heads))
        kv = max(1, min(heads, a.n_kv_heads))
        attn = dataclasses.replace(
            a, n_heads=heads, n_kv_heads=kv, head_dim=max(8, d_model // heads),
            sliding_window=min(a.sliding_window, seq // 2) if a.sliding_window else None,
        )
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(2, cfg.moe.top_k),
            d_ff_expert=max(16, int(cfg.moe.d_ff_expert * scale)),
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    period = cfg.interleave_period()
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(n_layers, min(period, 8)),
        d_model=d_model,
        vocab=vocab,
        d_ff=max(32, int(cfg.d_ff * scale)) if cfg.d_ff else 0,
        attention=attn, moe=moe, ssm=ssm,
        frontend_positions=min(cfg.frontend_positions, 8),
    )
