"""internvl2-2b [vlm] — 24L d2048 16H (GQA kv=8) d_ff=8192 vocab=92553;
InternViT frontend (stubbed: precomputed patch embeddings) + InternLM2
backbone. [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    vocab=92553,
    d_ff=8192,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=128, causal=True),
    act="swiglu",
    norm="rmsnorm",
    frontend="vision",
    frontend_positions=256,  # ViT patch embeddings prepended to the text
    source="arXiv:2404.16821; hf",
)
