"""hubert-xlarge [audio] — 48L d1280 16H (MHA kv=16) d_ff=5120 vocab=504;
encoder-only (no decode shapes), audio frontend stubbed with precomputed
frame embeddings. [arXiv:2106.07447; unverified]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    vocab=504,
    d_ff=5120,
    attention=AttentionConfig(
        n_heads=16, n_kv_heads=16, head_dim=80, causal=False, use_rope=False
    ),
    act="gelu",
    norm="layernorm",
    bidirectional=True,
    is_encoder_only=True,
    frontend="audio",
    frontend_positions=0,  # all positions come from the audio frontend
    source="arXiv:2106.07447; unverified",
)
