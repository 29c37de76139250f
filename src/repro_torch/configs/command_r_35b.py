"""command-r-35b [dense] — 40L d8192 64H (GQA kv=8) d_ff=22528
vocab=256000; GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    vocab=256000,
    d_ff=22528,
    attention=AttentionConfig(
        n_heads=64, n_kv_heads=8, head_dim=128, causal=True, qkv_bias=False
    ),
    act="swiglu",
    norm="layernorm",
    tie_embeddings=True,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
