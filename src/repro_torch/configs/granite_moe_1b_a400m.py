"""granite-moe-1b-a400m [moe] — 24L d1024 16H (GQA kv=8) d_ff_expert=512
vocab=49155, MoE 32e top-8. [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    vocab=49155,
    d_ff=0,
    attention=AttentionConfig(n_heads=16, n_kv_heads=8, head_dim=64, causal=True),
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512, period=1),
    act="swiglu",
    norm="rmsnorm",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
)
