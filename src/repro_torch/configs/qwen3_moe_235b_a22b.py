"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) d_ff_expert=1536
vocab=151936, MoE 128e top-8. [hf:Qwen/Qwen3-30B-A3B family; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    vocab=151936,
    d_ff=0,  # every layer is MoE; no shared dense FFN
    attention=AttentionConfig(
        n_heads=64, n_kv_heads=4, head_dim=128, causal=True, rope_theta=1e6
    ),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536, period=1),
    act="swiglu",
    norm="rmsnorm",
    source="hf:Qwen/Qwen3-235B-A22B; hf",
)
