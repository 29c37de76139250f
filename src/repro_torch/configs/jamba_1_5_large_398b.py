"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2, Mamba+attention 1:7 interleave.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    vocab=65536,
    d_ff=24576,
    attention=AttentionConfig(n_heads=64, n_kv_heads=8, head_dim=128, causal=True,
                              use_rope=False),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, period=2),
    ssm=SSMConfig(d_state=128, head_dim=128, expand=2, conv_width=4, chunk=256),
    attn_period=8,  # one attention layer per 8 (1:7 attn:mamba)
    act="swiglu",
    norm="rmsnorm",
    source="arXiv:2403.19887; hf",
)
