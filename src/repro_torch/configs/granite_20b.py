"""granite-20b [dense] — 52L d6144 48H (MQA kv=1) d_ff=24576 vocab=49152;
llama-arch code model, gpt-bigcode style MQA + learned positions.
[arXiv:2405.04324; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    vocab=49152,
    d_ff=24576,
    attention=AttentionConfig(
        n_heads=48, n_kv_heads=1, head_dim=128, causal=True, use_rope=False,
        qkv_bias=True,
    ),
    act="gelu",
    norm="layernorm",
    source="arXiv:2405.04324; hf",
)
