"""h2o-danube-1.8b [dense] — 24L d2560 32H (GQA kv=8) d_ff=6912 vocab=32000;
llama+mistral mix with sliding-window attention. [arXiv:2401.16818; hf]"""
from repro_torch.configs.base import AttentionConfig, ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    vocab=32000,
    d_ff=6912,
    attention=AttentionConfig(
        n_heads=32, n_kv_heads=8, head_dim=80, causal=True, sliding_window=4096
    ),
    act="swiglu",
    norm="rmsnorm",
    source="arXiv:2401.16818; hf",
)
