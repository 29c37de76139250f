"""mamba2-130m [ssm] — 24L d768, attention-free, vocab=50280,
ssm_state=128; SSD (state-space duality). [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab=50280,
    d_ff=0,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4, chunk=256),
    act="swiglu",  # unused by ssm blocks; kept for the shared norm/embed path
    norm="rmsnorm",
    tie_embeddings=True,
    source="arXiv:2405.21060; unverified",
)
