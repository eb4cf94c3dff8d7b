"""mamba2-130m [arXiv:2405.21060]: 24L d768, attention-free SSD, state=128, V=50280."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, mlp="swiglu", rope=False,
    ssm=True, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
)
