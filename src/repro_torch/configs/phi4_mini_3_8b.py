"""phi4-mini-3.8b [arXiv:2412.08905]: 32L d3072 24H (GQA kv=8) ff8192 V=200064, RoPE SwiGLU."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
    d_ff=8192, vocab_size=200064, head_dim=128, mlp="swiglu", rope=True,
)
