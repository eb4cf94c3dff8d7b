"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: 24L d1024 16H (GQA kv=16) ff2816 V=151936, QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True, mlp="swiglu", rope=True,
)
