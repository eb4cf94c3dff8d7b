"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]: 24L d1024 16H (GQA kv=8)
expert ff512 V=49155, MoE 32e top-8."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=512, vocab_size=49155, mlp="swiglu", rope=True,
    moe=True, num_experts=32, top_k=8, moe_every=1,
    stackable_layers=False,  # MoE FFN: aux-loss carry breaks the homogeneous-layer contract
)
