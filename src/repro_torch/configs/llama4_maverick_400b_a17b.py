"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*]: 48L d5120 40H (GQA kv=8) ff8192
V=202048, MoE 128e top-1 + shared expert, early fusion."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128, mlp="swiglu", rope=True,
    moe=True, num_experts=128, top_k=1, moe_every=2, shared_expert=True,
    stackable_layers=False,  # MoE-every-2 superblocks: stack not homogeneous
)
