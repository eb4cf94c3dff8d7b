"""jamba-1.5-large-398b [arXiv:2403.19887]: 72L d8192 64H (GQA kv=8) ff24576 V=65536,
MoE 16e top-2, Mamba+attention 1:7 interleave."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=24576, vocab_size=65536, mlp="swiglu", rope=False,
    moe=True, num_experts=16, top_k=2, moe_every=2,
    ssm=True, ssm_state=128, ssm_head_dim=64, ssm_expand=2, attn_every=8,
    stackable_layers=False,  # mamba/attention 1:7 interleave: heterogeneous stack
)
