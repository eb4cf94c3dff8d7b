"""internvl2-1b [arXiv:2404.16821]: InternLM2 backbone 24L d896 14H (GQA kv=2) ff4864 V=151655;
InternViT frontend stubbed (256 patch tokens)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, mlp="swiglu", rope=True,
    num_prefix_tokens=256,
    stackable_layers=False,  # ViT-prefix fusion sits inside the decode stack
)
