"""whisper-base [arXiv:2212.04356]: 6L enc + 6L dec, d512 8H ff2048 V=51865; conv frontend stubbed."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, mlp="gelu", rope=False, cross_attention=True,
    stackable_layers=False,  # encoder-decoder: two stacks + cross-attention
)
