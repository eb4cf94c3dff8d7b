"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01]: 40L d8192 64H (GQA kv=8) ff22528 V=256000, no bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000, mlp="swiglu", rope=True,
)
