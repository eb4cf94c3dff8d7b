"""nemotron-4-340b [arXiv:2402.16819]: 96L d18432 96H (GQA kv=8) ff73728 V=256000, squared-ReLU."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8,
    d_ff=73728, vocab_size=256000, mlp="relu2", rope=True,
)
