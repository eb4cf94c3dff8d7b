"""PyTorch/CUDA port of the GSPMD reproduction (the JAX package `repro` is the reference)."""
