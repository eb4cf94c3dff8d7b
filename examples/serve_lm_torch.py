"""Batched serving on the PyTorch port through ``repro_torch.launch.serve``:
the continuous-batching-lite engine with a kv cache, a reduced qwen config.

    PYTHONPATH=src python examples/serve_lm_torch.py                 # on the GPU
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu

Other arguments (``--device``, ``--seed``, ...) pass through to the entry
point.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.launch.serve import main  # noqa: E402


def run(argv):
    return main(["--arch", "qwen1.5-0.5b", "--reduce", "16", "--slots", "4", "--max-len", "64",
                 "--new-tokens", "8", "--requests", "6"] + list(argv))


if __name__ == "__main__":
    run(sys.argv[1:])
