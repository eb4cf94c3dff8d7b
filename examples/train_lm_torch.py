"""LM training on the PyTorch port through ``repro_torch.launch.train``: a
reduced qwen config with checkpoints every few steps (restart the same
command after a crash and it resumes from the newest one).

    PYTHONPATH=src python examples/train_lm_torch.py                 # quick demo, 30 steps
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu    # the same on the CPU
    PYTHONPATH=src python examples/train_lm_torch.py --full          # ~100M, 300 steps

Checkpoints go to ``build/lm_demo_ckpt`` (``build/lm100m_ckpt`` with
``--full``) unless ``--ckpt-dir`` names another directory; other arguments
(``--device``, ``--seed``, ``--fail-at-step``, ...) pass through to the
entry point.
"""
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.train import main  # noqa: E402


def run(argv):
    full = "--full" in argv
    rest = [a for a in argv if a != "--full"]
    if full:
        args = ["--arch", "qwen1.5-0.5b", "--reduce", "2", "--steps", "300", "--batch", "8",
                "--seq", "512", "--ckpt-every", "50"]
    else:
        args = ["--arch", "qwen1.5-0.5b", "--reduce", "8", "--steps", "30", "--batch", "4",
                "--seq", "128", "--ckpt-every", "10"]
    if "--ckpt-dir" not in rest:
        args += ["--ckpt-dir", os.path.join(ROOT, "build", "lm100m_ckpt" if full
                                            else "lm_demo_ckpt")]
    return main(args + rest)


if __name__ == "__main__":
    run(sys.argv[1:])
