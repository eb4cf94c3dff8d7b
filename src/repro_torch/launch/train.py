"""Training entry point (port of the JAX package's ``launch/train.py``):
init a (reduced) model from a seed and train it.  Runs on CUDA unless
``--device cpu``; ``--reduce 1`` is full width.

    PYTHONPATH=src python -m repro_torch.launch.train --reduce 16 --steps 5 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduce 1 --batch 4 --seq 2048 \\
        --steps 10 --data-pattern arithmetic
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m --reduce 1 \\
        --batch 8 --seq 2048 --steps 10 --data-pattern arithmetic

The last trains mamba2-130m at its published widths (bf16 compute, float32
master weights, remat "dots", Adafactor); its SSD's gradient is the backward
kernel.  ``--arch mamba2-130m --reduce 8 --batch 2 --seq 64 --device cpu``
is a small CPU run.

``--ckpt-dir DIR`` saves a checkpoint every ``--ckpt-every`` steps and at
the end (``train/checkpoint.py``, the JAX package's format) and, when DIR
already holds one, restores the newest and resumes at its data cursor,
logging ``restored checkpoint step=N cursor=C``; ``--fail-at-step K``
raises at the start of step K (a crash to restart from):

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduce 16 --steps 6 \
        --ckpt-dir build/ck --ckpt-every 3 --fail-at-step 4   # raises at step 4
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduce 16 --steps 6 \
        --ckpt-dir build/ck --ckpt-every 3                    # resumes at step 3
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import default_strategy, get_config, reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.train.loop import TrainConfig, TrainLoop
from repro_torch.train.optimizer import get_optimizer


def main(argv=None, hooks=None):
    """Train and return the per-step losses (of the steps this run took);
    ``hooks`` join the loop's own (``log`` and ``straggler`` print, so a
    restore prints its step and cursor)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--strategy", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduce", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--optimizer", default="adafactor")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-pattern", default="uniform", choices=["uniform", "arithmetic"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch), args.reduce)
    st = get_strategy(args.strategy or default_strategy(args.arch))
    opt = get_optimizer(args.optimizer, lr=args.lr)
    tc = TrainConfig(
        steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        grad_accum=args.grad_accum, compress_grads=args.compress_grads,
        fail_at_step=args.fail_at_step,
    )
    pipe = TokenPipeline(
        DataConfig(cfg.vocab_size, args.seq, args.batch, seed=args.seed,
                   pattern=args.data_pattern)
    )
    loop = TrainLoop(
        cfg, st, opt, tc, pipe, gen=torch.Generator(device).manual_seed(args.seed),
        hooks={"log": print, "straggler": lambda s, dt, med: print(
            f"[straggler] step {s}: {dt:.2f}s vs median {med:.2f}s"), **(hooks or {})},
        device=device,
    )
    t0 = time.time()
    _, losses = loop.run()
    dt = time.time() - t0
    print(f"done: {len(losses)} steps in {dt:.1f}s on {device}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
