"""Serving entry point: init a (reduced) model from a seed and answer batched
requests.  Runs on CUDA unless ``--device cpu``; ``--reduce 1`` is full width.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b --reduce 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m --reduce 8 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import default_strategy, get_config, reduced_config
from repro_torch.core.device import resolve_device
from repro_torch.models import api
from repro_torch.models.layers import tree_init
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduce", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(get_config(args.arch), args.reduce)
    st = get_strategy(default_strategy(args.arch))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tree_init(api.param_tree(cfg, st), gen, dtype=cfg.dtype, device=device)
    eng = Engine(cfg, st, params, batch_slots=args.slots, max_len=args.max_len)
    reqs = [
        Request(prompt=[(7 * i + j) % cfg.vocab_size for j in range(4)],
                max_new_tokens=args.new_tokens)
        for i in range(args.requests)
    ]
    t0 = time.time()
    eng.generate(reqs)
    dt = time.time() - t0
    ntok = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {ntok} tokens in {dt:.1f}s "
          f"({ntok/dt:.1f} tok/s) on {device}")
    for r in reqs[:3]:
        print("  prompt", r.prompt, "->", r.out)
    return reqs


if __name__ == "__main__":
    main()
