#!/usr/bin/env python3
"""How far float32 determines mamba2-130m's gradient: the loss and each
gradient leaf of ``value_and_grad`` (at full width, or ``--reduce k`` as
``launch/train.py`` cuts it), from a seed, against the same with every
weight multiplied by (1 + 1e-7 N), N standard normal (about one float32
ulp), or with ``--against float64`` against the same step in float64 (the
weights widened, the model in float64; on the card the SSD then takes its
plain route, as the kernels are float32 only).

    PYTHONPATH=src python3 tools/mamba2_conditioning.py --layers 24 --init tree --device cpu
    PYTHONPATH=src python3 tools/mamba2_conditioning.py --layers 24 --init published
    PYTHONPATH=src python3 tools/mamba2_conditioning.py --layers 2 --against float64 --device cpu

``--init tree`` takes the port's ``tree_init`` weights (A_log 0, dt_bias 0,
the mirror of the JAX package's); ``--init published`` then sets A and dt
as Mamba2's published initialization and scales the output projection by
1/sqrt(layers) (as ``chip_smoke.py``'s float32 Mamba2 cases do).  Float32, remat
"none", batch ``--batch`` x ``--seq`` of random tokens.  Prints each leaf's
relative change in norm (per layer for the stacked leaves) beside its
norm, and the largest.  Runs on the card unless ``--device cpu``.
"""
import argparse
import math
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_strategy  # noqa: E402
from repro_torch.configs.registry import get_config, reduced_config  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.train.loop import TrainConfig, init_state, value_and_grad  # noqa: E402
from repro_torch.train.optimizer import get_optimizer  # noqa: E402


def published_init(params, layers, gen):
    """In place: A_log = log A with A uniform in [1, 16], dt_bias the
    inverse softplus of dt log-uniform in [1e-3, 1e-1] (Mamba2's published
    initialization), and the output projection scaled by 1/sqrt(layers)."""
    mix = params["layers"]["mixer"]
    with torch.no_grad():
        shape, dev = mix["A_log"].shape, mix["A_log"].device
        mix["A_log"].copy_(torch.log(1 + 15 * torch.rand(shape, generator=gen, device=dev)))
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev))
        mix["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        mix["wo"].mul_(1 / math.sqrt(layers))


def rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--reduce", type=int, default=1)
    ap.add_argument("--init", choices=["tree", "published"], default="tree")
    ap.add_argument("--against", choices=["perturbed", "float64"], default="perturbed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    st = get_strategy("2d_finalized")
    cfg = reduced_config(get_config("mamba2-130m"), args.reduce).with_(
        num_layers=args.layers, dtype="float32", remat="none")
    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_state(cfg, st, get_optimizer("sgd"), TrainConfig(), gen, device)["params"]
    if args.init == "published":
        published_init(params, args.layers, gen)
    tokens = np.random.default_rng(args.seed).integers(0, cfg.vocab_size,
                                                       (args.batch, args.seq + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).to(device),
             "labels": torch.from_numpy(tokens[:, 1:]).to(device)}
    loss, grads = value_and_grad(cfg, st, params, batch)
    if args.against == "float64":
        route = ops._route
        ops._route = lambda t: "cpu"  # the plain SSD, on any device's tensors
        try:
            loss_m, grads_m = value_and_grad(cfg.with_(dtype="float64"), st, tree_map(
                lambda p: p.detach().double().requires_grad_(), params), batch)
        finally:
            ops._route = route
    else:
        noise = torch.Generator(device).manual_seed(args.seed + 1)
        moved = tree_map(lambda p: (p.detach() * (1 + 1e-7 * torch.randn(
            p.shape, generator=noise, device=p.device))).requires_grad_(), params)
        loss_m, grads_m = value_and_grad(cfg, st, moved, batch)
    print(f"mamba2-130m at reduce {args.reduce}, {args.layers} layers, {args.init} init, "
          f"B{args.batch} S{args.seq}, float32 on {device} against "
          f"{'float64' if args.against == 'float64' else 'the weights moved'}: loss "
          f"{loss.item():.6f}, {args.against} {loss_m.item():.8f}")
    worst = 0.0
    for (path, g), m in zip(leaves_with_paths(grads), leaves(grads_m)):
        r = rel(m, g)
        worst = max(worst, r)
        per_layer = ("; per layer " + " ".join(f"{rel(m[i], g[i]):.1e}" for i in range(len(g)))
                     if path[0] == "layers" else "")
        print(f"  {'/'.join(path)}: {r:.3e} (norm {g.norm().item():.3e}){per_layer}")
    print(f"largest relative change of a leaf: {worst:.3e}")


if __name__ == "__main__":
    main()
