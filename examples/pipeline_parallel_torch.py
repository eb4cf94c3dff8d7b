"""Pipeline parallelism as tensor sharding (paper §3.3) on the PyTorch port.

Runs a 4-stage circular pipeline (``core/pipeline.py``) against the
sequential oracle, then the same eight layers as a 4-stage stage-stacked
GPipe pipeline (``pipeline.pipelined_apply``) through the port's
partitioner on a simulated ("stage" 4, "data" 2) mesh, the stage dim
sharded on "stage" and the microbatch rows on "data", and prints the
plan's ppermutes per tick and the bubble ratios.

    PYTHONPATH=src python examples/pipeline_parallel_torch.py             # on the GPU
    PYTHONPATH=src python examples/pipeline_parallel_torch.py --device cpu

The mesh is simulated: every device's local shard lives on the one device
chosen, stacked along a leading dimension, and each tick's shift of the
buffer is a ppermute over that dimension.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core.compat import assert_close
from repro_torch.core.device import resolve_device
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.pipeline import circular_bubble_ratio, gpipe_bubble_ratio, pipeline
from repro_torch.pipeline import (bubble_fraction, pipeline_ticks, pipelined_apply,
                                  plan_ppermute_bytes, stage_stack_params)

L, R, M, D = 4, 2, 8, 32
mesh = Mesh.create((4, 2), ("stage", "data"))


def stage_fn(w, x):
    return torch.tanh(x @ w)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32

    rng = np.random.default_rng(0)
    ws = rng.standard_normal((L, R, D, D)).astype(np.float32) * 0.2
    xs = rng.standard_normal((M, 2, D)).astype(np.float32)

    # the sequential oracle: stage s of round r is layer r * L + s
    layers = [ws[s, r] for r in range(R) for s in range(L)]
    out = []
    for m in range(M):
        h = xs[m]
        for w in layers:
            h = np.tanh(h @ w)
        out.append(h)
    ref = np.stack(out)

    W, X = torch.tensor(ws, device=dev), torch.tensor(xs, device=dev)
    got = pipeline(stage_fn, W, X, num_stages=L, num_rounds=R)
    assert_close(got.cpu(), ref, "f32_chain")
    print("circular pipeline == sequential oracle: OK")

    # the same eight layers, stage-stacked (two contiguous layers a stage)
    stack = stage_stack_params(torch.tensor(np.stack(layers), device=dev), L)

    def pipelined(wstk, x):
        wstk = annotate(wstk, mesh_split(4, mesh, ["stage", -1, -1, -1]))
        x = annotate(x, mesh_split(3, mesh, [-1, "data", -1]))
        return pipelined_apply(lambda w, h, _: stage_fn(w, h), wstk, x, num_stages=L,
                               mesh=mesh, stage_axis="stage")

    runner = spmd_partition(pipelined, mesh, optimize=False, device=args.device)
    got = runner(stack, X)
    assert_close(got.cpu(), ref, "f32_chain")
    print("pipelined_apply through the partitioner == sequential oracle: OK")
    (entry,) = runner.plans.values()
    (tick,) = [s for s in entry.plan.steps if s.op == "scan"]
    perms = [s for s in tick.inner.steps if s.op == "ppermute"]
    pbytes, launches = plan_ppermute_bytes(entry.plan)
    print(f"ticks: {tick.call['trips']} (M + S - 1 = {pipeline_ticks(L, M)}); ppermutes per "
          f"tick: {len(perms)} over {perms[0].axes}, perm {perms[0].call['perm']}, "
          f"{perms[0].in_bytes:.0f} bytes each; {launches} a call ({pbytes:.0f} bytes); "
          f"collectives run: {dict(runner.collectives)}")
    print(f"bubble ratios: gpipe(L={L},M={M}) = {gpipe_bubble_ratio(L, M):.3f} "
          f"(stage-stacked: {bubble_fraction(L, M):.3f}), circular(R={R}) = "
          f"{circular_bubble_ratio(L, M, R):.3f}")


if __name__ == "__main__":
    main()
