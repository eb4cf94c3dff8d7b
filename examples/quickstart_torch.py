"""GSPMD quickstart on the PyTorch port: annotate a single-device program, let
propagation complete the shardings, and run one SPMD program on a simulated
(2,4) device mesh.

    PYTHONPATH=src python examples/quickstart_torch.py             # on the GPU
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The mesh is simulated: every device's local shard lives on the one device
chosen, stacked along a leading dimension, and the collectives are exact
tensor operations over it.  The partitioner compiles a plan once per input
signature (plan once, run many) and executes it on every call.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import Mesh, annotate, gspmd_jit, mesh_split, propagate
from repro_torch.core.compat import capture
from repro_torch.core.partitioner import spmd_partition

# 1. a logical device mesh (paper §3.1)
mesh = Mesh.create((2, 4), ("x", "y"))


# 2. write the model as if for ONE device; add two annotations (paper §3.2):
#    data-parallel batch on mesh dim x, model-parallel features on y.
def mlp(x, w1, w2):
    x = annotate(x, mesh_split(2, mesh, ["x", -1]))     # batch -> x
    w1 = annotate(w1, mesh_split(2, mesh, [-1, "y"]))   # features -> y
    h = torch.relu(x @ w1)
    return h @ w2


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(0)
    xn = rng.standard_normal((16, 64)).astype(np.float32)
    w1n = rng.standard_normal((64, 128)).astype(np.float32)
    w2n = rng.standard_normal((128, 32)).astype(np.float32)
    x, w1, w2 = (torch.from_numpy(a) for a in (xn, w1n, w2n))

    # 3. inspect what sharding completion infers for every tensor (paper §3.5)
    captured = capture(mlp, x, w1, w2)
    prop = propagate(captured, mesh)
    print("inferred shardings:")
    for v in captured.invars + captured.outvars:
        print(f"  {tuple(v.meta['val'].shape)}: {prop.get(v)}")

    # 4a. the end-user entry point: gspmd_jit runs the port's own partitioner
    out = gspmd_jit(mlp, mesh, device=args.device)(x, w1, w2)
    print("gspmd_jit out:", tuple(out.shape), "on", out.device)

    # 4b. the partitioner itself: a compiled plan with explicit collectives (§4)
    runner = spmd_partition(mlp, mesh, optimize=False, device=args.device)
    out_ref = runner(x, w1, w2)
    (entry,) = runner.plans.values()
    print("plan steps:")
    for step in entry.plan.steps:
        what = step.program.collectives() if step.program is not None else step.axes or ""
        print(f"  {step.kind:10} {step.op:18} {what}")
    print("collectives:", runner.collectives, "fallbacks:", runner.fallbacks)
    # the dynamic path decides every op again on each call; same result
    dynamic = spmd_partition(mlp, mesh, compile_plans=False, device=args.device)
    np.testing.assert_array_equal(out_ref.cpu().numpy(), dynamic(x, w1, w2).cpu().numpy())
    np.testing.assert_allclose(out.cpu().numpy(), out_ref.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)
    oracle = np.maximum(xn @ w1n, 0) @ w2n
    np.testing.assert_allclose(out.cpu().numpy(), oracle, rtol=1e-4, atol=1e-4)
    print("partitioned == single-device oracle: OK")


if __name__ == "__main__":
    main()
