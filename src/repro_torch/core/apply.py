"""The end-user entry point: ``gspmd_jit``.

In the JAX package ``gspmd_jit`` completes the shardings and hands the
constrained program to XLA's SPMD partitioner.  PyTorch has no compiler
partitioner to hand off to, so here it is the package's own partitioner:
``spmd_partition``, a compiled plan per input signature, on the simulated
mesh, optimized and verified with an explicit ``plan_profile`` (a
``RooflineParams``).  ``None`` keeps the unoptimized (verified) plan,
standing in for the reference's default constants until a
``MachineProfile`` fitted on the card (ROADMAP A15) can price the
optimizer.
"""
from __future__ import annotations

from .compat import capture
from .partitioner import spmd_partition
from .propagation import propagate
from .sharding import Mesh


def gspmd_jit(fn, mesh: Mesh, device="cuda", plan_profile=None):
    """Partition ``fn`` from its ``annotate`` calls and run it as one SPMD
    program.  The runner captures, propagates and compiles a plan once per
    input signature (optimized with ``plan_profile``, where one is given);
    ``runner.propagation_for(*args)`` returns the completed shardings."""
    runner = spmd_partition(fn, mesh, optimize=plan_profile is not None, verify=True,
                            profile=plan_profile, device=device)
    runner.propagation_for = lambda *args: propagate(capture(fn, *args), mesh)
    return runner
