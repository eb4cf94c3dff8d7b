"""The end-user entry point: ``gspmd_jit``.

In the JAX package ``gspmd_jit`` completes the shardings and hands the
constrained program to XLA's SPMD partitioner.  PyTorch has no compiler
partitioner to hand off to, so here it is the package's own partitioner:
``spmd_partition(..., optimize=False)``, a compiled plan per input
signature, on the simulated mesh.
"""
from __future__ import annotations

from .compat import capture
from .partitioner import spmd_partition
from .propagation import propagate
from .sharding import Mesh


def gspmd_jit(fn, mesh: Mesh, device="cuda"):
    """Partition ``fn`` from its ``annotate`` calls and run it as one SPMD
    program.  The runner captures, propagates and compiles a plan once per
    input signature;
    ``runner.propagation_for(*args)`` returns the completed shardings."""
    runner = spmd_partition(fn, mesh, optimize=False, device=device)
    runner.propagation_for = lambda *args: propagate(capture(fn, *args), mesh)
    return runner
