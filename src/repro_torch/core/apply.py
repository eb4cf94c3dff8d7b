"""The end-user entry point: ``gspmd_jit``.

In the JAX package ``gspmd_jit`` completes the shardings and hands the
constrained program to XLA's SPMD partitioner.  PyTorch has no compiler
partitioner to hand off to, so here it is the package's own partitioner:
``spmd_partition``, a compiled plan per input signature, on the simulated
mesh, optimized and verified as the reference's ``spmd_partition`` does by
default.  ``plan_profile`` prices it (a ``RooflineParams``, a
``MachineProfile`` or a JSON path); ``None`` resolves
``$REPRO_TORCH_MACHINE_PROFILE`` and then the profile fitted on an H100 and
committed with the package (``obs/profile.py::resolve_profile``).
``optimize=False`` keeps the unoptimized (verified) plan.
"""
from __future__ import annotations

from .compat import capture
from .partitioner import spmd_partition
from .propagation import propagate
from .sharding import Mesh


def gspmd_jit(fn, mesh: Mesh, device="cuda", plan_profile=None, optimize: bool = True):
    """Partition ``fn`` from its ``annotate`` calls and run it as one SPMD
    program.  The runner captures, propagates and compiles a plan once per
    input signature (optimized unless ``optimize=False``, priced by
    ``plan_profile`` as resolved); ``runner.propagation_for(*args)`` returns
    the completed shardings."""
    runner = spmd_partition(fn, mesh, optimize=optimize, verify=True,
                            profile=plan_profile, device=device)
    runner.propagation_for = lambda *args: propagate(capture(fn, *args), mesh)
    return runner
