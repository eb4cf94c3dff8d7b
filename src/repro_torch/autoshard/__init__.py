"""repro_torch.autoshard: automatic sharding-strategy search over partition
plans (a port of the JAX package's ``repro.autoshard``).

GSPMD's premise is that users annotate a handful of tensors and the
partitioner infers the rest; this package removes the last manual step by
searching those seed annotations under the partitioner's own cost model
(Automap arXiv:2112.02958, PartIR arXiv:2401.11202).  Given a captured
program (``core.compat.capture``), a mesh and a per-device memory budget,
it returns the cheapest feasible assignment of input and parameter
shardings, scored by cost-only plan lowering: propagation, ``compile_plan``
and ``plan_opt`` on meta tensors, with no execution.

    from repro_torch import autoshard
    result = autoshard.solve("qwen1.5-0.5b", mesh)   # a registry config
    result.dump("assignment.json")                    # a reproducible artifact

    runner = spmd_partition(fn, mesh, autoshard=autoshard.AutoshardConfig())
"""
from .api import (
    AutoshardConfig,
    AutoshardResult,
    assignment_from_json,
    clear_assignment_cache,
    expand_assignment,
    load,
    registry_pipeline_problem,
    registry_problem,
    remap_assignment,
    restrict_assignment,
    sharding_from_spec,
    solve,
    solve_jaxpr,
    solve_jaxpr_cached,
    solve_problem,
)
from .evaluate import Evaluation, Evaluator
from .search import SearchResult, search
from .space import (
    assignment_bytes,
    candidate_shardings,
    fits_budget,
    local_bytes,
    pipeline_decisions,
)

__all__ = [
    "AutoshardConfig", "AutoshardResult", "Evaluation", "Evaluator",
    "SearchResult", "assignment_bytes", "assignment_from_json",
    "candidate_shardings", "clear_assignment_cache", "expand_assignment",
    "fits_budget",
    "load", "local_bytes", "pipeline_decisions",
    "registry_pipeline_problem", "registry_problem", "remap_assignment",
    "restrict_assignment", "search",
    "sharding_from_spec", "solve", "solve_jaxpr", "solve_jaxpr_cached",
    "solve_problem",
]
