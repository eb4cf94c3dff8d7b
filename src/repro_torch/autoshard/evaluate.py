"""Candidate scoring: cost-only lowering of one input-sharding assignment.

A port of the JAX package's ``autoshard/evaluate.py``.  A candidate
assignment (one ``Optional[Sharding]`` per input of a ``compat.Captured``
program) is scored by running the port's pipeline end to end in cost-only
mode: propagation completes the unseeded tensors, ``compile_plan`` lowers
with cost-model-chosen reshard programs, ``plan_opt`` runs CSE, DCE,
fusion and scheduling, and the resulting :class:`~repro_torch.core.plan
.PlanCost` is read: a max-of-terms roofline objective (the overlap time of
the per-device compute seconds and the collective seconds).  No program
is executed: every step runner of a cost-only plan is a raising stub.

The port has no default machine constants, so the evaluator prices with
``obs.profile.resolve_profile(profile)``: the argument, else
``$REPRO_TORCH_MACHINE_PROFILE``, else the committed H100 profile.

Assignments whose propagated program demands an inexpressible reshard
(``PlanError``), or whose modeled per-device live-memory peak exceeds the
budget, are infeasible: they score ``inf`` and the search discards them.
Cost-only lowerings are verified like executable ones, and a
``PlanVerifyError`` (an optimizer-pass fault, not a layout the planner
cannot express) is recorded with a distinct ``verify:`` reason.  Any other
exception propagates: it is a fault of the port, not a property of the
layout.  Evaluations are memoized by assignment, and the evaluator counts
lowerings.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.collective_planner import PlanError
from ..core.plan import PlanCost, lower_for_cost
from ..core.plan_verify import PlanVerifyError
from ..core.rules import aval
from ..core.sharding import Mesh
from ..obs import metrics as obs_metrics
from .space import MaybeSharding


@dataclasses.dataclass
class Evaluation:
    """One scored candidate.  ``cost`` is None when lowering failed."""

    cost: Optional[PlanCost]
    feasible: bool
    reason: str = ""

    @property
    def score(self) -> float:
        if not self.feasible or self.cost is None:
            return math.inf
        return self.cost.total_s


class Evaluator:
    """Memoizing cost-only evaluator for one (captured program, mesh, budget)
    problem.

    ``budget_bytes`` is the hard per-device constraint (over it:
    infeasible).  ``mem_weight`` / ``soft_budget_bytes`` switch on the
    memory term: overshoot above the soft budget is priced into the
    candidate's ``total_s`` (``PlanCost.mem_s``), so otherwise tied
    assignments rank by live memory.  Off by default (weight 0)."""

    def __init__(self, captured, mesh: Mesh, budget_bytes: Optional[float] = None,
                 optimize: bool = True, mem_weight: float = 0.0,
                 soft_budget_bytes: Optional[float] = None, profile=None):
        from ..obs.profile import resolve_profile

        self.captured = captured
        self.mesh = mesh
        self.budget_bytes = budget_bytes
        self.optimize = optimize
        self.mem_weight = mem_weight
        self.soft_budget_bytes = soft_budget_bytes
        self.profile = resolve_profile(profile)
        self.cache: Dict[tuple, Evaluation] = {}
        self.lowerings = 0  # actual (not memoized) cost lowerings

    def key(self, assignment: Sequence[MaybeSharding]) -> tuple:
        return tuple(s.dims_mapping if s is not None else None for s in assignment)

    def __call__(self, assignment: Sequence[MaybeSharding]) -> Evaluation:
        key = self.key(assignment)
        hit = self.cache.get(key)
        if hit is not None:
            return hit
        self.lowerings += 1
        obs_metrics.inc("autoshard.evals")
        t0 = time.perf_counter()
        try:
            cost = lower_for_cost(self.captured, list(assignment), self.mesh,
                                  optimize=self.optimize, profile=self.profile)
        except PlanVerifyError as e:
            # a PlanVerifyError is a PlanError too: caught first, it names an
            # optimizer-pass fault rather than an inexpressible layout
            ev = Evaluation(None, False, f"verify: {e}")
        except PlanError as e:
            ev = Evaluation(None, False, f"plan: {e}")
        else:
            if self.mem_weight and self.soft_budget_bytes is not None:
                cost = dataclasses.replace(cost, mem_weight=self.mem_weight,
                                           soft_budget_bytes=self.soft_budget_bytes)
            if self.budget_bytes is not None and cost.peak_bytes > self.budget_bytes:
                ev = Evaluation(cost, False, "over memory budget")
            else:
                ev = Evaluation(cost, True)
        obs_metrics.observe("autoshard.eval_ms", (time.perf_counter() - t0) * 1e3)
        self.cache[key] = ev
        return ev

    def invar_shapes(self) -> List[Tuple[int, ...]]:
        return [aval(v).shape for v in self.captured.invars]

    def invar_dtype_bytes(self) -> List[int]:
        return [aval(v).dtype.itemsize for v in self.captured.invars]
