"""Pipeline schedule cost model (GSPMD §3.3).

A port of the JAX package's ``pipeline/schedule.py``.  The stage-stacked
pipeline executes ``T = M + S − 1`` ticks for ``M`` microbatches over ``S``
stages; every tick runs all stages (one vmapped body over the stage dim),
so ``S − 1`` ticks' worth of slots compute garbage: the bubble,

    bubble_fraction(S, M) = (S − 1) / (M + S − 1).

The compute inflation shows in ``PlanCost`` by itself (the tick scan's
FLOPs at trip count are ``(1 + bubble)`` times the useful work), and the
per-tick collectives (one boundary ppermute per shifting-buffer leaf, one
psum for the output collection) are priced there whole-program too.  This
module adds the analytic vocabulary on top: bubble fraction, tick count,
ppermute wire bytes, per-microbatch activation memory, as a
:class:`ScheduleCost` around the plan's :class:`~repro_torch.core.plan
.PlanCost`.

:class:`PipelineConfig` bounds the autoshard search over pipelining
(``autoshard.solve(..., pipeline=PipelineConfig(max_stages=4))``);
:class:`PipelineDecision` is one point of that decision space (the mesh
axis that carries the stage dim, the number of stages and of
microbatches), enumerated by ``autoshard.space.pipeline_decisions`` and
priced jointly with the tensor-sharding assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Pipeline decision-variable bounds for the autoshard search.

    ``max_stages`` caps the stage count; ``num_microbatches`` pins M (or
    ``None`` to search ``microbatch_options``); ``stage_axes`` restricts
    which mesh axes may carry the stage dim (``None``: any).  Stage counts
    are multiples of the chosen axis size (even local stage rows) that
    divide the layer count.
    """

    max_stages: int = 4
    num_microbatches: Optional[int] = None
    microbatch_options: Tuple[int, ...] = (2, 4)
    stage_axes: Optional[Tuple[str, ...]] = None

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PipelineDecision:
    """One point in the pipeline decision space."""

    stage_axis: str
    num_stages: int
    num_microbatches: int

    @property
    def ticks(self) -> int:
        return pipeline_ticks(self.num_stages, self.num_microbatches)

    @property
    def bubble(self) -> float:
        return bubble_fraction(self.num_stages, self.num_microbatches)

    def as_dict(self) -> Dict:
        return {
            "stage_axis": self.stage_axis,
            "num_stages": self.num_stages,
            "num_microbatches": self.num_microbatches,
            "ticks": self.ticks,
            "bubble_fraction": self.bubble,
        }


def pipeline_ticks(num_stages: int, num_microbatches: int) -> int:
    """GPipe schedule length: M + S − 1 shifting-buffer ticks."""
    return num_microbatches + num_stages - 1


def bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Idle-slot share of the stage × tick grid: (S − 1) / (M + S − 1)."""
    return (num_stages - 1) / float(pipeline_ticks(num_stages, num_microbatches))


def plan_ppermute_bytes(plan) -> Tuple[float, int]:
    """(whole-program ppermute wire bytes, launches) of a lowered plan: body
    plans at trip count, fused ppermutes included."""
    from ..core.plan_opt import _collective_step_wire_bytes

    total, launches = 0.0, 0
    for s in plan.steps:
        if s.kind == "collective" and s.op == "ppermute":
            total += _collective_step_wire_bytes(plan.mesh, s)
            launches += 1
        elif s.kind == "fused" and s.op == "fused-ppermute":
            total += s.wire_bytes
            launches += 1
        if s.inner is not None:
            b, n = plan_ppermute_bytes(s.inner)
            trips = s.call.get("trips", 1)
            total += trips * b
            launches += trips * n
    return total, launches


@dataclasses.dataclass
class ScheduleCost:
    """Analytic schedule terms around one pipelined plan's ``PlanCost``.

    ``ppermute_bytes`` / ``ppermute_launches`` are whole-program (per tick
    × ticks); ``microbatch_activation_bytes`` is the shifting buffer's
    per-device live size, the memory the microbatch split buys back against
    the full-batch activation; ``total_s`` is the plan's objective (which
    already holds the bubble-inflated compute and the tick-multiplied
    collectives)."""

    decision: PipelineDecision
    ppermute_bytes: float
    ppermute_launches: int
    microbatch_activation_bytes: float
    plan_cost: Optional[object] = None  # PlanCost of the pipelined plan

    @property
    def bubble(self) -> float:
        return self.decision.bubble

    @property
    def total_s(self) -> float:
        return self.plan_cost.total_s if self.plan_cost is not None else 0.0

    def as_dict(self) -> Dict:
        return {
            **self.decision.as_dict(),
            "ppermute_bytes": self.ppermute_bytes,
            "ppermute_launches": self.ppermute_launches,
            "microbatch_activation_bytes": self.microbatch_activation_bytes,
            "plan_cost": self.plan_cost.as_dict() if self.plan_cost is not None else None,
        }


def schedule_cost(captured, assignment, mesh, decision: PipelineDecision, *, profile,
                  state=None, verify: Optional[bool] = None) -> ScheduleCost:
    """Price one pipelined program: ``captured`` (``compat.capture`` of it,
    on fake or meta tensors) lowered cost-only and optimized under
    ``assignment`` (one ``Optional[Sharding]`` per input), priced by
    ``profile`` (a ``RooflineParams``: the port has no default constants),
    the ppermute traffic read off the plan, plus the analytic terms.

    ``state`` (the global shifting buffer, leading stage dim: a tensor, a
    meta one will do) sizes the per-device microbatch activation by its
    shape and dtype; omitted, it is 0.  The
    lowering runs the plan verifier (``verify=None``: the module default),
    as an executable plan's does."""
    from ..core.plan import lower_plan, plan_cost
    from ..core.reshard import shard_shape
    from ..core.sharding import Sharding

    plan = lower_plan(captured, list(assignment or []), mesh, verify=verify, profile=profile)
    pbytes, plaunches = plan_ppermute_bytes(plan)
    act = 0.0
    if state is not None:
        # the shifting buffer sharded on the stage axis: per-device live bytes
        s = Sharding(mesh, ((decision.stage_axis,),) + ((),) * (state.ndim - 1))
        act = float(state.element_size())
        for d in shard_shape(tuple(state.shape), s):
            act *= d
    return ScheduleCost(decision=decision, ppermute_bytes=pbytes, ppermute_launches=plaunches,
                        microbatch_activation_bytes=act, plan_cost=plan_cost(plan))
