"""Cost-model-driven reshard planning (paper §4.2, §4.5).

A port of the JAX package's ``core/collective_planner.py``: the planning
half is the same pure Python (shardings and static shapes only) and must
return the same programs; ``execute_program`` replays a program on the
stacked shards of the simulated mesh (``core/mesh_runtime.py``).

For every sharding transition the planner picks the cheapest valid
collective sequence (AllToAll when a mesh axis merely moves between tensor
dims, DynamicSlice before AllGather so gathered operands are as small as
possible), minimising the roofline wire-byte model
(:func:`repro_torch.analysis.roofline.collective_wire_bytes`).

Candidate enumeration
---------------------
``plan_reshard`` builds up to three candidate programs and keeps the cheapest
that validates under simulation:

* **optimized** — greedy with a strict preference order DynamicSlice >
  AllToAll > AllGather, which yields slice-before-gather ordering and direct
  dim-moves ((n-1)/n·B on the wire instead of AllGather's (n-1)·B).
* **legacy** — the historical greedy AllGather-first schedule (AllToAll only
  when already innermost, all gathers before any slice); kept both as a
  fallback for layouts the optimized generator cannot order and as a baseline.
* **gather-all** — replicate then re-slice; always valid, never cheapest
  unless the others fail.

All candidates are *simulated* step-by-step (sharding + local shape), so an
invalid program (precondition violation, non-divisible dim) is discarded
rather than executed.

Lattice search
--------------
For 3+-axis meshes and stacked/mixed dims, where step *ordering* changes
every later operand size, ``plan_reshard`` additionally runs a bounded
branch-and-bound over the step lattice (:func:`_candidate_search`): states
are (working sharding, local shape) nodes, moves are every legal
DynamicSlice/AllToAll/AllGather, the greedy winner is the incumbent, and
branches are pruned by accumulated wire bytes and state dominance.  The
search can only match or beat the greedy candidates; ``search=False`` (or
``LATTICE_SEARCH = False``) turns it off.
"""
from __future__ import annotations

import dataclasses
import threading as _threading
from typing import Dict, List, Optional, Tuple

from ..analysis.roofline import collective_wire_bytes
from . import mesh_runtime as mr
from .sharding import Sharding

# one collective step; ``dim`` is the tensor dim operated on.  For all_to_all,
# ``dim`` is the concat (source/gather) dim and ``dim2`` the split (dest) dim.
@dataclasses.dataclass(frozen=True)
class CollectiveStep:
    op: str  # "all_gather" | "all_to_all" | "dynamic_slice"
    axis: str
    dim: int
    dim2: int = -1

    def describe(self) -> str:
        if self.op == "all_to_all":
            return f"all-to-all({self.axis}:d{self.dim}->d{self.dim2})"
        kind = self.op.replace("_", "-")
        return f"{kind}({self.axis}:d{self.dim})"


@dataclasses.dataclass(frozen=True)
class ReshardProgram:
    src: Sharding
    dst: Sharding
    steps: Tuple[CollectiveStep, ...]
    cost_bytes: float  # modeled per-device wire bytes
    strategy: str  # which candidate generator produced it

    @property
    def is_identity(self) -> bool:
        return not self.steps

    def collectives(self) -> List[str]:
        return [s.describe() for s in self.steps]


class PlanError(Exception):
    """A candidate program violated a step precondition under simulation."""


# ---------------------------------------------------------------------------------
# simulation: apply one step to (sharding, local shape), validating preconditions
# ---------------------------------------------------------------------------------


def _apply_step(
    work: Sharding, shape: Tuple[int, ...], step: CollectiveStep
) -> Tuple[Sharding, Tuple[int, ...]]:
    mesh = work.mesh
    n = mesh.axis_size(step.axis)
    shape = list(shape)
    if step.op == "all_gather":
        dm = work.dims_mapping[step.dim]
        if not dm or dm[-1] != step.axis:
            raise PlanError(f"all_gather: {step.axis} not innermost on d{step.dim}")
        work = work.with_dim(step.dim, dm[:-1])
        shape[step.dim] *= n
    elif step.op == "all_to_all":
        dm = work.dims_mapping[step.dim]
        if not dm or dm[-1] != step.axis:
            raise PlanError(f"all_to_all: {step.axis} not innermost on d{step.dim}")
        if shape[step.dim2] % n:
            raise PlanError(f"all_to_all: d{step.dim2} not divisible by {n}")
        work = work.with_dim(step.dim, dm[:-1])
        work = work.with_dim(step.dim2, work.dims_mapping[step.dim2] + (step.axis,))
        shape[step.dim] *= n
        shape[step.dim2] //= n
    elif step.op == "dynamic_slice":
        if step.axis in work.sharded_axes:
            raise PlanError(f"dynamic_slice: {step.axis} still sharding data")
        if shape[step.dim] % n:
            raise PlanError(f"dynamic_slice: d{step.dim} not divisible by {n}")
        work = work.with_dim(step.dim, work.dims_mapping[step.dim] + (step.axis,))
        shape[step.dim] //= n
    else:
        raise PlanError(f"unknown op {step.op}")
    return work, tuple(shape)


def _nbytes(shape: Tuple[int, ...], dtype_bytes: int) -> float:
    b = float(dtype_bytes)
    for s in shape:
        b *= s
    return b


_STEP_KIND = {
    "all_gather": "all-gather",
    "all_to_all": "all-to-all",
    "dynamic_slice": "dynamic-slice",
}


def simulate(
    src: Sharding,
    dst: Sharding,
    steps: List[CollectiveStep],
    local_shape: Tuple[int, ...],
    dtype_bytes: int,
) -> float:
    """Validate ``steps`` takes src to dst; return modeled wire bytes."""
    work, shape = src, tuple(local_shape)
    cost = 0.0
    for step in steps:
        n = work.mesh.axis_size(step.axis)
        cost += collective_wire_bytes(_STEP_KIND[step.op], n, _nbytes(shape, dtype_bytes))
        work, shape = _apply_step(work, shape, step)
    if work.dims_mapping != dst.dims_mapping:
        raise PlanError(f"program ends at {work}, wanted {dst}")
    return cost


# ---------------------------------------------------------------------------------
# candidate generators
# ---------------------------------------------------------------------------------


def _axis_dim_map(s: Sharding) -> Dict[str, Tuple[int, int]]:
    out = {}
    for d, axes in enumerate(s.dims_mapping):
        for k, a in enumerate(axes):
            out[a] = (d, k)
    return out


def _candidate_optimized(
    src: Sharding, dst: Sharding, local_shape: Tuple[int, ...]
) -> Optional[List[CollectiveStep]]:
    """Greedy with preference DynamicSlice > AllToAll > AllGather.

    Invariant maintained: a dim whose working axes are a prefix of its target
    axes only ever *grows* toward the target (slice/a2a append at the end); a
    dim holding axes that must leave only ever *shrinks* (pops at the end).
    Stacked-axis tuples are ordered major-to-minor, and tiled collectives
    operate on the innermost (last) position, so append/pop-at-end is exactly
    what the hardware ops do.
    """
    work = src
    shape = list(local_shape)
    dst_map = _axis_dim_map(dst)
    steps: List[CollectiveStep] = []
    for _ in range(8 * (len(dst_map) + len(_axis_dim_map(src)) + 1)):
        if work.dims_mapping == dst.dims_mapping:
            return steps
        used = set(work.sharded_axes)
        progressed = False
        # 1) slices: dims whose working tuple is a proper prefix of the target
        #    tuple and whose next needed axis is currently free.  Zero wire
        #    bytes and shrinks the operand for every later collective.
        for d in range(work.rank):
            wd, td = work.dims_mapping[d], dst.dims_mapping[d]
            if len(wd) < len(td) and td[: len(wd)] == wd:
                a = td[len(wd)]
                n = work.mesh.axis_size(a)
                if a not in used and shape[d] % n == 0:
                    steps.append(CollectiveStep("dynamic_slice", a, d))
                    work, shp = _apply_step(work, tuple(shape), steps[-1])
                    shape = list(shp)
                    progressed = True
        if progressed:
            continue
        # 2) all-to-all: an innermost axis that is the next needed axis of a
        #    *different* prefix-aligned dim moves directly.
        for d in range(work.rank):
            wd = work.dims_mapping[d]
            if not wd:
                continue
            a = wd[-1]
            td = dst.dims_mapping[d]
            if td[: len(wd)] == wd:
                continue  # a is already placed correctly; leave it alone
            tgt = dst_map.get(a)
            if tgt is None:
                continue
            e, k = tgt
            we = work.dims_mapping[e]
            if e != d and len(we) == k and dst.dims_mapping[e][:k] == we:
                n = work.mesh.axis_size(a)
                if shape[e] % n == 0:
                    steps.append(CollectiveStep("all_to_all", a, d, e))
                    work, shp = _apply_step(work, tuple(shape), steps[-1])
                    shape = list(shp)
                    progressed = True
                    break
        if progressed:
            continue
        # 3) gather: pop one misplaced innermost axis (reintroduced later by a
        #    slice if the target still wants it somewhere).
        for d in range(work.rank):
            wd, td = work.dims_mapping[d], dst.dims_mapping[d]
            if wd and td[: len(wd)] != wd:
                steps.append(CollectiveStep("all_gather", wd[-1], d))
                work, shp = _apply_step(work, tuple(shape), steps[-1])
                shape = list(shp)
                progressed = True
                break
        if not progressed:
            return None  # stuck (e.g. non-divisible slice target)
    return None


def _candidate_legacy(
    src: Sharding, dst: Sharding, local_shape: Tuple[int, ...]
) -> Optional[List[CollectiveStep]]:
    """The historical greedy schedule: a2a moves (gathering stacked inner axes
    first), then AllGather every axis absent from the target, then slices.
    Serves as the baseline the cost model must beat and as a fallback."""
    steps: List[CollectiveStep] = []
    work = src
    shape = list(local_shape)

    def apply(step):
        nonlocal work, shape
        steps.append(step)
        work, shp = _apply_step(work, tuple(shape), step)
        shape = list(shp)

    try:
        cur_map = _axis_dim_map(work)
        tgt_map = _axis_dim_map(dst)
        for a, (di, _) in sorted(cur_map.items()):
            if a in tgt_map and tgt_map[a][0] != di:
                dj = tgt_map[a][0]
                while work.dims_mapping[di] and work.dims_mapping[di][-1] != a:
                    apply(CollectiveStep("all_gather", work.dims_mapping[di][-1], di))
                apply(CollectiveStep("all_to_all", a, di, dj))
        for a in sorted(_axis_dim_map(work)):
            if a not in tgt_map:
                live = _axis_dim_map(work)
                if a not in live:
                    continue  # already gathered as someone's stacked inner axis
                di = live[a][0]
                while work.dims_mapping[di][-1] != a:
                    apply(CollectiveStep("all_gather", work.dims_mapping[di][-1], di))
                apply(CollectiveStep("all_gather", a, di))
        for d in range(dst.rank):
            for a in dst.dims_mapping[d]:
                if a not in _axis_dim_map(work):
                    apply(CollectiveStep("dynamic_slice", a, d))
        if work.dims_mapping != dst.dims_mapping:
            return None
        return steps
    except PlanError:
        return None


def _candidate_gather_all(
    src: Sharding, dst: Sharding, local_shape: Tuple[int, ...]
) -> Optional[List[CollectiveStep]]:
    """Replicate fully, then slice to the target.  Always expressible."""
    steps: List[CollectiveStep] = []
    work = src
    shape = list(local_shape)
    for d in range(work.rank):
        for a in reversed(work.dims_mapping[d]):
            steps.append(CollectiveStep("all_gather", a, d))
            work, shp = _apply_step(work, tuple(shape), steps[-1])
            shape = list(shp)
    for d in range(dst.rank):
        for a in dst.dims_mapping[d]:
            n = work.mesh.axis_size(a)
            if shape[d] % n:
                return None
            steps.append(CollectiveStep("dynamic_slice", a, d))
            work, shp = _apply_step(work, tuple(shape), steps[-1])
            shape = list(shp)
    return steps


_CANDIDATES = (
    ("optimized", _candidate_optimized),
    ("legacy", _candidate_legacy),
    ("gather-all", _candidate_gather_all),
)

# lattice search tuning: the search is exact up to these bounds, then falls
# back to the greedy incumbent.  A few thousand nodes covers every 3-axis
# stacked layout in the test grid in well under a millisecond.
LATTICE_SEARCH = True
SEARCH_NODE_BUDGET = 4096

# telemetry: how often the bounded search actually hits its bounds.  Guarded
# by a lock: planning may run from several threads.
_TELEMETRY_LOCK = _threading.Lock()
_TELEMETRY = {"searches": 0, "node_cap_hits": 0, "depth_cap_hits": 0}


def search_telemetry() -> Dict[str, int]:
    """Snapshot of the process-wide lattice-search counters (monotone since
    process start or the last :func:`reset_search_telemetry`)."""
    with _TELEMETRY_LOCK:
        return dict(_TELEMETRY)


def reset_search_telemetry() -> None:
    with _TELEMETRY_LOCK:
        for k in _TELEMETRY:
            _TELEMETRY[k] = 0


def _record_search(node_cap: bool, depth_cap: bool) -> None:
    with _TELEMETRY_LOCK:
        _TELEMETRY["searches"] += 1
        _TELEMETRY["node_cap_hits"] += int(node_cap)
        _TELEMETRY["depth_cap_hits"] += int(depth_cap)


def _search_worthwhile(src: Sharding, dst: Sharding) -> bool:
    """Gate: greedy is provably fine on 1-2 plain axes; search only pays on
    3+-axis or stacked/mixed layouts (Automap/PartIR)."""
    axes = set(src.sharded_axes) | set(dst.sharded_axes)
    stacked = any(
        len(t) >= 2 for t in src.dims_mapping + dst.dims_mapping
    )
    return len(axes) >= 3 or (stacked and len(axes) >= 2)


def _search_moves(
    work: Sharding, shape: Tuple[int, ...], dst: Sharding
) -> List[CollectiveStep]:
    """Every legal single step from a search state.

    Slices only extend a dim toward its target prefix (a slice anywhere else
    must be undone by a priced gather later, so it can never improve on the
    same program without it); AllToAll moves any innermost axis to any
    divisible dim (detours through a third dim are how search beats greedy);
    AllGather pops any innermost axis.
    """
    moves: List[CollectiveStep] = []
    used = set(work.sharded_axes)
    for d in range(work.rank):
        wd, td = work.dims_mapping[d], dst.dims_mapping[d]
        if len(wd) < len(td) and td[: len(wd)] == wd:
            a = td[len(wd)]
            if a not in used and shape[d] % work.mesh.axis_size(a) == 0:
                moves.append(CollectiveStep("dynamic_slice", a, d))
    for d in range(work.rank):
        wd = work.dims_mapping[d]
        if not wd:
            continue
        a = wd[-1]
        n = work.mesh.axis_size(a)
        for e in range(work.rank):
            if e != d and shape[e] % n == 0:
                moves.append(CollectiveStep("all_to_all", a, d, e))
        moves.append(CollectiveStep("all_gather", a, d))
    return moves


def _candidate_search(
    src: Sharding,
    dst: Sharding,
    local_shape: Tuple[int, ...],
    dtype_bytes: int,
    incumbent_cost: float,
) -> Optional[List[CollectiveStep]]:
    """Bounded branch-and-bound over step interleavings.

    The greedy winner's cost is the incumbent: any branch whose accumulated
    wire bytes reach it is cut (wire cost is monotone in steps, so 0 is an
    admissible bound on the remainder).  Dominance pruning drops states
    already reached at equal-or-lower cost.  Returns a strictly cheaper step
    list or None.
    """
    best_cost = incumbent_cost
    best_steps: Optional[List[CollectiveStep]] = None
    budget = SEARCH_NODE_BUDGET
    max_depth = 2 * (len(set(src.sharded_axes) | set(dst.sharded_axes)) + 1) + 2
    depth_cap_hit = False
    seen: Dict[Tuple, float] = {}
    stack: List[Tuple[Sharding, Tuple[int, ...], float, Tuple[CollectiveStep, ...]]] = [
        (src, tuple(local_shape), 0.0, ())
    ]
    while stack and budget > 0:
        work, shape, cost, steps = stack.pop()
        budget -= 1
        if work.dims_mapping == dst.dims_mapping:
            if cost < best_cost - 1e-9:
                best_cost, best_steps = cost, list(steps)
            continue
        if len(steps) >= max_depth:
            depth_cap_hit = True
            continue
        key = (work.dims_mapping, shape)
        prev = seen.get(key)
        if prev is not None and prev <= cost + 1e-9:
            continue
        seen[key] = cost
        for mv in _search_moves(work, shape, dst):
            n = work.mesh.axis_size(mv.axis)
            c = collective_wire_bytes(
                _STEP_KIND[mv.op], n, _nbytes(shape, dtype_bytes)
            )
            if cost + c >= best_cost - 1e-9:
                continue  # prune: remaining steps cost >= 0
            try:
                w2, s2 = _apply_step(work, shape, mv)
            except PlanError:
                continue
            stack.append((w2, s2, cost + c, steps + (mv,)))
    _record_search(node_cap=budget == 0 and bool(stack), depth_cap=depth_cap_hit)
    return best_steps


def plan_reshard(
    src: Sharding,
    dst: Sharding,
    local_shape: Tuple[int, ...],
    dtype_bytes: int = 4,
    search: Optional[bool] = None,
) -> ReshardProgram:
    """Choose the cheapest valid collective sequence taking ``src`` to ``dst``.

    ``local_shape`` is the per-device shard shape under ``src`` (what the
    collectives actually move); costs are roofline wire bytes per device.
    ``search`` overrides the module-level ``LATTICE_SEARCH`` toggle for the
    branch-and-bound refinement pass (None = use the toggle).
    """
    if not src.rank == dst.rank == len(local_shape):
        raise ValueError(f"plan_reshard: ranks of {src}, {dst} and {local_shape} differ")
    if src.dims_mapping == dst.dims_mapping:
        return ReshardProgram(src, dst, (), 0.0, "identity")
    best: Optional[ReshardProgram] = None
    for name, gen in _CANDIDATES:
        steps = gen(src, dst, tuple(local_shape))
        if steps is None:
            continue
        try:
            cost = simulate(src, dst, steps, tuple(local_shape), dtype_bytes)
        except PlanError:
            continue
        if best is None or cost < best.cost_bytes:
            best = ReshardProgram(src, dst, tuple(steps), cost, name)
    if best is None:
        raise PlanError(f"no valid reshard program {src} -> {dst} @ {local_shape}")
    do_search = LATTICE_SEARCH if search is None else search
    if do_search and _search_worthwhile(src, dst):
        steps = _candidate_search(
            src, dst, tuple(local_shape), dtype_bytes, best.cost_bytes
        )
        if steps is not None:
            try:
                cost = simulate(src, dst, steps, tuple(local_shape), dtype_bytes)
                if cost < best.cost_bytes:
                    best = ReshardProgram(src, dst, tuple(steps), cost, "lattice")
            except PlanError:  # pragma: no cover - search simulates every step
                pass
    return best



def execute_program(x, prog: ReshardProgram):
    """Replay a planned reshard on the stacked shards ``x`` of ``prog.src``."""
    mesh = prog.src.mesh
    for step in prog.steps:
        if step.op == "all_gather":
            x = mr.all_gather(x, mesh, step.axis, step.dim)
        elif step.op == "all_to_all":
            x = mr.all_to_all(x, mesh, step.axis, split_dim=step.dim2, concat_dim=step.dim)
        elif step.op == "dynamic_slice":
            x = mr.dynamic_slice_by_axis_index(x, mesh, step.axis, step.dim)
        else:  # pragma: no cover
            raise PlanError(f"unknown op {step.op}")
    return x
