"""Static plan verifier (a port of the JAX package's ``core/plan_verify.py``).

The optimizer (``plan_opt.py``) rewrites a :class:`~.plan.PartitionPlan` in
place and promises to keep a set of invariants.  :func:`verify_plan` checks
them in one linear walk over the step list, on every plan ``compile_plan``
returns unless the caller passes ``verify=False``:

**Dataflow.**  Every read is produced before it is used (a plan input, a
constant or an earlier step's write), which also certifies the schedule,
since the step list is the schedule; no key is written twice (SSA), none
shadows an input; every output key is produced.

**Specs.**  Every reshard step's program is replayed through the collective
simulator (``collective_planner.simulate``): it must take ``program.src`` to
``program.dst`` at its recorded ``cost_bytes``, on axes of the mesh.  Where
a reshard's input layout is known (plan inputs, earlier reshards, layout-
preserving collectives and aliases) it must equal ``program.src``, and known
output layouts must equal ``out_shardings``.  Collective axes must be in the
mesh; ppermute permutations must be (partial) permutations in range.

**Accounting.**  Non-negative flops, write bytes and dtype bytes;
non-negative counts in ``plan.stats``, and counts equal to a recount from
the step list (reshard programs, standalone and fused collectives, and the
collectives each compute step records that it runs inside itself);
``stats.steps`` the step count; ``opt_report.wire_bytes_after`` and
``plan.peak_bytes`` equal to fresh recomputations.

**Scan bodies.**  Every check recurses into each scan step's body plan
(``PlanStep.inner``), with the step's path in the message: the body's own
dataflow, specs and accounting, its stats against its own recount (the
outer plan's recount counts the body at trip count, as ``PlanStats``
does), a non-negative trip count, and the step's ``transient_bytes``
equal to the body's peak.

Failures raise :class:`PlanVerifyError` with every violation found.
:func:`verify_state_reshard` checks a cross-topology restore's
:class:`~.plan.StateReshardPlan`: each leaf's shardings on the plan's mesh
and its program replayed from source to target at its recorded cost.
The simulation of a program is cached per (program, local shape, element
size): a train plan holds thousands of reshards of a few hundred distinct
programs.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

from .collective_planner import PlanError, simulate
from .plan import is_env_key

# how many plans this process verified and how many violations were found
# (violations also raise, so a clean run reports 0)
_TELEMETRY = {"plans_verified": 0, "violations": 0}

_REL_TOL = 1e-3  # byte-accounting tolerance (float accumulation order)

_SIMULATED: Dict[tuple, object] = {}  # (program, lshape, dbytes) -> cost or PlanError


def verify_enabled(flag: Optional[bool]) -> bool:
    """Resolve a tri-state ``verify=``: None and True verify, False does not."""
    return True if flag is None else bool(flag)


def verify_telemetry() -> Dict[str, int]:
    return dict(_TELEMETRY)


class PlanVerifyError(PlanError):
    """A compiled plan failed static verification."""

    def __init__(self, violations: List[str]):
        self.violations = list(violations)
        head = "\n  - ".join(self.violations[:20])
        more = len(self.violations) - 20
        super().__init__(f"plan verification failed ({len(self.violations)} violation(s)):"
                         f"\n  - {head}" + (f"\n  … and {more} more" if more > 0 else ""))


@dataclasses.dataclass
class VerifyReport:
    """What one :func:`verify_plan` call covered."""

    plans: int = 0
    steps: int = 0
    violations: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations


def _close(a: float, b: float, rel: float = _REL_TOL) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1.0)


def _simulated(prog, lshape: Tuple[int, ...], dbytes: int):
    """The program's simulated cost (or the PlanError it raises), cached."""
    key = (prog, lshape, dbytes)
    got = _SIMULATED.get(key)
    if got is None:
        try:
            got = simulate(prog.src, prog.dst, list(prog.steps), lshape, dbytes)
        except PlanError as e:
            got = e
        if len(_SIMULATED) > 65536:
            _SIMULATED.clear()
        _SIMULATED[key] = got
    return got


def _check_perm(perm, axis_size: int, where: str, out: List[str]) -> None:
    """A ppermute's perm must be a partial permutation of [0, axis_size)."""
    if perm is None:
        out.append(f"{where}: ppermute step carries no perm in call metadata")
        return
    srcs = [p[0] for p in perm]
    dsts = [p[1] for p in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        out.append(f"{where}: perm {perm} is not a permutation "
                   "(duplicate source or destination)")
    bad = [p for p in perm if not (0 <= p[0] < axis_size and 0 <= p[1] < axis_size)]
    if bad:
        out.append(f"{where}: perm entries {bad} out of range for axis size {axis_size}")


def _recount(plan) -> Dict[str, int]:
    """``PlanStats.collectives`` as the step list implies it (scan bodies at
    trip count)."""
    n: Dict[str, int] = collections.Counter()
    for s in plan.steps:
        if s.inner is not None:
            for kind, k in _recount(s.inner).items():
                n[kind] += s.call.get("trips", 1) * k
        if s.kind == "reshard" and s.program is not None:
            for ps in s.program.steps:
                n[ps.op.replace("_", "-")] += 1
        elif s.kind == "collective":
            if s.op == "ppermute":
                n["collective-permute"] += 1
            else:
                n["all-reduce"] += len(s.axes)
        elif s.kind == "fused":
            n[s.op] += 1
        for kind, k in s.collectives.items():
            n[kind] += k
    return n


def _accounting_checks(plan, out: List[str], path: str = "") -> None:
    from .plan import plan_peak_bytes
    from .plan_opt import whole_wire_bytes

    stats = {k: v for k, v in plan.stats.collectives.items() if v}
    for kind, v in stats.items():
        if v < 0:
            out.append(f"{path}stats: negative planned-collective count {kind}={v} "
                       "(double removal in an optimizer pass)")
    recount = {k: v for k, v in _recount(plan).items() if v}
    for kind in sorted(set(stats) | set(recount)):
        if stats.get(kind, 0) != recount.get(kind, 0):
            out.append(f"{path}stats: planned-collective count {kind}={stats.get(kind, 0)} but "
                       f"the step list runs {recount.get(kind, 0)} (a dropped or doubled step, or "
                       "a compute step's recorded collectives changed)")
    if plan.stats.steps != len(plan.steps):
        out.append(f"{path}stats: steps={plan.stats.steps} but the plan has {len(plan.steps)}")
    rep = plan.opt_report
    if rep is not None:
        try:
            recomputed = whole_wire_bytes(plan)
        except Exception as e:  # an unpriceable step (e.g. a bogus axis) is its own finding
            out.append(f"{path}accounting: whole-program bytes not recomputable ({e})")
        else:
            if not _close(recomputed, rep.wire_bytes_after):
                out.append(f"{path}accounting: opt_report.wire_bytes_after "
                           f"{rep.wire_bytes_after:.1f} != recomputed whole-program bytes "
                           f"{recomputed:.1f} (steps mutated after optimization?)")
    if plan.peak_bytes:
        try:
            peak = plan_peak_bytes(plan)
        except Exception as e:
            out.append(f"{path}accounting: liveness peak not recomputable ({e})")
        else:
            if not _close(peak, plan.peak_bytes):
                out.append(f"{path}accounting: plan.peak_bytes {plan.peak_bytes:.1f} != "
                           f"recomputed liveness peak {peak:.1f}")
    for i, s in enumerate(plan.steps):
        if s.inner is not None:
            where = f"{path}step[{i}] (scan)"
            if not _close(s.transient_bytes, s.inner.peak_bytes):
                out.append(f"{where}: transient_bytes {s.transient_bytes:.1f} != the body "
                           f"plan's peak {s.inner.peak_bytes:.1f}")
            _accounting_checks(s.inner, out, f"{where}.inner.")


def _verify_body(plan, report: VerifyReport, path: str = "") -> None:
    report.plans += 1
    out = report.violations
    mesh = plan.mesh
    axis_names = set(mesh.axis_names)
    defined = {id(v) for v in plan.invars} | {id(v) for v in plan.consts}
    known_sh: Dict[int, Tuple] = {id(v): s.dims_mapping
                                  for v, s in zip(plan.invars, plan.in_shardings)}
    for i, step in enumerate(plan.steps):
        report.steps += 1
        where = f"{path}step[{i}] ({step.kind}:{step.op or '?'})"
        # -- dataflow ---------------------------------------------------------
        for r in step.reads:
            if id(r) not in defined:
                out.append(f"{where}: reads {r!r} before it is produced (dangling or "
                           "reordered past its producer)")
        for w in step.writes:
            if id(w) in defined:
                out.append(f"{where}: writes {w!r} twice (SSA violation / shadows a plan "
                           "input)")
            defined.add(id(w))
        # -- cost sanity ------------------------------------------------------
        if step.flops < 0:
            out.append(f"{where}: negative flops {step.flops}")
        if step.dbytes < 0:
            out.append(f"{where}: negative dbytes {step.dbytes}")
        if any(b < 0 for b in step.wbytes):
            out.append(f"{where}: negative write bytes {step.wbytes}")
        if any(k < 0 for k in step.collectives.values()):
            out.append(f"{where}: negative recorded collectives {step.collectives}")
        if step.transient_bytes < 0:
            out.append(f"{where}: negative transient_bytes {step.transient_bytes}")
        if step.inner is not None:
            if step.call.get("trips", 1) < 0:
                out.append(f"{where}: negative trip count {step.call.get('trips')}")
            _verify_body(step.inner, report, f"{where}.inner.")
        # -- kind-specific spec checks ---------------------------------------
        if step.kind == "reshard" and step.program is not None:
            prog = step.program
            for ps in prog.steps:
                if ps.axis not in axis_names:
                    out.append(f"{where}: program step {ps.op} uses axis '{ps.axis}' not in "
                               f"mesh {mesh.axis_names}")
            src_known = known_sh.get(id(step.reads[0])) if step.reads else None
            if src_known is not None and src_known != prog.src.dims_mapping:
                out.append(f"{where}: input layout {src_known} disagrees with program.src "
                           f"{prog.src.dims_mapping}")
            lshape = tuple(step.lshape)
            if len(lshape) == prog.src.rank and all(ps.axis in axis_names
                                                    for ps in prog.steps):
                cost = _simulated(prog, lshape, step.dbytes or 1)
                if isinstance(cost, PlanError):
                    out.append(f"{where}: program does not reach its dst ({cost})")
                elif step.dbytes and not _close(cost, prog.cost_bytes):
                    out.append(f"{where}: recorded cost_bytes {prog.cost_bytes:.1f} != "
                               f"simulated {cost:.1f}")
            if step.writes:
                known_sh[id(step.writes[0])] = prog.dst.dims_mapping
        elif step.kind in ("collective", "fused"):
            for a in step.axes:
                if a not in axis_names:
                    out.append(f"{where}: {step.kind} axis '{a}' not in mesh "
                               f"{mesh.axis_names}")
            if step.op in ("ppermute", "fused-ppermute"):
                n = mesh.axis_size(step.axes[0]) if step.axes and step.axes[0] in axis_names \
                    else 1
                _check_perm(step.call.get("perm"), n, where, out)
            elif step.reduce_op not in ("add", "max", "min") and step.op != "fused-all-gather":
                out.append(f"{where}: unknown reduce_op '{step.reduce_op}'")
            if step.kind == "fused" and len(step.reads) != len(step.writes):
                out.append(f"{where}: fused step arity mismatch ({len(step.reads)} reads, "
                           f"{len(step.writes)} writes)")
            # a reduction or permutation moves data but keeps the layout
            if step.kind == "collective" and step.reads and step.writes:
                k = known_sh.get(id(step.reads[0]))
                if k is not None:
                    known_sh[id(step.writes[0])] = k
        elif (step.kind == "compute" and step.op in ("alias", "annotate")
              and len(step.reads) == 1 and len(step.writes) == 1):
            k = known_sh.get(id(step.reads[0]))
            if k is not None:
                known_sh[id(step.writes[0])] = k
    # -- outputs --------------------------------------------------------------
    for idx, k in enumerate(plan.out_keys):
        if not is_env_key(k):
            continue
        if id(k) not in defined:
            out.append(f"{path}out_keys[{idx}]: {k!r} is never produced")
        known = known_sh.get(id(k))
        if idx < len(plan.out_shardings) and plan.out_shardings[idx] is not None:
            want = plan.out_shardings[idx].dims_mapping
            if known is not None and known != want:
                out.append(f"{path}out_keys[{idx}]: layout {known} disagrees with out_shardings "
                           f"{want}")
    if len(plan.out_keys) != len(plan.out_shardings):
        out.append(f"{path}out_keys/out_shardings length mismatch ({len(plan.out_keys)} vs "
                   f"{len(plan.out_shardings)})")


def verify_plan(plan, strict: bool = True) -> VerifyReport:
    """Statically verify one compiled :class:`PartitionPlan` (executable,
    cost-only, optimized, guarded or raw).  With ``strict`` raise
    :class:`PlanVerifyError` on any violation; otherwise return the
    :class:`VerifyReport`."""
    report = VerifyReport()
    _verify_body(plan, report)
    _accounting_checks(plan, report.violations)
    _TELEMETRY["plans_verified"] += 1
    if report.violations:
        _TELEMETRY["violations"] += len(report.violations)
        if strict:
            raise PlanVerifyError(report.violations)
    return report


def verify_state_reshard(plan, strict: bool = True) -> VerifyReport:
    """Verify a :class:`~.plan.StateReshardPlan` (a cross-topology restore).

    Per leaf: the source and target shardings live on the plan's mesh with
    rank matching the global shape, and the leaf's program replays through
    the simulator from ``src`` to ``dst`` at its recorded cost.
    """
    from .plan import dtype_bytes
    from .reshard import shard_shape

    report = VerifyReport()
    report.plans = 1
    out = report.violations
    axis_names = set(plan.mesh.axis_names)
    for leaf in plan.leaves:
        report.steps += 1
        where = f"leaf '{leaf.key}'"
        for s, nm in ((leaf.src, "src"), (leaf.dst, "dst")):
            if s.rank != len(leaf.global_shape):
                out.append(f"{where}: {nm} rank {s.rank} != shape rank "
                           f"{len(leaf.global_shape)}")
            for dim_axes in s.dims_mapping:
                for a in dim_axes:
                    if a not in axis_names:
                        out.append(f"{where}: {nm} uses axis '{a}' not in "
                                   f"mesh {plan.mesh.axis_names}")
        if leaf.program.cost_bytes < 0:
            out.append(f"{where}: negative cost_bytes {leaf.program.cost_bytes}")
        if leaf.program.src.dims_mapping != leaf.src.dims_mapping:
            out.append(f"{where}: program.src {leaf.program.src.dims_mapping} disagrees with "
                       f"leaf src {leaf.src.dims_mapping}")
        if leaf.program.dst.dims_mapping != leaf.dst.dims_mapping:
            out.append(f"{where}: program.dst {leaf.program.dst.dims_mapping} disagrees with "
                       f"leaf dst {leaf.dst.dims_mapping}")
        local = shard_shape(leaf.global_shape, leaf.src)
        try:
            cost = simulate(leaf.src, leaf.dst, list(leaf.program.steps), local,
                            dtype_bytes(leaf.dtype))
            if not _close(cost, leaf.program.cost_bytes):
                out.append(f"{where}: recorded cost_bytes {leaf.program.cost_bytes:.1f} != "
                           f"simulated {cost:.1f}")
        except PlanError as e:
            out.append(f"{where}: program does not reach its dst ({e})")
    _TELEMETRY["plans_verified"] += 1
    if report.violations:
        _TELEMETRY["violations"] += len(report.violations)
        if strict:
            raise PlanVerifyError(report.violations)
    return report
