"""Whole-program plan optimizer: passes over a lowered ``PartitionPlan``
(a port of the JAX package's ``core/plan_opt.py``).

The collective planner makes each reshard locally cost-optimal; this module
optimizes the whole partitioned program before it runs.  ``compile_plan``
runs :func:`optimize_plan` when ``optimize=True``; every price comes from
``plan.params`` (the ``profile`` given to ``compile_plan``), and with no
profile the pipeline raises: the port has no default constants.

Passes, in pipeline order (the reference's names and order):

1. **pjit inlining** (:func:`inline_pjit`) reports zero: ``make_fx``
   inlines every nested call as it captures, so a captured graph has no
   call boundary to dissolve; the pass keeps its place so that the report
   has the reference's schema.
2. **scan-invariant hoisting** (:func:`hoist_scan_invariants`): where a
   scan body's only use of a const is one reshard (the per-trip gather of a
   loop-invariant value), the reshard moves before the scan, runs once,
   and the body reads the resharded const.

Before the passes run on a plan they run on each of its scan body plans
(``PlanStep.inner``), innermost first; every count here prices a body at
its trip count, and a body plan's edits move its plan's ``PlanStats`` by
trip count too.
3. **reshard CSE** (:func:`reshard_cse`): identical (source value, target
   sharding) reshards across consumers run once; later readers read the
   first result.  A source resolves through free aliases to its root, and
   the target is keyed by the mesh's structural key and the dims mapping.
   A duplicate whose result is a plan output becomes a free alias.
4. **dead-reshard elimination** (:func:`dead_reshard_elim`): reshard steps
   (and free aliases) whose result nothing reads go, iterating backwards so
   that chains die together.
5. **output-alias sinking** (:func:`sink_output_aliases`): free aliases read
   only by the output epilogue move to its front, so that they stop pinning
   fusion buckets.
6. **collective fusion** (:func:`fuse_collectives`): same-key collectives on
   independent values become one launch over a concatenated buffer.  On
   stacked shards each member is flattened to (devices, -1), the members
   are concatenated on dim 1, one collective runs, and the result is split
   back: standalone psum/pmax/pmin steps (one bucket per axes, reduce op and
   dtype, so bf16 and float32 never share one), single-AllGather reshards,
   and ppermutes with one permutation.  A bucket is capped at
   ``analysis/roofline.py::fusion_bucket_bytes`` of the profile (or an
   explicit ``bucket_bytes``).
7. **overlap scheduling** (:func:`schedule_overlap`): a list schedule onto a
   two-resource (compute, interconnect) machine priced by the profile; it
   is pure reordering, deterministic for a given plan.  On the simulated
   mesh one stream runs products and collectives in series (the committed
   profile's ``overlap_efficiency`` is 0): one lane, and the plan keeps
   its order.

Under a one-lane profile, where the schedule keeps the order, CSE with DCE
and fusion are each undone where they raise the plan's modeled peak above
its peak before the passes (:func:`_within_peak`): under remat CSE would
keep the forward's gathers alive for the backward's recompute, and on one
stream nothing hides a collective, so the optimized plan costs no memory
that the unoptimized one does not.  A profile that overlaps keeps the
reference's passes as they are, so that their reports can be held against
the JAX package's.

Collectives a compute step runs inside itself (``PlanStep.collectives``: a
``LocalOp``'s decode combine, SSD-gradient psums, ``logsumexp`` and index-op
psums) stay inside their step: fusion cannot see them, but
:func:`whole_collective_launches` counts them, as ``PlanCost`` does.  A
product's reduce-scatter is left out of launches and bytes, as in the
reference (ROADMAP R9).

Pass-ordering invariants (the reference's): CSE before DCE (rewiring is
what orphans duplicates); alias sinking after CSE and before fusion;
fusion after every rewrite pass; scheduling last.  Every pass keeps SSA,
write-before-read order, the set of output writes and ``plan.stats``
(``PlanStats.remove_program`` for a removed reshard; fusion moves its
members' counts to the fused kind).  The verifier (``plan_verify.py``)
re-derives these on every plan ``compile_plan`` returns.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..analysis.roofline import (RooflineParams, collective_wire_bytes, fusion_bucket_bytes,
                                 overlap_time_s)
from . import mesh_runtime as mr
from .partitioner import COLLECTIVE
from .plan import (PartitionPlan, PlanStep, ProxyVar, _alias_run, _cost_only_run, is_env_key,
                   plan_peak_bytes)

__all__ = [
    "OptReport", "PassReport", "optimize_plan",
    "inline_pjit", "hoist_scan_invariants",
    "reshard_cse", "dead_reshard_elim", "sink_output_aliases",
    "fuse_collectives", "schedule_overlap",
    "count_collective_launches", "whole_wire_bytes", "whole_collective_launches",
    "step_features", "step_class", "modeled_timeline",
]


def _params(plan: PartitionPlan) -> RooflineParams:
    """The plan's machine profile: every price in this module comes from it."""
    if plan.params is None:
        raise ValueError(
            "optimize_plan: no machine profile (RooflineParams) to price the passes with: "
            "the port has no default constants; pass profile= to compile_plan / lower_plan "
            "/ spmd_partition")
    return plan.params


# ---------------------------------------------------------------------------------
# reporting
# ---------------------------------------------------------------------------------


@dataclasses.dataclass
class PassReport:
    name: str
    removed_steps: int = 0
    wire_bytes_saved: float = 0.0
    fused_buckets: int = 0
    fused_members: int = 0
    launch_s_saved: float = 0.0
    inlined_bodies: int = 0  # inline-pjit only
    hoisted_reshards: int = 0  # scan-hoist only
    moved_steps: int = 0  # overlap-schedule only
    overlap_ratio: float = 1.0  # overlap-schedule only: makespan / serial
    detail: Dict = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class OptReport:
    """Before/after accounting for one run of the pass pipeline (the
    reference's schema): steps, collective launches and wire bytes before
    and after, per-pass detail, and the overlap schedule's model."""

    passes: List[PassReport]
    steps_before: int
    steps_after: int
    collectives_before: int  # collective launches
    collectives_after: int
    wire_bytes_before: float
    wire_bytes_after: float
    overlap: Optional[Dict] = None

    @property
    def fused_buckets(self) -> int:
        return sum(p.fused_buckets for p in self.passes)

    @property
    def launch_s_saved(self) -> float:
        return sum(p.launch_s_saved for p in self.passes)

    @property
    def inlined_bodies(self) -> int:
        return sum(p.inlined_bodies for p in self.passes)

    @property
    def hoisted_reshards(self) -> int:
        return sum(p.hoisted_reshards for p in self.passes)

    @property
    def overlap_ratio(self) -> float:
        return self.overlap["ratio"] if self.overlap else 1.0

    def as_dict(self) -> Dict:
        return {
            "passes": [p.as_dict() for p in self.passes],
            "steps_before": self.steps_before,
            "steps_after": self.steps_after,
            "collectives_before": self.collectives_before,
            "collectives_after": self.collectives_after,
            "wire_bytes_before": self.wire_bytes_before,
            "wire_bytes_after": self.wire_bytes_after,
            "fused_buckets": self.fused_buckets,
            "launch_s_saved": self.launch_s_saved,
            "inlined_bodies": self.inlined_bodies,
            "hoisted_reshards": self.hoisted_reshards,
            "overlap": dict(self.overlap) if self.overlap else None,
        }


def _program_launches(prog) -> int:
    """A reshard program's launches: DynamicSlice is local addressing."""
    return sum(1 for ps in prog.steps if ps.op != "dynamic_slice")


def _hidden_launches(step: PlanStep) -> int:
    """Collectives a compute step runs inside itself, one launch each; a
    product's reduce-scatter is left out, as the reference leaves it (R9)."""
    return sum(n for k, n in step.collectives.items() if k != "reduce-scatter")


def count_collective_launches(steps: List[PlanStep]) -> int:
    """Collective launches a step list issues: each reshard program step that
    moves data, each collective or fused step (one launch over all its
    axes), and each collective a compute step runs inside itself."""
    n = 0
    for s in steps:
        if s.kind == "reshard" and s.program is not None:
            n += _program_launches(s.program)
        elif s.kind in ("collective", "fused"):
            n += 1
        else:
            n += _hidden_launches(s)
    return n


def whole_wire_bytes(plan: PartitionPlan) -> float:
    """Modeled wire bytes of one execution, scan bodies at trip count."""
    mesh = plan.mesh
    total = 0.0
    for s in plan.steps:
        if s.kind == "reshard" and s.program is not None:
            total += s.program.cost_bytes
        elif s.kind == "collective":
            total += _collective_step_wire_bytes(mesh, s)
        elif s.kind == "fused":
            total += s.wire_bytes
        if s.inner is not None:
            total += s.call["trips"] * whole_wire_bytes(s.inner)
    return total


def whole_collective_launches(plan: PartitionPlan) -> int:
    """Collective launches of one execution, scan bodies at trip count."""
    total = count_collective_launches(plan.steps)
    for s in plan.steps:
        if s.inner is not None:
            total += s.call["trips"] * whole_collective_launches(s.inner)
    return total


def _psum_wire_bytes(mesh, axes, in_bytes: float) -> float:
    """Per-axis AllReduce pricing, as ``einsum_rules.compile_einsum`` prices
    each psum axis."""
    return sum(collective_wire_bytes("all-reduce", mesh.axis_size(a), in_bytes) for a in axes)


def _collective_step_wire_bytes(mesh, step: PlanStep) -> float:
    if step.op == "ppermute":
        n = mesh.axis_size(step.axes[0]) if step.axes else 1
        return collective_wire_bytes("collective-permute", n, step.in_bytes)
    return _psum_wire_bytes(mesh, step.axes, step.in_bytes)


# ---------------------------------------------------------------------------------
# pass 1: no call boundary to inline
# ---------------------------------------------------------------------------------


def inline_pjit(plan: PartitionPlan) -> PassReport:
    """Reports zero: ``make_fx`` inlines nested calls as it captures, so a
    captured graph has no call step to splice (a scan's body is a loop, not
    a call, and stays a body plan)."""
    return PassReport("inline-pjit")


# ---------------------------------------------------------------------------------
# pass 2: loop-invariant reshard hoisting out of scan bodies
# ---------------------------------------------------------------------------------


def hoist_scan_invariants(plan: PartitionPlan) -> PassReport:
    """Lift reshards of loop-invariant scan inputs out of the body.

    A scan const is bound once and read on every trip; where the body's
    only use of a const input (through free aliases) is one reshard step,
    replaying that collective every trip is waste: the reshard moves into
    this plan just before the scan, the scan reads the resharded value, and
    the body's readers of the reshard read the input instead.  Carries and
    xs change every trip and are never hoisted.  The body plan is edited in
    place (the scan's run closure holds the same object); its report and
    peak are brought up to date (:func:`_refresh_inner_report`)."""
    rep = PassReport("scan-hoist")
    launch_s = _params(plan).collective_launch_s
    out: List[PlanStep] = []
    for step in plan.steps:
        if step.op != "scan" or step.inner is None:
            out.append(step)
            continue
        inner = step.inner
        nc, trips = int(step.call["num_consts"]), int(step.call["trips"])
        canon: Dict[int, object] = {}
        for s in inner.steps:
            if _is_free_alias(s):
                _canon_insert(canon, s)
        out_ids = {id(k) for k in inner.out_keys if is_env_key(k)}
        new_reads = list(step.reads)
        drop: set = set()
        for i in range(nc):
            bv = inner.invars[i]
            chain = {id(bv)} | {w for w, root in canon.items() if root is bv}
            if chain & out_ids:
                continue
            cands = [j for j, s in enumerate(inner.steps)
                     if s.kind == "reshard" and s.program is not None and id(s.reads[0]) in chain]
            if len(cands) != 1:
                continue
            j = cands[0]
            rs = inner.steps[j]
            if id(rs.writes[0]) in out_ids:
                continue
            # every other reader of the const's chain must be a chain alias
            if any(j2 != j and any(id(r) in chain for r in s2.reads)
                   and not (_is_free_alias(s2) and id(s2.writes[0]) in chain)
                   for j2, s2 in enumerate(inner.steps)):
                continue
            proxy = ProxyVar("hoist.const")
            out.append(dataclasses.replace(rs, reads=(new_reads[i],), writes=(proxy,)))
            new_reads[i] = proxy
            w, src = rs.writes[0], rs.reads[0]
            for s2 in inner.steps:
                if any(r is w for r in s2.reads):
                    s2.reads = tuple(src if r is w else r for r in s2.reads)
            inner.in_shardings[i] = rs.program.dst
            inner.stats.remove_program(rs.program)
            plan.stats.add_program(rs.program)
            for _ in range(trips):
                plan.stats.remove_program(rs.program)
            drop.add(j)
            rep.hoisted_reshards += 1
            rep.wire_bytes_saved += max(trips - 1, 0) * rs.program.cost_bytes
            rep.launch_s_saved += max(trips - 1, 0) * launch_s * _program_launches(rs.program)
        if drop:
            inner.steps[:] = [s for j, s in enumerate(inner.steps) if j not in drop]
            step.reads = tuple(new_reads)
            _refresh_inner_report(inner)
            step.transient_bytes = inner.peak_bytes
        out.append(step)
    if rep.hoisted_reshards:
        plan.steps[:] = out
    return rep


def _refresh_inner_report(inner: PartitionPlan) -> None:
    """Bring a body plan up to date after an outer pass edited its steps:
    its dead lists, step count and peak, and, where it was optimized, its
    overlap schedule and its report's after-side counts (the verifier checks
    every body plan's report against its steps)."""
    rep = inner.opt_report
    if rep is not None:
        sched = schedule_overlap(inner)
        rep.steps_after = len(inner.steps)
        rep.collectives_after = whole_collective_launches(inner)
        rep.wire_bytes_after = whole_wire_bytes(inner)
        rep.overlap = dict(sched.detail, ratio=sched.overlap_ratio)
    inner.relive()
    inner.peak_bytes = plan_peak_bytes(inner)


# ---------------------------------------------------------------------------------
# pass 3: reshard CSE
# ---------------------------------------------------------------------------------


def _roots(plan: PartitionPlan) -> set:
    """Env keys execution reads at the end."""
    return {k for k in plan.out_keys if is_env_key(k)}


def _is_free_alias(step: PlanStep) -> bool:
    """A pure env copy: an annotate with a matching sharding or a CSE alias."""
    return (step.kind == "compute" and step.op in ("alias", "annotate")
            and len(step.reads) == 1 and len(step.writes) == 1)


def _canon_insert(canon: Dict[int, object], step: PlanStep) -> None:
    """Record a free alias in a value-root map (``id(write) -> root``)."""
    r = step.reads[0]
    while id(r) in canon:
        r = canon[id(r)]
    canon[id(step.writes[0])] = r


def reshard_cse(plan: PartitionPlan) -> PassReport:
    """Run identical (value, target sharding) reshards once.

    The builder emits one reshard step per consuming op, so two consumers of
    one value that need one target repeat the whole collective sequence
    (the backward re-gathering what the forward gathered).  The first
    occurrence stays and later readers read its result; a duplicate whose
    result is a plan output becomes a free alias.
    """
    rep = PassReport("reshard-cse")
    roots = _roots(plan)
    launch_s = _params(plan).collective_launch_s
    seen: Dict[Tuple[int, tuple], object] = {}
    rewrite: Dict[int, object] = {}
    canon: Dict[int, object] = {}
    keepalive: List[object] = []  # replaced keys stay alive so their id()s stay unique

    def _root(k):
        while id(k) in canon:
            k = canon[id(k)]
        return k

    out: List[PlanStep] = []
    for step in plan.steps:
        if rewrite:
            step.reads = tuple(rewrite.get(id(k), k) for k in step.reads)
        if _is_free_alias(step):
            _canon_insert(canon, step)
        if step.kind == "reshard" and step.program is not None:
            key = (id(_root(step.reads[0])), step.program.dst.structural_key())
            prior = seen.get(key)
            if prior is not None:
                rep.removed_steps += 1
                rep.wire_bytes_saved += step.program.cost_bytes
                rep.launch_s_saved += launch_s * _program_launches(step.program)
                plan.stats.remove_program(step.program)
                w = step.writes[0]
                if w in roots:
                    out.append(PlanStep("compute", (prior,), (w,), _alias_run, op="alias"))
                else:
                    rewrite[id(w)] = prior
                    keepalive.append(w)
                continue
            seen[key] = step.writes[0]
        out.append(step)
    plan.steps[:] = out
    return rep


# ---------------------------------------------------------------------------------
# pass 4: dead-reshard elimination
# ---------------------------------------------------------------------------------


def dead_reshard_elim(plan: PartitionPlan) -> PassReport:
    """Drop reshard steps (and free aliases) whose result nothing reads:
    annotations of values the program never consumes, and what CSE
    orphaned.  Backwards, so that a chain feeding only a dead reshard dies
    with it."""
    rep = PassReport("dead-reshard-elim")
    roots = _roots(plan)
    launch_s = _params(plan).collective_launch_s
    nreads: Dict[int, int] = {}
    for step in plan.steps:
        for k in step.reads:
            nreads[id(k)] = nreads.get(id(k), 0) + 1
    keep = [True] * len(plan.steps)
    for i in range(len(plan.steps) - 1, -1, -1):
        step = plan.steps[i]
        is_reshard = step.kind == "reshard" and step.program is not None
        if not is_reshard and not _is_free_alias(step):
            continue
        w = step.writes[0]
        if w in roots or nreads.get(id(w), 0) > 0:
            continue
        keep[i] = False
        rep.removed_steps += 1
        if is_reshard:
            rep.wire_bytes_saved += step.program.cost_bytes
            rep.launch_s_saved += launch_s * _program_launches(step.program)
            plan.stats.remove_program(step.program)
        for k in step.reads:
            nreads[id(k)] -= 1
    plan.steps[:] = [s for s, f in zip(plan.steps, keep) if f]
    return rep


# ---------------------------------------------------------------------------------
# pass 5: output-alias sinking
# ---------------------------------------------------------------------------------


def sink_output_aliases(plan: PartitionPlan) -> PassReport:
    """Sink free aliases that only the output epilogue reads (or nothing
    reads) to just before their first reader, so that an alias right after
    a collective it reads stops pinning that collective's bucket.  Pure
    reordering."""
    rep = PassReport("alias-sink")
    steps = plan.steps
    n = len(steps)
    epi_writes = {id(k) for k in plan.out_keys if is_env_key(k)}
    epi_steps = set()
    readers: Dict[int, List[int]] = {}
    for j, s in enumerate(steps):
        for k in s.reads:
            readers.setdefault(id(k), []).append(j)
        if s.kind == "reshard" and any(id(w) in epi_writes for w in s.writes):
            epi_steps.add(j)
    # an unmoved step keeps key (i, 0, i); a sinking alias takes
    # (first reader, -1, i): just before it, ties in the original order
    keys: List[tuple] = []
    moved = False
    for i, s in enumerate(steps):
        key = (i, 0, i)
        if s.kind == "compute" and s.op in ("alias", "annotate"):
            rd = readers.get(id(s.writes[0]), [])
            if all(j in epi_steps for j in rd):
                first = rd[0] if rd else n
                if first > i + 1:
                    key = (first, -1, i)
                    moved = True
        keys.append(key)
    if moved:
        order = sorted(range(n), key=lambda i: keys[i])
        steps[:] = [steps[i] for i in order]
    return rep


# ---------------------------------------------------------------------------------
# pass 6: collective fusion
# ---------------------------------------------------------------------------------


def _split_back(env, writes, buf, shapes, sizes):
    off = 0
    for w, shp, m in zip(writes, shapes, sizes):
        env[w] = buf[:, off:off + m].reshape((buf.shape[0],) + tuple(shp))
        off += m


def _concat(env, reads):
    flats = [env[k].reshape(env[k].shape[0], -1) for k in reads]
    return torch.cat(flats, 1) if len(flats) > 1 else flats[0]


def _fused_psum_run(mesh, axes, reduce_op, shapes):
    fn = COLLECTIVE[reduce_op]
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]

    def run(env, reads, writes):
        _split_back(env, writes, fn(_concat(env, reads), mesh, axes), shapes, sizes)

    return run


def _fused_ppermute_run(mesh, axis, perm, shapes):
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]

    def run(env, reads, writes):
        _split_back(env, writes, mr.ppermute(_concat(env, reads), mesh, axis, perm), shapes,
                    sizes)

    return run


def _fused_gather_run(mesh, axis, n, specs):
    # specs: per member (local shape, gather dim)
    sizes = [int(np.prod(s)) if s else 1 for s, _ in specs]

    def run(env, reads, writes):
        g = mr.all_gather(_concat(env, reads), mesh, axis, 0)  # (devices, n * total)
        per = g.reshape(g.shape[0], n, -1)
        off = 0
        for w, (shp, d), m in zip(writes, specs, sizes):
            seg = per[:, :, off:off + m].reshape((g.shape[0], n) + tuple(shp))
            # the axis index becomes the major factor of dim d
            out = list(shp)
            out[d] *= n
            env[w] = seg.movedim(1, 1 + d).reshape([g.shape[0]] + out)
            off += m

    return run


def _fuse_key(step: PlanStep) -> Optional[tuple]:
    """Bucket key, or None when the step is not fusable."""
    if step.kind == "collective":
        if step.op == "ppermute":
            return ("ppermute", step.axes, step.call.get("perm"), step.dtype)
        return ("psum", step.axes, step.reduce_op, step.dtype)
    if step.kind == "reshard" and step.program is not None:
        ps = step.program.steps
        if len(ps) == 1 and ps[0].op == "all_gather":
            return ("gather", ps[0].axis, step.dtype)
    return None


def fuse_collectives(plan: PartitionPlan, bucket_bytes: Optional[float] = None) -> PassReport:
    """Bucket independent same-key collectives into single fused launches.

    A bucket's one launch sits either at its first member (hoist: legal iff
    every member's inputs exist before it) or at its last (sink: legal iff
    no step between reads an earlier member's result).  A reader of a
    member's result pins a hoistable bucket and closes a sinking one.  The
    bucket is capped at ``bucket_bytes`` (default: the profile's
    ``fusion_bucket_bytes``).
    """
    rep = PassReport("collective-fusion")
    cap = bucket_bytes if bucket_bytes is not None else fusion_bucket_bytes(_params(plan))
    launch_s = _params(plan).collective_launch_s
    mesh = plan.mesh
    steps = plan.steps
    open_buckets: Dict[tuple, Dict] = {}
    fused_at: Dict[int, List[int]] = {}  # anchor index -> member indices
    pos_written: Dict[int, int] = {}  # id(env key) -> producing step index
    # a fused member's write lands at its bucket's anchor: unknown while the
    # bucket is open (the anchor may yet sink), the anchor once decided
    open_member_writes: Dict[int, tuple] = {}
    final_anchor: Dict[int, int] = {}

    def finalize(key) -> None:
        b = open_buckets.pop(key, None)
        if b is None:
            return
        for mi in b["members"]:
            for w in steps[mi].writes:
                open_member_writes.pop(id(w), None)
        if len(b["members"]) < 2:
            return
        anchor = b["members"][0] if b["hoistable"] else b["members"][-1]
        fused_at[anchor] = b["members"]
        for mi in b["members"]:
            for w in steps[mi].writes:
                final_anchor[id(w)] = anchor

    def available_before(r, first: int) -> bool:
        if id(r) in open_member_writes:
            return False
        a = final_anchor.get(id(r))
        if a is not None:
            return a < first
        return pos_written.get(id(r), -1) < first

    # which open bucket wrote each key, so that a reader finds its buckets
    # without scanning every open bucket's members
    member_of: Dict[int, tuple] = {}
    for j, s in enumerate(steps):
        for r in s.reads:
            k = member_of.get(id(r))
            if k is not None and k in open_buckets and id(r) in open_member_writes:
                if open_buckets[k]["hoistable"]:
                    open_buckets[k]["pinned"] = True
                else:
                    finalize(k)
        key = _fuse_key(s)
        if key is None:
            for w in s.writes:
                pos_written[id(w)] = j
            continue
        nb = s.in_bytes
        b = open_buckets.get(key)
        cand_hoistable = True
        if b is not None:
            first = b["members"][0]
            cand_hoistable = all(available_before(r, first) for r in s.reads)
            joinable = cand_hoistable or not b["pinned"]
            if not joinable or b["bytes"] + nb > cap:
                finalize(key)
                b = None
        if b is None:
            b = open_buckets[key] = {"members": [j], "bytes": nb, "hoistable": True,
                                     "pinned": False}
        else:
            b["members"].append(j)
            b["bytes"] += nb
            b["hoistable"] = b["hoistable"] and cand_hoistable
        for w in s.writes:
            pos_written[id(w)] = j
            open_member_writes[id(w)] = key
            member_of[id(w)] = key
    for k in list(open_buckets):
        finalize(k)
    if not fused_at:
        return rep

    removed: set = set()
    replacement: Dict[int, PlanStep] = {}
    for anchor, members in fused_at.items():
        group = [steps[i] for i in members]
        key = _fuse_key(group[0])
        reads = tuple(g.reads[0] for g in group)
        writes = tuple(g.writes[0] for g in group)
        total_bytes = sum(g.in_bytes for g in group)
        shapes = [g.lshape for g in group]
        numel = (int(sum(int(np.prod(s)) if s else 1 for s in shapes)),)
        common = dict(lshape=numel, dbytes=group[0].dbytes)
        if key[0] == "psum":
            axes, reduce_op, dtype = key[1], key[2], key[3]
            fused = PlanStep("fused", reads, writes,
                             _fused_psum_run(mesh, axes, reduce_op, shapes),
                             op="fused-all-reduce", axes=axes, reduce_op=reduce_op, dtype=dtype,
                             wbytes=tuple(g.in_bytes for g in group),
                             wire_bytes=_psum_wire_bytes(mesh, axes, total_bytes), **common)
            plan.stats.count("all-reduce", -len(group) * len(axes))
            plan.stats.count("fused-all-reduce", 1)
        elif key[0] == "ppermute":
            axes, perm, dtype = key[1], key[2], key[3]
            fused = PlanStep("fused", reads, writes,
                             _fused_ppermute_run(mesh, axes[0], perm, shapes),
                             op="fused-ppermute", axes=axes, dtype=dtype, call={"perm": perm},
                             wbytes=tuple(g.in_bytes for g in group),
                             wire_bytes=collective_wire_bytes(
                                 "collective-permute", mesh.axis_size(axes[0]), total_bytes),
                             **common)
            plan.stats.count("collective-permute", -len(group))
            plan.stats.count("fused-collective-permute", 1)
        else:
            axis, dtype = key[1], key[2]
            n = mesh.axis_size(axis)
            specs = [(g.lshape, g.program.steps[0].dim) for g in group]
            fused = PlanStep("fused", reads, writes, _fused_gather_run(mesh, axis, n, specs),
                             op="fused-all-gather", axes=(axis,), dtype=dtype,
                             wbytes=tuple(n * g.in_bytes for g in group),
                             wire_bytes=collective_wire_bytes("all-gather", n, total_bytes),
                             **common)
            plan.stats.count("all-gather", -len(group))
            plan.stats.count("fused-all-gather", 1)
        if group[0].run is _cost_only_run:
            fused.run = _cost_only_run
        replacement[anchor] = fused
        removed.update(m for m in members if m != anchor)
        rep.fused_buckets += 1
        rep.fused_members += len(group)
        rep.launch_s_saved += (len(group) - 1) * launch_s
    rep.removed_steps = len(removed)
    plan.steps[:] = [replacement.get(i, s) for i, s in enumerate(steps) if i not in removed]
    return rep


# ---------------------------------------------------------------------------------
# pass 7: overlap-aware list scheduling
# ---------------------------------------------------------------------------------


def step_features(step: PlanStep, mesh) -> Tuple[float, float, float]:
    """(flops, wire bytes, launches) of one step: the machine-independent
    features every time model here is linear in.  A compute step's own
    collectives count as launches; a scan step holds its body's at trip
    count (its schedule is opaque here)."""
    if step.kind == "reshard" and step.program is not None:
        return 0.0, step.program.cost_bytes, float(_program_launches(step.program))
    if step.kind == "collective":
        return 0.0, _collective_step_wire_bytes(mesh, step), 1.0
    if step.kind == "fused":
        return 0.0, step.wire_bytes, 1.0
    if step.inner is not None:
        trips = step.call["trips"]
        return (step.flops, trips * whole_wire_bytes(step.inner),
                float(trips * whole_collective_launches(step.inner)))
    return step.flops, 0.0, float(_hidden_launches(step))


def _step_durations(step: PlanStep, mesh, params: RooflineParams) -> Tuple[float, float]:
    """(compute_s, comm_s) of one step under the profile."""
    flops, wire, launches = step_features(step, mesh)
    return flops / params.peak_flops, wire / params.ici_bw + launches * params.collective_launch_s


def _slot_s(dc: float, dm: float, params: RooflineParams) -> float:
    return overlap_time_s(dc, dm, params) if (dc > 0.0 and dm > 0.0) else dc + dm


def _one_lane(params: RooflineParams) -> bool:
    """Whether the profile runs collectives and products in series (no
    overlap at all): then the machine is one lane, not two."""
    return params.overlap_efficiency <= 0.0


def schedule_overlap(plan: PartitionPlan) -> PassReport:
    """Reorder dataflow-independent steps so that collectives issue as early
    as their inputs allow, and record the max-of-terms overlap model.

    Greedy list scheduling onto (compute, interconnect): among the ready
    steps, place the one that can start earliest, a wire-only step first on
    ties, then the lower original index.  The emitted order is a
    topological order of the dataflow, the same for the same plan.  Under a
    profile with no overlap (one stream runs both) there is one lane, no
    order finishes sooner, and an earlier collective only lengthens its
    result's life: the plan keeps its order.
    """
    rep = PassReport("overlap-schedule")
    steps = plan.steps
    n = len(steps)
    mesh = plan.mesh
    params = _params(plan)
    durs = [_step_durations(s, mesh, params) for s in steps]
    if _one_lane(params):
        serial = sum(_slot_s(dc, dm, params) for dc, dm in durs)
        rep.detail = {"compute_s": sum(d[0] for d in durs), "comm_s": sum(d[1] for d in durs),
                      "serial_s": serial, "overlapped_s": serial}
        return rep
    producer: Dict[int, int] = {}
    for j, s in enumerate(steps):
        for w in s.writes:
            producer[id(w)] = j
    succs: List[List[int]] = [[] for _ in range(n)]
    indeg = [0] * n
    for j, s in enumerate(steps):
        deps = {producer[id(r)] for r in s.reads if id(r) in producer} - {j}
        indeg[j] = len(deps)
        for p in deps:
            succs[p].append(j)
    finish = [0.0] * n
    dep_ready = [0.0] * n
    ready = [j for j in range(n) if indeg[j] == 0]
    tc = tm = 0.0
    order: List[int] = []
    while ready:
        best = None
        for j in ready:
            dc, dm = durs[j]
            start = dep_ready[j]
            if dc > 0.0 and tc > start:
                start = tc
            if dm > 0.0 and tm > start:
                start = tm
            key = (start, 0 if (dm > 0.0 and dc == 0.0) else 1, j)
            if best is None or key < best:
                best = key
        start, _, j = best
        ready.remove(j)
        order.append(j)
        dc, dm = durs[j]
        f = start + _slot_s(dc, dm, params)
        finish[j] = f
        if dc > 0.0:
            tc = f
        if dm > 0.0:
            tm = f
        for k in succs[j]:
            indeg[k] -= 1
            if f > dep_ready[k]:
                dep_ready[k] = f
            if indeg[k] == 0:
                ready.append(k)
    if len(order) != n:
        raise RuntimeError("schedule_overlap: a dependency cycle in the plan's steps")
    serial = sum(_slot_s(dc, dm, params) for dc, dm in durs)
    makespan = max(finish, default=0.0)
    rep.moved_steps = sum(1 for pos, j in enumerate(order) if pos != j)
    rep.overlap_ratio = makespan / serial if serial > 0.0 else 1.0
    rep.detail = {"compute_s": sum(d[0] for d in durs), "comm_s": sum(d[1] for d in durs),
                  "serial_s": serial, "overlapped_s": makespan}
    if rep.moved_steps:
        plan.steps[:] = [steps[j] for j in order]
    return rep


# ---------------------------------------------------------------------------------
# schedule export: step taxonomy and modeled timeline
# ---------------------------------------------------------------------------------


def step_class(step: PlanStep) -> str:
    """Step taxonomy: ``reshard``, ``collective`` (psum family),
    ``ppermute``, ``fused``, ``call:scan`` (an opaque body plan), ``guard``
    (the sentinel's stat and pack steps) and ``compute``."""
    if step.kind == "reshard":
        return "reshard"
    if step.kind == "collective":
        return "ppermute" if step.op == "ppermute" else "collective"
    if step.kind == "fused":
        return "fused"
    if step.inner is not None:
        return f"call:{step.op}"
    if (step.op or "").startswith("guard"):
        return "guard"
    return "compute"


def modeled_timeline(plan: PartitionPlan) -> List[Dict]:
    """The schedule as a timeline: one row per step in the plan's order with
    modeled start and duration seconds and the lane it occupies, by
    :func:`schedule_overlap`'s rules (one lane under a profile with no
    overlap), so that on an optimized plan the makespan equals
    ``opt_report.overlap["overlapped_s"]``."""
    steps = plan.steps
    mesh = plan.mesh
    params = _params(plan)
    producer: Dict[int, int] = {}
    for j, s in enumerate(steps):
        for w in s.writes:
            producer[id(w)] = j
    finish = [0.0] * len(steps)
    tc = tm = 0.0
    one_lane = _one_lane(params)
    rows: List[Dict] = []
    for j, s in enumerate(steps):
        dc, dm = _step_durations(s, mesh, params)
        start = 0.0
        for r in s.reads:
            p = producer.get(id(r))
            if p is not None and p < j:
                start = max(start, finish[p])
        if dc > 0.0 or one_lane:
            start = max(start, tc)
        if dm > 0.0 or one_lane:
            start = max(start, tm)
        dur = _slot_s(dc, dm, params)
        finish[j] = start + dur
        if dc > 0.0 or one_lane:
            tc = finish[j]
        if dm > 0.0 or one_lane:
            tm = finish[j]
        rows.append({"index": j, "name": f"{s.kind}:{s.op}" if s.op else s.kind,
                     "cls": step_class(s),
                     "lane": "interconnect" if (dm > 0.0 and dc == 0.0) else "compute",
                     "start_s": start, "dur_s": dur, "compute_s": dc, "comm_s": dm})
    return rows


# ---------------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------------


def _within_peak(plan: PartitionPlan, budget: float, passes) -> List[PassReport]:
    """Run ``passes`` on ``plan`` and keep their edits unless they raise its
    modeled peak (``plan_peak_bytes``) above both its peak before them and
    ``budget``; then undo them (the steps, their reads and ``plan.stats``
    as they were) and report each as undone.  CSE stretches the first
    reshard's result to its last reader (under remat, the forward's gather
    to the backward's recompute, which is what remat let go); fusion moves
    its members' results or inputs to the bucket's anchor."""
    steps = list(plan.steps)
    reads = [s.reads for s in steps]
    stats = copy.deepcopy(plan.stats)
    before = plan_peak_bytes(plan)
    reports = [run(plan) for run in passes]
    after = plan_peak_bytes(plan)
    limit = max(before, budget)
    if after <= limit:
        return reports
    for s, r in zip(steps, reads):
        s.reads = r
    plan.steps[:] = steps
    plan.stats = stats
    return [PassReport(r.name, detail={"undone": "peak", "peak_bytes": after, "limit": limit})
            for r in reports]


def optimize_plan(plan: PartitionPlan, bucket_bytes: Optional[float] = None) -> PartitionPlan:
    """Run the pass pipeline (inline, hoist, CSE, DCE, alias sinking, fusion,
    overlap scheduling) on ``plan`` in place and attach an
    :class:`OptReport`: first on each scan body plan (innermost first, each
    with its own report; this plan's ``PlanStats`` follow the body's at
    trip count), then on this plan.  Under a one-lane profile (the committed
    one) CSE with DCE, and fusion, are each undone where they would raise
    the modeled peak above the plan's before the passes
    (:func:`_within_peak`).  ``bucket_bytes`` overrides the fusion cap;
    every other price is the plan's profile, without which this raises."""
    _params(plan)
    steps_before = len(plan.steps)
    coll_before = whole_collective_launches(plan)
    bytes_before = whole_wire_bytes(plan)
    for step in plan.steps:
        if step.inner is not None:
            inner, trips = step.inner, step.call["trips"]
            plan.stats.add_inner(inner.stats, trips, sign=-1)
            inner.params = plan.params
            optimize_plan(inner, bucket_bytes)
            plan.stats.add_inner(inner.stats, trips)
            step.transient_bytes = inner.peak_bytes
    reports = [inline_pjit(plan), hoist_scan_invariants(plan)]
    fuse = lambda p: fuse_collectives(p, bucket_bytes)  # noqa: E731
    if _one_lane(plan.params):
        budget = plan_peak_bytes(plan)
        reports += _within_peak(plan, budget, (reshard_cse, dead_reshard_elim))
        reports.append(sink_output_aliases(plan))
        reports += _within_peak(plan, budget, (fuse,))
    else:
        reports += [reshard_cse(plan), dead_reshard_elim(plan), sink_output_aliases(plan),
                    fuse(plan)]
    reports.append(schedule_overlap(plan))
    sched = reports[-1]
    plan.relive()
    plan.opt_report = OptReport(
        passes=reports, steps_before=steps_before, steps_after=len(plan.steps),
        collectives_before=coll_before, collectives_after=whole_collective_launches(plan),
        wire_bytes_before=bytes_before, wire_bytes_after=whole_wire_bytes(plan),
        overlap=dict(sched.detail, ratio=sched.overlap_ratio))
    plan.peak_bytes = plan_peak_bytes(plan)
    return plan
