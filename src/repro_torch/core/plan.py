"""Compiled partition plans: plan once, execute many (paper §4).

A port of the JAX package's ``core/plan.py`` over captured aten graphs.  The
dynamic path (``partitioner.py::SpmdPartitioner``) re-decides every op on
every call: it classifies the op, merges shardings, plans each reshard and
each einsum's grouping.  Those decisions depend only on the graph, the mesh
and the completed shardings, never on data, so :class:`PlanBuilder` makes
them once and lowers the graph into a :class:`PartitionPlan`: a flat list of
:class:`PlanStep`s over pre-resolved decisions —

* the op's local computation (the functions ``partitioner.py`` shares with
  the dynamic path: einsum, elementwise, reductions, convolutions with
  halos, the flash-attention operator, the fallback);
* operand reshard **programs** (``collective_planner.plan_reshard``), emitted
  as first-class ``reshard`` steps;
* the ReduceScatter-vs-AllReduce choice for partial sums
  (``einsum_rules.compile_einsum``), with trailing AllReduces emitted as
  first-class ``collective`` steps;
* the §3.3 stage shift (``core/shift.py``, ``_stage_shift``): a local
  concatenate, or a boundary row, a first-class ``ppermute`` collective
  step (``call["perm"]``) and a stitch;
* the output epilogue: outputs whose completed sharding differs from the
  one the body leaves them in get a reshard step that writes a
  :class:`ProxyVar`, and ``out_keys`` names what execution returns.

An annotation holds its value in its own sharding, except on its
unspecified dims, which keep what completion gave them (a vmapped
annotation's inserted dim, ``partitioner.annotation_target``).

Every step declares its dataflow (``reads`` / ``writes`` env keys) and its
runner reads operands through those tuples, as the reference's do, so the
whole-program optimizer (``plan_opt.py``) can rewire them.
Executing a plan is a straight walk of the step list over the simulated
mesh's stacked shards, with a dict environment: no capture, no propagation,
no per-op classification, no reshard search.

Cost-only lowering (:func:`lower_plan`, :func:`lower_for_cost`) runs the
same propagation and lowering on a graph captured from fake tensors, with
every step's runner a raising stub, and returns the plan or its
:class:`PlanCost`: modeled collective wire bytes and launches, per-device
FLOPs against the ideal balance point (``analysis/graph_cost.py``), and a
per-device live-memory peak from a liveness walk.  No device is touched, so
a full-size program can be priced on a mesh far larger than the card.

``compile_plan`` then appends the numerics-sentinel epilogue where asked
(``guard=``: :func:`append_guard_steps`), runs the whole-program optimizer
(``optimize=True``: ``plan_opt.optimize_plan``, priced by the ``profile``
it is given; without one it raises, as the port has no default constants)
and the static verifier (``plan_verify.verify_plan``; ``verify=None``, the
default, runs it).  A scan node (``core/scan.py``) lowers to one call step
(``op="scan"``) whose body plan is exposed as ``PlanStep.inner`` with its
call metadata (``call``: ``trips``, ``num_consts``, ``num_carry``), as the
reference's: the body is planned once under its completed shardings and
run once per trip; ``PlanStats``, ``PlanCost`` and ``plan_peak_bytes``
count it at trip count (the body's live peak as the step's
``transient_bytes``).

:func:`compile_state_reshard` lowers a cross-topology checkpoint restore
into a :class:`StateReshardPlan`: one reshard program per leaf, priced like
a partition plan.  This module takes its profile explicitly: the callers
that stand in for the reference's default constants (``spmd_partition``
and the entry points) resolve one with ``obs/profile.py::resolve_profile``,
the committed H100 profile unless told otherwise.
"""
from __future__ import annotations

import collections
import contextvars
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.fx

from ..analysis.graph_cost import count_flops
from ..analysis.roofline import RooflineParams, overlap_time_s
from . import mesh_runtime as mr
from .annotate import ANNOTATE_OP
from .collective_planner import (PlanError, ReshardProgram, _candidate_gather_all,
                                 _candidate_legacy, execute_program, plan_reshard,
                                 search_telemetry, simulate)
from .einsum_rules import compile_einsum, execute_einsum
from .partitioner import (COLLECTIVE, LOCAL_OPS, REDUCE_OP, _want, align, annotation_target,
                          broadcast_local, broadcast_sharding,
                          conv_bias, conv_feature_local, conv_halo_local, conv_target,
                          dot_spec, elementwise_local, elementwise_targets,
                          fallback_global, fallback_keep_sharding, fallback_local,
                          gathers, group_size, local_reduce,
                          local_reshape_ok, reduce_decision, reshape_carried, scan_body_shardings,
                          transpose_sharding, trip_order)
from .propagation import PropagationResult, add0, propagate
from .reshard import shard_shape
from .rules import (BROADCAST, DOT, ELEMENTWISE, REDUCE, RESHAPE, SCANS, STAGE_SHIFT, TRANSPOSE,
                    _bcast_map, _invert, _project, aval, lower)
from .shift import shift_local
from .sharding import Mesh, Sharding, replicated

Env = Dict[object, object]


# ---------------------------------------------------------------------------------
# env keys and structured steps
# ---------------------------------------------------------------------------------


class ProxyVar:
    """A plan-local SSA value key (a resharded operand, a pre-psum partial).

    Graph nodes name the values of the source program; the plan needs names
    for the intermediate values the partitioner itself introduces.
    """

    __slots__ = ("note",)

    def __init__(self, note: str = ""):
        self.note = note

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<proxy:{self.note}>"


@dataclasses.dataclass
class PlanStep:
    """One resolved execution step with explicit dataflow.

    ``run(env, reads, writes)`` reads its operands positionally from
    ``reads`` and writes its results to ``writes``.

    Kinds:
      * ``compute``    — a local op on stacked shards (einsum, elementwise,
                         reduce, the flash-attention kernel, …);
      * ``reshard``    — replay of one :class:`ReshardProgram`;
      * ``collective`` — a standalone trailing collective (psum/pmax/pmin,
                         or a ppermute) split out of its producing op;
      * ``fused``      — a fusion-pass product (``plan_opt.fuse_collectives``):
                         one launch over the concatenation of several
                         members' buffers.

    A compute step that runs collectives inside itself records them in
    ``collectives`` (kind -> count, as ``PlanStats`` counts them): a
    ``LocalOp``'s (the decode combine's pmax and psums, the SSD gradient's
    psums, ``logsumexp``'s, the index ops') and a product's reduce-scatter.
    The verifier's accounting and the optimizer's launch counts read them.

    A scan's call step (``op="scan"``) exposes its body plan as ``inner``
    and its call metadata as ``call`` (``trips``, ``num_consts``,
    ``num_carry``), so that the optimizer can hoist loop-invariant reshards
    out of the body and every count can price the body at trip count; its
    ``transient_bytes`` is the body's live peak.
    """

    kind: str
    reads: Tuple[object, ...]
    writes: Tuple[object, ...]
    run: Callable[[Env, Tuple, Tuple], None]
    op: str = ""  # the aten op / collective kind
    program: Optional[ReshardProgram] = None  # reshard steps only
    axes: Tuple[str, ...] = ()  # collective steps only
    reduce_op: str = ""  # "add" | "max" | "min"
    lshape: Tuple[int, ...] = ()  # local shape of reads[0] on entry
    dbytes: int = 0
    dtype: str = ""
    # -- cost-model annotations (lower_for_cost / PlanCost) ---------------------
    flops: float = 0.0  # per-device local FLOPs of this step
    wbytes: Tuple[float, ...] = ()  # local bytes of each write (memory model)
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)  # run inside
    call: Dict = dataclasses.field(default_factory=dict)  # ppermute: {"perm"}; scan: trips..
    wire_bytes: float = 0.0  # fused steps: modeled wire bytes of their one launch
    transient_bytes: float = 0.0  # scan steps: the body plan's live peak
    inner: Optional["PartitionPlan"] = None  # scan steps: the body plan

    @property
    def in_bytes(self) -> float:
        return _nbytes_of(self.lshape, self.dbytes)


def is_env_key(k) -> bool:
    """An env key a step can write: a graph node or a :class:`ProxyVar`
    (an output may also be a plain value)."""
    return isinstance(k, (torch.fx.Node, ProxyVar))


def _nbytes_of(shape: Tuple[int, ...], dbytes: int) -> float:
    return float(dbytes) * float(np.prod(shape)) if shape else float(dbytes)


def _alias_run(env, reads, writes):
    env[writes[0]] = env[reads[0]]


def _compute_run(fn):
    def run(env, reads, writes, fn=fn):
        env[writes[0]] = fn(*[env[k] for k in reads])

    return run


def _reshard_run(prog: ReshardProgram):
    def run(env, reads, writes, prog=prog):
        env[writes[0]] = execute_program(env[reads[0]], prog)

    return run


def _collective_run(mesh: Mesh, axes: Tuple[str, ...], reduce_op: str):
    fn = COLLECTIVE[reduce_op]

    def run(env, reads, writes, fn=fn, axes=axes):
        env[writes[0]] = fn(env[reads[0]], mesh, axes)

    return run


# the ``on_step`` of the plan execution in progress, which scan steps hand on
# to their body plans' executions
_ON_STEP: contextvars.ContextVar = contextvars.ContextVar("repro_torch_on_step", default=None)


def _scan_run(inner: "PartitionPlan", nc: int, nk: int, order):
    """A scan's call step: the body plan once per trip on the trip's slice
    of each stacked x (stacked shards: dim 0 is the device, dim 1 the scan),
    each trip's ys written into their slots of buffers allocated at the
    first trip, trip-major so that a slot is contiguous and one
    ``_foreach_copy_`` writes a trip's ys (a launch per dtype, not one per
    y: a forward scan's residuals are dozens of ys); writes the final carry
    and the ys (views, device dim first) as one list."""
    L = len(order)

    def run(env, reads, writes):
        vals = [env[k] for k in reads]
        consts, carry, xs = vals[:nc], vals[nc:nc + nk], vals[nc + nk:]
        hook, bufs = _ON_STEP.get(), None
        for t in order:
            outs = inner.execute(*consts, *carry, *(x[:, t] for x in xs), on_step=hook)
            carry, ys = outs[:nk], outs[nk:]
            if bufs is None:
                bufs = [y.new_empty((L,) + tuple(y.shape)) for y in ys]
            if ys:
                torch._foreach_copy_([b[t] for b in bufs], list(ys))
        env[writes[0]] = list(carry) + [b.movedim(0, 1) for b in bufs or ()]

    return run


def _cost_only_run(env, reads, writes):  # pragma: no cover - guard rail
    raise RuntimeError("cost-only plan executed: this plan was lowered by lower_plan / "
                       "lower_for_cost and carries no runnables")


# ---------------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------------


@dataclasses.dataclass
class PlanStats:
    """Planned-collective accounting for one compiled plan."""

    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    reshard_bytes: float = 0.0  # modeled wire bytes of planned reshards
    # the same operand and output reshards priced under the AllGather-first
    # (replicate, then re-slice) and the pre-planner greedy schedules
    baseline_bytes: float = 0.0
    legacy_bytes: float = 0.0
    eqns: int = 0
    steps: int = 0
    # lattice-search telemetry delta accumulated while this plan compiled
    lattice: Dict[str, int] = dataclasses.field(default_factory=dict)

    def count(self, kind: str, n: int = 1) -> None:
        self.collectives[kind] = self.collectives.get(kind, 0) + n

    def add_program(self, prog: Optional[ReshardProgram]) -> None:
        if prog is None or prog.is_identity:
            return
        for s in prog.steps:
            self.count(s.op.replace("_", "-"))
        self.reshard_bytes += prog.cost_bytes

    def add_inner(self, inner: "PlanStats", trips: int, sign: int = 1) -> None:
        """Count a body plan's collectives and bytes ``trips`` times (with
        ``sign`` -1, take them off again)."""
        for kind, n in inner.collectives.items():
            self.count(kind, sign * trips * n)
        self.reshard_bytes += sign * trips * inner.reshard_bytes
        self.baseline_bytes += sign * trips * inner.baseline_bytes
        self.legacy_bytes += sign * trips * inner.legacy_bytes
        self.eqns += sign * inner.eqns

    def remove_program(self, prog: Optional[ReshardProgram]) -> None:
        """Revert :meth:`add_program` for a reshard an optimizer pass removed
        (CSE, dead-reshard elimination).  ``baseline_bytes`` and
        ``legacy_bytes`` keep it: the reference schedules had no optimizer."""
        if prog is None or prog.is_identity:
            return
        for s in prog.steps:
            self.count(s.op.replace("_", "-"), -1)
        self.reshard_bytes -= prog.cost_bytes

    def as_dict(self) -> Dict:
        return {
            "collectives": dict(self.collectives),
            "reshard_bytes": self.reshard_bytes,
            "baseline_bytes": self.baseline_bytes,
            "legacy_bytes": self.legacy_bytes,
            "eqns": self.eqns,
            "steps": self.steps,
            "lattice": dict(self.lattice),
        }


# ---------------------------------------------------------------------------------
# the compiled plan
# ---------------------------------------------------------------------------------


@dataclasses.dataclass
class PartitionPlan:
    """A fully resolved partitioning of one captured graph over one mesh.

    ``out_keys`` holds one env key per graph output: the output node when
    the body already leaves it in the completed output sharding, the
    :class:`ProxyVar` the epilogue reshard step writes otherwise, or the
    output itself when it is not a tensor node.  ``fallbacks`` names the ops
    that took the fallback, and ``fallback_gathers`` those of them that
    gathered a sharded dim, in graph order.  ``outvars`` are the graph's
    outputs (the guard epilogue reads their shapes); ``guard`` describes the
    guard vector a guarded plan appends to its outputs, and ``opt_report``
    what the optimizer did.
    """

    graph: torch.fx.Graph
    mesh: Mesh
    steps: List[PlanStep]
    invars: List[torch.fx.Node]
    in_shardings: List[Sharding]
    out_shardings: List[Optional[Sharding]]
    out_keys: List[object]
    stats: PlanStats
    consts: Dict[torch.fx.Node, torch.Tensor]  # stacked (replicated) constants
    const_bytes: float = 0.0  # their bytes on each device
    fallbacks: List[str] = dataclasses.field(default_factory=list)
    fallback_gathers: List[str] = dataclasses.field(default_factory=list)
    peak_bytes: float = 0.0  # modeled per-device live-memory peak
    params: Optional[RooflineParams] = None
    outvars: List[object] = dataclasses.field(default_factory=list)
    guard: Optional["GuardInfo"] = None
    opt_report: Optional[object] = None  # plan_opt.OptReport after optimization
    # per step, the env keys no later step reads and no output names: run
    # eagerly, a value lives until its key leaves the env
    dead: List[Tuple[object, ...]] = dataclasses.field(init=False)

    def __post_init__(self):
        self.relive()

    def relive(self) -> None:
        """Recompute ``dead`` and ``stats.steps`` after the step list changed
        (the guard epilogue, the optimizer's passes)."""
        self.dead = _dead_after(self.steps, self.out_keys)
        self.stats.steps = len(self.steps)

    def execute(self, *args, on_step: Optional[Callable[[PlanStep, Env], None]] = None,
                tracer=None):
        """Run the plan on the stacked local shards of its inputs; returns the
        outputs' stacked shards (under ``out_shardings``).  Each value is
        dropped after its last reader, as ``plan_peak_bytes`` models.
        ``on_step(step, env)``, if given, sees each step's results before
        its dead values are dropped, the steps of scan bodies too.
        ``tracer`` (an ``obs.trace.Tracer``) runs and times each of this
        plan's steps (a scan's call step is one span) as its config says;
        the values are those of an untraced run."""
        env: Env = dict(self.consts)
        env.update(zip(self.invars, args))
        token = _ON_STEP.set(on_step)
        call = None
        if tracer is not None:
            call = tracer.begin_call(cuda=any(isinstance(a, torch.Tensor) and a.is_cuda
                                              for a in args))
        try:
            for i, (step, dead) in enumerate(zip(self.steps, self.dead)):
                if tracer is None:
                    step.run(env, step.reads, step.writes)
                else:
                    tracer.run_step(i, step, env, call)
                if on_step is not None:
                    on_step(step, env)
                for k in dead:
                    del env[k]
        finally:
            _ON_STEP.reset(token)
        return [env[k] if is_env_key(k) else k
                for k in self.out_keys]

    def steps_holding(self, args, holds: Callable[[torch.Tensor], bool]) -> List[str]:
        """Run the plan once on ``args`` (the program's global inputs, as a
        tree in their order) and return the ops of the steps one of whose
        results (stacked shards: dim 0 is the device) ``holds``: a check
        that no step gathers what should stay sharded."""
        from torch.utils._pytree import tree_flatten

        found: List[str] = []

        def look(step, env):
            for w in step.writes:
                vals = env[w] if isinstance(env[w], list) else [env[w]]
                if any(isinstance(t, torch.Tensor) and holds(t) for t in vals):
                    found.append(step.op)

        flat, _ = tree_flatten(args)
        with torch.no_grad():
            self.execute(*(mr.shard(a, s) for a, s in zip(flat, self.in_shardings)),
                         on_step=look)
        return found

    def total_flops(self) -> float:
        """Modeled per-device FLOPs of one plan execution (a scan step's
        are its body's at trip count)."""
        return sum(s.flops for s in self.steps)

    def op_counts(self) -> "collections.Counter":
        """How many steps of each op one execution runs: a scan body's at
        its trip count (the call step itself counts once, as ``scan``)."""
        n: collections.Counter = collections.Counter()
        for s in self.steps:
            n[s.op] += 1
            if s.inner is not None:
                for op, k in s.inner.op_counts().items():
                    n[op] += s.call["trips"] * k
        return n

    def body_plans(self) -> List["PartitionPlan"]:
        """Every scan body plan under this plan, nested ones too, outermost
        first."""
        out = []
        for s in self.steps:
            if s.inner is not None:
                out.append(s.inner)
                out.extend(s.inner.body_plans())
        return out


def _dead_after(steps: List[PlanStep], out_keys) -> List[Tuple[object, ...]]:
    """For each step, the keys whose last use (read or write) it is, outputs
    excepted: what ``PartitionPlan.execute`` drops once the step has run."""
    last: Dict[object, int] = {}
    for i, step in enumerate(steps):
        for k in (*step.reads, *step.writes):
            last[k] = i
    for k in out_keys:
        if is_env_key(k):
            last.pop(k, None)
    dead: List[List[object]] = [[] for _ in steps]
    for k, i in last.items():
        dead[i].append(k)
    return [tuple(d) for d in dead]


# ---------------------------------------------------------------------------------
# runtime numerics sentinels: the guard epilogue as plan steps
# ---------------------------------------------------------------------------------
#
# A guarded plan appends a non-finite / abs-max check over selected outputs
# as plan steps: one stat step per guarded tensor, one pack step, and one
# pmax over every mesh axis, priced and fused and scheduled like any other
# collective.  The guard vector becomes an extra plan output (replicated,
# shape (2k,): per leaf [non-finite count, abs max]); the runner turns a
# tripped guard into a NumericsFault naming the leaves (``guard_faults``).
# Under pmax the non-finite count becomes the largest per-device count, > 0
# iff any shard anywhere held a non-finite value, so one launch carries both.


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Which tensors the numerics sentinel watches, and its thresholds.

    Plan level (``append_guard_steps`` / ``spmd_partition(guard=)``):
    ``outputs`` picks plan output indices (None: all), ``names`` labels
    them.  Train level (``train/loop.py::make_train_step``): ``grads``,
    ``loss`` and ``moments`` select state leaves; ``max_grad_norm`` bounds
    the global gradient norm.  ``rewind_after`` consecutive faulted steps
    escalate from a skipped batch to a ``NumericsFault``, on which
    ``launch/elastic.py::ElasticCoordinator`` rewinds to a checkpoint.
    """

    outputs: Optional[Tuple[int, ...]] = None
    names: Optional[Tuple[str, ...]] = None
    max_abs: float = float("inf")
    grads: bool = True
    loss: bool = True
    moments: bool = False
    max_grad_norm: float = float("inf")
    rewind_after: int = 3


@dataclasses.dataclass
class GuardInfo:
    """Which leaves the guard vector's rows describe, and where the vector
    lands in the plan's outputs."""

    leaves: Tuple[str, ...]
    config: GuardConfig
    out_index: int


class NumericsFault(RuntimeError):
    """A numerics sentinel tripped.  ``faults`` holds one dict per leaf
    (``leaf``, ``kind``: nonfinite / absmax / norm, ``value``);
    ``consecutive`` counts back-to-back faulted steps."""

    def __init__(self, step: int, faults, consecutive: int = 1):
        self.step = int(step)
        self.faults = tuple(faults)
        self.consecutive = int(consecutive)
        leaves = ", ".join(f"{f['leaf']}[{f['kind']}={f['value']:.3g}]"
                           for f in self.faults) or "<none>"
        super().__init__(f"numerics fault at step {self.step} "
                         f"({self.consecutive} consecutive): {leaves}")


def guard_faults(config: GuardConfig, stats, leaves) -> List[Dict]:
    """Decode a guard vector ((2k,): [non-finite, abs max] per leaf, already
    reduced across devices) into per-leaf fault records (empty: clean)."""
    a = np.asarray(stats, dtype=np.float64).reshape(len(leaves), 2)
    faults: List[Dict] = []
    for name, (nonfin, amax) in zip(leaves, a):
        if nonfin > 0 or not np.isfinite(amax):
            faults.append({"leaf": name, "kind": "nonfinite", "value": float(nonfin)})
        elif amax > config.max_abs:
            faults.append({"leaf": name, "kind": "absmax", "value": float(amax)})
    return faults


def _guard_stat_run(env, reads, writes):
    x = env[reads[0]]
    flat = x.reshape(x.shape[0], -1)
    nonfin = (~torch.isfinite(flat)).sum(1).float()
    amax = (flat.float().abs().amax(1) if flat.shape[1]
            else torch.zeros(flat.shape[0], device=x.device))
    env[writes[0]] = torch.stack([nonfin, amax], 1)


def _guard_pack_run(env, reads, writes):
    env[writes[0]] = torch.cat([env[r] for r in reads], 1)


def append_guard_steps(plan: PartitionPlan, guard: GuardConfig,
                       cost_only: bool = False) -> PartitionPlan:
    """Append the numerics-sentinel epilogue to ``plan`` (in place), before
    the optimizer runs, so that its pmax is fused and scheduled like any
    other collective.  Adds one output (the guard vector) and records
    :class:`GuardInfo`; ``guard.outputs`` selects the outputs (None: every
    tensor output)."""
    n_out = len(plan.out_keys)
    sel = guard.outputs if guard.outputs is not None else tuple(range(n_out))
    entries = []
    for pos, i in enumerate(sel):
        if not 0 <= i < n_out:
            raise ValueError(f"guard output index {i} out of range 0..{n_out - 1}")
        k = plan.out_keys[i]
        if not is_env_key(k) or i >= len(plan.outvars):
            continue  # a non-tensor output, or an earlier guard's vector
        a = aval(plan.outvars[i])
        name = (guard.names[pos] if guard.names is not None and pos < len(guard.names)
                else f"out[{i}]")
        lshape = shard_shape(tuple(a.shape), plan.out_shardings[i])
        entries.append((name, k, lshape, a.dtype.itemsize, str(a.dtype)))
    if not entries:
        return plan
    run = (lambda fn: _cost_only_run) if cost_only else (lambda fn: fn)
    stat_keys = []
    for name, k, lshape, db, dt in entries:
        p = ProxyVar(f"guard:{name}")
        # two reduction passes over the local shard (non-finite count, abs max)
        plan.steps.append(PlanStep(
            "compute", (k,), (p,), run(_guard_stat_run), op="guard-stat", lshape=lshape,
            dbytes=db, dtype=dt, flops=2.0 * float(np.prod(lshape or (1,))), wbytes=(8.0,)))
        stat_keys.append(p)
    k2 = 2 * len(entries)
    packed, gout = ProxyVar("guard:pack"), ProxyVar("guard:out")
    plan.steps.append(PlanStep("compute", tuple(stat_keys), (packed,), run(_guard_pack_run),
                               op="guard-pack", lshape=(k2,), dbytes=4, dtype="float32",
                               wbytes=(4.0 * k2,)))
    axes = tuple(plan.mesh.axis_names)
    plan.steps.append(PlanStep("collective", (packed,), (gout,),
                               run(_collective_run(plan.mesh, axes, "max")), op="all-reduce",
                               axes=axes, reduce_op="max", lshape=(k2,), dbytes=4,
                               dtype="float32", wbytes=(4.0 * k2,)))
    plan.stats.count("all-reduce", len(axes))
    plan.out_keys.append(gout)
    plan.out_shardings.append(replicated(plan.mesh, 1))
    plan.guard = GuardInfo(leaves=tuple(e[0] for e in entries), config=guard,
                           out_index=len(plan.out_keys) - 1)
    plan.relive()
    return plan


# ---------------------------------------------------------------------------------
# PlanBuilder: abstract interpretation over shardings, emitting steps
# ---------------------------------------------------------------------------------


class PlanBuilder:
    """Walks a captured graph once, under its completed shardings, and emits
    resolved steps.

    Mirrors ``SpmdPartitioner``'s per-op semantics through the decision and
    local-compute functions it shares with it: every decision the dynamic
    path makes on each call (merge targets, reshard sequences,
    psum-vs-scatter, fallback gathers) is made here once, from shardings and
    static shapes alone.
    """

    def __init__(self, captured, prop: PropagationResult, mesh: Mesh,
                 cost_only: bool = False):
        self.captured = captured
        self.prop = prop
        self.mesh = mesh
        self.cost_only = cost_only
        self.sh: Dict[object, object] = {}
        self.steps: List[PlanStep] = []
        self.stats = PlanStats()
        self.fallbacks: List[str] = []
        self.fallback_gathers: List[str] = []

    # -- sharding/shape bookkeeping ---------------------------------------------
    def _lshape(self, v) -> Tuple[int, ...]:
        return shard_shape(aval(v).shape, self.sh[v])

    @staticmethod
    def _dbytes(v) -> int:
        return aval(v).dtype.itemsize

    @staticmethod
    def _dtype(v) -> str:
        return str(aval(v).dtype)

    def _account(self, prog: ReshardProgram, lshape, dbytes) -> None:
        self.stats.add_program(prog)
        # the same move under both reference schedules: the AllGather-first
        # expression and the pre-planner greedy one
        for attr, gen in (("baseline_bytes", _candidate_gather_all),
                          ("legacy_bytes", _candidate_legacy)):
            cost = prog.cost_bytes  # candidate inexpressible: no claimed saving
            try:
                steps = gen(prog.src, prog.dst, lshape)
                if steps is not None:
                    cost = simulate(prog.src, prog.dst, steps, lshape, dbytes)
            except PlanError:
                pass
            setattr(self.stats, attr, getattr(self.stats, attr) + cost)

    # -- step emission helpers ---------------------------------------------------
    def emit(self, step: PlanStep) -> None:
        if self.cost_only:
            step.run = _cost_only_run
        if not step.wbytes:
            # memory model: local bytes of each written node; a proxy without
            # an explicit hint from its handler is priced as the step's input
            wb = []
            for w in step.writes:
                a = aval(w) if isinstance(w, torch.fx.Node) else None
                if a is not None and isinstance(self.sh.get(w), Sharding):
                    wb.append(_nbytes_of(shard_shape(a.shape, self.sh[w]), a.dtype.itemsize))
                else:
                    wb.append(step.in_bytes)
            step.wbytes = tuple(wb)
        self.steps.append(step)

    def emit_reshard(self, src_key, out_key, prog: ReshardProgram,
                     lshape: Tuple[int, ...], dbytes: int, dtype: str) -> None:
        # local size after the program: gathers grow the shard, slices shrink it
        factor = 1.0
        for s in prog.steps:
            n = self.mesh.axis_size(s.axis)
            if s.op == "all_gather":
                factor *= n
            elif s.op == "dynamic_slice":
                factor /= n
        self.emit(PlanStep(
            "reshard", (src_key,), (out_key,), _reshard_run(prog),
            op="reshard", program=prog, lshape=lshape, dbytes=dbytes, dtype=dtype,
            wbytes=(_nbytes_of(lshape, dbytes) * factor,),
        ))

    def emit_collective(self, src_key, out_key, axes: Tuple[str, ...], reduce_op: str,
                        lshape: Tuple[int, ...], dbytes: int, dtype: str) -> None:
        self.emit(PlanStep(
            "collective", (src_key,), (out_key,), _collective_run(self.mesh, axes, reduce_op),
            op="all-reduce", axes=axes, reduce_op=reduce_op,
            lshape=lshape, dbytes=dbytes, dtype=dtype, wbytes=(_nbytes_of(lshape, dbytes),),
        ))

    def emit_compute(self, reads, write, fn, op: str, flops: float = 0.0, wbytes=(),
                     collectives=None):
        self.emit(PlanStep("compute", tuple(reads), (write,), _compute_run(fn), op=op,
                           flops=flops, wbytes=tuple(wbytes),
                           collectives=dict(collectives or {})))

    def reshard_operand(self, v, tgt: Sharding):
        """Reshard node ``v`` to ``tgt`` by a reshard step; returns the env key
        that holds the result (``v`` itself when it already is in ``tgt``)."""
        cur = self.sh[v]
        if cur.dims_mapping == tgt.dims_mapping:
            return v
        lshape, dbytes = self._lshape(v), self._dbytes(v)
        prog = plan_reshard(cur, tgt, lshape, dbytes)
        self._account(prog, lshape, dbytes)
        proxy = ProxyVar(f"reshard:{cur}->{tgt}")
        self.emit_reshard(v, proxy, prog, lshape, dbytes, self._dtype(v))
        return proxy

    def _emit_program(self, src_key, out_key, prog: Optional[ReshardProgram],
                      lshape, dbytes, dtype):
        """Emit a pre-planned (already accounted) program as a reshard step."""
        if prog is None or prog.is_identity:
            return src_key
        self.emit_reshard(src_key, out_key, prog, lshape, dbytes, dtype)
        return out_key

    # -- the walk -----------------------------------------------------------------
    def build(self) -> PartitionPlan:
        invars, consts, const_bytes = [], {}, 0.0
        for node in self.captured.graph.nodes:
            if node.op == "placeholder":
                a = aval(node)
                self.sh[node] = self.prop.get(node) or replicated(self.mesh, a.ndim)
                invars.append(node)
            elif node.op == "get_attr":
                c = self.captured.constant(node)
                self.sh[node] = replicated(self.mesh, c.ndim)
                const_bytes += float(c.numel() * c.element_size())
                if not self.cost_only:
                    consts[node] = mr.replicate(c, self.mesh)
            elif node.op == "call_function":
                self.stats.eqns += 1
                self.eqn(lower(node))
        out_shardings: List[Optional[Sharding]] = []
        out_keys: List[object] = []
        for v in self.captured.outvars:
            if not isinstance(v, torch.fx.Node):
                out_keys.append(v)
                out_shardings.append(None)
                continue
            cur = self.sh[v]
            want = self.prop.get(v) or replicated(self.mesh, cur.rank)
            key: object = v
            if cur.dims_mapping != want.dims_mapping:
                lshape, dbytes = self._lshape(v), self._dbytes(v)
                prog = plan_reshard(cur, want, lshape, dbytes)
                self._account(prog, lshape, dbytes)
                key = ProxyVar(f"out:{cur}->{want}")
                self.emit_reshard(v, key, prog, lshape, dbytes, self._dtype(v))
            out_keys.append(key)
            out_shardings.append(want)
        self.stats.steps = len(self.steps)
        plan = PartitionPlan(
            self.captured.graph, self.mesh, self.steps, invars,
            [self.sh[v] for v in invars], out_shardings, out_keys, self.stats, consts,
            const_bytes, self.fallbacks, self.fallback_gathers,
            outvars=list(self.captured.outvars))
        plan.peak_bytes = plan_peak_bytes(plan)
        return plan

    # -- per-op lowering ------------------------------------------------------------
    def eqn(self, eqn) -> None:
        name, node = eqn.name, eqn.node
        if node.target is ANNOTATE_OP:
            self._annotate(eqn)
        elif name == "getitem":
            src, i = node.args
            self.sh[node] = self.sh[src][i]
            self.emit_compute((src,), node, lambda t, i=i: t[i], "getitem")
        elif name in DOT:
            self.sh[node] = self._dot(eqn, node)
        elif name == "aten.addmm":
            self._addmm(eqn)
        elif name in ELEMENTWISE and eqn.out_avals:
            self._elementwise(eqn)
        elif name in SCANS:
            self._scan(eqn)
        elif name == STAGE_SHIFT:
            self._stage_shift(eqn)
        elif name in LOCAL_OPS and self._local(eqn):
            pass
        elif name in REDUCE:
            self._reduce(eqn)
        elif name in TRANSPOSE:
            self._transpose(eqn)
        elif name in BROADCAST:
            self._broadcast(eqn)
        elif name in RESHAPE:
            self._reshape(eqn)
        elif name == "aten.convolution":
            self._conv(eqn)
        else:
            self._fallback(eqn)

    def _local_elems(self, node) -> float:
        return float(np.prod(self._lshape(node) or (1,)))

    def _annotate(self, eqn) -> None:
        node = eqn.node
        iv = node.args[0]
        tgt = annotation_target(node, self.prop)
        cur = self.sh[iv]
        self.sh[node] = tgt
        if cur.dims_mapping == tgt.dims_mapping:
            self.emit(PlanStep("compute", (iv,), (node,), _alias_run, op="annotate"))
            return
        lshape, dbytes = self._lshape(iv), self._dbytes(iv)
        prog = plan_reshard(cur, tgt, lshape, dbytes)
        self._account(prog, lshape, dbytes)
        self.emit_reshard(iv, node, prog, lshape, dbytes, self._dtype(iv))

    def _dot(self, eqn, out_key) -> Sharding:
        """The product's steps (operand reshards, the local einsum with any
        ReduceScatter, a trailing AllReduce, the output reshard), writing
        ``out_key``; returns its sharding."""
        (lc, _), _ = eqn.params["dimension_numbers"]
        lv, rv = eqn.invars[-2], eqn.invars[-1]
        eplan = compile_einsum(dot_spec(eqn), self.sh[lv], self.sh[rv],
                               self.prop.get(eqn.node), self._lshape(lv), self._lshape(rv),
                               self._dbytes(lv))
        for prog in (eplan.lhs_program, eplan.rhs_program, eplan.out_program):
            self.stats.add_program(prog)
        for _ in eplan.scatter:
            self.stats.count("reduce-scatter")
        for _ in eplan.reduce_axes:
            self.stats.count("all-reduce")
        out = eqn.out_avals[0]
        odt, odb = str(out.dtype), out.dtype.itemsize
        lk = self._emit_program(lv, ProxyVar("dot.lhs"), eplan.lhs_program,
                                self._lshape(lv), self._dbytes(lv), self._dtype(lv))
        rk = self._emit_program(rv, ProxyVar("dot.rhs"), eplan.rhs_program,
                                self._lshape(rv), self._dbytes(rv), self._dtype(rv))
        # local shape of the partial result at the psum point (post-scatter)
        pre_out = eplan.out_program.src if eplan.out_program is not None else eplan.final_sharding
        zshape = shard_shape(out.shape, pre_out)
        # per-device local FLOPs: 2 · |local output| · |local contraction|
        k_local = 1.0
        for ci in lc:
            k_local *= eqn.in_avals[-2].shape[ci] / max(eplan.lhs_local.num_shards(ci), 1)
        exec_plan = dataclasses.replace(eplan, lhs_program=None, rhs_program=None,
                                        reduce_axes=(), out_program=None)
        tail = bool(eplan.reduce_axes) or eplan.out_program is not None
        mid = ProxyVar("dot.z") if tail else out_key
        self.emit_compute((lk, rk), mid,
                          lambda x, y, p=exec_plan, t=out.dtype: execute_einsum(p, x, y, t)[0],
                          eqn.name, flops=2.0 * float(np.prod(zshape or (1,))) * k_local,
                          wbytes=(_nbytes_of(zshape, odb),),
                          collectives={"reduce-scatter": len(eplan.scatter)} if eplan.scatter
                          else None)
        cur = mid
        if eplan.reduce_axes:
            nxt = out_key if eplan.out_program is None else ProxyVar("dot.psum")
            self.emit_collective(cur, nxt, tuple(eplan.reduce_axes), "add", zshape, odb, odt)
            cur = nxt
        if eplan.out_program is not None:
            self.emit_reshard(cur, out_key, eplan.out_program, zshape, odb, odt)
        return eplan.final_sharding

    def _addmm(self, eqn) -> None:
        node, z = eqn.node, ProxyVar("addmm.z")
        zsh = self._dot(eqn, z)
        bv = eqn.invars[0]
        bs, out_rank = self.sh[bv], eqn.out_avals[0].ndim
        bmap = _bcast_map(eqn.in_avals[0].shape, eqn.out_avals[0].shape)
        bk = self.reshard_operand(bv, _project(zsh, _invert(bmap, bs.rank), bs.rank))
        beta, alpha = eqn.params["beta"], eqn.params["alpha"]

        def run(b, z, r=bs.rank):
            b = align(b, r, out_rank)
            return (b if beta == 1 else beta * b) + (z if alpha == 1 else alpha * z)

        self.sh[node] = zsh
        self.emit_compute((bk, z), node, run, eqn.name, flops=self._local_elems(node))

    def _elementwise(self, eqn) -> None:
        tgt, targets = elementwise_targets(eqn, [self.sh[v] for v in eqn.invars], self.mesh)
        keys = [self.reshard_operand(v, t) for v, t in zip(eqn.invars, targets)]
        self.sh[eqn.node] = tgt
        self.emit_compute(keys, eqn.node, elementwise_local(eqn), eqn.name,
                          flops=self._local_elems(eqn.node))

    def _reduce(self, eqn) -> None:
        node, iv, name = eqn.node, eqn.invars[0], eqn.name
        sh = self.sh[iv]
        psum_axes, gather_first, osh = reduce_decision(eqn, sh, self.mesh)
        key = iv
        if gather_first:  # prod/any/all: gather the reduced axes first
            key = self.reshard_operand(iv, replicated(self.mesh, sh.rank))
            sh = replicated(self.mesh, sh.rank)
        elif psum_axes:
            self.stats.count("all-reduce", len(psum_axes))
        self.sh[node] = osh
        out = eqn.out_avals[0]
        olshape, odb, odt = shard_shape(out.shape, osh), out.dtype.itemsize, str(out.dtype)
        axes, keepdim = eqn.params["axes"], eqn.params["keepdim"]
        mean = name == "aten.mean" and bool(psum_axes)
        mid = ProxyVar("reduce.local") if psum_axes else node
        self.emit_compute(
            (key,), mid, lambda x: local_reduce(name, x, axes, keepdim, out.dtype), name,
            flops=float(np.prod(shard_shape(eqn.in_avals[0].shape, sh) or (1,))),
            wbytes=(_nbytes_of(olshape, odb),))
        if psum_axes:
            nxt = ProxyVar("reduce.psum") if mean else node
            self.emit_collective(mid, nxt, psum_axes, REDUCE_OP[name], olshape, odb, odt)
            if mean:  # the mean of local means: the psum over the group size
                n = group_size(self.mesh, psum_axes)
                self.emit_compute((nxt,), node, lambda x: x / n, "mean-divide",
                                  flops=float(np.prod(olshape or (1,))))

    def _transpose(self, eqn) -> None:
        iv, perm = eqn.invars[0], eqn.params["permutation"]
        self.sh[eqn.node] = transpose_sharding(eqn, self.sh[iv], self.mesh)
        order = (0,) + tuple(p + 1 for p in perm)
        self.emit_compute((iv,), eqn.node, lambda x: x.permute(order), eqn.name)

    def _broadcast(self, eqn) -> None:
        iv = eqn.invars[0]
        osh = broadcast_sharding(eqn, self.sh[iv], self.mesh)
        self.sh[eqn.node] = osh
        bcast = eqn.params["broadcast_dimensions"]
        local_shape = shard_shape(tuple(eqn.params["shape"]), osh)
        self.emit_compute((iv,), eqn.node, lambda x: broadcast_local(x, bcast, local_shape),
                          eqn.name)

    def _reshape(self, eqn) -> None:
        node, iv = eqn.node, eqn.invars[0]
        sh, want = self.sh[iv], self.prop.get(node)
        gshape = tuple(eqn.out_avals[0].shape)
        if want is not None and local_reshape_ok(eqn.in_avals[0].shape, gshape, sh, want):
            local = shard_shape(gshape, want)
            self.sh[node] = want
            self.emit_compute((iv,), node, lambda x: x.reshape((x.shape[0],) + local), eqn.name)
            return
        mid = reshape_carried(eqn.in_avals[0].shape, gshape, sh, want) if want is not None else None
        if mid is not None:
            # reshape each shard, then slice what ``want`` adds (a
            # stage-folded batch split back keeps its stage sharding)
            local, dbytes = shard_shape(gshape, mid), self._dbytes(iv)
            self.sh[node] = want
            key = ProxyVar("reshape.local")
            self.emit_compute((iv,), key, lambda x: x.reshape((x.shape[0],) + local), eqn.name)
            prog = plan_reshard(mid, want, local, dbytes)
            self._account(prog, local, dbytes)
            self.emit_reshard(key, node, prog, local, dbytes, self._dtype(iv))
            return
        # gather, reshape globally, re-slice
        key = self.reshard_operand(iv, replicated(self.mesh, sh.rank))
        osh = want or replicated(self.mesh, len(gshape))
        slice_prog = None
        if not osh.is_fully_replicated():
            slice_prog = plan_reshard(replicated(self.mesh, len(gshape)), osh, gshape,
                                      self._dbytes(iv))
            self.stats.add_program(slice_prog)
        self.sh[node] = osh
        mid = ProxyVar("reshape.global") if slice_prog is not None else node
        self.emit_compute((key,), mid, lambda x: x.reshape((x.shape[0],) + gshape), eqn.name,
                          wbytes=(_nbytes_of(gshape, self._dbytes(iv)),))
        if slice_prog is not None:
            self.emit_reshard(mid, node, slice_prog, gshape, self._dbytes(iv), self._dtype(iv))

    def _conv(self, eqn) -> None:
        node, p = eqn.node, eqn.params
        lv, rv = eqn.invars
        tgt = conv_target(eqn, self.sh[lv], self.mesh)
        if tgt is None:
            self._fallback(eqn)
            return
        rk = self.reshard_operand(rv, replicated(self.mesh, self.sh[rv].rank))
        lk = self.reshard_operand(lv, tgt)
        strides, padding, mesh = p["window_strides"], p["padding"], self.mesh
        out = eqn.out_avals[0]
        rsh = eqn.in_avals[1].shape
        k_per_out = float(np.prod(rsh)) / max(rsh[0], 1)
        after = ProxyVar("conv.out") if p["has_bias"] else node
        if tgt.dims_mapping[1]:
            # feature-dim sharded: contract locally then psum (Megatron-style)
            ax = tgt.dims_mapping[1]
            osh = Sharding(mesh, (tgt.dims_mapping[0], ()) + ((),) * (tgt.rank - 2))
            out_local = shard_shape(out.shape, osh)
            self.stats.count("all-reduce", len(ax))
            mid = ProxyVar("conv.partial")
            self.emit_compute(
                (lk, rk), mid, lambda x, w: conv_feature_local(x, w, mesh, ax, strides, padding),
                "conv", flops=2.0 * float(np.prod(out_local)) * k_per_out / group_size(mesh, ax),
                wbytes=(_nbytes_of(out_local, out.dtype.itemsize),))
            self.emit_collective(mid, after, ax, "add", out_local, out.dtype.itemsize,
                                 str(out.dtype))
        else:
            osh = tgt
            out_local = shard_shape(out.shape, osh)
            self.emit_compute(
                (lk, rk), after, lambda x, w: conv_halo_local(x, w, mesh, tgt, strides, padding),
                "conv", flops=2.0 * float(np.prod(out_local)) * k_per_out,
                wbytes=(_nbytes_of(out_local, out.dtype.itemsize),))
        self.sh[node] = osh
        if p["has_bias"]:
            bk = self.reshard_operand(node.args[2], replicated(mesh, 1))
            self.emit_compute((after, bk), node, conv_bias, "conv-bias",
                              flops=float(np.prod(out_local)))

    def _local(self, eqn) -> bool:
        """A ``LocalOp`` decision as one compute step after its operands'
        reshards; False where the op must take the fallback instead."""
        node = eqn.node
        d = LOCAL_OPS[eqn.name](eqn, [self.sh[v] for v in eqn.invars],
                                _want(eqn, self.prop), self.mesh)
        if d is None:
            return False
        keys = [self.reshard_operand(v, t) for v, t in zip(eqn.invars, d.targets)]
        self.sh[node] = d.out
        for kind, n in d.collectives.items():
            self.stats.count(kind, n)
        outs = list(zip(eqn.out_avals, [d.out])) if eqn.out_avals else \
            list(zip(eqn.tuple_avals, d.out))
        wbytes = sum(_nbytes_of(shard_shape(a.shape, sh), a.dtype.itemsize)
                     for a, sh in outs if a is not None)
        self.emit_compute(keys, node, d.fn, eqn.name, flops=d.flops, wbytes=(wbytes,),
                          collectives=d.collectives)
        return True

    def _scan(self, eqn) -> None:
        """One call step over the body plan (the reference's ``_scan``): the
        operands resharded to the body's input shardings
        (``scan_body_shardings``), the body planned once, a carry that would
        leave the body in another sharding than it enters with resharded at
        the body's end, the ys stacked on an unsharded leading dim; the body
        counted at trip count, its fallbacks listed with the plan's."""
        node, p = eqn.node, eqn.params
        nc, nk, L = p["num_consts"], p["num_carry"], p["length"]
        if L < 1:
            raise NotImplementedError(f"scan of length {L}: nothing to plan")
        targets, inner_res = scan_body_shardings(eqn, self.prop,
                                                 [self.sh[v] for v in eqn.invars], self.mesh)
        keys = [self.reshard_operand(v, t) for v, t in zip(eqn.invars, targets)]
        inner = PlanBuilder(p["body"], inner_res, self.mesh, cost_only=self.cost_only).build()
        self.fallbacks += inner.fallbacks  # the body's, as the dynamic path reports them
        self.fallback_gathers += inner.fallback_gathers
        for i in range(nk):
            _keep_carry_sharding(inner, i, inner.in_shardings[nc + i], self.cost_only)
        outs = [inner.in_shardings[nc + i] for i in range(nk)] + [
            add0(s) for s in inner.out_shardings[nk:]]
        self.sh[node] = outs
        self.stats.add_inner(inner.stats, L)
        avals = list(eqn.tuple_avals)
        wbytes = sum(_nbytes_of(shard_shape(a.shape, sh), a.dtype.itemsize)
                     for a, sh in zip(avals, outs) if a is not None)
        self.emit(PlanStep("compute", tuple(keys), (node,),
                           _scan_run(inner, nc, nk, tuple(trip_order(eqn))), op="scan",
                           flops=L * inner.total_flops(), wbytes=(wbytes,),
                           transient_bytes=inner.peak_bytes, inner=inner,
                           call={"trips": int(L), "num_consts": nc, "num_carry": nk}))

    def _stage_shift(self, eqn) -> None:
        """§3.3 shifting buffer (the reference's ``_stage_shift``): ``out[0]=x,
        out[s]=state[s-1]``, or the mirror image under ``reverse``.

        * stage dim replicated: one local concatenate, no communication;
        * stage dim on one mesh axis: three steps: the boundary stage row
          (the last local row, the first under ``reverse``), a ppermute of
          it one position along the axis (a first-class ``collective``
          step, which the optimizer prices, schedules and fuses), and the
          stitch of the received row in front of the remaining local rows,
          where the edge device takes the injected row instead;
        * stage dim on stacked axes: the stage dim gathered first (correct;
          the pipeline never emits this layout)."""
        node, mesh = eqn.node, self.mesh
        sv, xv = eqn.invars
        reverse = eqn.params["reverse"]
        s = self.sh[sv]
        axes = s.dims_mapping[0]
        n = group_size(mesh, axes) if axes else 1
        sk = sv
        if n > 1 and len(axes) > 1:
            s = Sharding(mesh, ((),) + s.dims_mapping[1:])
            sk = self.reshard_operand(sv, s)
            axes, n = (), 1
        # the injected row agrees with the state's trailing dims and is
        # replicated along the stage axis (it enters on one edge device)
        xk = self.reshard_operand(xv, Sharding(mesh, s.dims_mapping[1:]))
        self.sh[node] = s
        lshape = shard_shape(eqn.in_avals[0].shape, s)
        dbytes, dtype = self._dbytes(sv), self._dtype(sv)
        out_bytes = _nbytes_of(lshape, dbytes)
        flops = float(np.prod(lshape or (1,)))
        if n <= 1:
            self.emit_compute((sk, xk), node, lambda st, x: shift_local(st, x, reverse, dim=1),
                              "stage_shift", flops=flops, wbytes=(out_bytes,))
            return
        ax = axes[0]
        bshape = (1,) + tuple(lshape[1:])
        bbytes = _nbytes_of(bshape, dbytes)
        boundary, recv = ProxyVar("shift.boundary"), ProxyVar("shift.recv")
        self.emit(PlanStep("compute", (sk,), (boundary,),
                           _compute_run(lambda st: st[:, :1] if reverse else st[:, -1:]),
                           op="shift-boundary", lshape=lshape, dbytes=dbytes, dtype=dtype,
                           wbytes=(bbytes,)))
        perm = (tuple((i + 1, i) for i in range(n - 1)) if reverse
                else tuple((i, i + 1) for i in range(n - 1)))
        self.stats.count("collective-permute")
        self.emit(PlanStep("collective", (boundary,), (recv,),
                           _compute_run(lambda b: mr.ppermute(b, mesh, ax, perm)), op="ppermute",
                           axes=(ax,), lshape=bshape, dbytes=dbytes, dtype=dtype,
                           wbytes=(bbytes,), call={"perm": perm}))
        edge = tuple(bool(i == (n - 1 if reverse else 0)) for i in mr.axis_index(mesh, ax))

        def stitch(recv, st, x):
            at_edge = mr._on_device(edge, torch.bool, x.device).reshape((-1,) + (1,) * (x.ndim - 1))
            return shift_local(st, torch.where(at_edge, x, recv[:, 0]), reverse, dim=1)

        self.emit(PlanStep("compute", (recv, sk, xk), (node,), _compute_run(stitch),
                           op="shift-stitch", lshape=lshape, dbytes=dbytes, dtype=dtype,
                           flops=flops, wbytes=(out_bytes,)))

    def _fallback(self, eqn) -> None:
        """Gather → op → reshard (§4.5), gathering only the dims the op
        modifies where the op's touched dims are known."""
        node, mesh = eqn.node, self.mesh
        self.fallbacks.append(eqn.name)
        in_sh = [self.sh[v] for v in eqn.invars]
        kept = fallback_keep_sharding(eqn, in_sh, mesh)
        targets = [kept if kept is not None and a.ndim == kept.rank
                   else replicated(mesh, a.ndim) for a in eqn.in_avals]
        if any(gathers(s, t) for s, t in zip(in_sh, targets)):
            self.fallback_gathers.append(eqn.name)
        keys = [self.reshard_operand(v, t) for v, t in zip(eqn.invars, targets)]
        out = eqn.out_avals[0] if eqn.out_avals else None
        if kept is not None:
            osh = Sharding(mesh, tuple(kept.dims_mapping[d] if d < kept.rank else ()
                                       for d in range(out.ndim)))
            fn = fallback_local(eqn)
        else:
            osh = replicated(mesh, out.ndim) if out is not None else None
            fn = fallback_global(eqn, mesh)
        if out is None:  # a tuple (read back by getitem nodes) or a non-tensor
            val = node.meta.get("val")
            self.sh[node] = ([replicated(mesh, o.ndim) if isinstance(o, torch.Tensor) else None
                              for o in val] if isinstance(val, (list, tuple)) else None)
            self.emit_compute(keys, node, fn, eqn.name)
            return
        want = self.prop.get(node) or osh
        self.sh[node] = want
        mid = node if osh.dims_mapping == want.dims_mapping else ProxyVar("fallback.out")
        lshape, db = shard_shape(out.shape, osh), out.dtype.itemsize
        self.emit_compute(keys, mid, fn, eqn.name, flops=float(np.prod(lshape or (1,))),
                          wbytes=(_nbytes_of(lshape, db),))
        if mid is not node:
            prog = plan_reshard(osh, want, lshape, db)
            self.stats.add_program(prog)
            self.emit_reshard(mid, node, prog, lshape, db, str(out.dtype))


def _keep_carry_sharding(plan: PartitionPlan, i: int, want: Sharding,
                        cost_only: bool = False) -> None:
    """Make a body plan's output ``i`` leave in ``want``: a carry must leave
    the body in the sharding it enters with, or the next trip misreads it.
    Appends a reshard step where the body leaves it otherwise."""
    cur = plan.out_shardings[i]
    if cur.dims_mapping == want.dims_mapping:
        return
    a = aval(plan.outvars[i])
    lshape, db = shard_shape(a.shape, cur), a.dtype.itemsize
    prog = plan_reshard(cur, want, lshape, db)
    plan.stats.add_program(prog)
    key = ProxyVar(f"carry:{cur}->{want}")
    out_bytes = _nbytes_of(shard_shape(a.shape, want), db)
    plan.steps.append(PlanStep("reshard", (plan.out_keys[i],), (key,),
                               _cost_only_run if cost_only else _reshard_run(prog),
                               op="reshard", program=prog, lshape=lshape, dbytes=db,
                               dtype=str(a.dtype), wbytes=(out_bytes,)))
    plan.out_keys[i] = key
    plan.out_shardings[i] = want
    plan.relive()
    plan.peak_bytes = plan_peak_bytes(plan)


# ---------------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------------


def compile_plan(captured, prop: PropagationResult, mesh: Mesh, optimize: bool = True,
                 cost_only: bool = False, verify: Optional[bool] = None,
                 guard: Optional[GuardConfig] = None,
                 profile: Optional[RooflineParams] = None) -> PartitionPlan:
    """Lower a captured graph under its completed shardings into a
    :class:`PartitionPlan`.

    ``optimize=True`` runs the whole-program optimizer
    (``plan_opt.optimize_plan``: reshard CSE, dead-reshard elimination,
    alias sinking, collective fusion, overlap scheduling).  It prices its
    choices with ``profile`` (a :class:`RooflineParams`); the port has no
    default constants, so without one it raises ``ValueError``.  ``guard``
    (a :class:`GuardConfig`) appends the numerics-sentinel epilogue before
    the optimizer runs.  ``verify`` runs the static verifier
    (``plan_verify.verify_plan``) on the finished plan: ``None`` (the
    default) and ``True`` run it, ``False`` does not.  ``cost_only=True``
    replaces every step's runner with a raising stub: the plan prices but
    never runs.  A scan's body plan is built, optimized and verified with
    its plan (``PlanStep.inner``).
    """
    if optimize and profile is None:
        raise ValueError(
            "compile_plan(optimize=True) prices the optimizer's passes with a machine "
            "profile and the port has no default constants: pass profile=RooflineParams(...) "
            "or optimize=False")
    t0 = search_telemetry()
    plan = PlanBuilder(captured, prop, mesh, cost_only=cost_only).build()
    plan.params = profile
    if guard is not None:
        append_guard_steps(plan, guard, cost_only=cost_only)
        plan.peak_bytes = plan_peak_bytes(plan)
    if optimize:
        from .plan_opt import optimize_plan

        optimize_plan(plan)
    t1 = search_telemetry()
    plan.stats.lattice = {k: t1[k] - t0[k] for k in t1}
    from .plan_verify import verify_enabled, verify_plan

    if verify_enabled(verify):
        verify_plan(plan)
    return plan


def plan_peak_bytes(plan: PartitionPlan) -> float:
    """Modeled per-device live-memory peak of one plan execution.

    Inputs and constants are resident for the whole plan; intermediates are
    allocated at their producing step (each step's ``wbytes``) and freed
    after their last reader; outputs stay live to the end.  A scan step adds
    its body plan's peak as a transient while it runs, less the body's
    consts and xs slices: those are views of values live in this plan
    already.  The body's carry stays in the transient: from the second trip
    on it is the previous trip's output, a buffer of its own, while this
    plan's initial carry stays live until the scan step ends.
    """
    resident = plan.const_bytes + sum(_input_sizes(plan))
    pinned = {id(v) for v in plan.invars}
    last_read: Dict[int, int] = {}
    for i, step in enumerate(plan.steps):
        for k in step.reads:
            last_read[id(k)] = i
    for k in plan.out_keys:
        last_read[id(k)] = len(plan.steps)
    live = peak = resident
    freed_after: Dict[int, float] = {}  # step index -> bytes its end frees
    for i, step in enumerate(plan.steps):
        for w, b in zip(step.writes, step.wbytes):
            if id(w) in pinned:
                continue
            live += b
            end = max(i, last_read.get(id(w), -1))
            freed_after[end] = freed_after.get(end, 0.0) + b
        transient = step.transient_bytes
        if step.inner is not None:
            nc, nk = step.call["num_consts"], step.call["num_carry"]
            sizes = _input_sizes(step.inner)
            transient -= sum(sizes[:nc]) + sum(sizes[nc + nk:])
        peak = max(peak, live + transient)
        live -= freed_after.pop(i, 0.0)
    return peak


def _input_sizes(plan: PartitionPlan) -> List[float]:
    """Per-device bytes of each of a plan's inputs under its input shardings."""
    return [_nbytes_of(shard_shape(aval(v).shape, s), aval(v).dtype.itemsize)
            for v, s in zip(plan.invars, plan.in_shardings)]


@dataclasses.dataclass
class PlanCost:
    """Whole-program modeled cost of one lowered plan.

    The modeled quantities (wire bytes, launches, per-device and ideal
    FLOPs, peak bytes, steps) need no machine constant.  The time-valued
    properties price them with ``params`` (a :class:`RooflineParams`); the
    port has no default constants, so with no params they raise.
    :attr:`total_s` is max-of-terms: the roofline overlap time of the
    compute term (per-device FLOPs / peak) and the collective term (wire
    bytes / link bandwidth + a launch cost per collective), plus
    :attr:`mem_s`, the optional soft-budget memory term (off at the default
    weight 0).
    """

    wire_bytes: float
    launches: int
    flops_per_device: float
    ideal_flops_per_device: float
    peak_bytes: float
    steps: int
    soft_budget_bytes: Optional[float] = None
    mem_weight: float = 0.0
    params: Optional[RooflineParams] = None

    def _p(self) -> RooflineParams:
        if self.params is None:
            raise ValueError(
                "PlanCost: no machine profile (RooflineParams) to price time with: pass "
                "profile= to compile_plan / lower_plan / lower_for_cost (the committed H100 "
                "profile is repro_torch.obs.profile.resolve_profile())")
        return self.params

    @property
    def collective_s(self) -> float:
        p = self._p()
        return self.wire_bytes / p.ici_bw + self.launches * p.collective_launch_s

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self._p().peak_flops

    @property
    def imbalance_s(self) -> float:
        excess = max(self.flops_per_device - self.ideal_flops_per_device, 0.0)
        return excess / self._p().peak_flops

    @property
    def mem_s(self) -> float:
        """Soft-budget memory term: the peak's overshoot above
        ``soft_budget_bytes`` over the HBM bandwidth, times ``mem_weight``;
        0 when the term is off (no soft budget or weight 0) or the peak is
        under the budget."""
        p = self._p()
        if not self.mem_weight or self.soft_budget_bytes is None:
            return 0.0
        return self.mem_weight * max(self.peak_bytes - self.soft_budget_bytes, 0.0) / p.hbm_bw

    @property
    def total_s(self) -> float:
        return overlap_time_s(self.compute_s, self.collective_s, self._p()) + self.mem_s

    def as_dict(self) -> Dict:
        d = {"wire_bytes": self.wire_bytes, "launches": self.launches,
             "flops_per_device": self.flops_per_device,
             "ideal_flops_per_device": self.ideal_flops_per_device,
             "peak_bytes": self.peak_bytes, "steps": self.steps}
        if self.params is not None:
            d.update(collective_s=self.collective_s, compute_s=self.compute_s,
                     imbalance_s=self.imbalance_s, mem_s=self.mem_s, total_s=self.total_s)
        return d


def plan_cost(plan: PartitionPlan) -> PlanCost:
    """Price an already-lowered plan under the roofline cost model: wire
    bytes and launches as ``plan_opt.whole_wire_bytes`` and
    ``whole_collective_launches`` count them (a compute step's recorded
    collectives launch, R9's reduce-scatter excepted)."""
    from .plan_opt import whole_collective_launches, whole_wire_bytes

    return PlanCost(
        wire_bytes=whole_wire_bytes(plan),
        launches=whole_collective_launches(plan),
        flops_per_device=plan.total_flops(),
        ideal_flops_per_device=count_flops(plan.graph) / max(plan.mesh.size, 1),
        peak_bytes=plan.peak_bytes,
        steps=len(plan.steps),
        params=plan.params,
    )


def lower_plan(captured, in_shardings, mesh: Mesh, optimize: bool = True,
               verify: Optional[bool] = None, guard: Optional[GuardConfig] = None,
               profile: Optional[RooflineParams] = None) -> PartitionPlan:
    """Cost-only lowering that returns the :class:`PartitionPlan` itself
    (step runners are raising stubs: the plan prices, it does not run).

    ``captured`` is a ``compat.capture`` of the program, typically on fake
    or meta tensors; ``in_shardings`` is one ``Optional[Sharding]`` per
    input, ``None`` entries left for propagation to infer.  Raises
    ``PlanError`` when the program demands a reshard the planner cannot
    express.
    """
    prop = propagate(captured, mesh, in_shardings=list(in_shardings or []))
    return compile_plan(captured, prop.result(), mesh, optimize=optimize, cost_only=True,
                        verify=verify, guard=guard, profile=profile)


def lower_for_cost(captured, in_shardings, mesh: Mesh, optimize: bool = True,
                   verify: Optional[bool] = None, guard: Optional[GuardConfig] = None,
                   profile: Optional[RooflineParams] = None) -> PlanCost:
    """:func:`lower_plan`, priced: no execution, no device."""
    return plan_cost(lower_plan(captured, in_shardings, mesh, optimize=optimize,
                                verify=verify, guard=guard, profile=profile))


# ---------------------------------------------------------------------------------
# state-reshard plans: cross-topology checkpoint restore as a compiled program
# ---------------------------------------------------------------------------------
#
# Restoring a checkpoint saved on one mesh onto another is a pure layout
# problem: every leaf has a *source* sharding (the manifest's spec projected
# onto the new mesh: axes that no longer exist or divide become replication)
# and a *target* sharding.  One reshard program per leaf is lowered by the
# cost-model planner, priced with the same model as any partition plan, and
# replayed on the simulated mesh's stacked shards.


def dtype_bytes(dtype: str) -> int:
    """Bytes per element of a dtype named as a manifest names it ("float32",
    "bfloat16", "int32", ...)."""
    return getattr(torch, str(dtype)).itemsize


@dataclasses.dataclass
class LeafReshard:
    """One leaf's planned source->target layout change."""

    key: str
    src: Sharding
    dst: Sharding
    global_shape: Tuple[int, ...]
    dtype: str
    program: ReshardProgram

    @property
    def is_identity(self) -> bool:
        return self.program.is_identity


@dataclasses.dataclass
class StateReshardPlan:
    """A compiled cross-topology restore: per-leaf reshard programs on one
    (target) mesh, priced like any other plan.

    Planning is pure (no tensors), so a full-size restore is priced on the
    host; :meth:`execute` replays each program on the stacked shards of its
    leaf's source layout.  Time-valued fields need ``params`` (a
    :class:`RooflineParams`): the port has no default constants.
    """

    mesh: Mesh
    leaves: List[LeafReshard]
    stats: PlanStats
    gather_all_bytes: float = 0.0  # reference: replicate-then-slice restore
    params: Optional[RooflineParams] = None

    @property
    def wire_bytes(self) -> float:
        return sum(l.program.cost_bytes for l in self.leaves)

    @property
    def launches(self) -> int:
        return sum(1 for l in self.leaves for s in l.program.steps if s.op != "dynamic_slice")

    @property
    def resharded_leaves(self) -> int:
        return sum(1 for l in self.leaves if not l.is_identity)

    def cost(self) -> PlanCost:
        """A restore is all collectives: ``collective_s`` is its time (wire
        bytes over the link rate plus a launch cost each)."""
        peak = sum(max(_nbytes_of(shard_shape(l.global_shape, l.src), dtype_bytes(l.dtype)),
                       _nbytes_of(shard_shape(l.global_shape, l.dst), dtype_bytes(l.dtype)))
                   for l in self.leaves)
        return PlanCost(wire_bytes=self.wire_bytes, launches=self.launches,
                        flops_per_device=0.0, ideal_flops_per_device=0.0,
                        peak_bytes=peak, steps=len(self.leaves), params=self.params)

    def source_specs(self) -> Dict[str, Sharding]:
        """Per-leaf source shardings (the checkpoint's layout on the mesh)."""
        return {l.key: l.src for l in self.leaves}

    def target_specs(self) -> Dict[str, Sharding]:
        """Per-leaf destination shardings (the new layout)."""
        return {l.key: l.dst for l in self.leaves}

    def report(self) -> Dict:
        """The reference's report keys; ``reshard_s`` is None without
        ``params``."""
        cost = self.cost()
        return {
            "leaves": len(self.leaves),
            "resharded_leaves": self.resharded_leaves,
            "wire_bytes": self.wire_bytes,
            "launches": self.launches,
            "gather_all_bytes": self.gather_all_bytes,
            "ratio_vs_gather_all": (self.wire_bytes / self.gather_all_bytes
                                    if self.gather_all_bytes else 1.0),
            "reshard_s": cost.collective_s if self.params is not None else None,
            "collectives": dict(self.stats.collectives),
        }

    def execute_leaf(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Leaf ``i``'s program on ``x``, the stacked shards of its source
        layout; returns the stacked shards of its target layout."""
        return execute_program(x, self.leaves[i].program)

    def execute(self, arrays) -> Tuple[torch.Tensor, ...]:
        """Every leaf's program on its stacked source shards, in order."""
        return tuple(self.execute_leaf(i, x) for i, x in enumerate(arrays))


def compile_state_reshard(items, mesh: Mesh, verify: Optional[bool] = None,
                          profile: Optional[RooflineParams] = None) -> StateReshardPlan:
    """Lower a cross-topology state restore into a :class:`StateReshardPlan`.

    ``items`` holds ``(key, src, dst, global_shape, dtype)`` with both
    shardings on ``mesh`` (project manifest specs with
    ``sharding.project_dims_mapping`` first).  Each leaf's program is chosen
    by ``plan_reshard``; the replicate-then-slice restore is priced as
    ``gather_all_bytes``.  Raises ``PlanError`` when a layout change is
    inexpressible.  The plan is verified (``plan_verify.verify_state_reshard``)
    unless ``verify`` is False.
    """
    leaves: List[LeafReshard] = []
    stats = PlanStats()
    gather_bytes = 0.0
    for key, src, dst, shape, dtype in items:
        shape = tuple(int(s) for s in shape)
        db = dtype_bytes(dtype)
        local = shard_shape(shape, src)
        prog = plan_reshard(src, dst, local, dtype_bytes=db)
        stats.add_program(prog)
        stats.steps += 1
        ref_steps = _candidate_gather_all(src, dst, local)
        if ref_steps is not None:
            gather_bytes += simulate(src, dst, ref_steps, local, db)
        leaves.append(LeafReshard(key, src, dst, shape, str(dtype), prog))
    plan = StateReshardPlan(mesh, leaves, stats, gather_bytes, profile)
    from .plan_verify import verify_enabled, verify_state_reshard

    if verify_enabled(verify):
        verify_state_reshard(plan)
    return plan
