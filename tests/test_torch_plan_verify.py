"""The static plan verifier (``core/plan_verify.py``): seeded plan
corruptions must be caught (tests/test_plan_verify.py's cases).

Each test builds a valid plan through the normal compile path (so it
verifies clean), applies one mutation of the kind a broken optimizer pass
would make, and asserts that ``verify_plan`` reports it with the same kind
of message as the reference's verifier: a dropped reshard, a swapped spec, a
schedule that breaks dependencies, a dangling alias, a double write, a bad
permutation, an axis not in the mesh, negative costs and counters, a
cost-bytes mismatch and a wire-accounting mismatch.  The port adds a check
the reference's plans do not need: the collectives a compute step runs
inside itself (a ``LocalOp``'s) are recorded on the step, and a plan whose
record was dropped no longer matches its ``PlanStats``.  The scan-body
cases are in tests/test_torch_scan.py; the state-reshard cases wait for
ROADMAP A14.
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis.roofline import RooflineParams
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core.compat import capture
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.plan import (GuardConfig, PlanStep, ProxyVar, _cost_only_run,
                                   compile_plan, lower_for_cost, lower_plan)
from repro_torch.core.plan_verify import PlanVerifyError, verify_plan, verify_telemetry
from repro_torch.core.propagation import propagate

MESH = Mesh.create((4, 8), ("x", "y"))
PROFILE = RooflineParams(peak_flops=1e15, hbm_bw=3e12, ici_bw=4.5e11, collective_launch_s=2e-5,
                         overlap_efficiency=0.9)
Y = mesh_split(2, MESH, ["y", -1])


def _meta(*shapes):
    return [torch.empty(s, device="meta") for s in shapes]


def _plan(f, *shapes, optimize=True, verify=False, guard=None):
    cap = capture(f, *_meta(*shapes))
    prop = propagate(cap, MESH).result()
    return compile_plan(cap, prop, MESH, optimize=optimize, cost_only=True, verify=verify,
                        guard=guard, profile=PROFILE)


def _mlp(a, w1, w2):
    # a reshards to contract with the "y"-row-sharded weights, and the
    # sharded contraction psums: the plan has reshards and collectives
    a, w1, w2 = annotate(a, Y), annotate(w1, Y), annotate(w2, Y)
    return (a @ w1) + (a @ w2)


MLP = (64, 64), (64, 64), (64, 64)


def _violations(plan):
    return verify_plan(plan, strict=False).violations


# ---------------------------------------------------------------------------------
# clean plans verify
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("optimize", [False, True])
def test_clean_plans_verify_ok(optimize):
    plan = _plan(_mlp, *MLP, optimize=optimize)
    rep = verify_plan(plan)
    assert rep.ok and rep.plans == 1 and rep.steps == len(plan.steps)


@pytest.mark.parametrize("optimize", [False, True])
def test_guarded_plan_verifies_ok(optimize):
    plan = _plan(lambda a, b: torch.tanh(annotate(a, Y) @ b), (16, 16), (16, 16),
                 optimize=optimize, guard=GuardConfig())
    assert plan.guard is not None and verify_plan(plan).ok


def test_telemetry_counts():
    before = verify_telemetry()
    _plan(_mlp, *MLP, verify=True)
    after = verify_telemetry()
    assert after["plans_verified"] > before["plans_verified"]
    assert after["violations"] == before["violations"]


def test_compile_paths_verify_by_default_and_verify_false_disables():
    before = verify_telemetry()["plans_verified"]
    cap = capture(_mlp, *_meta(*MLP))
    prop = propagate(cap, MESH).result()
    compile_plan(cap, prop, MESH, optimize=False)
    lower_for_cost(cap, None, MESH, optimize=True, profile=PROFILE)
    spmd_partition(lambda x: annotate(x, Y) * 2, MESH, optimize=False, device="cpu")(
        torch.ones(8, 8))
    assert verify_telemetry()["plans_verified"] == before + 3
    lower_plan(cap, None, MESH, optimize=False, verify=False)
    assert verify_telemetry()["plans_verified"] == before + 3
    plan = _plan(_mlp, *MLP)
    del plan.steps[0]
    assert not verify_plan(plan, strict=False).ok


# ---------------------------------------------------------------------------------
# seeded mutations: each must be caught
# ---------------------------------------------------------------------------------


def test_dropped_reshard_caught():
    plan = _plan(_mlp, *MLP)
    idx = [i for i, s in enumerate(plan.steps) if s.kind == "reshard"]
    assert idx, "expected a reshard step in the MLP plan"
    del plan.steps[idx[0]]
    v = _violations(plan)
    assert any("before it is produced" in x or "never produced" in x or "recomputed" in x
               for x in v), v
    with pytest.raises(PlanVerifyError):
        verify_plan(plan)


def test_swapped_spec_caught():
    """An epilogue reshard whose program was swapped to the wrong layout pair
    disagrees with its input's layout and with ``out_shardings``."""

    def f(a, b):
        a = annotate(a, mesh_split(2, MESH, ["x", -1]))
        b = annotate(b, mesh_split(2, MESH, [-1, "y"]))
        return annotate(a @ b, mesh_split(2, MESH, [-1, -1]))

    plan = _plan(f, (64, 64), (64, 64))
    tgt = [s for s in plan.steps if s.kind == "reshard"][-1]
    tgt.program = dataclasses.replace(tgt.program, src=tgt.program.dst, dst=tgt.program.src)
    v = _violations(plan)
    assert any("disagrees" in x for x in v), v
    with pytest.raises(PlanVerifyError):
        verify_plan(plan)


def test_dep_violating_schedule_caught():
    """A step moved before its producer (a broken scheduler): the step list
    is the schedule."""
    plan = _plan(_mlp, *MLP)
    written, mover = set(), None
    for i, s in enumerate(plan.steps):
        if any(id(r) in written for r in s.reads):
            mover = i
            break
        written.update(id(w) for w in s.writes)
    plan.steps.insert(0, plan.steps.pop(mover))
    v = _violations(plan)
    assert any("before it is produced" in x for x in v), v


def test_dangling_alias_caught():
    plan = _plan(_mlp, *MLP)
    read_ids = {id(r) for s in plan.steps for r in s.reads}
    victim = next(i for i, s in enumerate(plan.steps) if any(id(w) in read_ids for w in s.writes))
    del plan.steps[victim]
    v = _violations(plan)
    assert any("before it is produced" in x or "never produced" in x for x in v), v


def test_double_write_caught():
    plan = _plan(_mlp, *MLP)
    plan.steps.append(next(s for s in plan.steps if s.writes))
    v = _violations(plan)
    assert any("SSA" in x or "twice" in x for x in v), v


def test_bad_ppermute_perm_caught():
    """A ppermute whose perm repeats a destination (a fusion pass that merged
    incompatible shifts), then one out of range.  The port lowers no
    ppermute yet (the pipeline shift is A10), so the step is appended to a
    plan by hand and the plan's stats count it."""
    plan = _plan(_mlp, *MLP, optimize=False)
    src = plan.out_keys[0]
    pp = PlanStep("collective", (src,), (ProxyVar("shift"),), _cost_only_run, op="ppermute",
                  axes=("y",), lshape=(16, 64), dbytes=4, dtype="float32",
                  call={"perm": tuple((i, (i + 1) % 8) for i in range(8))})
    plan.steps.append(pp)
    plan.stats.count("collective-permute")
    plan.relive()
    assert verify_plan(plan).ok
    pp.call = {"perm": ((0, 1), (1, 1), (2, 3))}
    assert any("not a permutation" in x for x in _violations(plan))
    pp.call = {"perm": ((0, 9),)}
    assert any("out of range" in x for x in _violations(plan))


def test_collective_axis_not_in_mesh_caught():
    def f(a, w):
        return annotate(a, mesh_split(2, MESH, [-1, "y"])) @ annotate(w, Y)

    plan = _plan(f, (64, 64), (64, 64))
    cols = [s for s in plan.steps if s.kind in ("collective", "fused")]
    assert cols, "expected a psum from the sharded contraction"
    cols[0].axes = ("ghost",)
    v = _violations(plan)
    assert any("'ghost' not in mesh" in x for x in v), v


def test_negative_cost_fields_and_stats_counter_caught():
    plan = _plan(_mlp, *MLP)
    plan.steps[0].flops = -5.0
    plan.steps[0].wbytes = (-1.0,)
    plan.stats.collectives["all-reduce"] = -2
    v = _violations(plan)
    assert any("negative flops" in x for x in v), v
    assert any("negative write bytes" in x for x in v), v
    assert any("negative planned-collective" in x for x in v), v


def test_cost_bytes_mismatch_caught():
    plan = _plan(_mlp, *MLP)
    rs = next(s for s in plan.steps if s.kind == "reshard")
    rs.program = dataclasses.replace(rs.program, cost_bytes=rs.program.cost_bytes * 7 + 1234.0)
    v = _violations(plan)
    assert any("cost_bytes" in x or "recomputed" in x for x in v), v


def test_wire_accounting_mismatch_caught():
    plan = _plan(_mlp, *MLP)
    assert plan.opt_report is not None
    plan.opt_report.wire_bytes_after = plan.opt_report.wire_bytes_after * 3 + 1e6
    v = _violations(plan)
    assert any("wire_bytes_after" in x for x in v), v


@pytest.mark.parametrize("optimize", [False, True])
def test_a_local_ops_dropped_collective_record_caught(optimize):
    """logsumexp over a sharded dim is one compute step that runs a pmax and
    a psum itself; dropping its record leaves ``PlanStats`` counting two
    all-reduces the step list no longer runs."""

    def f(x):
        return torch.logsumexp(annotate(x, mesh_split(2, MESH, [-1, "y"])), dim=1)

    plan = _plan(f, (16, 64), optimize=optimize)
    (step,) = [s for s in plan.steps if s.op == "aten.logsumexp"]
    assert step.collectives == {"all-reduce": 2} and verify_plan(plan).ok
    step.collectives = {}
    v = _violations(plan)
    assert any("planned-collective count all-reduce" in x for x in v), v
