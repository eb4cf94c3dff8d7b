"""Elastic recovery: the port's ``launch/elastic.py`` against the JAX
package's.

The reference's single-device cases (``tests/test_elastic.py``,
``tests/test_guard.py::test_coordinator_rewinds_after_consecutive_faults``)
run the same schedule through both packages' coordinators from one initial
state: the reference's ``init_state`` written as a step-0 checkpoint with
``data_cursor`` 0, which both loops restore.  The recovery logs and the
control-event signatures must be equal, the loss curves within
``loss_curve`` (the arithmetic data pattern, identical in both packages).
The reference runs its step plainly on one device; the port runs its
partitioned step on a (1, 1) mesh.  A coordinator run that a case shares
with another is computed once (``reference``, ``port_rewind``), and both
packages' searches are memoized (``memo_solves``).  Eval counts are held within
each package only: the two price different plans (ROADMAP, "By design", autoshard).

The multi-device cases of ``tests/multidev/test_elastic_multidev.py`` run
on a simulated world of 8 (``model_parallel=2``), held to those tests'
stated expectations and to the reference's unsharded ``TrainLoop`` (the
reference cannot run 8 devices in this process).
"""
import contextlib
import copy
import dataclasses
import os
import unittest.mock
from typing import Dict, Optional

import jax
import numpy as np
import pytest
import torch

from repro import autoshard as jautoshard
from repro import obs as jobs
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_strategy as jax_get_strategy
from repro.core.plan import GuardConfig as JaxGuardConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.launch import chaos as jchaos
from repro.launch import elastic as jelastic
from repro.train import checkpoint as jck
from repro.train.loop import NumericFaultSpec as JaxNumericFaultSpec
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import init_state as jax_init_state
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch import autoshard, obs
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.core.compat import assert_close, set_mesh
from repro_torch.core.plan import GuardConfig
from repro_torch.core.rules import aval
from repro_torch.core.sharding import Mesh
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import chaos
from repro_torch.launch.elastic import (
    DeviceLossError,
    ElasticCoordinator,
    FaultInjector,
    derive_mesh,
    sharding_problem,
    specs_by_key,
    state_partition_specs,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, TrainLoop, init_state
from repro_torch.train.optimizer import get_optimizer

ST, JST = get_strategy("2d_finalized"), jax_get_strategy("2d_finalized")
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
            d_ff=64, vocab_size=128, attn_chunk=16, remat="none")
# tests/multidev/test_elastic_multidev.py's config
MULTI = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
             d_ff=64, vocab_size=64, attn_chunk=16, remat="none", qkv_bias=True)
CHEAP = dict(top_n=2, sa_steps=2, max_candidates=6)
# the recovery log's fields both packages must agree on
LOG_KEYS = ("classes", "step", "restored_from", "rewound_to", "fell_back_from", "mesh", "lost",
            "gained", "consecutive", "crash_save", "warm_started", "degraded")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The file's tiny models train fastest on one thread, and stay so when
    the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass(frozen=True)
class Case:
    """One coordinator run: the schedule (``FaultInjector`` fields) and the
    loop's settings, shared by both packages."""

    steps: int
    injector: Dict
    ckpt_every: int = 2
    rewind_after: Optional[int] = None
    max_recoveries: int = 3
    world: int = 1
    model_parallel: Optional[int] = None
    batch: int = 4
    model: str = "TINY"


CASES = {
    "device_loss": Case(10, dict(device_loss_at=5, lose=0), max_recoveries=2),
    "crash_save": Case(8, dict(crash_save_at_leaf=3), max_recoveries=2),
    "rewind": Case(12, dict(nan_at_step=5, numeric_steps=4), ckpt_every=3, rewind_after=2,
                   max_recoveries=2),
    "shrink_regrow": Case(12, dict(schedule=[{"kind": "device_loss", "step": 3, "lose": 0},
                                             {"kind": "device_return", "step": 7, "gain": 0}])),
    "combined": Case(12, dict(nan_at_step=5, numeric_steps=2, device_loss_at=6, lose=0),
                     rewind_after=2, max_recoveries=2),
}


def _seed_checkpoint(d, model="TINY"):
    """The reference's initial state as a step-0 checkpoint both loops
    restore (cursor 0)."""
    jcfg = JaxModelConfig(**(TINY if model == "TINY" else MULTI))
    state = jax_init_state(jcfg, JST, jax_get_optimizer("adafactor", lr=0.05), JaxTrainConfig(),
                           jax.random.PRNGKey(0))
    jck.save(str(d), 0, state, extra={"data_cursor": 0})


_SOLVES = {}


def _dims(assignment):
    return None if assignment is None else tuple(
        None if s is None else tuple(tuple(d) for d in s.dims_mapping) for s in assignment)


def _memo_solve(solve, program_key):
    """A package's ``autoshard.solve_problem``, memoized: a solve is a pure
    function of the program, the mesh, the config, the baseline and the
    warm start, and the coordinator runs here solve the same few problems
    (a cold solve alone takes seconds).  ``program_key(captured, mesh,
    config)`` names the program, mesh and config in that package's terms."""
    def memo(captured, mesh, config, baseline=None, arch="", warm_start=None):
        key = (solve.__module__, program_key(captured, mesh, config), _dims(baseline),
               _dims(warm_start))
        if key not in _SOLVES:
            _SOLVES[key] = solve(captured, mesh, config, baseline=baseline, arch=arch,
                                 warm_start=warm_start)
        return _SOLVES[key]

    return memo


REFERENCE_SOLVE = _memo_solve(jautoshard.solve_problem,
                              lambda closed, mesh, config: (str(closed), mesh.shape, config))
PORT_SOLVE = _memo_solve(autoshard.solve_problem, lambda captured, mesh, config: (
    captured.digest(), mesh.structural_key(), config.cache_key()))


@contextlib.contextmanager
def memo_solves():
    """Both packages' coordinators solve through the memos above."""
    with unittest.mock.patch.object(jautoshard, "solve_problem", REFERENCE_SOLVE), \
            unittest.mock.patch.object(autoshard, "solve_problem", PORT_SOLVE):
        yield


def reference_run(d, case, hooks=None):
    """``case`` through the reference's coordinator from the step-0
    checkpoint in ``d``; returns what the comparisons read."""
    jcfg = JaxModelConfig(**TINY)
    guard = None if case.rewind_after is None else JaxGuardConfig(rewind_after=case.rewind_after)
    tc = JaxTrainConfig(steps=case.steps, ckpt_dir=str(d), ckpt_every=case.ckpt_every,
                        keep_ckpts=3, log_every=1000, guard=guard)
    pipe = JaxTokenPipeline(JaxDataConfig(jcfg.vocab_size, 16, case.batch, seed=7,
                                          pattern="arithmetic"))
    n0 = len(jobs.control_events())
    co = jelastic.ElasticCoordinator(
        jcfg, JST, jax_get_optimizer("adafactor", lr=0.05), tc, pipe, n_devices=1,
        injector=jelastic.FaultInjector(**copy.deepcopy(case.injector)), hooks=hooks,
        autoshard_config=jautoshard.AutoshardConfig(**CHEAP),
        max_recoveries=case.max_recoveries)
    with memo_solves():
        _, losses = co.run()
    events = jobs.control_events()[n0:]
    return {"recoveries": co.recoveries, "losses": losses, "events": events,
            "signature": jchaos._signature(events), "skipped": list(co.loop.skipped_steps),
            "rewinds": co.loop.guard_counters["rewinds"], "numeric_fault": tc.numeric_fault}


def port_coordinator(d, case, hooks=None, **kw):
    cfg = ModelConfig(**(TINY if case.model == "TINY" else MULTI))
    guard = None if case.rewind_after is None else GuardConfig(rewind_after=case.rewind_after)
    tc = TrainConfig(steps=case.steps, ckpt_dir=str(d), ckpt_every=case.ckpt_every, keep_ckpts=3,
                     log_every=1000, guard=guard)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, case.batch, seed=7, pattern="arithmetic"))
    kw.setdefault("autoshard_config", autoshard.AutoshardConfig(**CHEAP))
    return ElasticCoordinator(cfg, ST, get_optimizer("adafactor", lr=0.05), tc, pipe,
                              n_devices=case.world, model_parallel=case.model_parallel,
                              injector=FaultInjector(**copy.deepcopy(case.injector)), hooks=hooks,
                              max_recoveries=case.max_recoveries, device="cpu", **kw)


def port_run(d, case, **kw):
    """``case`` through the port's coordinator; returns (coordinator, losses,
    control events)."""
    co = port_coordinator(d, case, **kw)
    n0 = len(obs.control_events())
    with memo_solves():
        _, losses = co.run()
    return co, losses, obs.control_events()[n0:]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's coordinator run of a named case, computed once."""
    runs = {}

    def get(name):
        if name not in runs:
            d = tmp_path_factory.mktemp(f"ref_{name}")
            _seed_checkpoint(d)
            runs[name] = reference_run(d, CASES[name])
        return runs[name]

    return get


@pytest.fixture(scope="module")
def port_rewind(tmp_path_factory):
    """The port's run of the "rewind" case, shared by the trace drill and
    the guard drill: the coordinator, its losses and control events, the
    exported control trace and the metrics snapshot, and the checkpoint
    directory."""
    obs.reset_control_events()
    d = tmp_path_factory.mktemp("port_rewind") / "ck"
    _seed_checkpoint(d)
    co, losses, events = port_run(d, CASES["rewind"])
    return {"co": co, "losses": losses, "events": events, "dir": d,
            "trace": obs.export_control_trace(), "snapshot": obs.snapshot()}


def _seeded(tmp_path, name="ck", model="TINY"):
    d = tmp_path / name
    _seed_checkpoint(d, model)
    return d


def _log(recoveries):
    return [{k: r[k] for k in LOG_KEYS if k in r} for r in recoveries]


def _same_run(co, losses, events, ref):
    """The port's run against the reference's: the recovery log and the
    control-event signature exactly, the losses within loss_curve."""
    assert _log(co.recoveries) == _log(ref["recoveries"])
    assert chaos._signature(events) == ref["signature"]
    assert co.loop.skipped_steps == ref["skipped"]
    assert len(losses) == len(ref["losses"])
    assert_close(np.array(losses), np.array(ref["losses"]), "loss_curve")


# ---------------------------------------------------------------------------------
# tests/test_elastic.py's cases
# ---------------------------------------------------------------------------------


def test_derive_mesh_shapes_and_clamp():
    mesh = derive_mesh(n_devices=1)
    assert mesh.shape == (1, 1) and mesh.axis_names == ("data", "model")
    assert derive_mesh(n_devices=1, model_parallel=4).shape == (1, 1)
    jplanner, _ = jelastic.derive_mesh(n_devices=1, model_parallel=4)
    assert jplanner.shape == derive_mesh(1, 4).shape


def test_device_loss_recovery_matches_uninterrupted_run(tmp_path, reference):
    """A device loss at step 5 restores the last checkpoint, re-solves warm,
    swaps the step and resumes: one loss per step, equal to the port's own
    uninterrupted run under the same (1, 1) mesh within f32, and the
    reference's run as a whole."""
    co, losses, events = port_run(_seeded(tmp_path), CASES["device_loss"])
    assert len(losses) == 10 and len(co.recoveries) == 1
    ev = co.recoveries[0]
    assert ev["warm_started"] and not ev["degraded"]
    assert ev["reshard"]["leaves"] > 0 and ev["reshard"]["reshard_s"] is not None
    _same_run(co, losses, events, reference("device_loss"))

    d = _seeded(tmp_path, "ref")
    tc = TrainConfig(steps=10, ckpt_dir=str(d), ckpt_every=2, keep_ckpts=3, log_every=1000)
    pipe = TokenPipeline(DataConfig(128, 16, 4, seed=7, pattern="arithmetic"))
    with set_mesh(derive_mesh(1)):
        _, want = TrainLoop(ModelConfig(**TINY), ST, get_optimizer("adafactor", lr=0.05), tc,
                            pipe, device="cpu").run()
    assert_close(np.array(losses), np.array(want), "f32")


def test_exhausted_recoveries_reraise(tmp_path, reference):
    """No recovery left: the loss propagates at step 5, after the same
    events as the reference's run up to its first recovery."""
    co = port_coordinator(_seeded(tmp_path), dataclasses.replace(CASES["device_loss"],
                                                                 max_recoveries=0))
    n0 = len(obs.control_events())
    with pytest.raises(DeviceLossError):
        co.run()
    sig = chaos._signature(obs.control_events()[n0:])
    ref = reference("device_loss")["signature"]
    assert sig == ref[:len(sig)] and ref[len(sig)] == ("device_loss", None, 5)


def test_crash_mid_save_resumes_from_intact_step(tmp_path, reference):
    d = _seeded(tmp_path)
    co, losses, events = port_run(d, CASES["crash_save"])
    assert len(losses) == 8
    assert any(r.get("crash_save") for r in co.recoveries)
    # the final checkpoint committed; no orphan tmp dir breaks latest_step
    assert ckpt.latest_step(str(d)) == 8
    _same_run(co, losses, events, reference("crash_save"))


def test_straggler_stall_trips_watchdog(tmp_path, reference):
    """The watchdog keys off wall time, so its event stays out of the
    signature; without a recovery the run's losses are the uninterrupted
    curve, which the reference's lose=0 / gain=0 drill also trains."""
    seen = []
    case = Case(12, dict(straggler_at=9, stall_s=0.3))
    co = port_coordinator(_seeded(tmp_path), case,
                          hooks={"straggler": lambda step, dt, med: seen.append(step)})
    co.tc.straggler_factor = 2.0
    co.loop.tc.straggler_factor = 2.0
    _, losses = co.run()
    assert 9 in seen and co.recoveries == []
    assert_close(np.array(losses), np.array(reference("shrink_regrow")["losses"]), "loss_curve")


def _shapes(captured):
    return [tuple(aval(v).shape) for v in captured.invars]


def test_warm_start_fewer_evals_than_cold():
    """Warm start across a mesh shrink: strictly fewer cost lowerings, no
    worse score (pure planning; the reference's own test holds its
    package)."""
    cfg, cfgs = ModelConfig(**TINY), autoshard.AutoshardConfig(**CHEAP)
    old = Mesh.create((2, 4), ("data", "model"))
    captured, baseline = sharding_problem(cfg, ST, old, 4, 16)
    prior = autoshard.solve_problem(captured, old, cfgs, baseline=baseline)
    assert not prior.warm_started

    new = Mesh.create((2, 2), ("data", "model"))
    captured2, baseline2 = sharding_problem(cfg, ST, new, 4, 16)
    warm = autoshard.remap_assignment(prior.assignment, new, _shapes(captured2))
    warm_res = autoshard.solve_problem(captured2, new, cfgs, baseline=baseline2, warm_start=warm)
    cold_res = autoshard.solve_problem(captured2, new, cfgs, baseline=baseline2)
    assert warm_res.warm_started
    assert warm_res.evals < cold_res.evals
    assert warm_res.evaluation.score <= cold_res.evaluation.score * (1 + 1e-6)


def test_sharding_problem_inputs_match_reference():
    """The problem's inputs leaf for leaf with the reference's: shapes,
    dtypes and the Table-1 baseline's dims mappings."""
    cfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    mesh = Mesh.create((2, 4), ("data", "model"))
    captured, baseline = sharding_problem(cfg, ST, mesh, 4, 16)
    from repro.core.sharding import Mesh as JMesh

    closed, jbaseline = jelastic.sharding_problem(jcfg, JST, JMesh.create((2, 4),
                                                                          ("data", "model")),
                                                  4, 16)
    assert _shapes(captured) == [tuple(v.aval.shape) for v in closed.jaxpr.invars]
    assert [str(aval(v).dtype).replace("torch.", "") for v in captured.invars] == \
        [str(v.aval.dtype) for v in closed.jaxpr.invars]
    assert [s.dims_mapping for s in baseline] == [tuple(tuple(a) for a in s.dims_mapping)
                                                  for s in jbaseline]


def test_warm_start_roundtrips_through_json_dump(tmp_path):
    cfg, cfgs = ModelConfig(**TINY), autoshard.AutoshardConfig(**CHEAP)
    old = Mesh.create((2, 4), ("data", "model"))
    captured, baseline = sharding_problem(cfg, ST, old, 4, 16)
    prior = autoshard.solve_problem(captured, old, cfgs, baseline=baseline)
    p = str(tmp_path / "assignment.json")
    prior.dump(p)
    _, loaded = autoshard.load(p)
    new = Mesh.create((2, 2), ("data", "model"))
    captured2, baseline2 = sharding_problem(cfg, ST, new, 4, 16)
    warm = autoshard.remap_assignment(loaded, new, _shapes(captured2))
    res = autoshard.solve_problem(captured2, new, cfgs, baseline=baseline2, warm_start=warm)
    assert res.warm_started and res.to_json()["warm_started"]


def test_infeasible_budget_degrades_to_data_parallel(tmp_path):
    """A budget no assignment meets does not abort: the coordinator falls
    back to the data-parallel-only restriction of the baseline, as the
    reference's does."""
    budget = dict(top_n=2, sa_steps=2, budget_bytes=1.0)
    co = port_coordinator(tmp_path / "ck", Case(2, {}),
                          autoshard_config=autoshard.AutoshardConfig(**budget))
    res = co.solve_assignment()
    assert co.degraded
    for s in res.assignment:
        if s is not None:
            assert {a for dim in s.dims_mapping for a in dim} <= {"data"}, s
    assert os.path.exists(co.dump_path)


def test_state_partition_specs_cover_state():
    opt, tc = get_optimizer("adafactor", lr=0.05), TrainConfig(steps=1)
    state = init_state(ModelConfig(**TINY), ST, opt, tc, torch.Generator().manual_seed(0), "cpu")
    keys = {k for k, _ in ckpt._flatten_with_paths(state)}
    assert keys == set(specs_by_key(state_partition_specs(ModelConfig(**TINY), ST, opt, tc)))


def test_recovery_story_reconstructable_from_trace(port_rewind, reference):
    """The fault -> skip -> rewind -> plan-swap story rebuilt from the
    exported control lane alone; the run equal to the reference's."""
    co, losses, events = port_rewind["co"], port_rewind["losses"], port_rewind["events"]
    assert len(losses) == 11  # one skipped batch, training completed

    doc = port_rewind["trace"]
    assert obs.validate_trace_events(doc["traceEvents"]) == []
    instants = sorted((e for e in doc["traceEvents"] if e["ph"] == "i"), key=lambda e: e["ts"])
    names = [e["name"] for e in instants]
    first_fault, skip = names.index("numerics_fault"), names.index("skip_step")
    rewind, swap = names.index("rewind"), names.index("plan_swap")
    assert first_fault < skip < rewind < swap
    faults = [e for e in instants if e["name"] == "numerics_fault"]
    assert faults[-1]["args"]["consecutive"] == 2
    assert [e["args"]["step"] for e in faults[:2]] == [5, 6]
    (skip_ev,) = [e for e in instants if e["name"] == "skip_step"]
    assert skip_ev["args"]["step"] == 5
    assert instants[swap]["args"]["reason"] == "rewind"
    snap = port_rewind["snapshot"]
    assert snap["counters"]["train.guard.faults"] >= 2
    assert snap["counters"]["train.guard.rewinds"] >= 1
    _same_run(co, losses, events, reference("rewind"))


def test_expand_assignment_regrow_warm_fewer_evals():
    """The regrow counterpart: a data-parallel-only (2,1) assignment lifted
    onto (2,4) by expand_assignment proposes the freed model axis again
    (remap would leave every leaf data-parallel), and the warm solve costs
    strictly fewer evals."""
    cfg, cfgs = ModelConfig(**TINY), autoshard.AutoshardConfig(**CHEAP)
    small = Mesh.create((2, 1), ("data", "model"))
    captured_s, base_s = sharding_problem(cfg, ST, small, 4, 16)
    prior = autoshard.restrict_assignment(base_s, small, _shapes(captured_s))

    big = Mesh.create((2, 4), ("data", "model"))
    captured_b, base_b = sharding_problem(cfg, ST, big, 4, 16)
    shapes = _shapes(captured_b)
    warm = autoshard.expand_assignment(prior, big, shapes)
    remap = autoshard.remap_assignment(prior, big, shapes)
    dms = lambda a: [None if s is None else s.dims_mapping for s in a]  # noqa: E731
    assert dms(warm) != dms(remap)
    warm_res = autoshard.solve_problem(captured_b, big, cfgs, baseline=base_b, warm_start=warm)
    cold_res = autoshard.solve_problem(captured_b, big, cfgs, baseline=base_b)
    assert warm_res.warm_started
    assert warm_res.evals < cold_res.evals


def test_schedule_json_round_trip_and_validation(tmp_path):
    sched = [{"kind": "device_loss", "step": 3, "lose": 0},
             {"kind": "nan_burst", "step": 7, "steps": 1}]
    inj = FaultInjector(schedule=sched)
    p = str(tmp_path / "campaign.json")
    doc = inj.dump_schedule(p)
    assert doc == jelastic.FaultInjector(schedule=sched).dump_schedule()
    assert doc["version"] == 1
    assert FaultInjector.load_schedule(p).schedule == sched
    assert FaultInjector.load_schedule(doc).schedule == sched
    assert FaultInjector.load_schedule(sched).schedule == sched
    assert jelastic.FaultInjector.load_schedule(p).schedule == sched
    with pytest.raises(ValueError, match="unknown schedule"):
        FaultInjector(schedule=[{"kind": "meteor", "step": 1}])
    with pytest.raises(ValueError, match="missing step"):
        FaultInjector(schedule=[{"kind": "nan_burst"}])
    assert chaos.SIGNATURE_KINDS == jchaos.SIGNATURE_KINDS
    assert dataclasses.asdict(FaultInjector(nan_at_step=5, numeric_steps=4).numeric_spec()) == \
        dataclasses.asdict(JaxNumericFaultSpec(nan_at_step=5, steps=4))


def test_shrink_then_regrow_drill_continuous_curve(tmp_path, reference):
    """The drill at a world of one: shrink, train, regrow, train; both
    recoveries warm, one restore each, a continuous curve, the campaign
    rebuilt from the control events alone, all as the reference's."""
    obs.reset_control_events()
    co, losses, events = port_run(_seeded(tmp_path), CASES["shrink_regrow"])
    assert len(losses) == 12
    assert [r["classes"] for r in co.recoveries] == [["device_loss"], ["device_return"]]
    assert all(r["warm_started"] and not r["degraded"] for r in co.recoveries)
    names = [e["name"] for e in events]
    assert "mesh_shrink" in names and "mesh_grow" in names
    assert names.count("restore") == 2
    chaos_kinds = [e["args"]["kind"] for e in events if e["name"] == "chaos_event"]
    assert chaos_kinds == ["device_loss", "device_return"]
    narr = obs.recovery_narrative(events)
    assert [ep["classes"] for ep in narr] == [["device_loss"], ["device_return"]]
    assert all(ep["restores"] == 1 for ep in narr)
    _same_run(co, losses, events, reference("shrink_regrow"))


def test_combined_nan_and_device_loss_single_restore(tmp_path, reference):
    """A coincident NumericsFault window and device loss resolve in one
    pass (one classification, one mesh change, one restore), asserted from
    the control lane, the provenance in the next manifest."""
    d = _seeded(tmp_path)
    co, losses, events = port_run(d, CASES["combined"])
    assert len(co.recoveries) == 1
    ev = co.recoveries[0]
    assert ev["classes"] == ["device_loss", "numerics"]
    assert "restored_from" in ev and ev["reshard"]["leaves"] > 0
    names = [e["name"] for e in events]
    assert names.count("restore") == 1 and names.count("combined_recovery") == 1
    (comb,) = [e for e in events if e["name"] == "combined_recovery"]
    assert comb["args"]["classes"] == ["device_loss", "numerics"]
    narr = obs.recovery_narrative(events)
    assert len(narr) == 1 and narr[0]["restores"] == 1
    assert narr[0]["classes"] == ["device_loss", "numerics"]
    man = ckpt._load_manifest(str(d), ckpt.latest_step(str(d)))
    assert man["extra"]["recovery"]["count"] == 1
    assert man["extra"]["recovery"]["last"]["classes"] == ["device_loss", "numerics"]
    _same_run(co, losses, events, reference("combined"))


def test_coordinator_rewinds_after_consecutive_faults(port_rewind, reference):
    """tests/test_guard.py's drill: two consecutive NaN steps escalate, the
    coordinator rewinds in process, disarms the window and finishes; the
    counters reach the manifest.  Same schedule as the trace drill above
    (both packages' runs are shared)."""
    d = str(port_rewind["dir"])
    co, losses, events = port_rewind["co"], port_rewind["losses"], port_rewind["events"]
    assert len(losses) == 11 and all(np.isfinite(losses))
    (ev,) = [e for e in co.recoveries if e.get("numerics")]
    assert ev["consecutive"] == 2 and ev["faults"] and "rewound_to" in ev
    assert co.loop.guard_counters["rewinds"] == 1
    assert co.tc.numeric_fault is None
    m = ckpt._load_manifest(d, ckpt.latest_step(d))
    assert m["extra"]["guard"]["rewinds"] == 1
    ref = reference("rewind")
    assert ref["rewinds"] == 1 and ref["numeric_fault"] is None
    _same_run(co, losses, events, ref)


# ---------------------------------------------------------------------------------
# tests/multidev/test_elastic_multidev.py's coordinator cases, on a simulated
# world of 8
# ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unsharded_reference():
    """The reference's unsharded TrainLoop on MULTI, batch 8, from its
    initial state: plain for 14 steps, and with step 5's batch skipped by
    the guard (a one-step NaN window) for 12."""
    jcfg = JaxModelConfig(**MULTI)
    pipe = lambda: JaxTokenPipeline(JaxDataConfig(jcfg.vocab_size, 16, 8, seed=7,  # noqa: E731
                                                  pattern="arithmetic"))
    opt = jax_get_optimizer("adafactor", lr=0.05)
    _, plain = JaxTrainLoop(jcfg, JST, opt, JaxTrainConfig(steps=14, log_every=1000), pipe(),
                            rng=jax.random.PRNGKey(0)).run()
    tc = JaxTrainConfig(steps=12, log_every=1000, guard=JaxGuardConfig(rewind_after=2),
                        numeric_fault=JaxNumericFaultSpec(nan_at_step=5, steps=1))
    _, skipped = JaxTrainLoop(jcfg, JST, opt, tc, pipe(), rng=jax.random.PRNGKey(0)).run()
    return {"plain": plain, "skipped": skipped}


def _multi(steps, injector, **kw):
    return Case(steps, injector, world=8, model_parallel=2, batch=8, model="MULTI", **kw)


def test_device_loss_recovers_on_smaller_mesh_in_process(tmp_path, unsharded_reference):
    """Lose 4 of 8 devices at step 5: (4,2) -> (2,2), a warm re-solve, one
    restore, the step swapped; one loss per step, within loss_curve of the
    reference's unsharded run."""
    co, losses, _ = port_run(_seeded(tmp_path, model="MULTI"),
                             _multi(10, dict(device_loss_at=5, lose=4), max_recoveries=2))
    assert len(losses) == 10 and len(co.recoveries) == 1
    ev = co.recoveries[0]
    assert ev["mesh"] == {"from": [4, 2], "to": [2, 2]}
    assert ev["warm_started"] and not ev["degraded"] and ev["reshard"]["leaves"] > 0
    assert co.loop.step_fn.runner.fallback_gathers == []
    assert_close(np.array(losses), np.array(unsharded_reference["plain"][:10]), "loss_curve")


def test_shrink_train_regrow_drill_continuous_curve(tmp_path, unsharded_reference):
    """8 devices, lose 4 at step 4 ((4,2) -> (2,2)), regain 4 at step 9
    (back to (4,2)): both re-solves warm, the regrow cheaper than a cold
    solve on the grown mesh, one restore each, a continuous curve."""
    obs.reset_control_events()
    sched = [{"kind": "device_loss", "step": 4, "lose": 4},
             {"kind": "device_return", "step": 9, "gain": 4}]
    co, losses, events = port_run(_seeded(tmp_path, model="MULTI"),
                                  _multi(14, dict(schedule=sched)))
    assert co.mesh.shape == (4, 2) and len(losses) == 14
    shrink, regrow = co.recoveries
    assert shrink["classes"] == ["device_loss"]
    assert shrink["mesh"] == {"from": [4, 2], "to": [2, 2]}
    assert regrow["classes"] == ["device_return"]
    assert regrow["mesh"] == {"from": [2, 2], "to": [4, 2]}
    assert shrink["warm_started"] and regrow["warm_started"]
    assert regrow["reshard"]["leaves"] > 0
    captured, baseline = sharding_problem(ModelConfig(**MULTI), ST, co.mesh, 8, 16)
    # the coordinator's first (cold) solve on (4, 2), from the memo
    cold = PORT_SOLVE(captured, co.mesh, co.ashard_config, baseline=baseline)
    assert regrow["evals"] < cold.evals
    names = [e["name"] for e in events]
    assert "mesh_shrink" in names and "mesh_grow" in names and names.count("restore") == 2
    assert_close(np.array(losses), np.array(unsharded_reference["plain"]), "loss_curve")


def test_combined_nan_and_device_loss_single_pass_multidev(tmp_path, unsharded_reference):
    """A NaN window at 5-6 and the loss of 4 devices at 6: one
    classification, one shrink, one restore; the curve is the reference's
    unsharded run with step 5's batch skipped."""
    obs.reset_control_events()
    co, losses, events = port_run(
        _seeded(tmp_path, model="MULTI"),
        _multi(12, dict(nan_at_step=5, numeric_steps=2, device_loss_at=6, lose=4),
               rewind_after=2, max_recoveries=2))
    (ev,) = co.recoveries
    assert ev["classes"] == ["device_loss", "numerics"]
    assert ev["mesh"] == {"from": [4, 2], "to": [2, 2]} and "restored_from" in ev
    names = [e["name"] for e in events]
    assert names.count("restore") == 1 and names.count("combined_recovery") == 1
    narr = obs.recovery_narrative(events)
    assert len(narr) == 1 and narr[0]["restores"] == 1
    assert co.loop.skipped_steps == [5]
    assert_close(np.array(losses), np.array(unsharded_reference["skipped"]), "loss_curve")
