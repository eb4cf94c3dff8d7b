"""The observability layer of the port (``repro_torch/obs``) against the JAX
package's (``repro/obs``): the cases of ``tests/test_obs.py`` on the port.

Covers the metrics registry (thread-safe instruments, JSON snapshots, the
port's own dump variable, plan-cache counters), the Chrome trace-event
validator (the port's against the reference's on the same events, and the
reference's on the port's exports), the modeled timeline against the
overlap schedule, traced execution on a simulated (2, 4) mesh (eager and
tight outputs bit-equal to untraced ones, a scanned gradient program too,
launches of the timed repeats kept apart from the path's), control events
(a port ``TrainLoop`` and a reference ``TrainLoop`` with the same planted
NaN batch emit the same events and counters), the per-class calibration
join (equal rows on equal spans) and the CLI.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_strategy as jax_get_strategy
from repro.core.plan import GuardConfig as JGuardConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.obs import calibrate as jcalibrate
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro.train.loop import NumericFaultSpec as JaxNumericFaultSpec
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import init_state as jax_init_state
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch import obs
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core import partitioner as _partitioner  # noqa: F401 (snapshot source)
from repro_torch.core import plan_verify as _plan_verify  # noqa: F401 (snapshot source)
from repro_torch.core.compat import capture, set_mesh
from repro_torch.core.partitioner import (clear_process_plan_cache, process_plan_cache_stats,
                                          spmd_partition)
from repro_torch.core.plan import GuardConfig, lower_plan
from repro_torch.core.plan_opt import modeled_timeline, step_class
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.obs import calibrate, metrics, trace
from repro_torch.train.loop import NumericFaultSpec, TrainConfig, TrainLoop, sharded_value_and_grad
from repro_torch.train.optimizer import get_optimizer

MESH = Mesh.create((4, 8), ("x", "y"))
SMALL = Mesh.create((2, 4), ("x", "y"))
PROFILE = RooflineParams(peak_flops=1e15, hbm_bw=3e12, ici_bw=4.5e11, collective_launch_s=2e-5,
                         overlap_efficiency=0.0)


def _mlp(mesh):
    def f(a, w1, w2):
        a = annotate(a, mesh_split(2, mesh, ["x", -1]))
        w1 = annotate(w1, mesh_split(2, mesh, [-1, "y"]))
        h = torch.maximum(a @ w1, torch.zeros((), dtype=a.dtype))
        h = annotate(h, mesh_split(2, mesh, ["x", -1]))
        return h @ w2

    return f


MLP_SHAPES = ((64, 32), (32, 64), (64, 16))


def _plan():
    cap = capture(_mlp(MESH), *[torch.empty(s, device="meta") for s in MLP_SHAPES])
    return lower_plan(cap, None, MESH, optimize=True, profile=PROFILE)


def _mlp_args(seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)) for s in MLP_SHAPES]


def _runner(trace_cfg=None, **kw):
    return spmd_partition(_mlp(SMALL), SMALL, trace=trace_cfg, profile=PROFILE, device="cpu", **kw)


# ---------------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------------


def test_counter_and_histogram_thread_safety():
    reg = metrics.MetricsRegistry()

    def work():
        for i in range(500):
            reg.inc("hits")
            reg.observe("lat", float(i))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.counter("hits").value == 8 * 500
    assert reg.histogram("lat").count == 8 * 500
    assert reg.histogram("lat").summary()["sum"] == pytest.approx(8 * sum(range(500)))


def test_histogram_summary_matches_numpy_and_reference():
    """Percentiles as numpy's, and every summary field equal to the
    reference's histogram on the same samples (made with numpy from a seed),
    also after 2:1 thinning."""
    vals = np.random.default_rng(0).exponential(10.0, size=501)
    mine, ref = metrics.Histogram("h"), jmetrics.Histogram("h")
    for v in vals:
        mine.observe(float(v))
        ref.observe(float(v))
    for p in (0, 25, 50, 90, 99, 100):
        assert mine.percentile(p) == pytest.approx(np.percentile(vals, p))
    assert mine.summary() == ref.summary()
    mine, ref = metrics.Histogram("h"), jmetrics.Histogram("h")
    n = metrics.MAX_SAMPLES + 1000
    for i in range(n):
        mine.observe(float(i))
        ref.observe(float(i))
    assert mine.count == n and len(mine._values) <= metrics.MAX_SAMPLES
    assert mine.summary() == ref.summary()
    empty = metrics.Histogram("e")
    assert empty.percentile(50) is None and empty.summary()["mean"] is None
    empty.observe(7.0)
    assert empty.percentile(0) == empty.percentile(100) == 7.0


def test_snapshot_roundtrips_through_json_with_the_ports_sources(tmp_path):
    reg = metrics.MetricsRegistry()
    reg.inc("a.hits", 3)
    reg.set_gauge("mesh.devices", 8)
    for v in (1.0, 2.0, 3.0):
        reg.observe("step_ms", v)
    reg.register_source("flaky", lambda: 1 / 0)
    with open(reg.dump(str(tmp_path / "m.json"))) as f:
        snap = json.load(f)
    assert snap["counters"]["a.hits"] == 3 and snap["gauges"]["mesh.devices"] == 8
    assert snap["histograms"]["step_ms"]["count"] == 3
    assert snap["histograms"]["step_ms"]["p50"] == 2.0
    assert {"lattice", "plan_verify", "process_plan_cache"} <= set(snap["sources"])
    assert set(snap["sources"]["process_plan_cache"]) == {"hits", "misses", "hit_rate"}
    assert snap["sources"]["flaky"] == {"error": "division by zero"}
    reg.reset()
    snap = reg.snapshot()
    assert snap["counters"] == {} and "flaky" in snap["sources"]


def test_plan_cache_hits_and_misses_land_in_the_registry():
    """``PlanCacheStats`` of a runner and of the process cache feed
    ``plan_cache.runner.*`` and ``plan_cache.process.*``, as the reference's
    ``core/partitioner.py:440-454`` do."""
    clear_process_plan_cache()
    metrics.registry().reset()
    a = _mlp_args()
    r1, r2 = _runner(optimize=False), _runner(optimize=False)
    r1(*a)
    r1(*a)
    r2(*a)
    c = metrics.snapshot()["counters"]
    assert (c["plan_cache.runner.misses"], c["plan_cache.runner.hits"]) == (2, 1)
    assert (c["plan_cache.process.misses"], c["plan_cache.process.hits"]) == (1, 1)
    assert process_plan_cache_stats().as_dict() == {"hits": 1, "misses": 1, "hit_rate": 0.5}


def test_dumps_follow_the_ports_own_variable(tmp_path, monkeypatch):
    """``REPRO_TORCH_METRICS_DUMP`` (``maybe_dump`` and the atexit dump of a
    fresh interpreter); the reference's ``REPRO_METRICS_DUMP`` does not
    reach the port."""
    assert metrics.DUMP_ENV == "REPRO_TORCH_METRICS_DUMP" != jmetrics.DUMP_ENV
    p = str(tmp_path / "dump.json")
    monkeypatch.delenv(metrics.DUMP_ENV, raising=False)
    monkeypatch.setenv(jmetrics.DUMP_ENV, p)
    assert metrics.maybe_dump() is None
    monkeypatch.setenv(metrics.DUMP_ENV, p)
    metrics.inc("dump.test.marker")
    assert metrics.maybe_dump() == p
    with open(p) as f:
        assert json.load(f)["counters"]["dump.test.marker"] >= 1
    p2 = str(tmp_path / "atexit.json")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, **{metrics.DUMP_ENV: p2})
    env.pop(jmetrics.DUMP_ENV, None)
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('m', sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec); spec.loader.exec_module(m)\n"
            "m.inc('atexit.test.marker', 2); m.set_gauge('atexit.test.gauge', 1.5)\n"
            "m.observe('atexit.test.hist', 3.0)\n")
    subprocess.run([sys.executable, "-c", code, metrics.__file__], check=True, env=env,
                   timeout=120)
    with open(p2) as f:
        snap = json.load(f)
    assert snap["counters"]["atexit.test.marker"] == 2
    assert snap["gauges"]["atexit.test.gauge"] == 1.5
    assert snap["histograms"]["atexit.test.hist"]["count"] == 1


# ---------------------------------------------------------------------------------
# trace schema validator
# ---------------------------------------------------------------------------------


def _span(name, ts, dur, pid=2, tid=1, **args):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args}


VALIDATOR_CASES = [
    [{"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "m"}},
     _span("a", 0.0, 10.0), _span("b", 10.0, 5.0),
     {"name": "fault", "ph": "i", "s": "g", "ts": 3.0, "pid": 3, "tid": 1}],
    [_span("outer", 0.0, 100.0), _span("inner", 10.0, 20.0), _span("inner2", 40.0, 50.0)],
    [_span("a", 0.0, 10.0), _span("b", 5.0, 10.0)],
    [_span("a", 0.0, 10.0), _span("b", 5.0, 10.0, tid=2)],
    [{"name": "x", "ph": "Z", "pid": 1, "ts": 0.0}],
    [{"name": "x", "ph": "X", "pid": 1, "dur": 1.0, "tid": 1}],
    [_span("x", 0.0, -1.0)],
    [{"name": "x", "ph": "X", "pid": 1, "ts": 0.0, "dur": 1.0}],
    [{"ph": "X", "pid": 1, "ts": 0.0, "dur": 1.0, "tid": 1}],
    ["nope"],
]


@pytest.mark.parametrize("case", range(len(VALIDATOR_CASES)))
def test_validator_matches_reference(case):
    """Valid events, nesting, a partial overlap within a lane (fine across
    lanes) and each kind of malformed event: the port's problems are the
    reference's, word for word."""
    events = VALIDATOR_CASES[case]
    problems = trace.validate_trace_events(events)
    assert problems == jtrace.validate_trace_events(events)
    assert (problems == []) == (case in (0, 1, 3))


# ---------------------------------------------------------------------------------
# modeled timeline
# ---------------------------------------------------------------------------------


def test_modeled_timeline_matches_overlap_schedule_and_taxonomy():
    plan = _plan()
    rows = modeled_timeline(plan)
    assert len(rows) == len(plan.steps)
    makespan = max(r["start_s"] + r["dur_s"] for r in rows)
    assert makespan == pytest.approx(plan.opt_report.overlap["overlapped_s"], rel=1e-9)
    assert [r["cls"] for r in rows] == [step_class(s) for s in plan.steps]
    assert [r["index"] for r in rows] == list(range(len(plan.steps)))
    for r in rows:
        if r["comm_s"] > 0.0 and r["compute_s"] == 0.0:
            assert r["lane"] == "interconnect"
        if r["comm_s"] == 0.0:
            assert r["lane"] == "compute"
    classes = {step_class(s) for s in plan.steps}
    assert "compute" in classes and classes & {"reshard", "collective"}


def test_tracer_modeled_lane_validates_offsets_and_writes(tmp_path):
    plan = _plan()
    tr = trace.Tracer(trace.TraceConfig(measured=False))
    tr.on_plan(plan)
    first = tr.modeled_events()
    tr.on_plan(plan)  # a second plan's timeline is appended after the first
    second = [e for e in tr.modeled_events() if e["args"]["plan"] == 1]
    assert len(second) == len(first)
    end_first = max(e["ts"] + e["dur"] for e in first)
    assert all(e["ts"] >= end_first - 1e-6 for e in second)
    with open(tr.write(str(tmp_path / "trace.json"))) as f:
        events = json.load(f)["traceEvents"]
    assert trace.validate_trace_events(events) == []
    assert jtrace.validate_trace_events(events) == []
    names = {e["args"]["name"] for e in events if e["ph"] == "M" and e["name"] == "process_name"}
    assert names == {"modeled", "measured", "control"}


# ---------------------------------------------------------------------------------
# traced execution on the simulated mesh
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("timing", ["eager", "tight"])
def test_traced_execution_is_bit_equal_to_untraced(timing):
    """Eager and tight traced calls give the untraced outputs bit for bit,
    one span per plan step per call, and a trace both validators pass."""
    a = _mlp_args()
    ref = _runner()(*a)
    traced = _runner(obs.TraceConfig(timing=timing, repeats=2))
    assert torch.equal(traced(*a), ref)
    tr = traced.tracer
    (entry,) = traced.plans.values()
    n = len(entry.plan.steps)
    assert tr.calls == 1 and len(tr.measured_events()) == n
    assert {e["args"]["call"] for e in tr.measured_events()} == {0}
    assert [e["args"]["index"] for e in tr.measured_events()] == list(range(n))
    assert len(tr.modeled_events()) == n
    events = tr.chrome_trace()["traceEvents"]
    assert trace.validate_trace_events(events) == []
    assert jtrace.validate_trace_events(events) == []
    assert torch.equal(traced(*a), ref)
    assert tr.calls == 2 and len(tr.measured_events()) == 2 * n


def test_tight_tracing_of_a_scanned_gradient_program_is_bit_equal():
    """The gradient program of a two-layer model with its layers scanned
    (one scan call step forward, one reverse), its plan run untraced and
    under eager and tight tracing: the loss and every gradient bit-equal,
    each scan call step one ``call:scan`` span."""
    from repro_torch.core import mesh_runtime as mr
    from repro_torch.models import api
    from repro_torch.models.layers import tree_init

    cfg = ModelConfig(**dict(TINY, scan_layers=True))
    mesh = make_test_mesh()
    with set_mesh(mesh):
        params = tree_init(api.param_tree(cfg, ST), torch.Generator().manual_seed(0),
                           dtype="float32", device="cpu")
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, 128, (4, 8))) for k in ("tokens", "labels")}
    runner = spmd_partition(sharded_value_and_grad(cfg, ST, mesh), mesh, profile=PROFILE,
                            device="cpu")
    want = tree_flatten(runner(params, batch))[0]
    (entry,) = runner.plans.values()
    plan = entry.plan
    flat = tree_flatten((params, batch))[0]
    for timing in ("eager", "tight"):
        tr = obs.Tracer(obs.TraceConfig(timing=timing, repeats=2))
        local = [mr.shard(a, s) for a, s in zip(flat, plan.in_shardings)]
        outs = plan.execute(*local, tracer=tr)
        got = [mr.unshard(o, s) for o, s in zip(outs, plan.out_shardings)]
        assert len(got) == len(want)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), timing
        classes = [e["args"]["class"] for e in tr.measured_events()]
        assert len(classes) == len(plan.steps) and classes.count("call:scan") == 2


def test_tight_repeats_launch_what_the_counters_say_kept_apart_from_the_path():
    """A step that launches a kernel under tight timing: the wrapper's count
    holds every launch (the untimed run and each repeat), the tracer puts
    the untimed run's under ``launches["path"]`` (what an untraced call
    launches) and the repeats' under ``launches["timing"]``, and the value
    the plan goes on with is the untimed run's."""
    from repro_torch.core.plan import PlanStep

    runs = []

    def run(env, reads, writes):
        fa.launches += 1
        runs.append(len(runs))
        env[writes[0]] = env[reads[0]] + len(runs)

    step = PlanStep(kind="compute", reads=("a",), writes=("b",), run=run, op="kernel")
    tr = trace.Tracer(trace.TraceConfig(timing="tight", repeats=3))
    saved, fa.launches = fa.launches, 0
    try:
        env = {"a": torch.zeros(())}
        tr.run_step(0, step, env, tr.begin_call())
        assert fa.launches == 4 and len(runs) == 4
        assert tr.launches["path"]["flash_attention"] == 1
        assert tr.launches["timing"]["flash_attention"] == 3
        assert env["b"].item() == 1.0 and set(env) == {"a", "b"}
    finally:
        fa.launches = saved


def test_disabled_trace_config_is_the_untraced_runner():
    clear_process_plan_cache()
    a = _mlp_args()
    base, off = _runner(), _runner(obs.TraceConfig(enabled=False))
    base(*a)
    off(*a)  # plans compile at the first call: this one is a process-cache hit
    assert process_plan_cache_stats().hits == 1
    assert off.tracer is None and base.tracer is None
    on = _runner(obs.TraceConfig())
    on(*a)
    assert process_plan_cache_stats().hits == 1  # a traced runner stays out of it
    with pytest.raises(ValueError, match="compile_plans=True"):
        spmd_partition(lambda x: x, SMALL, compile_plans=False, trace=obs.TraceConfig(),
                       device="cpu")


# ---------------------------------------------------------------------------------
# control events and the train loop
# ---------------------------------------------------------------------------------


def test_control_events_record_and_export():
    obs.reset_control_events()
    trace.control_event("numerics_fault", step=4, consecutive=1)
    trace.control_event("skip_step", step=4)
    evs = obs.control_events()
    assert [e["name"] for e in evs] == ["numerics_fault", "skip_step"]
    assert evs[0]["ts"] <= evs[1]["ts"]
    doc = obs.export_control_trace()
    instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
    assert [e["name"] for e in instants] == ["numerics_fault", "skip_step"]
    assert all(e["pid"] == trace.CONTROL_PID for e in instants)
    assert trace.validate_trace_events(doc["traceEvents"]) == []
    assert jtrace.validate_trace_events(doc["traceEvents"]) == []
    assert obs.recovery_narrative(instants) == jtrace.recovery_narrative(instants) == []
    obs.reset_control_events()
    assert obs.control_events() == []


TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
            d_ff=64, vocab_size=128, attn_chunk=16, remat="none", dtype="float32",
            scan_layers=False)
ST, JST = get_strategy("2d_finalized"), jax_get_strategy("2d_finalized")
DATA = dict(vocab_size=128, seq_len=8, global_batch=4, seed=1, pattern="arithmetic")


def _events(ctl):
    return [(e["name"], {k: v for k, v in e["args"].items() if k != "dt_ms"}) for e in ctl]


def test_train_loop_control_events_and_counters_match_reference(tmp_path):
    """A port and a reference ``TrainLoop`` (the reference's initial weights,
    NaN planted at step 2, checkpoints every two steps): the same control
    events in order with the same arguments (``ckpt_save``,
    ``numerics_fault``, ``skip_step``; timestamps left out), the same guard
    counters and one ``train.step_ms`` and ``train.tokens_per_s`` sample per
    step in both registries."""
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    jopt, opt = jax_get_optimizer("adafactor", lr=0.05), get_optimizer("adafactor", lr=0.05)
    common = dict(steps=4, ckpt_every=2)
    jtc = JaxTrainConfig(**common, ckpt_dir=str(tmp_path / "ref"),
                         guard=JGuardConfig(rewind_after=3),
                         numeric_fault=JaxNumericFaultSpec(nan_at_step=2))
    tc = TrainConfig(**common, ckpt_dir=str(tmp_path / "port"), guard=GuardConfig(rewind_after=3),
                     numeric_fault=NumericFaultSpec(nan_at_step=2))
    jstate = jax_init_state(jcfg, JST, jopt, jtc, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jstate["params"]), cfg, "cpu",
                               dtype="float32")
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    jloop = JaxTrainLoop(jcfg, JST, jopt, jtc, JaxTokenPipeline(JaxDataConfig(**DATA)))
    loop = TrainLoop(cfg, ST, opt, tc, TokenPipeline(DataConfig(**DATA)), device="cpu")
    got, want = {}, {}
    for name, lp, st, mod, reg in (("port", loop, state, trace, metrics),
                                   ("ref", jloop, jstate, jtrace, jmetrics)):
        mod.reset_control_events()
        reg.registry().reset()
        lp.run(initial_state=st, start_step=0)
        snap = reg.snapshot(include_sources=False)
        (got if name == "port" else want).update(
            events=_events(mod.control_events()),
            counters={k: v for k, v in snap["counters"].items() if k.startswith("train.")},
            samples={k: h["count"] for k, h in snap["histograms"].items()
                     if k.startswith("train.")})
    assert [n for n, _ in got["events"]] == ["ckpt_save", "numerics_fault", "skip_step",
                                             "ckpt_save", "ckpt_save"]
    assert got["events"] == want["events"]
    assert got["counters"] == want["counters"] == {"train.guard.faults": 1.0,
                                                   "train.guard.skips": 1.0}
    assert got["samples"] == want["samples"] == {"train.step_ms": 4, "train.tokens_per_s": 4}


# ---------------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------------


def _random_spans(seed):
    """Modeled and measured spans of four classes over three calls, some
    classes modeled at zero and one never measured (numpy from a seed)."""
    rng = np.random.default_rng(seed)
    classes = ["compute", "collective", "reshard", "call:scan"]
    events, t = [], 0.0
    for cls in classes:
        for _ in range(3):
            dur = 0.0 if cls == "reshard" else float(rng.uniform(1, 100))
            events.append(_span(f"m:{cls}", t, dur, pid=trace.MODELED_PID, **{"class": cls}))
            t += dur
    for call in range(3):
        for cls in classes[:3]:
            dur = float(rng.uniform(1, 400))
            events.append(_span(f"x:{cls}", t, dur, pid=trace.MEASURED_PID,
                                **{"class": cls, "call": call}))
            t += dur
    return events


@pytest.mark.parametrize("seed,factor", [(0, 3.0), (1, 3.0), (2, 1.5)])
def test_calibration_report_rows_match_reference(seed, factor):
    events = _random_spans(seed)
    mine = calibrate.calibration_report(events, factor=factor)
    ref = jcalibrate.calibration_report(events, factor=factor)
    assert mine.as_dict() == ref.as_dict()
    assert mine.calls == 3 and not mine.complete  # "call:scan" is priced, never measured
    assert mine.row("reshard").ratio is None
    assert calibrate.calibration_report({"traceEvents": events}).as_dict() == \
        jcalibrate.calibration_report({"traceEvents": events}).as_dict()
    assert mine.table() == ref.table()


def test_calibration_joins_by_class_and_normalizes_by_calls():
    events = [
        _span("m1", 0, 10.0, pid=trace.MODELED_PID, **{"class": "compute"}),
        _span("m2", 10, 100.0, pid=trace.MODELED_PID, tid=2, **{"class": "collective"}),
        _span("x1", 0, 20.0, pid=trace.MEASURED_PID, **{"class": "compute", "call": 0}),
        _span("x2", 20, 100.0, pid=trace.MEASURED_PID, tid=2,
              **{"class": "collective", "call": 0}),
        _span("x3", 200, 20.0, pid=trace.MEASURED_PID, **{"class": "compute", "call": 1}),
        _span("x4", 220, 100.0, pid=trace.MEASURED_PID, tid=2,
              **{"class": "collective", "call": 1}),
    ]
    rep = calibrate.calibration_report(events, factor=3.0)
    assert rep.calls == 2 and rep.complete and rep.flagged == []
    assert rep.row("compute").ratio == pytest.approx(2.0)
    assert rep.row("collective").ratio == pytest.approx(1.0)
    assert calibrate.calibration_report(events, factor=1.5).flagged == ["compute"]
    assert "| class |" in rep.table() and "| compute |" in rep.table()


def test_calibration_of_a_traced_runner_is_complete():
    """The modeled and measured lanes of one traced call join into a ratio
    for every priced class of the plan."""
    traced = _runner(obs.TraceConfig(timing="tight", repeats=1))
    traced(*_mlp_args())
    rep = calibrate.calibration_report(traced.tracer.chrome_trace())
    assert rep.complete and rep.calls == 1
    (entry,) = traced.plans.values()
    assert {r.cls for r in rep.rows} == {step_class(s) for s in entry.plan.steps}


# ---------------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------------


def test_cli_summarize(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    reg = metrics.MetricsRegistry()
    reg.inc("a.hits", 3)
    reg.set_gauge("g", 1.5)
    reg.observe("lat_ms", 2.0)
    p = reg.dump(str(tmp_path / "m.json"))
    assert main(["summarize", p]) == 0
    out = capsys.readouterr().out
    assert "a.hits" in out and "lat_ms" in out and "counters" in out


def test_cli_trace_emits_valid_chrome_json(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    p = str(tmp_path / "trace.json")
    assert main(["trace", p, "--mesh", "1x2", "--axes", "data,model", "--batch", "2",
                 "--seq", "16", "--reduce-k", "4"]) == 0
    with open(p) as f:
        doc = json.load(f)
    assert trace.validate_trace_events(doc["traceEvents"]) == []
    assert jtrace.validate_trace_events(doc["traceEvents"]) == []
    assert any(e["ph"] == "X" and e["pid"] == trace.MODELED_PID for e in doc["traceEvents"])
    out = capsys.readouterr().out
    assert "steps=" in out and "makespan=" in out
