"""Machine-profile fitting of the port (``repro_torch/obs/profile.py``)
against the JAX package's: the cases of ``tests/test_profile.py`` on the
port.

Covers planted-constant recovery and the fit against the reference's on the
same samples (the reference's ``DEFAULT_PARAMS`` passed to the port as its
explicit base: equal constants, residuals and flags within ``f32_chain``),
robust outlier rejection, JSON round-trips, resolution (argument, then
``$REPRO_TORCH_MACHINE_PROFILE``, then the committed H100 profile), the
committed profile itself, re-scoring, the calibration join, tight-timed
tracing joined into samples, process-cache isolation by profile, pricing
with a profile, the memory report, ``plan_peak_bytes`` of a two-trip scan
worked out by hand, and the ``profile`` CLI on the CPU.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro.analysis.roofline import DEFAULT_PARAMS as JDEFAULT
from repro.obs import calibrate as jcalibrate
from repro.obs import profile as jprofile
from repro_torch import obs
from repro_torch.analysis import roofline
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core import partitioner
from repro_torch.core.compat import assert_close, capture
from repro_torch.core.partitioner import (clear_process_plan_cache, process_plan_cache_stats,
                                          spmd_partition)
from repro_torch.core.plan import lower_for_cost, lower_plan
from repro_torch.core.scan import scan
from repro_torch.obs import calibrate, metrics, trace
from repro_torch.obs.profile import (PROFILE_ENV, MachineProfile, StepSample, collect_samples,
                                     device_memory_stats, fit_profile, memory_report,
                                     rescore_report, resolve_profile)

PLANTED = RooflineParams(peak_flops=1.5e13, hbm_bw=8.19e11, ici_bw=2.5e10,
                         collective_launch_s=2.5e-5, overlap_efficiency=0.9)
BASE = RooflineParams(**JDEFAULT.as_dict())  # the reference's TPU defaults, as an explicit base

# (class, flops, wire_bytes, launches): two compute classes spanning a 16x
# flops range plus three collective shapes, so all three fitted columns are
# well determined
_FEATS = (
    ("einsum", 2e9, 0.0, 0.0), ("einsum", 8e9, 0.0, 0.0),
    ("eltwise", 5e8, 0.0, 0.0),
    ("reshard", 0.0, 4e6, 1.0), ("reshard", 0.0, 3.2e7, 1.0),
    ("reshard", 0.0, 1e5, 2.0),
)


def _planted_samples(params=PLANTED):
    out = []
    for cls, fl, wb, la in _FEATS:
        s = StepSample(cls=cls, flops=fl, wire_bytes=wb, launches=la, measured_s=0.0)
        out.append(dataclasses.replace(s, measured_s=s.modeled_s(params)))
    return out


def _noisy_samples(seed):
    """Planted samples times log-normal noise, one of them a 40x outlier,
    plus a zero-feature step (numpy from a seed)."""
    rng = np.random.default_rng(seed)
    out = []
    for rep in range(4):
        for s in _planted_samples():
            out.append(dataclasses.replace(s, measured_s=s.measured_s
                                           * float(np.exp(rng.normal(0.0, 0.2)))))
    out[int(rng.integers(len(out)))] = dataclasses.replace(out[0], measured_s=out[0].measured_s
                                                           * 40.0)
    out.append(StepSample("compute", 0.0, 0.0, 0.0, 1e-6))
    return out


def _ref_samples(samples):
    return [jprofile.StepSample(cls=s.cls, flops=s.flops, wire_bytes=s.wire_bytes,
                                launches=s.launches, measured_s=s.measured_s) for s in samples]


# ---------------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------------


def test_fit_recovers_planted_constants_and_keeps_the_base_elsewhere():
    prof = fit_profile(_planted_samples(), BASE, source="test", device="cpu")
    assert set(prof.fitted) == {"peak_flops", "ici_bw", "collective_launch_s"}
    planted, fitted = PLANTED.as_dict(), prof.params.as_dict()
    for k in prof.fitted:
        assert_close(fitted[k], planted[k], "f32", err_msg=f"constant {k}")
    # unobservable fields are the explicit base's
    assert fitted["hbm_bw"] == BASE.hbm_bw
    assert fitted["overlap_efficiency"] == BASE.overlap_efficiency
    for cls, ratio in prof.residuals.items():
        assert_close(ratio, 1.0, "f32", err_msg=f"residual {cls}")
    assert prof.flagged == [] and prof.dropped == 0 and prof.n_samples == len(_FEATS)
    assert prof.device == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_matches_reference_on_the_same_samples(seed):
    """The same noisy samples, with an outlier, fitted by both packages (the
    reference's DEFAULT_PARAMS as the port's base): equal constants,
    residuals, flags, drops and fitted fields within f32_chain, and the same
    re-scoring."""
    samples = _noisy_samples(seed)
    mine = fit_profile(samples, BASE)
    ref = jprofile.fit_profile(_ref_samples(samples), JDEFAULT)
    assert mine.fitted == ref.fitted and mine.flagged == ref.flagged
    assert (mine.dropped, mine.n_samples) == (ref.dropped, ref.n_samples) and mine.dropped >= 1
    want = ref.params.as_dict()
    for k, v in mine.params.as_dict().items():
        assert_close(v, want[k], "f32_chain", err_msg=k)
    assert sorted(mine.residuals) == sorted(ref.residuals)
    for cls, v in mine.residuals.items():
        assert_close(v, ref.residuals[cls], "f32_chain", err_msg=cls)
    assert_close(mine.max_rel_residual, ref.max_rel_residual, "f32_chain")
    got = rescore_report(samples, mine.params, BASE)
    exp = jprofile.rescore_report(_ref_samples(samples), ref.params, JDEFAULT)
    assert got["in_band_classes"] == exp["in_band_classes"]
    assert got["improved_all"] == exp["improved_all"]
    for cls, row in got["classes"].items():
        for k, v in row.items():
            if isinstance(v, float):
                assert_close(v, exp["classes"][cls][k], "f32_chain", err_msg=f"{cls} {k}")
            else:
                assert v == exp["classes"][cls][k]


def test_fit_sets_residual_gauges_in_registry():
    metrics.registry().reset()
    fit_profile(_planted_samples(), BASE)
    gauges = metrics.snapshot()["gauges"]
    assert gauges["profile.fit_samples"] == len(_FEATS)
    assert gauges["profile.classes_flagged"] == 0.0
    assert gauges["profile.max_rel_residual"] == pytest.approx(0.0, abs=1e-9)
    for cls in ("einsum", "eltwise", "reshard"):
        assert gauges[f"profile.residual.{cls}"] == pytest.approx(1.0)


def test_fit_drops_outlier_partial_features_and_degenerate_sets():
    samples = _planted_samples()
    samples[0] = dataclasses.replace(samples[0], measured_s=samples[0].measured_s * 100.0)
    prof = fit_profile(samples, BASE)
    assert prof.dropped >= 1
    assert_close(prof.params.peak_flops, PLANTED.peak_flops, "f32")
    compute_only = fit_profile([s for s in _planted_samples() if s.flops > 0.0], BASE)
    assert compute_only.fitted == ["peak_flops"]
    assert compute_only.params.ici_bw == BASE.ici_bw
    assert compute_only.params.collective_launch_s == BASE.collective_launch_s
    empty = fit_profile([], BASE)
    assert empty.params == BASE and empty.fitted == []
    assert fit_profile([StepSample("x", 0.0, 0.0, 0.0, 1.0)], BASE).fitted == []
    with pytest.raises(TypeError):
        fit_profile(_planted_samples())  # the port's fit takes its base explicitly


# ---------------------------------------------------------------------------------
# persistence, resolution and the committed profile
# ---------------------------------------------------------------------------------


def test_roofline_params_and_machine_profile_roundtrip(tmp_path):
    back = RooflineParams.from_dict(json.loads(json.dumps(PLANTED.as_dict())))
    assert back == PLANTED and back.digest() == PLANTED.digest() != BASE.digest()
    assert PLANTED.digest() == jprofile.RooflineParams(**PLANTED.as_dict()).digest()
    prof = fit_profile(_planted_samples(), BASE, source="roundtrip", device="cpu")
    prof.measurements = {"hbm_copy_gbs": 1.5}
    back = MachineProfile.load(prof.dump(str(tmp_path / "prof.json")))
    assert back.params == prof.params and back.digest() == prof.digest()
    assert back.fitted == prof.fitted and back.residuals == pytest.approx(prof.residuals)
    assert (back.n_samples, back.source, back.device) == (prof.n_samples, "roundtrip", "cpu")
    assert back.measurements == {"hbm_copy_gbs": 1.5}


def test_resolve_profile_precedence(tmp_path, monkeypatch):
    prof = fit_profile(_planted_samples(), BASE)
    path = prof.dump(str(tmp_path / "prof.json"))
    monkeypatch.delenv(PROFILE_ENV, raising=False)
    assert resolve_profile(None) is roofline.DEFAULT_PARAMS  # the committed card profile
    assert resolve_profile(PLANTED) is PLANTED
    assert resolve_profile(prof) == prof.params
    assert resolve_profile(path) == prof.params
    metrics.registry().reset()
    monkeypatch.setenv(PROFILE_ENV, path)
    assert resolve_profile(None) == prof.params
    assert metrics.snapshot()["gauges"]["profile.staleness_s"] >= 0.0
    assert resolve_profile(PLANTED) is PLANTED
    with pytest.raises(TypeError):
        resolve_profile(42)


def test_committed_profile_was_fitted_on_an_h100():
    """The package's default constants: fitted on an H100 whose name and
    power limit it records, its three fitted fields fitted, ``hbm_bw`` the
    copy it measured, no overlap, and none of the reference's TPU
    constants."""
    prof = MachineProfile.load(roofline.PROFILE_FILE)
    assert prof.params == roofline.DEFAULT_PARAMS
    assert prof.device.startswith("NVIDIA H100") and prof.device.endswith(" W")
    assert set(prof.fitted) == {"peak_flops", "ici_bw", "collective_launch_s"}
    assert prof.params.overlap_efficiency == 0.0
    assert prof.params.hbm_bw == pytest.approx(prof.measurements["hbm_copy_gbs"] * 1e9)
    tpu = JDEFAULT.as_dict()
    assert all(v != tpu[k] for k, v in prof.params.as_dict().items() if k != "overlap_efficiency")
    assert prof.digest() == prof.params.digest()


# ---------------------------------------------------------------------------------
# re-scoring and the calibration join
# ---------------------------------------------------------------------------------


def test_rescore_improves_when_fitted_matches_machine():
    samples = _planted_samples()
    res = rescore_report(samples, PLANTED, BASE)
    assert res["in_band_classes"] == 3 and res["improved_all"]
    for row in res["classes"].values():
        assert row["ratio_fitted"] == pytest.approx(1.0) and row["improved"]
    assert not rescore_report(samples, BASE, BASE)["improved_all"]
    assert not rescore_report([], PLANTED, BASE)["improved_all"]


def test_attach_profile_joins_residuals_as_the_reference():
    events = [
        {"name": "m", "ph": "X", "ts": 0, "dur": 1.0, "pid": trace.MODELED_PID, "tid": 1,
         "args": {"class": "compute"}},
        {"name": "x", "ph": "X", "ts": 0, "dur": 2.0, "pid": trace.MEASURED_PID, "tid": 1,
         "args": {"class": "compute", "call": 0}},
    ]
    rep = calibrate.calibration_report(events)
    assert "profile_digest" not in rep.as_dict()
    calibrate.attach_profile(rep, MachineProfile(params=PLANTED, residuals={"compute": 1.2}))
    ref = jcalibrate.attach_profile(
        jcalibrate.calibration_report(events),
        jprofile.MachineProfile(params=jprofile.RooflineParams(**PLANTED.as_dict()),
                                residuals={"compute": 1.2}))
    assert rep.as_dict() == ref.as_dict()
    assert rep.as_dict()["profile_digest"] == PLANTED.digest()


# ---------------------------------------------------------------------------------
# tight tracing, samples and the process cache (a simulated (2, 4) mesh)
# ---------------------------------------------------------------------------------

SMALL = Mesh.create((2, 4), ("x", "y"))


def _f(a, b):
    a = annotate(a, mesh_split(2, SMALL, ["x", -1]))
    b = annotate(b, mesh_split(2, SMALL, [-1, "y"]))
    return torch.tanh(a @ b)


def _runner(trace_cfg=None, profile=None):
    return spmd_partition(_f, SMALL, trace=trace_cfg, profile=profile, device="cpu")


def _ab(n=16):
    rng = np.random.default_rng(0)
    return [torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)) for _ in range(2)]


def test_tight_timing_matches_untraced_and_collects_samples():
    a, b = _ab()
    ref = _runner(profile=PLANTED)(a, b)
    tight = _runner(obs.TraceConfig(timing="tight", repeats=2), profile=PLANTED)
    assert torch.equal(tight(a, b), ref)
    (entry,) = tight.plans.values()
    measured = tight.tracer.measured_events()
    assert len(measured) == len(entry.plan.steps)
    assert trace.validate_trace_events(tight.tracer.chrome_trace()["traceEvents"]) == []
    samples = collect_samples(entry.plan, measured)
    assert len(samples) == len(measured) and all(s.measured_s > 0.0 for s in samples)
    assert any(s.flops > 0.0 for s in samples)


def test_cache_isolation_by_profile_and_profile_applied_events(monkeypatch, tmp_path):
    """The default profile shares one process-cache entry across call sites;
    two other profiles get two more; an ambient profile file gets its own;
    each build emits ``profile_applied`` with the digest it priced by."""
    monkeypatch.delenv(PROFILE_ENV, raising=False)
    clear_process_plan_cache()
    obs.reset_control_events()
    a = torch.ones(8, 8)
    _runner()(a, a)
    _runner()(a, a)
    assert process_plan_cache_stats().hits == 1 and len(partitioner._PROCESS_CACHE) == 1
    p2 = dataclasses.replace(PLANTED, peak_flops=PLANTED.peak_flops * 2)
    r1, r2 = _runner(profile=PLANTED), _runner(profile=p2)
    r1(a, a)
    r2(a, a)
    assert len(partitioner._PROCESS_CACHE) == 3
    (e1,) = r1.plans.values()
    assert e1.plan.params == PLANTED
    monkeypatch.setenv(PROFILE_ENV, MachineProfile(params=p2).dump(str(tmp_path / "p.json")))
    _runner()(a, a)  # the ambient profile: p2's entry, a hit
    assert len(partitioner._PROCESS_CACHE) == 3 and process_plan_cache_stats().hits == 2
    applied = [e["args"]["digest"] for e in obs.control_events()
               if e["name"] == "profile_applied"]
    assert applied == [roofline.DEFAULT_PARAMS.digest(), PLANTED.digest(), p2.digest()]
    clear_process_plan_cache()
    obs.reset_control_events()


def _mlp_cost(params):
    mesh = Mesh.create((4, 8), ("x", "y"))

    def f(a, w):
        a = annotate(a, mesh_split(2, mesh, ["x", -1]))
        w = annotate(w, mesh_split(2, mesh, [-1, "y"]))
        return torch.tanh(a @ w)

    cap = capture(f, torch.empty(64, 32, device="meta"), torch.empty(32, 64, device="meta"))
    return lower_for_cost(cap, None, mesh, optimize=False, profile=params)


def test_plancost_reprices_with_the_profile():
    base = _mlp_cost(roofline.DEFAULT_PARAMS)
    half = _mlp_cost(dataclasses.replace(roofline.DEFAULT_PARAMS,
                                         peak_flops=roofline.DEFAULT_PARAMS.peak_flops / 2.0,
                                         ici_bw=roofline.DEFAULT_PARAMS.ici_bw / 2.0))
    assert half.total_s > base.total_s
    assert half.compute_s == pytest.approx(2.0 * base.compute_s)
    assert base.as_dict()["wire_bytes"] == half.as_dict()["wire_bytes"]


# ---------------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------------


class _FakePlan:
    peak_bytes = 1024.0


def test_memory_report_joins_or_degrades():
    assert device_memory_stats() is None  # no card here
    rep = memory_report(_FakePlan(), None, None)
    assert rep["modeled_peak_bytes"] == 1024.0 and rep["modeled_peak_bytes_all_devices"] == 1024.0
    assert not rep["measured"] and rep["measured_peak_bytes"] is None
    rep2 = memory_report(_FakePlan(), {"peak_bytes_in_use": 100.0},
                         {"peak_bytes_in_use": 900.0, "bytes_in_use": 500.0})
    ref = jprofile.memory_report(_FakePlan(), {"peak_bytes_in_use": 100.0},
                                 {"peak_bytes_in_use": 900.0, "bytes_in_use": 500.0})
    assert {k: rep2[k] for k in ref} == ref
    assert rep2["measured_peak_delta_bytes"] == 800.0


def test_plan_peak_bytes_counts_a_scan_bodys_consts_and_xs_once():
    """A two-trip scan on a (2, 4) mesh, everything replicated, float32:
    carry c (256, 16), xs (2, 256), the const w (256, 16); the body computes
    y = w * c + x[:, None] and returns (y, y.sum(1)).

    Outer inputs: c 16,384 + xs 2,048 + w 16,384 = 34,816 bytes.  The scan
    step writes the final carry (16,384) and the stacked ys (2,048): 53,248
    live.  The body's own peak is its inputs (w 16,384, c 16,384, x 1,024
    = 33,792) plus the product (16,384), the unsqueeze (1,024) and the sum
    w * c + x (16,384): 67,584.  Its const and its slice of xs are views of
    the outer plan's w and xs, so the step adds 67,584 - 16,384 - 1,024 =
    50,176: its carry stays, since from the second trip on it is the first
    trip's y while the outer c is still live.  Peak 53,248 + 50,176 =
    103,424 (the two ``getitem`` steps after it reach 53,248).  Taking the
    carry off as well gave 87,040; counting every body input twice gave
    120,832."""
    N, K = 256, 16

    def f(c, xs, w):
        def body(carry, x, w):
            y = w * carry + x[:, None]
            return y, y.sum(1)

        return scan(body, c, xs, consts=(w,))

    cap = capture(f, torch.empty(N, K, device="meta"), torch.empty(2, N, device="meta"),
                  torch.empty(N, K, device="meta"))
    plan = lower_plan(cap, None, SMALL, optimize=False)
    (step,) = [s for s in plan.steps if s.inner is not None]
    assert step.call == {"trips": 2, "num_consts": 1, "num_carry": 1}
    assert step.inner.peak_bytes == 67584.0 == step.transient_bytes
    assert plan.peak_bytes == 103424.0


# ---------------------------------------------------------------------------------
# the profile CLI on the CPU
# ---------------------------------------------------------------------------------


def test_cli_profile_fits_on_the_cpu(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    p = str(tmp_path / "prof.json")
    assert main(["profile", p, "--device", "cpu", "--dims", "64,32", "--layers", "2",
                 "--repeats", "1"]) == 0
    prof = MachineProfile.load(p)
    assert prof.device == "cpu" and prof.n_samples > 0 and prof.fitted
    assert prof.params.overlap_efficiency == 0.0
    assert prof.params.hbm_bw == pytest.approx(prof.measurements["hbm_copy_gbs"] * 1e9)
    assert math.isfinite(prof.params.peak_flops)
    out = capsys.readouterr().out
    assert "device: cpu" in out and "| class |" in out
