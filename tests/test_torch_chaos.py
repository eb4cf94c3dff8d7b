"""The chaos soak harness (``launch/chaos.py``) against the JAX package's:
seed-deterministic campaign generation (the reference's schedule event for
event), the JSON round trip, single-device soaks through the invariant
battery, the replay-identical contract, planted faults the battery must
report, and one campaign whose control-event signature equals the
reference's run of it."""
import dataclasses
import json
import types

import pytest
import test_torch_elastic as elastic_t
import torch

from repro.launch import chaos as jchaos
from repro_torch.launch.chaos import (
    DEFAULT_KINDS,
    CampaignSpec,
    check_invariants,
    generate_campaign,
    replay_identical,
    run_campaign,
)
from repro_torch.train import checkpoint as ckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The soaks' tiny model trains fastest on one thread, and stays so when
    the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_generate_campaign_is_seed_deterministic():
    a = generate_campaign(11, steps=30, n_events=5)
    b = generate_campaign(11, steps=30, n_events=5)
    assert a.schedule == b.schedule
    c = generate_campaign(12, steps=30, n_events=5)
    assert [e["kind"] for e in a.schedule] != [e["kind"] for e in c.schedule]
    # every event has an intact checkpoint behind it
    steps = [e["step"] for e in a.schedule]
    assert steps == sorted(steps)
    assert all(t2 - t1 >= a.ckpt_every + 2 for t1, t2 in zip(steps, steps[1:]))


@pytest.mark.parametrize("seed,steps,events,world", [(11, 30, 5, 1), (3, 14, 3, 1),
                                                     (5, 80, 10, 8), (7, 20, 4, 4)])
def test_generate_campaign_equals_reference(seed, steps, events, world):
    got = generate_campaign(seed, steps=steps, n_events=events, world=world)
    want = jchaos.generate_campaign(seed, steps=steps, n_events=events, world=world)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert DEFAULT_KINDS == jchaos.DEFAULT_KINDS


def test_generate_campaign_legality_rules():
    # a return only once devices are out; one straggler at most
    for seed in range(24):
        spec = generate_campaign(seed, steps=80, n_events=10, world=8)
        out, stragglers = 0, 0
        for ev in spec.schedule:
            assert ev["kind"] in DEFAULT_KINDS
            if ev["kind"] == "device_loss":
                out += ev["lose"]
            elif ev["kind"] == "device_return":
                assert out > 0, f"seed {seed}: return with no devices out"
                out -= ev["gain"]
                assert out >= 0
            elif ev["kind"] == "straggler":
                stragglers += 1
        assert stragglers <= 1


def test_campaign_spec_json_round_trip(tmp_path):
    spec = generate_campaign(7, steps=20, n_events=4, world=4)
    p = str(tmp_path / "campaign.json")
    spec.to_json(p)
    again = CampaignSpec.from_json(p)
    assert again == spec
    with open(p) as f:
        assert json.load(f)["version"] == 1
    assert jchaos.CampaignSpec.from_json(p) == jchaos.CampaignSpec(**dataclasses.asdict(spec))


def test_soak_holds_invariants_and_replays(tmp_path):
    """A seeded 3-event soak (shrink -> NaN burst -> regrow, the one-device
    lose=0 / gain=0 edition) ends with no violation, and the same spec
    replays to the same control-event signature."""
    spec = CampaignSpec(seed=42, steps=14, ckpt_every=2, schedule=[
        {"kind": "device_loss", "step": 3, "lose": 0},
        {"kind": "nan_burst", "step": 7, "steps": 1},
        {"kind": "device_return", "step": 11, "gain": 0},
    ])
    same, a, b = replay_identical(spec, str(tmp_path), device="cpu")
    assert a.violations == []
    assert a.losses == 14
    assert same, "replay produced a different control-event signature"
    assert len(a.recoveries) == 3
    assert all("restored_from" in r for r in a.recoveries)
    assert [ep["restores"] for ep in a.narrative] == [1, 1, 1]
    assert all("corrupted_step" not in e for e in spec.schedule)


def test_soak_flags_deliberate_corruption_without_violations(tmp_path):
    """manifest_corrupt just before a rewind: the restore falls back past the
    corrupted newest step in the same pass, the step is known from the
    campaign's annotations, and the battery reports a clean soak."""
    spec = CampaignSpec(seed=1, steps=12, ckpt_every=2, schedule=[
        {"kind": "manifest_corrupt", "step": 7},
        {"kind": "nan_burst", "step": 7, "steps": 1},
    ])
    with elastic_t.memo_solves():
        report = run_campaign(spec, str(tmp_path), device="cpu")
    assert report.violations == []
    rec = [r for r in report.recoveries if "restored_from" in r]
    assert rec and any(r.get("fell_back_from") for r in rec)
    assert any("corrupt_checkpoint" in r["classes"] for r in rec)


def test_generated_campaign_signature_equals_reference(tmp_path):
    """The CLI's campaign (seed 3, 14 steps, 3 events, a world of one): the
    reference's schedule exactly, and the port's soak gives the
    reference's control-event signature (both clean).  The two packages'
    initial weights and tokens differ; the signature does not depend on
    them."""
    spec = generate_campaign(3, steps=14, n_events=3)
    jspec = jchaos.generate_campaign(3, steps=14, n_events=3)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    with elastic_t.memo_solves():  # the searches of both, memoized
        got = run_campaign(spec, str(tmp_path / "port"), device="cpu")
        want = jchaos.run_campaign(jspec, str(tmp_path / "ref"))
    assert got.violations == [] and want.violations == []
    assert got.signature == want.signature
    assert [r["classes"] for r in got.recoveries] == [r["classes"] for r in want.recoveries]
    assert got.losses == want.losses


def _fake_coordinator(d, losses, fired=()):
    """What ``check_invariants`` reads of a coordinator, over a directory of
    real checkpoints."""
    return types.SimpleNamespace(
        losses=dict(losses), tc=types.SimpleNamespace(ckpt_dir=d), recoveries=[],
        loop=types.SimpleNamespace(skipped_steps=[]),
        injector=types.SimpleNamespace(fired=set(fired)))


def test_planted_faults_fail_the_invariants(tmp_path):
    """The battery on a clean four-step record passes; one loss removed, a
    manifest whose data cursor is off by one (re-checksummed, so it still
    verifies), a non-finite state leaf, and a restore with no event each
    make it report a violation."""
    d = str(tmp_path / "ck")
    state = {"params": {"w": torch.ones(2, 3)}, "step": 4}
    for s in (2, 4):
        ckpt.save(d, s, state, extra={"data_cursor": s})
    spec = CampaignSpec(steps=4)
    losses = {s: 1.0 for s in range(4)}
    assert check_invariants(_fake_coordinator(d, losses), state, [], spec, []) == []

    gap = dict(losses)
    del gap[2]
    assert any("gaps" in v for v in
               check_invariants(_fake_coordinator(d, gap), state, [], spec, []))

    man = ckpt._load_manifest(d, 4)
    man["extra"]["data_cursor"] = 5
    man.pop("checksum")
    man["checksum"] = ckpt._manifest_checksum(man)
    with open(f"{d}/step_00000004/manifest.json", "w") as f:
        json.dump(man, f)
    assert ckpt.verify_step(d, 4)["ok"]
    assert any("data_cursor=5" in v for v in
               check_invariants(_fake_coordinator(d, losses), state, [], spec, []))

    bad = {"params": {"w": torch.tensor([1.0, float("nan")])}, "step": 4}
    assert any("non-finite" in v for v in
               check_invariants(_fake_coordinator(d, losses), bad, [], spec, []))

    co = _fake_coordinator(d, losses)
    co.recoveries = [{"classes": ["device_loss"], "restored_from": 2}]
    assert any("not single-pass" in v for v in check_invariants(co, state, [], spec, []))
