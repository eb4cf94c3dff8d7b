"""Deterministic fault-campaign soak harness over the elastic coordinator
(a port of the JAX package's ``launch/chaos.py``).

A chaos *campaign* is a seed-derived, JSON-serializable schedule of fault
events (the :class:`~repro_torch.launch.elastic.FaultInjector` schedule
format: device loss, device return, NaN bursts, gradient spikes, a crash
mid-save, straggler stalls, manifest corruption) driven through an
:class:`~repro_torch.launch.elastic.ElasticCoordinator` for an N-step soak.
After the run a battery of machine-checkable invariants is evaluated:

* **params finite**: every float leaf of the final state is finite;
* **loss curve gapless**: one loss per step over the soak, the only
  admissible holes being steps the guard skipped and never replayed;
* **data cursor monotone**: every surviving manifest's ``data_cursor``
  equals its step, and the sequence increases across steps;
* **checkpoints verify offline**: every intact step passes
  ``checkpoint.verify_step`` except the steps the campaign corrupted on
  purpose (the schedule's ``corrupted_step`` annotations), and the newest
  step always verifies;
* **narrative reconstructs**: every fired schedule event has its
  ``chaos_event`` instant on the control lane, every recovery restored
  exactly once, and :func:`~repro_torch.obs.trace.recovery_narrative`
  rebuilds the episodes from the control events alone.

:func:`run_campaign` returns a *signature* (the deterministic control-event
subsequence), and :func:`replay_identical` runs one spec twice in fresh
directories and compares the signatures: a failing soak replays from its
JSON artifact alone (``CampaignSpec.to_json`` / ``from_json``).

CLI::

    PYTHONPATH=src python -m repro_torch.launch.chaos --seed 3 --steps 14 \\
        --events 3 [--out campaign.json] [--replay] [--device cpu]

exits 0 when the soak holds every invariant (and, with ``--replay``, the
signature reproduces), 1 otherwise.  ``--device`` is "cuda" unless the
caller asks for "cpu".
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..obs import metrics as obs_metrics
from ..obs.trace import control_events, recovery_narrative
from ..train import checkpoint as ckpt_lib

# Control-event kinds that are deterministic under a fixed campaign seed.
# The loop's straggler watchdog ("straggler") keys off wall-clock step times
# and is left out; everything else is a function of the schedule, the data
# seed and the model's initial state.
SIGNATURE_KINDS = frozenset({
    "chaos_event", "device_loss", "device_return", "rewind",
    "combined_recovery", "mesh_shrink", "mesh_grow", "restore",
    "ckpt_fallback", "plan_swap", "crash_save", "numerics_fault",
    "skip_step", "ckpt_save",
})

# The kind pool of generated campaigns.  manifest_corrupt covers the
# restore-time fallback; a straggler is pure latency, so it is drawn at most
# once a campaign.
DEFAULT_KINDS = ("device_loss", "device_return", "nan_burst", "grad_spike",
                 "crash_save", "manifest_corrupt", "straggler")


@dataclasses.dataclass
class CampaignSpec:
    """One soak campaign, fully serializable: the replay artifact.

    ``world`` is the device-world size the schedule was generated for (the
    lose and gain counts are sized to it: a one-device world gets lose=0 and
    gain=0 events, which still run the whole recovery: classification,
    re-solve, restore).
    """

    seed: int = 0
    steps: int = 14
    ckpt_every: int = 2
    keep_ckpts: int = 3
    rewind_after: int = 1
    world: int = 1
    model_parallel: Optional[int] = None
    schedule: List[Dict] = dataclasses.field(default_factory=list)

    def to_json(self, path: Optional[str] = None) -> Dict:
        doc = dataclasses.asdict(self)
        doc["version"] = 1
        if path:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

    @classmethod
    def from_json(cls, src) -> "CampaignSpec":
        if isinstance(src, str):
            with open(src) as f:
                src = json.load(f)
        src = dict(src)
        src.pop("version", None)
        return cls(**src)


def generate_campaign(seed: int, steps: int = 14, n_events: int = 3, ckpt_every: int = 2,
                      world: int = 1, kinds: Tuple[str, ...] = DEFAULT_KINDS,
                      model_parallel: Optional[int] = None) -> CampaignSpec:
    """A seed-derived campaign: event steps ``ckpt_every + 2`` apart (each
    event has a fresh intact checkpoint behind it), kinds drawn from
    ``kinds`` under two legality rules: a ``device_return`` only after an
    unreturned ``device_loss`` (no regrow past the full world), and at most
    one ``straggler``.  The draws are the JAX package's, so a seed gives
    its schedule event for event."""
    rng = random.Random(seed)
    gap = ckpt_every + 2
    slots = list(range(ckpt_every + 1, max(steps - 1, ckpt_every + 2), gap))
    events: List[Dict] = []
    lost = 0  # devices currently out of the world
    had_straggler = False
    for slot in slots[:n_events]:
        pool = [k for k in kinds
                if not (k == "device_return" and world > 1 and lost == 0)
                and not (k == "straggler" and had_straggler)]
        kind = rng.choice(pool)
        ev: Dict[str, Any] = {"kind": kind, "step": slot}
        if kind == "device_loss":
            ev["lose"] = rng.randint(1, max(world // 2, 1)) if world > 1 else 0
            lost += ev["lose"]
        elif kind == "device_return":
            ev["gain"] = rng.randint(1, max(lost, 1)) if world > 1 else 0
            lost = max(lost - ev["gain"], 0)
        elif kind == "nan_burst":
            ev["steps"] = 1
        elif kind == "grad_spike":
            ev["factor"] = 1e12
        elif kind == "crash_save":
            ev["at_leaf"] = rng.randint(0, 2)
        elif kind == "straggler":
            ev["stall_s"] = 0.05
            had_straggler = True
        events.append(ev)
    return CampaignSpec(seed=seed, steps=steps, ckpt_every=ckpt_every, world=world,
                        model_parallel=model_parallel, schedule=events)


@dataclasses.dataclass
class CampaignReport:
    """Everything a post-mortem needs, JSON-ready (:meth:`to_json`)."""

    spec: CampaignSpec
    signature: List[Tuple]          # the deterministic control-event subsequence
    recoveries: List[Dict]          # the coordinator's recovery log
    narrative: List[Dict]           # recovery_narrative over the run's events
    violations: List[str]
    losses: int = 0                 # points on the returned curve
    skipped: List[int] = dataclasses.field(default_factory=list)
    recovery_ms: Optional[Dict] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self, path: Optional[str] = None) -> Dict:
        doc = {
            "spec": self.spec.to_json(),
            "ok": self.ok,
            "violations": self.violations,
            "signature": [list(s) for s in self.signature],
            "recoveries": self.recoveries,
            "narrative": self.narrative,
            "losses": self.losses,
            "skipped": self.skipped,
            "recovery_ms": self.recovery_ms,
        }
        if path:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1, default=str)
        return doc


def _default_model():
    from ..configs.base import ModelConfig, get_strategy

    cfg = ModelConfig(name="chaos-tiny", family="dense", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=128, attn_chunk=16,
                      remat="none")
    return cfg, get_strategy("2d_finalized")


def _signature(events: List[Dict]) -> List[Tuple]:
    """The deterministic (name, kind, step) subsequence of a run's control
    events: the replay-comparison key."""
    out = []
    for e in events:
        if e["name"] not in SIGNATURE_KINDS:
            continue
        args = e.get("args", {})
        out.append((e["name"], args.get("kind"), args.get("step")))
    return out


def run_campaign(spec: CampaignSpec, workdir: str, cfg=None, st=None,
                 device="cuda") -> CampaignReport:
    """Soak one campaign: build a tiny run on ``device``, drive the schedule
    through the elastic coordinator on a world of ``spec.world`` simulated
    devices, then check every invariant.  The injector gets a deep copy of
    the schedule (firing annotates events in place, ``corrupted_step``, and
    the spec must stay replayable)."""
    from .. import autoshard
    from ..core.plan import GuardConfig
    from ..data.pipeline import DataConfig, TokenPipeline
    from ..train.loop import TrainConfig
    from ..train.optimizer import get_optimizer
    from . import elastic

    if cfg is None:
        cfg, st = _default_model()
    ckpt_dir = os.path.join(workdir, "ck")
    tc = TrainConfig(
        steps=spec.steps, ckpt_dir=ckpt_dir, ckpt_every=spec.ckpt_every,
        keep_ckpts=spec.keep_ckpts, log_every=10_000,
        guard=GuardConfig(rewind_after=spec.rewind_after,
                          max_grad_norm=1e6))  # finite: grad spikes must trip
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 4, seed=7))
    schedule = copy.deepcopy(spec.schedule)
    inj = elastic.FaultInjector(schedule=schedule)
    co = elastic.ElasticCoordinator(
        cfg, st, get_optimizer("adafactor", lr=0.05), tc, pipe, n_devices=spec.world,
        model_parallel=spec.model_parallel,
        autoshard_config=autoshard.AutoshardConfig(top_n=2, sa_steps=2, max_candidates=6),
        injector=inj, max_recoveries=len(schedule) + 3, device=device)
    n0 = len(control_events())
    state, losses = co.run()
    events = control_events()[n0:]
    corrupted = [ev["corrupted_step"] for ev in schedule
                 if ev.get("corrupted_step") is not None]
    violations = check_invariants(co, state, events, spec, corrupted)
    rms = [r["duration_ms"] for r in co.recoveries if "duration_ms" in r]
    return CampaignReport(
        spec=spec, signature=_signature(events), recoveries=co.recoveries,
        narrative=recovery_narrative(events), violations=violations, losses=len(losses),
        skipped=list(co.loop.skipped_steps),
        recovery_ms=(None if not rms else {"count": len(rms), "max": max(rms),
                                           "mean": sum(rms) / len(rms)}))


def check_invariants(co, state, events: List[Dict], spec: CampaignSpec,
                     corrupted_steps: List[int]) -> List[str]:
    """The invariant battery: each violation is one human-readable line; an
    empty list is a passing soak."""
    import torch

    v: List[str] = []
    # 1. params finite
    for i, (key, leaf) in enumerate(ckpt_lib._flatten_with_paths(state)):
        if (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
                and not bool(torch.isfinite(leaf.detach()).all())):
            v.append(f"non-finite state leaf #{i} {key} (dtype {leaf.dtype})")
            break
    # 2. loss curve gapless modulo guard-skipped steps
    have = set(co.losses)
    missing = set(range(spec.steps)) - have
    stray = have - set(range(spec.steps))
    unexplained = missing - set(co.loop.skipped_steps)
    if unexplained:
        v.append(f"loss-curve gaps not explained by skips: {sorted(unexplained)}")
    if stray:
        v.append(f"loss curve has steps outside the soak: {sorted(stray)}")
    bad = [s for s, x in co.losses.items() if not np.isfinite(x)]
    if bad:
        v.append(f"non-finite losses at steps {sorted(bad)}")
    # 3. data cursor monotone across surviving manifests
    ckpt_dir = co.tc.ckpt_dir
    steps = ckpt_lib.intact_steps(ckpt_dir)
    cursors = []
    for s in steps:
        if s in corrupted_steps:
            continue  # unreadable by design; checked under invariant 4
        try:
            man = ckpt_lib._load_manifest(ckpt_dir, s)
        except ckpt_lib.CheckpointCorruptError:
            continue
        cur = man.get("extra", {}).get("data_cursor")
        if cur != s:
            v.append(f"step {s} manifest data_cursor={cur} != step")
        cursors.append((s, cur))
    if cursors != sorted(cursors):
        v.append(f"data cursors not monotone: {cursors}")
    # 4. checkpoints verify offline (deliberate corruption excepted; a
    #    corrupted step later overwritten by a new save is fine either way)
    for s in steps:
        rep = ckpt_lib.verify_step(ckpt_dir, s)
        if not rep["ok"] and s not in corrupted_steps:
            v.append(f"step {s} fails offline verify: {rep['errors'][:2]}")
    last = ckpt_lib.latest_step(ckpt_dir)
    if last is None:
        v.append("no intact checkpoint after the soak")
    elif not ckpt_lib.verify_step(ckpt_dir, last)["ok"]:
        v.append(f"newest step {last} fails offline verify")
    # 5. the narrative reconstructs from the control events alone
    fired_kinds = [e["args"]["kind"] for e in events if e["name"] == "chaos_event"]
    sched_fired = [ev["kind"] for i, ev in enumerate(spec.schedule)
                   if f"sched:{i}" in co.injector.fired]
    if sorted(fired_kinds) != sorted(sched_fired):
        v.append(f"chaos_event trace {sorted(fired_kinds)} != fired schedule "
                 f"{sorted(sched_fired)}")
    restores = [e for e in events if e["name"] == "restore"]
    restored = [r for r in co.recoveries if "restored_from" in r]
    if len(restores) != len(restored):
        v.append(f"{len(restores)} restore events vs {len(restored)} restoring recoveries: "
                 "not single-pass")
    narr = recovery_narrative(events)
    if restored and not narr:
        v.append("recovery_narrative empty despite restoring recoveries")
    for ep in narr:
        if ep["restores"] > 1:
            v.append(f"episode at step {ep.get('step')} restored {ep['restores']} times: "
                     "not single-pass")
    return v


def replay_identical(spec: CampaignSpec, workdir: str, cfg=None, st=None,
                     device="cuda") -> Tuple[bool, CampaignReport, CampaignReport]:
    """Run ``spec`` twice in fresh subdirectories and compare the
    deterministic signatures: the replayability contract of failing soaks."""
    a = run_campaign(spec, os.path.join(workdir, "a"), cfg=cfg, st=st, device=device)
    b = run_campaign(spec, os.path.join(workdir, "b"), cfg=cfg, st=st, device=device)
    return a.signature == b.signature, a, b


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(description="deterministic elastic chaos soak")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=14)
    ap.add_argument("--events", type=int, default=3)
    ap.add_argument("--ckpt-every", type=int, default=2)
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--spec", default=None,
                    help="replay a CampaignSpec JSON instead of generating")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write the report JSON here")
    ap.add_argument("--replay", action="store_true",
                    help="run twice and require identical signatures")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)

    spec = (CampaignSpec.from_json(args.spec) if args.spec
            else generate_campaign(args.seed, steps=args.steps, n_events=args.events,
                                   ckpt_every=args.ckpt_every, world=args.world))
    workdir = args.workdir or tempfile.mkdtemp(prefix="chaos_")
    if args.replay:
        same, report, _ = replay_identical(spec, workdir, device=args.device)
        if not same:
            report.violations.append("replay signature mismatch")
    else:
        report = run_campaign(spec, workdir, device=args.device)
    obs_metrics.maybe_dump()
    doc = report.to_json(args.out)
    print(json.dumps({k: doc[k] for k in ("ok", "violations", "losses", "recovery_ms")},
                     indent=1, default=str))
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
