"""Plan-step tracing: measured spans, modeled timelines, control events
(port of the JAX package's ``obs/trace.py``).

Tracing contract (read this before trusting a number)
-----------------------------------------------------

A compiled :class:`~repro_torch.core.plan.PartitionPlan` runs eagerly: its
step walk is Python on the host, each step enqueueing its kernels on the
card's current stream.  ``PartitionPlan.execute(..., tracer=...)`` hands
each step to :meth:`Tracer.run_step`, which times it.  Only the plan's own
steps are spans: a scan's call step is one span (class ``call:scan``), its
body plan's trips inside it.

``timing="eager"`` (the default): one ``perf_counter`` pair around the
step.  With :attr:`TraceConfig.sync` (the default) the span closes after
``torch.cuda.synchronize()``, so it covers the host's dispatch *plus* the
device's work; with ``sync=False`` it measures dispatch only (the device
runs behind), which shows host-bound steps and is useless for calibration.
Eager spans are upper bounds on a step's device time, loosest for tiny
steps.

``timing="tight"`` is the calibration mode.  Each step runs once untimed:
that run's results are the ones the plan goes on with, so a traced call's
outputs are those of an untraced call.  Then the step runs
:attr:`TraceConfig.repeats` more times, each timed with CUDA events on the
card (``perf_counter`` on the CPU), and the minimum is the span.  The
repeats write into a scratch overlay of the step's environment that is
dropped afterwards, so they change no value the plan reads later (a scan
step's ys buffers, a kernel's non-deterministic sums).  Every launch of a
kernel wrapper counts as always (``kernels/*.py``'s ``launches``); the
tracer keeps apart the launches of the untimed runs (``launches["path"]``,
what an untraced call launches) and of the repeats
(``launches["timing"]``).  Span timestamps under tight timing are a
synthetic cursor (the sum of the minima): durations are real, positions
are not, and the control lane no longer lines up with the steps.  Each step
runs ``1 + repeats`` times, so tight tracing is for calibration runs only,
never for end-to-end times.

The *modeled* timeline is ``plan_opt.modeled_timeline``: the overlap
scheduler's own timing rules replayed over the final step order, priced by
the plan's profile.

Lanes (Chrome trace ``pid``/``tid`` mapping)
--------------------------------------------

========  ===========  ====================================================
pid       process      tids
========  ===========  ====================================================
1         modeled      1 = compute, 2 = interconnect
2         measured     1 = compute, 2 = interconnect
3         control      1 = instant events (faults, skips, saves, profiles)
========  ===========  ====================================================

A step lands on the interconnect lane when the overlap scheduler charges
it to the communication resource (reshard, collective and fused steps),
on the compute lane otherwise (compute, guard and scan call steps); the
``class`` argument is ``plan_opt.step_class``'s.

Control events are process-global (:func:`control_event`), timestamped on
the same ``perf_counter`` epoch as eager spans.  Export is Chrome
trace-event JSON (``{"traceEvents": [...]}``, ``ts``/``dur`` in
microseconds), which Perfetto and ``chrome://tracing`` load.
"""
from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

# One perf_counter epoch per process: measured spans and control events share
# it, so cross-source ordering in the merged trace is meaningful.
_EPOCH = time.perf_counter()

MODELED_PID = 1
MEASURED_PID = 2
CONTROL_PID = 3
COMPUTE_TID = 1
INTERCONNECT_TID = 2
CONTROL_TID = 1

# Step kinds the overlap scheduler charges to the communication resource
# (plan_opt._step_durations gives them comm seconds only).
_COMM_KINDS = ("reshard", "collective", "fused")

# the kernel wrappers' modules, each with a module-level ``launches`` count
KERNEL_MODULES = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")


def _now_us() -> float:
    return (time.perf_counter() - _EPOCH) * 1e6


def kernel_launches() -> Dict[str, int]:
    """The kernel wrappers' launch counts, by module (those not imported
    yet have launched nothing)."""
    out = {}
    for name in KERNEL_MODULES:
        mod = sys.modules.get(f"repro_torch.kernels.{name}")
        out[name] = int(getattr(mod, "launches", 0)) if mod is not None else 0
    return out


def _sync() -> None:
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Scratch(dict):
    """A step environment whose writes land here and whose reads fall through
    to the plan's: what a tight repeat runs in, dropped after it."""

    def __init__(self, base):
        super().__init__()
        self.base = base

    def __missing__(self, key):
        return self.base[key]


@dataclass(frozen=True)
class TraceConfig:
    """Opt-in tracing switch for ``spmd_partition(trace=...)``.

    enabled
        Master switch; ``TraceConfig(enabled=False)`` is normalized to no
        tracing inside ``spmd_partition``: the same plan-cache key and the
        same runner as no config at all.
    modeled
        Emit the modeled timeline of each compiled plan.
    measured
        Record a measured span per plan step (see the module docstring).
    sync
        Synchronize the card before closing each eager span (device time
        included); ``False`` measures dispatch only.
    path
        Carries the caller's intent only: export with
        ``runner.tracer.write(path)``.
    timing
        ``"eager"`` (default): one ``perf_counter`` pair per step.
        ``"tight"``: one untimed run, then the minimum of ``repeats`` runs
        timed with CUDA events (``perf_counter`` on the CPU); synthetic
        timestamps.
    repeats
        Timed repetitions per step under ``timing="tight"``.
    """

    enabled: bool = True
    modeled: bool = True
    measured: bool = True
    sync: bool = True
    path: Optional[str] = None
    timing: str = "eager"
    repeats: int = 3

    @property
    def cache_key(self) -> Tuple:
        return (self.enabled, self.modeled, self.measured, self.sync,
                self.timing, self.repeats)


def step_lane(kind: str) -> int:
    return INTERCONNECT_TID if kind in _COMM_KINDS else COMPUTE_TID


class Tracer:
    """Collects modeled timelines and measured spans, and exports Chrome JSON.

    One tracer per ``spmd_partition`` runner: the runner feeds it each
    compiled plan (:meth:`on_plan`, the modeled lane) and
    ``plan.execute(..., tracer=...)`` runs every step through
    :meth:`run_step` (the measured lane).  ``launches`` holds the kernel
    launches of the traced calls, ``"path"`` (the untimed runs) and
    ``"timing"`` (tight timing's repeats), by kernel module.
    """

    def __init__(self, config: Optional[TraceConfig] = None):
        self.config = config or TraceConfig()
        self._lock = threading.Lock()
        self._modeled: List[Dict[str, Any]] = []  # chrome events, pid 1
        self._measured: List[Dict[str, Any]] = []  # chrome events, pid 2
        self._calls = 0
        self._plans_seen = 0
        self._cursor = 0.0  # tight timing's synthetic clock (µs)
        self._cuda = False  # the call in progress runs on the card
        self.launches = {"path": collections.Counter(), "timing": collections.Counter()}

    # -- modeled lane --------------------------------------------------------
    def on_plan(self, plan) -> None:
        """Emit the modeled timeline of a freshly compiled plan.  Repeated
        calls (new input signatures) append further rows offset past the
        previous plan's makespan; ``args["plan"]`` carries the ordinal."""
        if not self.config.modeled:
            return
        from ..core.plan_opt import modeled_timeline

        rows = modeled_timeline(plan)
        with self._lock:
            base = 0.0
            for ev in self._modeled:
                base = max(base, ev["ts"] + ev.get("dur", 0.0))
            ordinal = self._plans_seen
            self._plans_seen += 1
            for row in rows:
                self._modeled.append({
                    "name": row["name"],
                    "ph": "X",
                    "ts": base + row["start_s"] * 1e6,
                    "dur": row["dur_s"] * 1e6,
                    "pid": MODELED_PID,
                    "tid": INTERCONNECT_TID
                    if row["lane"] == "interconnect" else COMPUTE_TID,
                    "args": {
                        "class": row["cls"],
                        "index": row["index"],
                        "plan": ordinal,
                        "compute_s": row["compute_s"],
                        "comm_s": row["comm_s"],
                    },
                })

    # -- measured lane -------------------------------------------------------
    def begin_call(self, cuda: bool = False) -> int:
        """Open one traced plan execution; ``cuda``: its values live on the
        card (tight timing then times with CUDA events)."""
        with self._lock:
            call = self._calls
            self._calls += 1
        self._cuda = cuda
        self._cursor = _now_us()
        return call

    def run_step(self, index: int, step, env, call: int) -> None:
        """Run ``step`` in ``env`` (as ``PartitionPlan.execute`` would) and
        record its span."""
        before = kernel_launches()
        if self.config.timing == "tight":
            step.run(env, step.reads, step.writes)
            _sync()
            mid = kernel_launches()
            best = self._best_of(step, env)
            self._add_launches("path", before, mid)
            self._add_launches("timing", mid, kernel_launches())
            self.record_step(index, step, self._cursor, self._cursor + best, call)
            self._cursor += best
            return
        t0 = _now_us()
        step.run(env, step.reads, step.writes)
        if self.config.sync:
            _sync()
        t1 = _now_us()
        self._add_launches("path", before, kernel_launches())
        self.record_step(index, step, t0, t1, call)

    def _best_of(self, step, env) -> float:
        """The least of ``repeats`` timed runs of ``step`` (µs), each in a
        scratch overlay of ``env``."""
        import torch

        best = float("inf")
        for _ in range(max(1, int(self.config.repeats))):
            scratch = _Scratch(env)
            if self._cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                step.run(scratch, step.reads, step.writes)
                e1.record()
                e1.synchronize()
                us = e0.elapsed_time(e1) * 1e3
            else:
                t0 = time.perf_counter()
                step.run(scratch, step.reads, step.writes)
                us = (time.perf_counter() - t0) * 1e6
            best = min(best, us)
            del scratch
        return best

    def _add_launches(self, lane: str, before: Dict[str, int], after: Dict[str, int]) -> None:
        with self._lock:
            for name, n in after.items():
                if n != before[name]:
                    self.launches[lane][name] += n - before[name]

    def record_step(self, index: int, step, t0_us: float, t1_us: float, call: int) -> None:
        """One measured span; ``t0_us``/``t1_us`` from :meth:`now_us`."""
        from ..core.plan_opt import step_class

        ev = {
            "name": f"{step.kind}:{step.op or ''}".rstrip(":"),
            "ph": "X",
            "ts": t0_us,
            "dur": max(t1_us - t0_us, 0.0),
            "pid": MEASURED_PID,
            "tid": step_lane(step.kind),
            "args": {
                "class": step_class(step),
                "index": index,
                "call": call,
            },
        }
        with self._lock:
            self._measured.append(ev)

    @staticmethod
    def now_us() -> float:
        return _now_us()

    # -- accessors / export --------------------------------------------------
    @property
    def calls(self) -> int:
        with self._lock:
            return self._calls

    def modeled_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._modeled)

    def measured_events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._measured)

    def chrome_trace(self, include_control: bool = True) -> Dict[str, Any]:
        events = _lane_metadata()
        events += self.modeled_events()
        events += self.measured_events()
        if include_control:
            events += control_chrome_events()
        return {"traceEvents": events}

    def write(self, path: str, include_control: bool = True) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(include_control=include_control), f,
                      indent=1, default=str)
        return path


def _lane_metadata() -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for pid, pname in ((MODELED_PID, "modeled"), (MEASURED_PID, "measured"),
                       (CONTROL_PID, "control")):
        events.append({
            "name": "process_name", "ph": "M", "pid": pid,
            "args": {"name": pname},
        })
    for pid in (MODELED_PID, MEASURED_PID):
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": COMPUTE_TID, "args": {"name": "compute"},
        })
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid,
            "tid": INTERCONNECT_TID, "args": {"name": "interconnect"},
        })
    events.append({
        "name": "thread_name", "ph": "M", "pid": CONTROL_PID,
        "tid": CONTROL_TID, "args": {"name": "elastic"},
    })
    return events


# -- control lane (process-global) -------------------------------------------
#
# Guard, checkpoint and profile events outlive any single runner, so the
# control log is module-level.  The train loop and the partitioner call
# control_event(...) unconditionally: appending a dict under a lock is cheap
# enough to leave always on, and it is what lets a post-mortem trace tell the
# whole story.

_CONTROL_LOCK = threading.Lock()
_CONTROL_EVENTS: List[Dict[str, Any]] = []

# Every control-event kind of the guard, checkpoint, elastic and chaos
# machinery (train/loop.py, launch/elastic.py) and of profile application.
# The set is advisory (control_event stays permissive) but narrative
# reconstruction keys off it.
CONTROL_EVENT_KINDS = frozenset({
    "numerics_fault", "skip_step", "rewind",          # guard (train/loop)
    "device_loss", "device_return",                   # world membership
    "mesh_shrink", "mesh_grow",                       # mesh re-derivation
    "combined_recovery", "restore", "ckpt_fallback",  # single-pass recovery
    "plan_swap", "crash_save", "straggler",           # plan/save/watchdog
    "ckpt_save",                                      # committed checkpoints
    "chaos_event",                                    # injected campaign event
    "profile_applied",                                # calibrated RooflineParams
})


def control_event(name: str, **args: Any) -> Dict[str, Any]:
    """Record an instant event (see :data:`CONTROL_EVENT_KINDS`) on the
    control lane."""
    ev = {"name": name, "ts": _now_us(), "args": dict(args)}
    with _CONTROL_LOCK:
        _CONTROL_EVENTS.append(ev)
    return ev


def control_events() -> List[Dict[str, Any]]:
    with _CONTROL_LOCK:
        return [dict(e) for e in _CONTROL_EVENTS]


def reset_control_events() -> None:
    with _CONTROL_LOCK:
        _CONTROL_EVENTS.clear()


def control_chrome_events() -> List[Dict[str, Any]]:
    return [{
        "name": e["name"],
        "ph": "i",
        "s": "g",
        "ts": e["ts"],
        "pid": CONTROL_PID,
        "tid": CONTROL_TID,
        "args": e["args"],
    } for e in control_events()]


def export_control_trace() -> Dict[str, Any]:
    """Standalone Chrome trace of just the control lane (used by tests and
    by runs that never enabled step tracing but still want the elastic
    story)."""
    return {"traceEvents": _lane_metadata() + control_chrome_events()}


# Recovery-*action* instants that open an episode.  Raw fault instants
# (numerics_fault / skip_step) deliberately do not: a skip-only burst that
# never escalates is handled inside the step and triggers no recovery, so it
# must not bleed into a later unrelated episode.
_EPISODE_OPENERS = frozenset(
    {"device_loss", "device_return", "crash_save", "rewind",
     "combined_recovery"})


def recovery_narrative(events: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Reconstruct recovery episodes purely from control events.

    ``events`` is either the raw :func:`control_events` list or the instant
    (``ph == "i"``) events of an exported Chrome trace — both carry
    ``name``/``ts``/``args``.  Returns one dict per episode, in time order::

        {"classes": [fault classes handled],    # e.g. ["device_loss", "numerics"]
         "step": the fault step the episode opened at,
         "mesh": {"from": [...], "to": [...]} or None (mesh unchanged),
         "restore_steps": [manifest steps restored from],
         "restores": how many restore passes ran,
         "events": [control-event names, in order]}

    An episode opens at a recovery *action* (device loss/return, rewind,
    combined recovery, crash-mid-save) and closes at the ``plan_swap`` that
    resumes training (a crash-save resume closes at its own instant — no plan
    changes).  This is the machine-checkable form of "the trace tells the
    whole story": the chaos harness asserts each injected fault maps onto an
    episode with the expected classes, and the combined-recovery drill
    asserts coincident faults land in **one** episode with **one** restore.
    """
    inst = sorted(
        (e for e in events if e.get("ph", "i") == "i"),
        key=lambda e: e.get("ts", 0.0))
    episodes: List[Dict[str, Any]] = []
    cur: Optional[Dict[str, Any]] = None
    for e in inst:
        name = e["name"]
        args = e.get("args", {})
        if name not in CONTROL_EVENT_KINDS:
            continue
        if cur is None:
            if name not in _EPISODE_OPENERS:
                continue
            cur = {"classes": [], "step": args.get("step"), "mesh": None,
                   "restore_steps": [], "restores": 0, "events": []}
        cur["events"].append(name)
        if name in ("device_loss", "device_return", "crash_save"):
            if name not in cur["classes"]:
                cur["classes"].append(name)
        elif name == "rewind" and "numerics" not in cur["classes"]:
            cur["classes"].append("numerics")
        elif name == "combined_recovery":
            for c in args.get("classes", []):
                if c not in cur["classes"]:
                    cur["classes"].append(c)
        elif name in ("mesh_shrink", "mesh_grow"):
            cur["mesh"] = {"from": args.get("mesh_from"),
                           "to": args.get("mesh_to")}
        elif name == "restore":
            cur["restores"] += 1
            if args.get("step") is not None:
                cur["restore_steps"].append(args["step"])
        elif name == "ckpt_fallback" and "corrupt_checkpoint" not in cur["classes"]:
            cur["classes"].append("corrupt_checkpoint")
        if name == "plan_swap" or (name == "crash_save"
                                   and args.get("resumed")):
            episodes.append(cur)
            cur = None
    if cur is not None:
        episodes.append(cur)
    return episodes


# -- schema validation --------------------------------------------------------

_VALID_PH = {"X", "i", "M"}
_EPS_US = 1e-3  # float-roundoff slack when checking nesting, in µs


def validate_trace_events(events: Sequence[Dict[str, Any]]) -> List[str]:
    """Validate Chrome trace-event structure; return a list of problems
    (empty ⇒ valid).

    Checks, per the tracing contract:

    * every event has ``name``/``ph``/``pid``; ``ph`` is one of X/i/M;
    * ``X`` (complete) events carry numeric ``ts`` ≥ 0, ``dur`` ≥ 0 and a
      ``tid``; ``i`` (instant) events carry ``ts``;
    * within one ``(pid, tid)`` lane, spans either nest properly or are
      disjoint — partial overlap means two steps claimed the same resource
      at once, which neither the scheduler model nor eager execution can
      produce.
    """
    problems: List[str] = []
    lanes: Dict[Tuple[Any, Any], List[Tuple[float, float, str]]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not a dict")
            continue
        name = ev.get("name")
        ph = ev.get("ph")
        if not isinstance(name, str) or not name:
            problems.append(f"event {i}: missing name")
        if ph not in _VALID_PH:
            problems.append(f"event {i} ({name}): bad ph {ph!r}")
            continue
        if "pid" not in ev:
            problems.append(f"event {i} ({name}): missing pid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({name}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({name}): bad dur {dur!r}")
                continue
            if "tid" not in ev:
                problems.append(f"event {i} ({name}): X event missing tid")
                continue
            lanes.setdefault((ev.get("pid"), ev.get("tid")), []).append(
                (float(ts), float(dur), name))
    for (pid, tid), spans in lanes.items():
        # Sort by start; ties broken longest-first so an enclosing span is
        # seen before the spans it contains.
        spans.sort(key=lambda s: (s[0], -s[1]))
        stack: List[Tuple[float, str]] = []  # (end, name) of open spans
        for ts, dur, name in spans:
            end = ts + dur
            while stack and stack[-1][0] <= ts + _EPS_US:
                stack.pop()
            if stack and end > stack[-1][0] + _EPS_US:
                problems.append(
                    f"lane (pid={pid}, tid={tid}): span {name!r} "
                    f"[{ts:.3f}, {end:.3f}] overlaps {stack[-1][1]!r} "
                    f"(ends {stack[-1][0]:.3f}) without nesting")
                continue
            stack.append((end, name))
    return problems
