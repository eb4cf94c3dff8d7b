"""Modeled-against-measured calibration: a ratio table per step class
(port of the JAX package's ``obs/calibrate.py``).

The roofline prices every plan step (``plan_opt._step_durations``, with the
plan's profile) and the overlap scheduler turns the prices into a modeled
timeline; traced execution (:mod:`repro_torch.obs.trace`) records what the
same steps measured.  :func:`calibration_report` joins the two by *step
class* (``plan_opt.step_class``: compute / reshard / collective / ppermute
/ fused / guard / call:scan) and reports the measured/modeled seconds ratio
per class.

Reading the ratios: eager spans are host dispatch plus (with ``sync``)
device time, an upper bound on the device's own time, loosest for tiny
steps; tight spans are the least of several runs timed with CUDA events
(see the tracing contract in :mod:`repro_torch.obs.trace`).  A ratio far
above the flag factor means the model is optimistic for that class (or its
steps are dispatch-bound); far below ``1/factor``, pessimistic.

Measured totals are divided by the number of traced calls (``args["call"]``
on measured spans), so running the plan N times does not inflate ratios N×.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from .trace import MEASURED_PID, MODELED_PID

DEFAULT_FLAG_FACTOR = 3.0


@dataclass
class ClassRow:
    """One step class's modeled-vs-measured join."""

    cls: str
    modeled_s: float = 0.0
    measured_s: float = 0.0
    modeled_spans: int = 0
    measured_spans: int = 0
    ratio: Optional[float] = None  # measured / modeled; None if either absent
    flagged: bool = False
    # filled only when a fitted MachineProfile is joined in: the class's
    # measured/modeled ratio under the *fitted* params, and whether the fit
    # itself left the class out of band (obs.profile.MachineProfile.flagged)
    fit_residual: Optional[float] = None
    fit_flagged: bool = False

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "class": self.cls,
            "modeled_s": self.modeled_s,
            "measured_s": self.measured_s,
            "modeled_spans": self.modeled_spans,
            "measured_spans": self.measured_spans,
            "ratio": self.ratio,
            "flagged": self.flagged,
        }
        if self.fit_residual is not None or self.fit_flagged:
            out["fit_residual"] = self.fit_residual
            out["fit_flagged"] = self.fit_flagged
        return out


@dataclass
class CalibrationReport:
    """Per-step-class measured/modeled ratio table.

    ``complete`` is true when every class the model prices (modeled seconds
    > 0) also has a measured ratio — the acceptance bar: a ratio for every
    step class present.  Classes modeled at zero seconds (identity reshards,
    pure aliases) stay listed but cannot have a finite ratio and do not
    count against completeness.  ``flagged`` lists classes whose ratio falls
    outside ``[1/factor, factor]``.
    """

    rows: List[ClassRow] = field(default_factory=list)
    factor: float = DEFAULT_FLAG_FACTOR
    calls: int = 0
    # set when a fitted MachineProfile was joined in (see attach_profile)
    profile_digest: Optional[str] = None
    profile_flagged: List[str] = field(default_factory=list)

    @property
    def complete(self) -> bool:
        return bool(self.rows) and all(
            r.ratio is not None for r in self.rows if r.modeled_s > 0.0)

    @property
    def flagged(self) -> List[str]:
        return [r.cls for r in self.rows if r.flagged]

    def row(self, cls: str) -> Optional[ClassRow]:
        for r in self.rows:
            if r.cls == cls:
                return r
        return None

    def as_dict(self) -> Dict[str, Any]:
        out = {
            "rows": [r.as_dict() for r in self.rows],
            "factor": self.factor,
            "calls": self.calls,
            "complete": self.complete,
            "flagged": self.flagged,
        }
        if self.profile_digest is not None:
            out["profile_digest"] = self.profile_digest
            out["profile_flagged"] = list(self.profile_flagged)
        return out

    def table(self) -> str:
        """Markdown table for reports and the CLI."""
        lines = [
            "| class | modeled s | measured s | ratio | flag |",
            "|---|---|---|---|---|",
        ]
        for r in self.rows:
            ratio = f"{r.ratio:.3g}" if r.ratio is not None else "—"
            flag = "⚠" if r.flagged else ""
            lines.append(
                f"| {r.cls} | {r.modeled_s:.3g} | {r.measured_s:.3g} "
                f"| {ratio} | {flag} |")
        return "\n".join(lines)


def calibration_report(
    events: Sequence[Dict[str, Any]],
    factor: float = DEFAULT_FLAG_FACTOR,
) -> CalibrationReport:
    """Build a :class:`CalibrationReport` from exported Chrome trace events.

    Accepts either the raw event list or the whole ``{"traceEvents": [...]}``
    export.  Only ``ph == "X"`` spans on the modeled/measured pids
    participate; each span's class comes from ``args["class"]`` (falling
    back to the event name).
    """
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    rows: Dict[str, ClassRow] = {}
    calls: set = set()
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        pid = ev.get("pid")
        if pid not in (MODELED_PID, MEASURED_PID):
            continue
        args = ev.get("args") or {}
        cls = args.get("class") or ev.get("name") or "?"
        row = rows.setdefault(cls, ClassRow(cls=cls))
        dur_s = float(ev.get("dur", 0.0)) * 1e-6
        if pid == MODELED_PID:
            row.modeled_s += dur_s
            row.modeled_spans += 1
        else:
            row.measured_s += dur_s
            row.measured_spans += 1
            if "call" in args:
                calls.add(args["call"])
    ncalls = max(len(calls), 1)
    report = CalibrationReport(factor=factor, calls=ncalls)
    for cls in sorted(rows):
        row = rows[cls]
        row.measured_s /= ncalls
        if row.modeled_s > 0.0 and row.measured_spans:
            row.ratio = row.measured_s / row.modeled_s
            row.flagged = not (1.0 / factor <= row.ratio <= factor)
        report.rows.append(row)
    return report


def attach_profile(report: CalibrationReport, profile) -> CalibrationReport:
    """Join a fitted :class:`~repro_torch.obs.profile.MachineProfile` into a
    calibration report in place: each class row gains the fit's residual
    ratio (measured/modeled under the *fitted* constants) and its
    out-of-band flag, and the report records the profile digest.  This is
    how "the fitter's residuals surface in the CalibrationReport" — the
    eager ratio column says how loose the default model was, the
    ``fit_residual`` column says how much of that the fitted profile
    explains."""
    report.profile_digest = profile.digest()
    report.profile_flagged = list(profile.flagged)
    for row in report.rows:
        if row.cls in profile.residuals:
            row.fit_residual = profile.residuals[row.cls]
            row.fit_flagged = row.cls in profile.flagged
    return report
