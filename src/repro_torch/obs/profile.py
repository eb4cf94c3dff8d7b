"""Machine-profile fitting: roofline constants fitted to tight spans (port of
the JAX package's ``obs/profile.py``).

Traced execution under ``TraceConfig(timing="tight")`` (one untimed run,
then the least of several runs timed with CUDA events) gives per-step
seconds of measurement quality.  Joined against the cost model's own
per-step features (``plan_opt.step_features``: flops, wire bytes, launches,
the quantities the overlap scheduler prices), they over-determine the
machine's effective roofline constants, and :func:`fit_profile` recovers
them by robust least squares::

    measured_s  ≈  flops / peak_flops
                 + wire_bytes / ici_bw
                 + launches * collective_launch_s

The fit solves for the inverse constants (``1/peak_flops``, ``1/ici_bw``,
``collective_launch_s``) so the system is linear; only the features present
in the samples are fitted.  The reference fills the rest from its TPU
defaults; the port has none, so the caller passes the ``base``
:class:`~repro_torch.analysis.roofline.RooflineParams` the unfitted fields
come from (``hbm_bw`` and ``overlap_efficiency`` are never observable from
per-step spans).  One robust pass drops samples whose absolute residual
exceeds :data:`OUTLIER_FACTOR` × the median and solves again.

The fitted :class:`MachineProfile` carries per-class residual ratios and
out-of-band flags and the device it was fitted on (``nvidia-smi``'s name
and power limit, or "cpu"), persists to JSON (``python -m repro_torch.obs
profile``), and prices every plan through :func:`resolve_profile`: the
argument, then ``$REPRO_TORCH_MACHINE_PROFILE``, then the profile committed
with the package (``analysis/roofline.py::DEFAULT_PARAMS``, fitted on an
H100).

Memory: :func:`device_memory_stats` reads the CUDA caching allocator
(``torch.cuda.memory_stats``; None on the CPU) and :func:`memory_report`
sets its peak beside the plan's modeled ``plan_peak_bytes``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..analysis import roofline
from ..analysis.roofline import RooflineParams
from . import metrics as obs_metrics
from .calibrate import DEFAULT_FLAG_FACTOR
from .trace import MEASURED_PID

PROFILE_ENV = "REPRO_TORCH_MACHINE_PROFILE"

OUTLIER_FACTOR = 3.0  # robust pass drops |residual| > factor × median

# feature name → RooflineParams field it determines
_FEATURE_FIELDS = (
    ("flops", "peak_flops"),
    ("wire_bytes", "ici_bw"),
    ("launches", "collective_launch_s"),
)


@dataclasses.dataclass(frozen=True)
class StepSample:
    """One measured step execution joined with its cost-model features."""

    cls: str  # plan_opt.step_class taxonomy
    flops: float
    wire_bytes: float
    launches: float
    measured_s: float

    def modeled_s(self, params: RooflineParams) -> float:
        return (self.flops / params.peak_flops + self.wire_bytes / params.ici_bw
                + self.launches * params.collective_launch_s)


def collect_samples(plan, events: Sequence[Dict[str, Any]]) -> List[StepSample]:
    """Join measured spans against ``plan``'s per-step cost features.

    ``events`` is a raw event list or a ``{"traceEvents": [...]}`` export;
    only ``ph == "X"`` spans on the measured pid participate, matched to
    plan steps by ``args["index"]``.  Every span becomes one sample (N
    traced calls of the same step give N samples)."""
    from ..core.plan_opt import step_class, step_features

    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    samples: List[StepSample] = []
    for ev in events:
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        if ev.get("pid") != MEASURED_PID:
            continue
        args = ev.get("args") or {}
        idx = args.get("index")
        if idx is None or not (0 <= idx < len(plan.steps)):
            continue
        step = plan.steps[idx]
        flops, wire, launches = step_features(step, plan.mesh)
        samples.append(StepSample(
            cls=args.get("class") or step_class(step),
            flops=float(flops), wire_bytes=float(wire), launches=float(launches),
            measured_s=float(ev.get("dur", 0.0)) * 1e-6,
        ))
    return samples


@dataclasses.dataclass
class MachineProfile:
    """Fitted roofline constants plus the fit's own quality report.

    ``residuals`` maps step class → measured/modeled ratio under the fitted
    params (1.0 = perfect); ``flagged`` lists the classes outside
    ``[1/factor, factor]``; ``fitted`` names the fields the samples
    determined (the rest are the base's).  ``device`` is the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them, or "cpu"; ``measurements`` holds
    what the fitting command measured beside the fit (e.g. the HBM copy
    that gives ``hbm_bw``).
    """

    params: RooflineParams
    residuals: Dict[str, float] = dataclasses.field(default_factory=dict)
    fitted: List[str] = dataclasses.field(default_factory=list)
    flagged: List[str] = dataclasses.field(default_factory=list)
    n_samples: int = 0
    dropped: int = 0  # outliers removed by the robust pass
    max_rel_residual: float = 0.0
    source: str = ""
    device: str = ""
    measurements: Dict[str, Any] = dataclasses.field(default_factory=dict)
    version: int = 1

    def digest(self) -> str:
        return self.params.digest()

    def as_dict(self) -> Dict[str, Any]:
        return {
            "version": self.version,
            "params": self.params.as_dict(),
            "residuals": dict(self.residuals),
            "fitted": list(self.fitted),
            "flagged": list(self.flagged),
            "n_samples": self.n_samples,
            "dropped": self.dropped,
            "max_rel_residual": self.max_rel_residual,
            "source": self.source,
            "device": self.device,
            "measurements": dict(self.measurements),
            "digest": self.digest(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MachineProfile":
        return cls(
            params=RooflineParams.from_dict(d["params"]),
            residuals={k: float(v) for k, v in (d.get("residuals") or {}).items()},
            fitted=list(d.get("fitted", [])),
            flagged=list(d.get("flagged", [])),
            n_samples=int(d.get("n_samples", 0)),
            dropped=int(d.get("dropped", 0)),
            max_rel_residual=float(d.get("max_rel_residual", 0.0)),
            source=str(d.get("source", "")),
            device=str(d.get("device", "")),
            measurements=dict(d.get("measurements") or {}),
            version=int(d.get("version", 1)),
        )

    def dump(self, path: str) -> str:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "MachineProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _lstsq(rows: List[Tuple[float, ...]], y: List[float]) -> List[float]:
    import numpy as np

    a = np.asarray(rows, dtype=np.float64)
    b = np.asarray(y, dtype=np.float64)
    # column scaling: flops ~1e9 and launch counts ~1 in one system would
    # otherwise make lstsq's implicit rank cutoff drop the small columns
    scale = np.maximum(np.abs(a).max(axis=0), 1e-30)
    x, *_ = np.linalg.lstsq(a / scale, b, rcond=None)
    return list(x / scale)


def fit_profile(samples: Sequence[StepSample], base: RooflineParams,
                factor: float = DEFAULT_FLAG_FACTOR, source: str = "",
                device: str = "") -> MachineProfile:
    """Robust least-squares recovery of effective roofline constants.

    Only features with any nonzero presence in ``samples`` are fitted; a
    coefficient that comes out non-positive (a degenerate sample set) keeps
    ``base``'s value, and so does every field no feature determines.  After
    the first solve, samples whose absolute residual exceeds
    :data:`OUTLIER_FACTOR` × the median absolute residual are dropped and the
    system solved once more.  Per-class residual ratios land in the metrics
    registry as ``profile.residual.<cls>`` gauges (with
    ``profile.max_rel_residual``, ``profile.fit_samples`` and
    ``profile.classes_flagged``).
    """
    samples = [s for s in samples if s.measured_s > 0.0]
    feats = [(s.flops, s.wire_bytes, s.launches) for s in samples]
    active = [i for i in range(3) if any(f[i] > 0.0 for f in feats)]
    prof = MachineProfile(params=base, n_samples=len(samples), source=source, device=device)
    if not samples or not active:
        return prof

    def solve(subset: List[StepSample]) -> List[float]:
        rows = [tuple((s.flops, s.wire_bytes, s.launches)[i] for i in active)
                for s in subset]
        return _lstsq(rows, [s.measured_s for s in subset])

    def predict(s: StepSample, x: List[float]) -> float:
        f = (s.flops, s.wire_bytes, s.launches)
        return sum(x[j] * f[i] for j, i in enumerate(active))

    x = solve(list(samples))
    resid = [abs(predict(s, x) - s.measured_s) for s in samples]
    med = sorted(resid)[len(resid) // 2]
    keep = [s for s, r in zip(samples, resid)
            if med <= 0.0 or r <= OUTLIER_FACTOR * med]
    if 0 < len(keep) < len(samples):
        prof.dropped = len(samples) - len(keep)
        x = solve(keep)
    else:
        keep = list(samples)

    # inverse coefficients → params; non-positive = not determined
    fields = dict(base.as_dict())
    for j, i in enumerate(active):
        fname = _FEATURE_FIELDS[i][1]
        c = x[j]
        if c <= 0.0:
            continue
        fields[fname] = (c if fname == "collective_launch_s" else 1.0 / c)
        prof.fitted.append(fname)
    prof.params = RooflineParams.from_dict(fields)

    # per-class residual ratios under the fitted params
    by_cls: Dict[str, List[StepSample]] = {}
    for s in keep:
        by_cls.setdefault(s.cls, []).append(s)
    for cls in sorted(by_cls):
        grp = by_cls[cls]
        modeled = sum(s.modeled_s(prof.params) for s in grp)
        measured = sum(s.measured_s for s in grp)
        if modeled <= 0.0:
            continue
        ratio = measured / modeled
        prof.residuals[cls] = ratio
        prof.max_rel_residual = max(prof.max_rel_residual, abs(ratio - 1.0))
        if not (1.0 / factor <= ratio <= factor):
            prof.flagged.append(cls)
        obs_metrics.set_gauge(f"profile.residual.{cls}", ratio)
    obs_metrics.set_gauge("profile.max_rel_residual", prof.max_rel_residual)
    obs_metrics.set_gauge("profile.fit_samples", float(len(keep)))
    obs_metrics.set_gauge("profile.classes_flagged", float(len(prof.flagged)))
    return prof


# -- rescoring: does the fitted profile tighten the ratios? -------------------


def rescore_report(samples: Sequence[StepSample], params: RooflineParams,
                   base: RooflineParams) -> Dict[str, Any]:
    """Per-class measured/modeled ratios under ``base`` and under the fitted
    ``params``.  A class *improves* when the fitted ratio is strictly closer
    to 1.0 in log space; ``improved_all`` holds when every class with
    nonzero measured and modeled seconds improves."""
    import math

    by_cls: Dict[str, List[StepSample]] = {}
    for s in samples:
        by_cls.setdefault(s.cls, []).append(s)
    classes: Dict[str, Dict[str, Any]] = {}
    improved_all = True
    in_band = 0
    for cls in sorted(by_cls):
        grp = by_cls[cls]
        measured = sum(s.measured_s for s in grp)
        m_def = sum(s.modeled_s(base) for s in grp)
        m_fit = sum(s.modeled_s(params) for s in grp)
        row: Dict[str, Any] = {
            "measured_s": measured,
            "modeled_default_s": m_def,
            "modeled_fitted_s": m_fit,
        }
        if measured > 0.0 and m_def > 0.0 and m_fit > 0.0:
            rd = measured / m_def
            rf = measured / m_fit
            row["ratio_default"] = rd
            row["ratio_fitted"] = rf
            row["improved"] = abs(math.log(rf)) < abs(math.log(rd))
            in_band += 1
            improved_all = improved_all and row["improved"]
        classes[cls] = row
    return {
        "classes": classes,
        "in_band_classes": in_band,
        "improved_all": bool(in_band) and improved_all,
    }


# -- resolution: argument > env var > the committed card profile --------------

_ENV_CACHE: Dict[str, Tuple[float, RooflineParams]] = {}


def resolve_profile(profile=None) -> RooflineParams:
    """Resolve a profile argument to :class:`RooflineParams`.

    Accepts a :class:`RooflineParams`, a :class:`MachineProfile` or a JSON
    path; ``None`` falls back to ``$REPRO_TORCH_MACHINE_PROFILE`` (loaded
    lazily, cached by path and mtime, the file's age exported as the
    ``profile.staleness_s`` gauge) and, with that unset, to the profile
    committed with the package (``analysis/roofline.py::DEFAULT_PARAMS``).
    """
    if isinstance(profile, RooflineParams):
        return profile
    if isinstance(profile, MachineProfile):
        return profile.params
    if isinstance(profile, str):
        return MachineProfile.load(profile).params
    if profile is not None:
        raise TypeError(f"profile: expected RooflineParams / MachineProfile / path, "
                        f"got {type(profile).__name__}")
    path = os.environ.get(PROFILE_ENV)
    if not path:
        return roofline.DEFAULT_PARAMS
    mtime = os.path.getmtime(path)
    hit = _ENV_CACHE.get(path)
    if hit is None or hit[0] != mtime:
        _ENV_CACHE[path] = (mtime, MachineProfile.load(path).params)
    obs_metrics.set_gauge("profile.staleness_s", max(time.time() - mtime, 0.0))
    return _ENV_CACHE[path][1]


def device_name(device: str = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (its first line), or
    "cpu"."""
    if str(device).startswith("cpu"):
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip()
        return out.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(0)}, power limit not read"


# -- memory telemetry ---------------------------------------------------------


def device_memory_stats() -> Optional[Dict[str, float]]:
    """The CUDA caching allocator's bytes on the current device:
    ``bytes_in_use`` / ``peak_bytes_in_use`` (allocated, current and since
    the last ``torch.cuda.reset_peak_memory_stats``) and ``bytes_reserved``
    / ``peak_bytes_reserved``.  None where there is no card (the CPU)."""
    import torch

    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    s = torch.cuda.memory_stats()
    return {"bytes_in_use": float(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": float(s.get("allocated_bytes.all.peak", 0)),
            "bytes_reserved": float(s.get("reserved_bytes.all.current", 0)),
            "peak_bytes_reserved": float(s.get("reserved_bytes.all.peak", 0))}


def memory_report(plan, before: Optional[Dict[str, float]] = None,
                  after: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Set the allocator's measured peak beside ``plan.peak_bytes``.

    ``before``/``after`` are :func:`device_memory_stats` readings around
    the call; ``measured`` is false (the measured fields None) where there
    is no allocator to read.  The plan's peak is per simulated device, and
    one card holds all of them: ``modeled_peak_bytes_all_devices`` is it
    times the mesh's size, the figure to set beside the card's."""
    mesh = getattr(plan, "mesh", None)
    devices = int(mesh.size) if mesh is not None else 1
    out: Dict[str, Any] = {
        "modeled_peak_bytes": float(plan.peak_bytes),
        "devices": devices,
        "modeled_peak_bytes_all_devices": float(plan.peak_bytes) * devices,
        "measured": False,
        "measured_peak_bytes": None,
        "measured_live_bytes": None,
    }
    if after:
        out["measured"] = True
        out["measured_peak_bytes"] = after.get("peak_bytes_in_use")
        out["measured_live_bytes"] = after.get("bytes_in_use")
        if before and before.get("peak_bytes_in_use") is not None \
                and out["measured_peak_bytes"] is not None:
            out["measured_peak_delta_bytes"] = (
                out["measured_peak_bytes"] - before["peak_bytes_in_use"])
    return out
