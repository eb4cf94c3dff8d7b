"""Plan-native observability: step tracing, metrics, modeled-against-measured
calibration and a machine profile (port of the JAX package's ``obs/``).

* :mod:`repro_torch.obs.metrics`: one process-wide registry of thread-safe
  counters, gauges and histograms, joined with the planner's, verifier's
  and plan cache's telemetry into one :func:`snapshot`, dumpable as JSON
  (``REPRO_TORCH_METRICS_DUMP=path``).
* :mod:`repro_torch.obs.trace`: opt-in traced execution of compiled plans
  (``spmd_partition(trace=TraceConfig(...))``): a measured span per plan
  step on the compute and interconnect lanes, the modeled timeline of the
  overlap schedule, and control events (numerics faults, skips, checkpoint
  saves, stragglers, profiles applied), exported as Chrome trace-event JSON.
* :mod:`repro_torch.obs.calibrate`: measured span seconds joined with the
  roofline's modeled seconds into a per-step-class
  :class:`~repro_torch.obs.calibrate.CalibrationReport`.
* :mod:`repro_torch.obs.profile`: tight-timed spans (``TraceConfig(
  timing="tight")``, CUDA events on the card) fitted into a
  :class:`~repro_torch.obs.profile.MachineProfile` of effective
  ``RooflineParams``, which price every plan (``spmd_partition(profile=)``,
  the entry points' ``plan_profile``, ``REPRO_TORCH_MACHINE_PROFILE=path``,
  and by default the profile fitted on an H100 and committed with the
  package); the allocator's memory peak beside the plan's modeled peak.

``python -m repro_torch.obs summarize <metrics.json>``,
``python -m repro_torch.obs trace <out.json>`` and
``python -m repro_torch.obs profile <out.json>`` give CLI access (see
``__main__``).
"""
from .calibrate import CalibrationReport, attach_profile, calibration_report
from .metrics import (
    MetricsRegistry,
    registry,
    snapshot,
)
from .profile import (
    MachineProfile,
    StepSample,
    collect_samples,
    device_memory_stats,
    fit_profile,
    memory_report,
    rescore_report,
    resolve_profile,
)
from .trace import (
    CONTROL_EVENT_KINDS,
    TraceConfig,
    Tracer,
    control_event,
    control_events,
    export_control_trace,
    recovery_narrative,
    reset_control_events,
    validate_trace_events,
)

__all__ = [
    "CONTROL_EVENT_KINDS",
    "CalibrationReport",
    "MachineProfile",
    "MetricsRegistry",
    "StepSample",
    "TraceConfig",
    "Tracer",
    "attach_profile",
    "calibration_report",
    "collect_samples",
    "control_event",
    "control_events",
    "device_memory_stats",
    "export_control_trace",
    "fit_profile",
    "memory_report",
    "recovery_narrative",
    "registry",
    "rescore_report",
    "reset_control_events",
    "resolve_profile",
    "snapshot",
    "validate_trace_events",
]
