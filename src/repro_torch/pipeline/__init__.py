"""repro_torch.pipeline: GSPMD §3.3 pipeline parallelism over partition plans.

A port of the JAX package's ``repro.pipeline``.  The paper's reduction:
pipeline parallelism *is* tensor sharding.  Stack the per-stage weights on
a leading ``stage`` dim, vmap one stage body over it, shard that dim on a
mesh axis, and express the cross-stage handoff as a shifting buffer whose
per-tick slide is a collective permute: no MPMD runtime, no per-stage
programs.

* ``stages.py``: the rewrite: :func:`stage_stack_params` (``(L, …) → (S,
  L/S, …)``), :func:`pipelined_apply` (the ``M + S − 1``-tick
  shifting-buffer scan on ``core.shift.stage_shift``) and
  :func:`pipelined_loss_fn` (a registry config's loss with its declared
  stackable-layer region pipelined); :func:`stage_batch` lets the stage
  axis carry the batch outside the pipelined region.  It lowers through
  the ordinary ``core/plan.py`` → ``core/plan_opt.py`` path: the per-tick
  ppermute and the output-collection psum are first-class plan steps.
* ``schedule.py``: the schedule cost model: the bubble fraction
  ``(S−1)/(M+S−1)``, tick counts, ppermute wire bytes, microbatch
  activation memory (:class:`ScheduleCost`), the
  :class:`PipelineDecision` decision variables and the
  :class:`PipelineConfig` bounds of the autoshard search over them
  (``autoshard.solve(..., pipeline=)``).

The older ``core/pipeline.py`` wrapper stays as the §3.3 schedule-math
reference (GPipe against circular bubble ratios).
"""
from .schedule import (
    PipelineConfig,
    PipelineDecision,
    ScheduleCost,
    bubble_fraction,
    pipeline_ticks,
    plan_ppermute_bytes,
    schedule_cost,
)
from .stages import pipelined_apply, pipelined_loss_fn, stage_batch, stage_stack_params

__all__ = [
    "PipelineConfig", "PipelineDecision", "ScheduleCost", "bubble_fraction",
    "pipeline_ticks", "pipelined_apply", "pipelined_loss_fn",
    "plan_ppermute_bytes", "schedule_cost", "stage_batch", "stage_stack_params",
]
