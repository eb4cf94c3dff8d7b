"""Stage-stacked pipelining: rewrite a layer stack into GSPMD §3.3 form.

A port of the JAX package's ``pipeline/stages.py``.  Given a homogeneous
layer body and per-layer params stacked on a leading ``L`` dim,
:func:`pipelined_apply` rewrites the stack into the paper's
pipeline-as-sharding form:

* **stack**: params reshape to a leading ``stage`` dim
  (:func:`stage_stack_params`: ``(L, …) → (S, L/S, …)``; stage ``s`` holds
  layers ``[s·L/S, (s+1)·L/S)`` contiguously, the GPipe placement);
* **vmap**: ONE stage body (the stage's layers in turn) is vectorized over
  the stage dim (``torch.func.vmap``), so all stages are one SPMD
  computation; attention and the SSD reach their operators' vmap rules
  (``kernels/ops.py``), which fold the stage dim into the batch: one kernel
  launch per layer for every stage;
* **shift**: data moves between stages through the shifting buffer, a scan
  (``core/scan.py::scan``) over ``T = M + S − 1`` ticks whose body calls
  :func:`repro_torch.core.shift.stage_shift` (inject microbatch ``t`` at
  stage 0, slide every stage's state one slot right) and collects stage
  ``S−1``'s output through a masked row sum
  (:func:`repro_torch.core.shift.take_stage_row`).

Sharding the buffer's stage dim on a mesh axis (the ``mesh`` /
``stage_axis`` annotation) is the whole distribution story:
``core/plan.py`` lowers the shift to a boundary-row ppermute and the row
sum to a psum, both first-class steps of the tick scan's body plan, which
``core/plan_opt.py`` prices at trip count and can fuse.  Only microbatch
``t − s`` occupies stage ``s`` at tick ``t``; the other slots hold zeros
or garbage whose outputs are never collected, so the pipelined program
equals running each microbatch through the plain stack.

:func:`pipelined_loss_fn` applies the rewrite to a registry config through
the stackable-layer boundary its family declares
(``models.api.pipeline_boundary``): embedding prologue → pipelined stack →
loss epilogue, with the batch split into ``M`` microbatches.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..core.annotate import annotate
from ..core.scan import scan
from ..core.sharding import Mesh, Sharding
from ..core.shift import stage_shift, take_stage_row
from ..kernels.ops import as_operators
from .schedule import PipelineDecision


def stage_stack_params(params, num_stages: int):
    """Reshape per-layer stacked params ``(L, …)`` to stage-stacked
    ``(S, L/S, …)``: stage ``s`` holds layers ``[s·L/S, (s+1)·L/S)``."""

    def mk(p):
        L = p.shape[0]
        if L % num_stages:
            raise ValueError(f"{L} layers do not divide into {num_stages} stages")
        return p.reshape((num_stages, L // num_stages) + tuple(p.shape[1:]))

    return tree_map(mk, params)


def stage_batch(st, stage_axis: str):
    """``st`` with ``stage_axis`` added to its activations' batch rule, for
    the code outside the pipelined region, where the stage axis may carry
    the batch (data parallelism on the pipeline's own axis) instead of
    every "stage" row of the mesh holding the whole batch's embedding,
    logits and loss.  The stage body keeps the plain strategy: its stage
    dim holds the axis (``pipelined_loss_fn``)."""
    act = dict(st.act_rules)
    act["batch"] = tuple(act.get("batch", ())) + (stage_axis,)
    return dataclasses.replace(st, name=f"{st.name}+batch_on_{stage_axis}", act_rules=act)


def _stage_constrain(v, mesh: Optional[Mesh], stage_axis: Optional[str]):
    if mesh is None or stage_axis is None:
        return v
    return annotate(v, Sharding(mesh, ((stage_axis,),) + ((),) * (v.ndim - 1)))


def pipelined_apply(
    layer_fn: Callable,
    stacked_params,
    microbatches,
    *,
    num_stages: int,
    mesh: Optional[Mesh] = None,
    stage_axis: Optional[str] = None,
    extra=None,
):
    """Run ``layer_fn(lp, x, extra) -> x`` as an S-stage GPipe pipeline.

    ``stacked_params``: pytree with leading dims ``(S, L/S, …)`` (see
    :func:`stage_stack_params`); ``microbatches``: ``(M, mb…)`` inputs;
    ``extra`` a tensor every layer reads (the positions), or None.  Returns
    the ``(M, mb…)`` final-layer outputs.  With ``mesh``/``stage_axis`` the
    shifting buffer's stage dim is annotated so that the partitioner shards
    it; without them the same program runs locally (the reference
    semantics).  The tick loop is a scan whose consts are the stage-stacked
    params and ``extra``."""
    S = int(num_stages)
    row_shape = tuple(microbatches.shape[1:])
    if mesh is not None:
        # every microbatch enters at stage 0: the microbatch dim whole (where
        # the stage axis carried the batch outside the region, it is gathered
        # here, by a reshard), the rest left to completion
        nd = microbatches.ndim
        microbatches = annotate(microbatches, Sharding(mesh, ((),) * nd), range(1, nd))
    leaves, spec = tree_flatten(stacked_params)
    layers_per_stage = leaves[0].shape[1]
    n = len(leaves)

    def tick(state, x_t, *consts):
        params = tree_unflatten(list(consts[:n]), spec)
        ext = consts[n] if len(consts) > n else None
        vlayer = torch.func.vmap(lambda lp, h: layer_fn(lp, h, ext), in_dims=(0, 0))
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in (state, *consts))
        state = _stage_constrain(stage_shift(state, x_t), mesh, stage_axis)
        with as_operators(grad):
            for i in range(layers_per_stage):
                # layer i of every stage, sliced outside the vmap (a select on
                # dim 1 keeps the stage sharding; an index inside the vmapped
                # body would gather the whole stack every tick)
                state = vlayer(tree_map(lambda t: t.select(1, i), params), state)
        state = _stage_constrain(state, mesh, stage_axis)
        return state, take_stage_row(state, S - 1)

    state0 = _stage_constrain(
        torch.zeros((S,) + row_shape, dtype=microbatches.dtype, device=microbatches.device),
        mesh, stage_axis)
    xs = microbatches
    if S > 1:
        pad = torch.zeros((S - 1,) + row_shape, dtype=microbatches.dtype,
                          device=microbatches.device)
        xs = torch.cat([microbatches, pad], dim=0)
    consts = tuple(leaves) + (() if extra is None else (extra,))
    _, ys = scan(tick, state0, xs, consts=consts)  # T = M + S - 1 ticks
    return ys[S - 1:]


# ---------------------------------------------------------------------------------
# registry configs: pipeline the declared stackable-layer region
# ---------------------------------------------------------------------------------


def pipelined_loss_fn(cfg, st, params, batch, decision: PipelineDecision,
                      mesh: Optional[Mesh] = None):
    """The registry config's training loss with the layer stack pipelined.

    ``params`` must carry **stage-stacked** layers (leaves ``(S, L/S, …)``;
    convert live params with :func:`stage_stack_params`).  The batch is
    split into ``decision.num_microbatches`` along dim 0; the prologue
    (embedding) and epilogue (final norm and loss) run unpipelined on the
    full batch, as GSPMD keeps them outside the §3.3 region, under
    :func:`stage_batch`'s strategy: where the mesh has the stage axis it
    carries their batch.  The layers run under ``st``."""
    from ..models import api as model_api

    b = model_api.pipeline_boundary(cfg, st)
    if b is None:
        raise ValueError(f"{cfg.name}: no stackable-layer boundary "
                         f"(family={cfg.family}, stackable_layers={cfg.stackable_layers})")
    outer = model_api.pipeline_boundary(cfg, stage_batch(st, decision.stage_axis))
    tokens = batch["tokens"]
    B, SQ = tokens.shape
    M = decision.num_microbatches
    if B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    mb = B // M
    x = outer.prologue(params, tokens)  # (B, SQ, D)
    xs = x.reshape((M, mb) + tuple(x.shape[1:]))
    positions = torch.arange(SQ, device=tokens.device).expand(mb, SQ)  # per-microbatch
    ys = pipelined_apply(b.layer, params[b.layers_key], xs, num_stages=decision.num_stages,
                         mesh=mesh, stage_axis=decision.stage_axis, extra=positions)
    x = ys.reshape((B,) + tuple(x.shape[1:]))
    return outer.epilogue(params, x, batch)
