"""Pipeline parallelism reduced to tensor sharding (paper §3.3).

A port of the JAX package's ``core/pipeline.py``.  The layer computation is
vectorized over a leading stage dimension L (``torch.func.vmap``); data
flows between stages through a *shifting buffer*: each step the state rolls
one stage to the right and stage 0 picks up a fresh microbatch.
Distribution is then a sharding annotation on the L dimension.

Both schedules from the paper:

* **GPipe** (R=1): stage s holds layers [s*R_layers, ...) contiguously;
  M + L - 1 steps; bubble ratio (L-1)/(M+L-1).
* **Circular** (R>1): stage s holds layers {s, s+L, s+2L, ...} round-robin;
  work item (group g, round r, microbatch m) enters stage 0 at step
  (g*R + r)*L + m and the buffer wraps around from the last stage back to
  stage 0.  M*R + L - 1 steps when L | M; bubble ratio (L-1)/(M*R+L-1),
  the paper's Table 5 bubbles (L=8, M=16, R=4 -> 9.9 % by schedule slots).

The step loop is ``core/scan.py::scan`` with the stage params and the
microbatches as its consts (a body reads outside tensors only through
them).  Where the reference branches with ``lax.cond``, the port selects
with ``torch.where``; ``dynamic_index_in_dim`` is ``index_select`` on a
tensor index.  The wrapper is differentiable (scan, vmap and roll), and
``remat`` checkpoints the vmapped stage function (the paper's recompute
configuration, Table 4).  ``pipeline/stages.py`` is the partition-plan
pipeline (the shift as ``core/shift.py::stage_shift``); this wrapper stays
as the §3.3 schedule-math reference.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import as_operators
from .annotate import annotate
from .compat import get_abstract_mesh
from .scan import scan
from .sharding import Mesh, mesh_split


def _shift_right_ring(state, wrap: bool):
    """state[s] <- state[s-1]; ``wrap=True`` rolls the last stage's output
    back to stage 0 (the circular schedule), else stage 0 gets zeros."""
    rolled = torch.roll(state, 1, dims=0)
    if wrap:
        return rolled
    return torch.cat([torch.zeros_like(rolled[:1]), rolled[1:]], dim=0)


def _pick(t, i):
    """Row ``i`` (a 0-d int64 tensor) of ``t``'s leading dim."""
    return t.index_select(0, i.reshape(1)).squeeze(0)


def pipeline(
    stage_fn: Callable,
    stage_params,
    microbatches,
    *,
    num_stages: int,
    num_rounds: int = 1,
    mesh: Optional[Mesh] = None,
    stage_axis: Optional[str] = None,
    remat: bool = False,
):
    """Run ``stage_fn(params_slice, x) -> y`` as an L-stage pipeline.

    ``stage_params``: pytree with leading dims (L, R, ...), per (stage,
    round) parameter slices (GPipe: R=1).  ``microbatches``: (M, ...).
    ``mesh``/``stage_axis`` (or an ambient mesh with ``stage_axis``)
    annotate the shifting buffer's stage dim, so that completion shards it.
    ``remat`` checkpoints the stage function.  Returns the (M, ...) outputs
    of the final layer per microbatch."""
    L, R = num_stages, num_rounds
    M = microbatches.shape[0]
    if not (M % L == 0 or R == 1):
        raise ValueError(f"the circular schedule expects L | M (L={L}, M={M})")
    total_steps = M * R + L - 1 if R > 1 else M + L - 1
    dev = microbatches.device
    leaves, spec = tree_flatten(stage_params)

    vfn = torch.func.vmap(stage_fn, in_dims=(0, 0))

    def run_stages(params_t, sel):
        leaves_t = tree_flatten(params_t)[0]
        with as_operators(torch.is_grad_enabled()
                          and any(t.requires_grad for t in (sel, *leaves_t))):
            return vfn(params_t, sel)

    def maybe_annotate(x):
        m = mesh
        if m is None and stage_axis is not None:
            am = get_abstract_mesh()
            m = am if am is not None and stage_axis in am.axis_names else None
        if m is None or stage_axis is None:
            return x
        return annotate(x, mesh_split(x.ndim, m, [stage_axis] + [-1] * (x.ndim - 1)))

    def step(carry, t, params, mbs):
        state, outs = carry
        state = maybe_annotate(state)
        shifted = _shift_right_ring(state, wrap=R > 1)

        # stage-0 injection: the work item entering stage 0 at step t is
        # m = t mod L (grouped) for R > 1, round r = (t//L) % R, group
        # g = (t//L)//R; fresh data only when r == 0
        if R > 1:
            m_in = (t // L) // R * L + t % L
            fresh = (t // L) % R == 0
        else:
            m_in, fresh = t, torch.ones((), dtype=torch.bool, device=dev)
        inp = _pick(mbs, m_in.clamp(0, M - 1))
        use_fresh = fresh & (m_in < M)
        # stage 0 takes fresh data when starting round 0, otherwise the value
        # rolled around from the last stage (circular) or zeros (GPipe)
        sel = torch.cat([torch.where(use_fresh, inp, shifted[0])[None], shifted[1:]], dim=0)

        # stage s at step t runs round r_s = ((t - s) // L) % R
        k = t - torch.arange(L, device=dev)
        r_s = torch.where(k >= 0, torch.div(k, L, rounding_mode="floor") % R, 0)
        params_t = tree_map(lambda p: torch.func.vmap(_pick)(p, r_s), params)

        if remat and torch.is_grad_enabled():
            new_state = checkpoint(run_stages, params_t, sel, use_reentrant=False,
                                   preserve_rng_state=False)
        else:
            new_state = run_stages(params_t, sel)
        new_state = maybe_annotate(new_state)

        # collect final-layer outputs: stage L-1 finishes item (g, R-1, m) at
        # t = (g*R + R-1)*L + m + L - 1
        k_last = t - (L - 1)
        if R > 1:
            m_out = (k_last // L) // R * L + k_last % L
            done = (k_last >= 0) & ((k_last // L) % R == R - 1)
        else:
            m_out, done = k_last, k_last >= 0
        done = done & (m_out < M)
        written = outs.index_copy(0, m_out.clamp(0, M - 1).reshape(1), new_state[-1][None])
        outs = torch.where(done, written, outs)
        return (new_state, outs), None

    state0 = torch.zeros((L,) + tuple(microbatches.shape[1:]), dtype=microbatches.dtype,
                         device=dev)
    steps = torch.arange(total_steps, device=dev)

    def body(carry, t, *consts):
        return step(carry, t, tree_unflatten(list(consts[:-1]), spec), consts[-1])

    (_, outs), _ = scan(body, (state0, torch.zeros_like(microbatches)), steps,
                        consts=(*leaves, microbatches))
    return outs


def gpipe_bubble_ratio(num_stages: int, num_micro: int) -> float:
    return (num_stages - 1) / (num_micro + num_stages - 1)


def circular_bubble_ratio(num_stages: int, num_micro: int, num_rounds: int) -> float:
    return (num_stages - 1) / (num_micro * num_rounds + num_stages - 1)
