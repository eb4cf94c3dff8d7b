"""The stage-shift op: GSPMD §3.3's shifting buffer as one operator.

A port of the JAX package's ``core/shift.py``.  Pipeline parallelism
reduces to tensor sharding by stacking per-stage state on a leading
``stage`` dim and, once per tick, shifting that buffer one stage to the
right while injecting a fresh microbatch at stage 0:

    out[0] = x          (the injected microbatch)
    out[s] = state[s-1] (stage s picks up stage s-1's output)

``stage_shift(state, x)`` is that whole data movement as the custom
operator ``repro_torch::stage_shift``, so that capture keeps it as one node
and the plan compiler (``core/plan.py``) lowers it structurally:

* stage dim replicated -> one local concatenate (no communication);
* stage dim sharded on a mesh axis -> a boundary-row exchange: each device
  sends its last local stage row to its right neighbour (a ``ppermute`` over
  ``((i, i+1), ...)``, a first-class ``collective`` plan step that the
  optimizer prices and fuses) and stitches the received row in front of
  its remaining rows.

The op is linear in ``(state, x)``; its registered gradient is the mirror
shift of the cotangent (``reverse=True``: out[s] = state[s+1], out[S-1] =
x) with a zero row injected, plus a masked row sum for ``x``, so a
pipelined program differentiates through autograd and its backward carries
the opposite-direction ppermute, as GSPMD's backward pipeline flow does.
"""
from __future__ import annotations

import torch


def _check(state: torch.Tensor, x: torch.Tensor) -> None:
    """The reference's ``_abstract``: a malformed call raises here, not deep
    inside the plan compiler."""
    if state.ndim < 1:
        raise ValueError(
            f"stage_shift: state needs a leading stage dim, got rank-0 {tuple(state.shape)}")
    if state.shape[0] < 1:
        raise ValueError(f"stage_shift: empty stage dim in state shape {tuple(state.shape)}")
    if tuple(x.shape) != tuple(state.shape[1:]):
        raise ValueError(
            f"stage_shift: x shape {tuple(x.shape)} != one stage row "
            f"{tuple(state.shape[1:])} of state {tuple(state.shape)}")
    if x.dtype != state.dtype:
        raise ValueError(f"stage_shift: dtype mismatch (state {state.dtype}, x {x.dtype})")


def shift_local(state: torch.Tensor, x: torch.Tensor, reverse: bool, dim: int = 0):
    """The shift on a whole stage dim ``dim``: ``x`` enters at stage 0 (or at
    the last stage, ``reverse``), every other row moves one stage on."""
    row = x.unsqueeze(dim)
    n = state.shape[dim]
    if reverse:
        return torch.cat([state.narrow(dim, 1, n - 1), row], dim=dim)
    return torch.cat([row, state.narrow(dim, 0, n - 1)], dim=dim)


@torch.library.custom_op("repro_torch::stage_shift", mutates_args=())
def stage_shift_op(state: torch.Tensor, x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """``out[0] = x, out[s] = state[s-1]`` (``reverse``: ``out[S-1] = x,
    out[s] = state[s+1]``)."""
    _check(state, x)
    return shift_local(state, x, reverse)


@stage_shift_op.register_fake
def _(state, x, reverse):
    _check(state, x)
    return torch.empty_like(state, memory_format=torch.contiguous_format)


def _setup(ctx, inputs, output):
    ctx.reverse = inputs[2]


def _backward(ctx, ct):
    # the mirror shift of the cotangent, a zero row injected; the injected
    # row's cotangent (out[0] forward, out[S-1] reverse) as a masked row sum
    zero = ct.new_zeros(ct.shape[1:])
    ct_state = stage_shift_op(ct, zero, not ctx.reverse)
    return ct_state, take_stage_row(ct, ct.shape[0] - 1 if ctx.reverse else 0), None


stage_shift_op.register_autograd(_backward, setup_context=_setup)

# the node target that capture records for a shift
STAGE_SHIFT_OP = torch.ops.repro_torch.stage_shift.default


def stage_shift(state: torch.Tensor, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Shift the stage-stacked buffer one slot (``out[0]=x, out[s]=state[s-1]``).

    ``state`` has a leading stage dim S; ``x`` is one stage row (the fresh
    microbatch entering stage 0).  ``reverse=True`` is the mirror image
    (``out[S-1]=x, out[s]=state[s+1]``), which the gradient uses."""
    _check(state, x)
    return stage_shift_op(state, x, bool(reverse))


def take_stage_row(state: torch.Tensor, row: int) -> torch.Tensor:
    """Read one stage row as a masked row sum: ``state[row]`` without an
    index into the (possibly sharded) stage dim, so that it lowers to a
    local reduction and a psum over the stage axis: the per-tick
    output-collection collective of §3.3."""
    n = state.shape[0]
    mask = (torch.arange(n, device=state.device) == row).to(state.dtype)
    return (state * mask.reshape((n,) + (1,) * (state.ndim - 1))).sum(dim=0)
