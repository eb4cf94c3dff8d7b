"""Dispatch for the kernels: CUDA tensors go to the hand-written kernel,
CPU tensors to the plain PyTorch version, anything else raises.  There is no
fallback from one to the other.  On the card, attention that needs a
gradient (grad enabled and an input that requires it) goes through
``flash_attention_bwd.flash_attention_train``, whose backward is the
backward kernel, and raises where that kernel does not cover the call;
everything else takes the forward kernel alone.  On the CPU, autograd
differentiates the plain version.

``attention`` takes the JAX package's kernel layout (B,H,S,D) with the GQA map
q-head h -> kv-head h // group; ``attention_model_layout`` takes the model's
padded layout q (B,S,KR,Gl,D), k/v (B,T,KR,D), as ``chunked_attention`` does.

A decode step whose position is a tensor (``flash_decode``) is, under
capture, the operator ``repro_torch::flash_decode``, whose position stays
data (the kernel reads it on the device), so one graph serves every step.
Its sibling ``repro_torch::flash_decode_partial`` (``flash_decode_partial``)
takes one position per batch row and also returns each row's
log-sum-exp: what a sequence-sharded cache's shards run before the
partitioner combines them.
The SSD scan is, under capture, ``repro_torch::ssd_scan`` (``ssd``), whose
registered gradient is the operator ``repro_torch::ssd_scan_bwd``: a CUDA
tensor goes to the backward kernel, a CPU tensor to ``ssd_scan_bwd_ref``.
Run eagerly, an SSD that needs a gradient goes on the card through
``ssd_scan_bwd.ssd_scan_train`` (the forward kernel, then the backward
kernel); on the CPU autograd differentiates the plain version.
Attention that needs no gradient is, under graph capture
(``core/compat.py::capture``), the custom operator
``repro_torch::flash_attention`` (``flash_attention_op``), which the capture
keeps as one node and the partitioner shards on batch and kv heads
(``core/rules.py``, ``core/partitioner.py::flash_local``).  Attention that
needs one is, under capture, ``repro_torch::flash_attention_fwd`` (the
output and each q row's float32 log-sum-exp), whose registered gradient is
the operator ``repro_torch::flash_attention_bwd``; both shard the same way
(``core/partitioner.py::decide_flash_fwd``, ``decide_flash_bwd``).  A CUDA tensor reaching either goes to the kernels
(the forward with its log-sum-exp; the backward kernel's launches), a CPU
tensor to the plain versions (``chunked_attention_ref`` and
``attention_lse_ref``; ``flash_attention_bwd_ref``).  Run eagerly, the same
calls go to the kernels or the plain versions directly (``flash_forward``,
``flash_attention_train``): an operator's dispatch costs host time on every
call, and serving makes one call per layer per decode step.  Under
``torch.func.vmap`` (the §3.3 pipeline's stage body, inside
``as_operators``) the operators fold the vmapped dim into the batch and
make one call for every slice (their vmap rules, at the end).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, is_fake
from torch.fx.experimental.proxy_tensor import get_proxy_mode

from . import flash_attention as fa
from . import flash_attention_bwd as fab
from . import ssd_scan as ssd_kernel
from . import ssd_scan_bwd as ssd_bwd_kernel
from .ref import (attention_lse_ref, chunked_attention_ref, flash_attention_bwd_ref,
                  flash_decode_partial_ref, ssd_scan_bwd_ref, ssd_scan_ref)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"kernel input on {t.device}: only cuda (kernel) and cpu (plain) run")


def _needs_grad(*tensors) -> bool:
    """Whether autograd records through the call.  Inside ``as_operators``
    the caller says (a tensor batched by ``torch.func.vmap`` reports no
    ``requires_grad``)."""
    if not torch.is_grad_enabled():
        return False
    grad = _OPERATORS.get()
    if grad is not None:
        return grad
    return any(t.requires_grad for t in tensors)


def _flash_forward(q, k, v, causal, q_offset, kv_len, chunk):
    if _route(q) == "cuda":
        return fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    return chunked_attention_ref(
        q, k, v, causal=causal, chunk=chunk, q_offset=q_offset, kv_len=kv_len
    )


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                       q_offset: int, kv_len: Optional[int], chunk: int) -> torch.Tensor:
    """The forward kernel as an operator: q (B,S,KR,Gl,D), k/v (B,T,KR,D) ->
    (B,S,KR,Gl,D).  A CUDA tensor goes to the kernel, a CPU tensor to the
    plain version (``chunk`` is its kv chunk).  It has no gradient."""
    return _flash_forward(q, k, v, causal, q_offset, kv_len, chunk)


@flash_attention_op.register_fake
def _(q, k, v, causal, q_offset, kv_len, chunk):
    if not is_fake(q):  # an eager call on the meta device: no kernel runs there
        _route(q)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def flash_attention_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                           chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of differentiable attention as an operator: q
    (B,S,KR,Gl,D), k/v (B,T,KR,D) -> (out (B,S,KR,Gl,D), lse float32
    (B,KR,S*Gl)), q_offset 0 and every key valid.  A CUDA tensor goes to the
    forward kernel (writing the log-sum-exp, within the backward kernel's
    limits: ``check_trainable``), a CPU tensor to the plain versions."""
    if _route(q) == "cuda":
        fab.check_trainable(q, k, v)
        B, S, KR, Gl, _ = q.shape
        lse = torch.empty((B, KR, S * Gl), dtype=torch.float32, device=q.device)
        return fa.flash_attention(q, k, v, causal=causal, lse=lse), lse
    return (chunked_attention_ref(q, k, v, causal=causal, chunk=chunk).contiguous(),
            attention_lse_ref(q, k, causal=causal).contiguous())


@flash_attention_fwd_op.register_fake
def _(q, k, v, causal, chunk):
    if q.device.type == "cuda":
        fab.check_trainable(q, k, v)
    B, S, KR, Gl, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, KR, S * Gl), dtype=torch.float32))


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def flash_attention_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, dout: torch.Tensor, causal: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``flash_attention_fwd`` as an operator: (dq, dk, dv)
    from the forward's inputs, output and log-sum-exp and the output's
    gradient.  A CUDA tensor goes to the backward kernel, a CPU tensor to
    its plain version."""
    if _route(q) == "cuda":
        return fab.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    return tuple(t.contiguous() for t in flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                                                 causal=causal))


@flash_attention_bwd_op.register_fake
def _(q, k, v, out, lse, dout, causal):
    if q.device.type == "cuda":
        fab.check_trainable(q, k, v)
    like = lambda t: torch.empty_like(t, memory_format=torch.contiguous_format)
    return like(q), like(k), like(v)


def _fwd_setup(ctx, inputs, output):
    q, k, v, causal, _ = inputs
    ctx.save_for_backward(q, k, v, *output)
    ctx.causal = causal


def _fwd_backward(ctx, dout, _dlse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_attention_bwd_op(q, k, v, out, lse, dout, ctx.causal)
    return dq, dk, dv, None, None


flash_attention_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


def _flash_decode(q, k, v, pos, chunk):
    if _route(q) == "cuda":
        return fa.flash_attention(q, k, v, causal=False, q_offset=0, kv_len=1, pos=pos)
    return chunked_attention_ref(q, k, v, causal=False, chunk=chunk, q_offset=pos,
                                 kv_len=pos + 1)


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def flash_decode_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                    chunk: int) -> torch.Tensor:
    """One decode step's attention as an operator: q (B,S,KR,Gl,D) at
    position ``pos`` (a 0-d int32 tensor: q_offset pos, keys below pos + 1
    valid, no causal mask), k/v (B,T,KR,D) -> (B,S,KR,Gl,D).  The position
    is data, so one captured graph serves every step.  A CUDA tensor goes to
    the kernel's decode, which reads ``pos`` on the device; a CPU tensor to
    the plain version.  It has no gradient."""
    return _flash_decode(q, k, v, pos, chunk)


@flash_decode_op.register_fake
def _(q, k, v, pos, chunk):
    if not is_fake(q):  # an eager call on the meta device: no kernel runs there
        _route(q)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def flash_decode(q, k, v, pos, chunk: int):
    """A decode step's attention at the tensor position ``pos``: the operator
    while a graph is being captured, else the kernel (CUDA) or the plain
    version (CPU) called directly, as ``flash_forward``."""
    if _capturing(q):
        return flash_decode_op(q, k, v, pos, int(chunk))
    return _flash_decode(q, k, v, pos, chunk)


def _flash_decode_partial(q, k, v, pos, chunk):
    if _route(q) == "cuda":
        B, S, KR, Gl, _ = q.shape
        lse = torch.empty((B, KR, S * Gl), dtype=torch.float32, device=q.device)
        out = fa.flash_attention(q, k, v, causal=False, q_offset=0, kv_len=1, pos=pos, lse=lse)
        return out, lse
    out, lse = flash_decode_partial_ref(q, k, v, pos, chunk)
    return out.contiguous(), lse


@torch.library.custom_op("repro_torch::flash_decode_partial", mutates_args=())
def flash_decode_partial_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
                            chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decode step's attention at one position per batch row, with each
    row's log-sum-exp, as an operator: q (B,S,KR,Gl,D), k/v (B,T,KR,D), pos
    int32 (B,) (possibly negative: no key visible) -> (out (B,S,KR,Gl,D),
    lse float32 (B,KR,S*Gl), -1e9 for a row that saw no key).  A
    sequence-sharded decode runs it on every shard at once, each row at the
    position relative to its shard, and combines the shards by their
    log-sum-exps (``core/partitioner.py::decide_flash_decode``).  A CUDA
    tensor goes to the kernel's decode, a CPU tensor to
    ``flash_decode_partial_ref``.  It has no gradient."""
    return _flash_decode_partial(q, k, v, pos, chunk)


@flash_decode_partial_op.register_fake
def _(q, k, v, pos, chunk):
    if not is_fake(q):  # an eager call on the meta device: no kernel runs there
        _route(q)
    B, S, KR, Gl, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, KR, S * Gl), dtype=torch.float32))


def flash_decode_partial(q, k, v, pos, chunk: int):
    """``flash_decode_partial_op`` while a graph is being captured, else the
    kernel (CUDA) or the plain version (CPU) called directly."""
    if _capturing(q):
        return flash_decode_partial_op(q, k, v, pos, int(chunk))
    return _flash_decode_partial(q, k, v, pos, chunk)


def _capturing(q) -> bool:
    """Whether a graph is being captured: fake tensors, or a proxy mode on
    the stack."""
    return isinstance(q, FakeTensor) or get_proxy_mode() is not None


# inside ``as_operators``: whether autograd records through the calls
_OPERATORS: contextvars.ContextVar = contextvars.ContextVar("repro_torch_operators",
                                                            default=None)


@contextlib.contextmanager
def as_operators(grad: bool):
    """Inside the block, attention and the SSD go through their operators
    eagerly too, as under capture, and ``grad`` says whether autograd
    records through them.  A ``torch.func.vmap`` of a layer needs this: the
    operators' vmap rules fold the vmapped dim into the batch and make one
    call, where the kernels' wrappers cannot take a batched tensor, and a
    batched tensor does not report ``requires_grad`` (the §3.3 pipeline
    vmaps one stage body over the stage dim)."""
    token = _OPERATORS.set(bool(grad))
    try:
        yield
    finally:
        _OPERATORS.reset(token)


def _operator_route(q) -> bool:
    """Whether a call goes through its operator: under capture, or inside
    ``as_operators``."""
    return _OPERATORS.get() is not None or _capturing(q)


def flash_forward(q, k, v, causal: bool, q_offset: int, kv_len: Optional[int], chunk: int):
    """The forward with no gradient: the operator while a graph is being
    captured (fake tensors, or a proxy mode on the stack) or inside
    ``as_operators``, else the kernel (CUDA) or the plain version (CPU)
    called directly."""
    if _operator_route(q):
        return flash_attention_op(q, k, v, bool(causal), int(q_offset),
                                  None if kv_len is None else int(kv_len), int(chunk))
    return _flash_forward(q, k, v, causal, q_offset, kv_len, chunk)


def attention_model_layout(
    q, k, v, *, causal: bool = True, chunk: int = 1024, q_offset: int = 0,
    kv_len: Optional[int] = None,
):
    """q (B,S,KR,Gl,D), k/v (B,T,KR,D) -> (B,S,KR,Gl,D).  ``chunk`` is the
    plain version's kv chunk (its online-softmax steps follow the JAX
    package's); the kernel tiles kv itself."""
    if not _needs_grad(q, k, v):
        return flash_forward(q, k, v, causal, q_offset, kv_len, chunk)
    if _operator_route(q):
        if q.device.type == "cuda":
            fab.check_trainable(q, k, v, q_offset=q_offset, kv_len=kv_len)
        elif q_offset != 0 or kv_len not in (None, k.shape[1]):
            raise NotImplementedError(
                f"differentiable attention under capture takes q_offset 0 and every key "
                f"valid, not q_offset {q_offset}, kv_len {kv_len}")
        return flash_attention_fwd_op(q, k, v, bool(causal), int(chunk))[0]
    if _route(q) == "cuda":
        return fab.flash_attention_train(q, k, v, causal=causal, q_offset=q_offset,
                                         kv_len=kv_len)
    return chunked_attention_ref(
        q, k, v, causal=causal, chunk=chunk, q_offset=q_offset, kv_len=kv_len
    )


def attention(q, k, v, *, causal: bool = True, block_k: int = 128):
    """q (B,Hq,S,D), k/v (B,Hkv,T,D) -> (B,Hq,S,D), GQA group = Hq // Hkv.

    The same kernel on strided views, with no copy and no repeat of kv:
    q as (B,S,Hkv,group,D), k/v as (B,T,Hkv,D).  The causal mask is aligned
    top-left (q_offset = 0), as the Pallas kernel's; it matches the
    bottom-right ``attention_ref`` when S == T."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if Hq % Hkv:
        raise ValueError(f"{Hq} q heads are not a multiple of {Hkv} kv heads")

    def model_view(x):  # (B,Hq,S,D) -> (B,S,Hkv,group,D)
        return x.unflatten(1, (Hkv, Hq // Hkv)).permute(0, 3, 1, 2, 4)

    qm, km, vm = model_view(q), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    if _route(q) == "cuda":
        if _needs_grad(q, k, v):
            o = fab.flash_attention_train(qm, km, vm, causal=causal)
            return o.permute(0, 2, 3, 1, 4).reshape(B, Hq, S, D)
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        fa.flash_attention(qm, km, vm, causal=causal, out=model_view(out))
        return out
    o = chunked_attention_ref(qm, km, vm, causal=causal, chunk=block_k)
    return o.permute(0, 2, 3, 1, 4).reshape(B, Hq, S, D)


def _ssd(x, dt, B, C, A, chunk):
    if _route(x) == "cuda":
        if _needs_grad(x, dt, B, C, A):
            return ssd_bwd_kernel.ssd_scan_train(x, dt, B, C, A, chunk=chunk)
        return ssd_kernel.ssd_scan(x, dt, B, C, A, chunk=chunk)
    return ssd_scan_ref(x, dt, B, C, A, chunk)


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=())
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                A: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD scan as an operator: x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds),
    A (H,) -> y (Bb,S,H,hd) float32.  A CUDA tensor goes to the kernel, a CPU
    tensor to the plain version.  Its gradient is ``ssd_scan_bwd_op``."""
    with torch.no_grad():  # the registered gradient differentiates it
        return _ssd(x, dt, B, C, A, chunk)


@ssd_scan_op.register_fake
def _(x, dt, B, C, A, chunk):
    if not is_fake(x):  # an eager call on the meta device: no kernel runs there
        _route(x)
    return torch.empty_like(x, memory_format=torch.contiguous_format)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def ssd_scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                    A: torch.Tensor, dy: torch.Tensor, chunk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """The gradient of ``ssd_scan_op`` as an operator: (dx, ddt, dB, dC, dA)
    from the forward's inputs and the output's gradient, dA in A's shape.  A
    CUDA tensor goes to the backward kernel, a CPU tensor to its plain
    version."""
    if _route(x) == "cuda":
        return ssd_bwd_kernel.ssd_scan_bwd(x, dt, B, C, A, dy, chunk=chunk)
    return tuple(t.contiguous() for t in ssd_scan_bwd_ref(x, dt, B, C, A, dy, chunk))


@ssd_scan_bwd_op.register_fake
def _(x, dt, B, C, A, dy, chunk):
    if not is_fake(x):
        _route(x)
    return tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                 for t in (x, dt, B, C, A))


def _ssd_setup(ctx, inputs, output):
    *tensors, chunk = inputs
    ctx.save_for_backward(*tensors)
    ctx.chunk = chunk


def _ssd_backward(ctx, dy):
    return (*ssd_scan_bwd_op(*ctx.saved_tensors, dy, ctx.chunk), None)


ssd_scan_op.register_autograd(_ssd_backward, setup_context=_ssd_setup)


def ssd(x, dt, B, C, A, *, chunk: int = 128):
    """Mamba2 SSD: x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds), A (H,) negative
    -> y (Bb,S,H,hd), with chunks of min(chunk, S) rows.  Under graph capture
    the operator ``repro_torch::ssd_scan`` (one node, which the partitioner
    shards on batch, heads and head dim: ``core/partitioner.py::decide_ssd``;
    its gradient one ``repro_torch::ssd_scan_bwd`` node, ``decide_ssd_bwd``);
    else the kernels (CUDA: with a gradient, ``ssd_scan_train``) or the
    plain version (CPU) called directly; inside ``as_operators`` the
    operator too."""
    if _operator_route(x):
        return ssd_scan_op(x, dt, B, C, A, int(chunk))
    return _ssd(x, dt, B, C, A, chunk)


# ---------------------------------------------------------------------------------
# vmap rules: one call for every vmapped slice
# ---------------------------------------------------------------------------------
#
# A ``torch.func.vmap`` of a layer (the §3.3 pipeline's stage body, vmapped
# over the stage dim) reaches these operators with a batched dim.  Each rule
# moves that dim first (an operand that is not batched is expanded), folds
# it into the batch dim, makes one call and unfolds the results: one kernel
# launch for every stage, not one per stage.  The fold is a view whose
# vmapped dim is the major dim of the merged batch, so a stage-sharded dim
# stays sharded through it (``rules.rule_reshape``).


def _lead(t, d, n: int):
    """``t`` with its vmapped dim ``d`` first; unbatched, expanded to ``n``."""
    if d is None:
        return t.expand((n,) + tuple(t.shape))
    return t if d == 0 else t.movedim(d, 0)


def _merge(t):
    return t.reshape((-1,) + tuple(t.shape[2:]))


def _folded(info, in_dims, *tensors):
    """The operands with the vmapped dim folded into their batch dim."""
    return [_merge(_lead(t, d, info.batch_size)) for t, d in zip(tensors, in_dims)]


def _unfold(t, n: int):
    return t.reshape((n, -1) + tuple(t.shape[1:]))


def a_per_row(A, n: int, rows: int):
    """The SSD's A for a call whose batch folds ``n`` slices of ``rows``
    rows (a vmapped call, or the partitioner's stacked devices): A (n, H),
    one row of heads per slice, repeated over its rows, or A (n, rows, H)
    merged; returns A (n·rows, H), which the kernel reads per row."""
    if A.ndim == 2:
        return A[:, None, :].expand(n, rows, A.shape[-1]).reshape(n * rows, A.shape[-1])
    return _merge(A)


def _flash_vmap(info, in_dims, q, k, v, causal, q_offset, kv_len, chunk):
    n = info.batch_size
    out = flash_attention_op(*_folded(info, in_dims[:3], q, k, v), causal, q_offset, kv_len,
                             chunk)
    return _unfold(out, n), 0


def _flash_fwd_vmap(info, in_dims, q, k, v, causal, chunk):
    n = info.batch_size
    out, lse = flash_attention_fwd_op(*_folded(info, in_dims[:3], q, k, v), causal, chunk)
    return (_unfold(out, n), _unfold(lse, n)), (0, 0)


def _flash_bwd_vmap(info, in_dims, q, k, v, out, lse, dout, causal):
    n = info.batch_size
    grads = flash_attention_bwd_op(*_folded(info, in_dims[:6], q, k, v, out, lse, dout), causal)
    return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def _ssd_vmap(info, in_dims, x, dt, B, C, A, chunk):
    n = info.batch_size
    xf, dtf, Bf, Cf = _folded(info, in_dims[:4], x, dt, B, C)
    Af = a_per_row(_lead(A, in_dims[4], n), n, xf.shape[0] // n)
    return _unfold(ssd_scan_op(xf, dtf, Bf, Cf, Af, chunk), n), 0


def _ssd_bwd_vmap(info, in_dims, x, dt, B, C, A, dy, chunk):
    n = info.batch_size
    xf, dtf, Bf, Cf, dyf = _folded(info, in_dims[:4] + in_dims[5:6], x, dt, B, C, dy)
    rows = xf.shape[0] // n
    A = _lead(A, in_dims[4], n)
    dx, ddt, dB, dC, dA = ssd_scan_bwd_op(xf, dtf, Bf, Cf, a_per_row(A, n, rows), dyf, chunk)
    dA = dA.reshape(n, rows, -1)
    if A.ndim == 2:  # each slice's A was one row of heads: its gradient sums the rows
        dA = dA.sum(1)
    return tuple(_unfold(g, n) for g in (dx, ddt, dB, dC)) + (dA,), (0,) * 5


for _name, _rule in (("flash_attention", _flash_vmap), ("flash_attention_fwd", _flash_fwd_vmap),
                     ("flash_attention_bwd", _flash_bwd_vmap), ("ssd_scan", _ssd_vmap),
                     ("ssd_scan_bwd", _ssd_bwd_vmap)):
    torch.library.register_vmap(f"repro_torch::{_name}", _rule)
