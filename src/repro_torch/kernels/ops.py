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
call, and serving makes one call per layer per decode step.
"""
from __future__ import annotations

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
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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


def flash_forward(q, k, v, causal: bool, q_offset: int, kv_len: Optional[int], chunk: int):
    """The forward with no gradient: the operator while a graph is being
    captured (fake tensors, or a proxy mode on the stack), else the kernel
    (CUDA) or the plain version (CPU) called directly."""
    if _capturing(q):
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
    if _capturing(q):
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
    plain version (CPU) called directly."""
    if _capturing(x):
        return ssd_scan_op(x, dt, B, C, A, int(chunk))
    return _ssd(x, dt, B, C, A, chunk)
