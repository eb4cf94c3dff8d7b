"""Build and bind the Hopper flash-attention backward kernel
(``csrc/flash_attention_bwd.cu``), and the autograd function that pairs it
with the forward kernel.

The JAX package differentiates ``models/attention.py::chunked_attention``
with XLA's autodiff (its Pallas kernel has no gradient); the port's
gradient is this kernel.  ``flash_attention_train`` is the training path's
attention: its forward is ``flash_attention.flash_attention`` (a prefill
variant, now also writing each q row's log-sum-exp), its backward this
kernel.  It covers what training runs, and raises on anything else rather
than falling back to the plain version:

- ``q_offset == 0`` and every key valid (``kv_len`` None or T);
- one dtype (float32 or bfloat16) for q, k and v; D in {32, 64, 128};
- R = S * Gl > 16 q rows (a prefill variant, which writes the log-sum-exp).

One call is two launches on PyTorch's current stream: ``flash_bwd_dq``
(Delta and dq) and ``flash_bwd_dkdv``.  ``launches`` counts calls (one per
call, not two), so a run can show that its gradient went through them.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from . import flash_attention as fa
from .build import build_library

launches = 0  # calls that launched the kernels since the last reset (callers set it to 0)

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def build() -> pathlib.Path:
    """Compile the kernel library if this source has not been built yet, and
    return its path (``kernels/build.py``)."""
    return build_library(_SRC)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attention_bwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i32] * 8 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_trainable(q, k, v, *, q_offset: int = 0, kv_len: Optional[int] = None):
    """Raise unless the kernels' gradient covers this call."""
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    why = []
    if q_offset != 0:
        why.append(f"q_offset {q_offset} != 0")
    if kv_len is not None and kv_len != T:
        why.append(f"kv_len {kv_len} != T {T}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        why.append(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} (want one of float32, bfloat16)")
    if D not in fa._HEAD_DIMS:
        why.append(f"head dim {D} not in {fa._HEAD_DIMS}")
    if S * Gl <= fa.DECODE_ROWS:
        why.append(f"{S * Gl} q rows per kv head: the decode variant has no backward")
    if why:
        raise RuntimeError("flash_attention's backward kernel does not cover this call ("
                           + "; ".join(why) + "): call it under torch.no_grad() or "
                           "torch.inference_mode()")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool):
    """Launch the backward.  q, out, dout (B,S,KR,Gl,D), k/v (B,T,KR,D) on
    one CUDA device, one dtype; lse float32 (B,KR,S*Gl) from the forward.
    Returns (dq, dk, dv), contiguous, in the inputs' dtype."""
    global launches
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    check_trainable(q, k, v)
    if k.shape != (B, T, KR, D) or v.shape != k.shape or out.shape != q.shape \
            or dout.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"out {tuple(out.shape)}, dout {tuple(dout.shape)} do not match")
    if out.dtype != q.dtype or dout.dtype != q.dtype:
        raise TypeError(f"out {out.dtype} and dout {dout.dtype} must be q's dtype {q.dtype}")
    if lse.shape != (B, KR, S * Gl) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want float32 {(B, KR, S * Gl)}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in (k, v, out, lse, dout)):
        raise ValueError("the backward takes tensors on one CUDA device")
    q, k, v, out, lse, dout = (t.contiguous() for t in (q, k, v, out, lse, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], B, S, KR, Gl, T, D, int(causal), fa._scale(D, q.dtype),
            torch._C._cuda_getCurrentRawStream(dev.index))
    fn = _load().flash_attention_bwd
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):
            err = fn(*args)
    launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (with the log-sum-exp) and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        B, S, KR, Gl, _ = q.shape
        lse = torch.empty((B, KR, S * Gl), dtype=torch.float32, device=q.device)
        out = fa.flash_attention(q, k, v, causal=causal, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, out, lse, dout, causal=ctx.causal), None)


def flash_attention_train(q, k, v, *, causal: bool, q_offset: int = 0,
                          kv_len: Optional[int] = None):
    """Differentiable attention on the card: q (B,S,KR,Gl,D), k/v
    (B,T,KR,D).  Raises where the backward kernel does not cover the call."""
    check_trainable(q, k, v, q_offset=q_offset, kv_len=kv_len)
    return _FlashAttention.apply(q, k, v, causal)
