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

A bf16 call is three launches on PyTorch's current stream (``plan`` gives
their grids, tiles and scratch): ``flash_bwd_prep`` (Delta, the scaled q and
a copy of dO in a row-contiguous layout, a zeroed dq accumulator),
``flash_bwd_main`` (wgmma fed by TMA: dk and dv per 128-key block, dq added
into the float32 accumulator by bulk atomic adds) and ``flash_bwd_dq_out``
(dq rounded into q's layout).  A float32 call is two CUDA-core launches,
``flash_bwd_dq_f32`` and ``flash_bwd_dkdv_f32``.  ``launches`` counts calls
(one per call, whatever the launches), so a run can show that its gradient
went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional

import torch

from . import flash_attention as fa
from .build import build_library

launches = 0  # calls that launched the kernels since the last reset (callers set it to 0)

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None

BLOCK_Q = 64        # q rows per tile of flash_bwd_main (one TMA box)
BLOCK_K = 128       # keys per flash_bwd_main block: two consumer warpgroups of 64
PREP_THREADS = 256  # flash_bwd_prep: D / 8 threads per row
OUT_THREADS = 256   # flash_bwd_dq_out: one thread per eight columns of a row


class Plan(NamedTuple):
    variant: str       # "wgmma" (bf16: three launches) or "f32" (two CUDA-core launches)
    rows_padded: int   # R = S * Gl rounded up to BLOCK_Q: the scratch's rows (wgmma)
    grids: tuple       # blocks of flash_bwd_prep, flash_bwd_main, flash_bwd_dq_out (wgmma)
    scratch: dict      # name -> (shape, dtype) of what the wrapper allocates


@functools.lru_cache(maxsize=1024)
def plan(B: int, S: int, KR: int, Gl: int, T: int, D: int, dtype: torch.dtype) -> Plan:
    """Launches, grids and scratch of a call (pure Python; the bf16 launch
    recomputes the grids and refuses others)."""
    R = S * Gl
    if dtype == torch.float32:
        return Plan("f32", R, (), {"delta": ((B, KR, R), torch.float32)})
    Rp = -(-R // BLOCK_Q) * BLOCK_Q
    grids = (B * KR * Rp * (D // 8) // PREP_THREADS, -(-T // BLOCK_K) * KR * B,
             -(-B * KR * R * (D // 8) // OUT_THREADS))
    rows = (B * KR, Rp)
    scratch = {"qf": ((*rows, D), torch.bfloat16), "dob": ((*rows, D), torch.bfloat16),
               "lse_p": (rows, torch.float32), "delta": (rows, torch.float32),
               "dq_acc": ((*rows, D), torch.float32)}
    return Plan("wgmma", Rp, grids, scratch)


def build() -> pathlib.Path:
    """Compile the kernel library if this source has not been built yet, and
    return its path (``kernels/build.py``)."""
    return build_library(_SRC)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attention_bwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 14 + [i32] * 8 + [ctypes.c_float, i32] + [i64] * 3 + [ptr]
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
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("the backward moves 16-byte chunks and TMA boxes: q, k, v, out and "
                         "dout must start at multiples of 16 bytes")
    pl = plan(B, S, KR, Gl, T, D, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    scratch = {name: torch.empty(shape, dtype=dt, device=dev)
               for name, (shape, dt) in pl.scratch.items()}
    grids = pl.grids if pl.variant == "wgmma" else (0, 0, 0)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *(scratch[n].data_ptr() if n in scratch else None
              for n in ("delta", "qf", "dob", "lse_p", "dq_acc")),
            _DTYPES[q.dtype], B, S, KR, Gl, T, D, int(causal), fa._scale(D, q.dtype),
            pl.rows_padded, *grids, torch._C._cuda_getCurrentRawStream(dev.index))
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
