"""Build and bind the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The CUDA source replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention`` and, on the model path, the
XLA loop ``models/attention.py::chunked_attention``; the source's header says
what bounds it on an H100 and what its design does about that.

The library is built at the first CUDA call (``kernels/build.py``) and
loaded with ``ctypes``.  The kernel launches on PyTorch's current stream.  ``launches`` counts the launches, so a
run can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
import pathlib
from typing import Optional

import torch

from .build import build_library, strides_arg

launches = 0  # kernel launches since the last reset (callers set it to 0)

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_lib = None


def build() -> pathlib.Path:
    """Compile the kernel library if this source has not been built yet, and
    return its path (``kernels/build.py``)."""
    return build_library(_SRC)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.flash_attention_fwd
        ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
                       i64p, i64p, i64p, i64p, i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    q_offset: int = 0, kv_len: Optional[int] = None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel.  q (B,S,KR,Gl,D), k/v (B,T,KR,D), any strides with a
    unit-stride head dim.  Writes ``out`` (same shape as q, q's dtype; a new
    contiguous tensor when None) and returns it."""
    global launches
    if q.ndim != 5 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,KR,Gl,D), k/v (B,T,KR,D); got {q.shape}, {k.shape}, {v.shape}")
    B, S, KR, Gl, D = q.shape
    T = k.shape[1]
    if k.shape[0] != B or k.shape[2] != KR or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if min(B, S, KR, Gl, T) < 1:
        raise ValueError(f"empty attention {tuple(q.shape)}, {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} on {t.device}; the kernel takes tensors on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype} not supported")
    if q.dtype == torch.bfloat16 and k.dtype == torch.float32:
        raise TypeError("bf16 q with f32 kv is not supported")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    elif out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} {out.device} does not match q")
    kv_len = T if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if q_offset < 0 or kv_len < 1:
        raise ValueError(f"q_offset {q_offset} must be >= 0 and kv_len {kv_len} >= 1")
    # the scale as the reference applies it: a Python scalar weak-typed to q's dtype
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype))
    lib = _load()
    with torch.cuda.device(q.device):  # the runtime launches on its current device
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], _DTYPES[k.dtype], B, S, KR, Gl, T, D,
            strides_arg(q, "q"), strides_arg(k, "k"), strides_arg(v, "v"),
            strides_arg(out, "out"),
            int(causal), q_offset, kv_len, scale,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    return out
