"""Build and bind the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

The CUDA source replaces the JAX package's Pallas TPU kernel
``kernels/ssd_scan.py::ssd_scan`` and, on the model path, the oracle
``models/ssm.py::ssd_scan_ref`` that the reference's Mamba2 calls; the
source's header says what bounds it on an H100 and what its design does
about that.  Forward only: there is no backward kernel, so inputs that
require grad while grad is enabled raise rather than being detached.

The library is built at the first CUDA call (``kernels/build.py``) and
loaded with ``ctypes``.  The kernel launches on PyTorch's current stream.
``launches`` counts the launches, so a run can show that its SSD went
through the kernel.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .build import build_library, strides_arg

launches = 0  # kernel launches since the last reset (callers set it to 0)

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_HEAD_DIMS = (32, 64)
_STATE_DIMS = (16, 128)
MAX_CHUNK = 128
_lib = None


def build() -> pathlib.Path:
    """Compile the kernel library if this source has not been built yet, and
    return its path (``kernels/build.py``)."""
    return build_library(_SRC)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ssd_scan_fwd
        ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [ptr] * 6 + [i32] * 6 + [i64p] * 5 + [ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             A: torch.Tensor, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """Launch the kernel.  x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds), A (H,),
    all float32 on one CUDA device, any strides with a unit-stride last dim.
    The chunk is Q = min(chunk, S), and S must be a multiple of Q.  Returns y
    (Bb,S,H,hd), a new contiguous float32 tensor."""
    global launches
    if x.ndim != 4 or dt.ndim != 3 or B.ndim != 3 or C.shape != B.shape or A.ndim != 1:
        raise ValueError(f"want x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds), A (H,); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}, {tuple(A.shape)}")
    Bb, S, H, hd = x.shape
    ds = B.shape[-1]
    if dt.shape != (Bb, S, H) or B.shape[:2] != (Bb, S) or A.shape != (H,):
        raise ValueError(f"dt {tuple(dt.shape)}, B/C {tuple(B.shape)} or A {tuple(A.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if hd not in _HEAD_DIMS or ds not in _STATE_DIMS:
        raise ValueError(f"(hd, ds) = ({hd}, {ds}) not in {_HEAD_DIMS} x {_STATE_DIMS}")
    Q = min(int(chunk), S)
    if not 1 <= Q <= MAX_CHUNK or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q} (1 <= chunk <= "
                         f"{MAX_CHUNK}); callers pad")
    tensors = (("x", x), ("dt", dt), ("B", B), ("C", C), ("A", A))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} on {t.device}; the kernel takes tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in tensors):
        raise RuntimeError("ssd_scan has no backward kernel yet: call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if A.stride(0) != 1:
        raise ValueError(f"A must have unit stride, got {A.stride()}")
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):  # the runtime launches on its current device
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            y.data_ptr(), Bb, S, H, hd, ds, Q,
            strides_arg(x, "x"), strides_arg(dt, "dt"), strides_arg(B, "B"),
            strides_arg(C, "C"), strides_arg(y, "y"),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    return y
