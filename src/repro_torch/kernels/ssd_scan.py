"""Build and bind the Hopper SSD-scan kernel (``csrc/ssd_scan.cu``).

The CUDA source replaces the JAX package's Pallas TPU kernel
``kernels/ssd_scan.py::ssd_scan`` and, on the model path, the oracle
``models/ssm.py::ssd_scan_ref`` that the reference's Mamba2 calls; the
source's header says what bounds it on an H100 and what its design does
about that.  This wrapper is the forward alone: called directly with inputs
that require grad while grad is enabled, it raises rather than detaching
them.  The gradient is ``ssd_scan_bwd.py``'s kernel (entry point
``ssd_scan_bwd`` of the same source), which ``ssd_scan_bwd.ssd_scan_train``
pairs with this forward.

One call is three kernel launches on PyTorch's current stream, in the plain
version's order: ``ssd_chunk_state`` (the chunk-local states),
``ssd_state_pass`` (the states entering each chunk) and ``ssd_chunk_out``
(the outputs, G = C B^T once per head group).  ``plan`` gives their grids,
which the launch takes as they are (it checks that they cover the work),
the head group and the scratch the wrapper allocates for them.  The library
is built at the first CUDA call (``kernels/build.py``) and loaded with
``ctypes``.  ``launches`` counts wrapper calls that launched the kernels
(one per call, not three), so a run can show that its SSD went through
them.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import torch

from .build import build_library, strides_arg

launches = 0  # calls that launched the kernels since the last reset (callers set it to 0)

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"
_HEAD_DIMS = (32, 64)
_STATE_DIMS = (16, 128)
MAX_CHUNK = 128
HEAD_GROUP = 8       # heads per ssd_chunk_out block, at most
STATE_THREADS = 256  # ssd_state_pass threads per block, four state values each
_lib = None
_sms = {}            # streaming multiprocessors by CUDA device index


class Plan(NamedTuple):
    chunk: int              # Q
    chunks: int             # nc = S / Q
    head_group: int         # heads per ssd_chunk_out block
    state_grid: tuple       # ssd_chunk_state: (chunk, head, batch row)
    scan_grid: tuple        # ssd_state_pass: (slice of hd * ds, head, batch row)
    out_grid: tuple         # ssd_chunk_out: (chunk, head group, batch row)
    lsum_shape: tuple       # (Bb, nc, H, Q): l within each chunk
    state_shape: tuple      # (Bb, nc, H, hd, ds): chunk states
    scratch_bytes: int


def plan(Bb: int, S: int, H: int, hd: int, ds: int, chunk: int = MAX_CHUNK, *,
         sms: int) -> Plan:
    """The three launches' grids, the head group and the float32 scratch of a
    call on a card with ``sms`` streaming multiprocessors (pure Python; the
    wrapper launches these grids, and the launch refuses grids that do not
    cover the work).  Every head group computes G = C B^T once per (batch
    row, chunk) for all of its heads; the groups cover the H heads once, the
    last one short where the group does not divide H.  The group is
    ``head_group``'s for ssd_chunk_out, whose block holds about 200 KB of
    shared memory, one block per SM."""
    Q = min(int(chunk), S)
    if not 1 <= Q <= MAX_CHUNK or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q} (1 <= chunk <= "
                         f"{MAX_CHUNK}); callers pad")
    nc = S // Q
    hg = head_group(nc, H, Bb, sms)
    lsum_shape, state_shape = (Bb, nc, H, Q), (Bb, nc, H, hd, ds)
    return Plan(
        chunk=Q, chunks=nc, head_group=hg,
        state_grid=(nc, H, Bb),
        scan_grid=(-(-hd * ds // (4 * STATE_THREADS)), H, Bb),
        out_grid=(nc, -(-H // hg), Bb),
        lsum_shape=lsum_shape, state_shape=state_shape,
        scratch_bytes=4 * (Bb * nc * H * Q + Bb * nc * H * hd * ds),
    )


def head_group(nc: int, H: int, Bb: int, sms: int) -> int:
    """The heads per block of a launch with one block per (chunk, head group,
    batch row) and one block per SM, each block computing G = C B^T once
    for its group: the group of at most HEAD_GROUP heads with the least
    modelled time, its waves times a block's work, where G and the C and B
    loads count as one more head; ties go to the larger group."""
    best = None
    for g in range(1, min(HEAD_GROUP, H) + 1):
        cost = -(-nc * -(-H // g) * Bb // sms) * (g + 1)
        if best is None or cost <= best[0]:
            best = (cost, g)
    return best[1]


def multiprocessors(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, read once per device."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sms[index]


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
        fn.argtypes = ([ptr] * 8 + [i32] * 7 + [ctypes.POINTER(i32), i32] + [i64p] * 5
                       + [ctypes.c_longlong, ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             A: torch.Tensor, *, chunk: int = MAX_CHUNK) -> torch.Tensor:
    """Launch the kernel.  x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds), A (H,)
    shared by every row or (Bb,H) one per row (a partitioned call folds each
    device's heads, and so its A, into the batch), all float32 on one CUDA
    device, any strides with a unit-stride last dim.
    The chunk is Q = min(chunk, S), and S must be a multiple of Q.  Returns y
    (Bb,S,H,hd), a new contiguous float32 tensor."""
    global launches
    if x.ndim != 4 or dt.ndim != 3 or B.ndim != 3 or C.shape != B.shape or A.ndim not in (1, 2):
        raise ValueError(f"want x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds), A (H,) or (Bb,H); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}, {tuple(A.shape)}")
    Bb, S, H, hd = x.shape
    ds = B.shape[-1]
    if dt.shape != (Bb, S, H) or B.shape[:2] != (Bb, S) or A.shape not in ((H,), (Bb, H)):
        raise ValueError(f"dt {tuple(dt.shape)}, B/C {tuple(B.shape)} or A {tuple(A.shape)} "
                         f"do not match x {tuple(x.shape)}")
    if hd not in _HEAD_DIMS or ds not in _STATE_DIMS:
        raise ValueError(f"(hd, ds) = ({hd}, {ds}) not in {_HEAD_DIMS} x {_STATE_DIMS}")
    tensors = (("x", x), ("dt", dt), ("B", B), ("C", C), ("A", A))
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} on {t.device}; the kernel takes tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in tensors):
        raise RuntimeError("ssd_scan is the forward alone and would detach its inputs: "
                           "take the backward kernel through ssd_scan_bwd.ssd_scan_train, or "
                           "call it under torch.no_grad() or torch.inference_mode()")
    if A.stride(-1) != 1:
        raise ValueError(f"A must have a unit-stride last dim, got {A.stride()}")
    a_stride = A.stride(0) if A.ndim == 2 and Bb > 1 else 0
    pl = plan(Bb, S, H, hd, ds, chunk, sms=multiprocessors(x.device))
    grid = (ctypes.c_int * 9)(*pl.state_grid, *pl.scan_grid, *pl.out_grid)
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    lsum = torch.empty(pl.lsum_shape, dtype=torch.float32, device=x.device)
    state = torch.empty(pl.state_shape, dtype=torch.float32, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):  # the runtime launches on its current device
        err = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), B.data_ptr(), C.data_ptr(), A.data_ptr(),
            y.data_ptr(), lsum.data_ptr(), state.data_ptr(), Bb, S, H, hd, ds, pl.chunk,
            pl.head_group, grid, STATE_THREADS, strides_arg(x, "x"), strides_arg(dt, "dt"),
            strides_arg(B, "B"), strides_arg(C, "C"), strides_arg(y, "y"), a_stride,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_scan_fwd launch failed: cudaError {err}")
    return y
