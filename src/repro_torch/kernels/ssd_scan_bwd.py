"""Bind the Hopper SSD-scan backward kernel (``csrc/ssd_scan.cu``, entry point
``ssd_scan_bwd``), and the autograd function that pairs it with the forward
kernel.

The JAX package differentiates its oracle ``models/ssm.py::ssd_scan_ref``
with XLA's autodiff (its Pallas kernel has no gradient); the port's
gradient is this kernel, whose formulas ``kernels/ref.py::ssd_scan_bwd_ref``
spells out step by step.  ``ssd_scan_train`` is the training path's SSD:
its forward is ``ssd_scan.ssd_scan``, its backward this kernel.

One call is six launches on PyTorch's current stream (the source's header
says what each does), all products in 3xTF32 on the tensor cores:
``ssd_bwd_chunk_local`` (l and the chunk states, rebuilt rather than kept
from the forward, and each chunk's own gradient of the state entering it),
``ssd_bwd_scans`` (the states entering each chunk, and in reverse the
gradients of those leaving it), ``ssd_bwd_inter`` and ``ssd_bwd_intra``
(per head group: what crosses chunks, then the causal half within the
chunk, G = C B^T once per group and dG summed over the group's heads),
``ssd_bwd_dbc`` (dB and dC, one GEMM each over every head and group) and
``ssd_bwd_da``.  ``plan`` gives their grids, which the launch takes as they
are (it refuses grids that do not cover the work), the head group and the
scratch the wrapper allocates.  The library is the forward's
(``ssd_scan.build``).  ``launches`` counts wrapper calls that launched the
kernels (one per call, not six), so a run can show that its gradient went
through them.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import ssd_scan as ssd

launches = 0  # calls that launched the kernels since the last reset (callers set it to 0)

THREADS = 256  # threads per block of every launch
DBC_COLUMNS = 64  # columns of ds per ssd_bwd_dbc block, at most
_lib = None


class Plan(NamedTuple):
    chunk: int          # Q
    chunks: int         # nc = S / Q
    head_group: int     # heads per ssd_bwd_inter and ssd_bwd_intra block
    grids: tuple        # six (x, y, z) grids, in launch order
    scratch: dict       # name -> shape of the float32 scratch


def plan(Bb: int, S: int, H: int, hd: int, ds: int, chunk: int = ssd.MAX_CHUNK,
         per_row_a: bool = False, *, sms: int) -> Plan:
    """The six launches' grids, the head group and the float32 scratch of a
    call on a card with ``sms`` streaming multiprocessors (pure Python):
    blocks per (chunk, head, row) for the chunk states and, in a second
    half, the local state gradients; four state values per thread of each
    (head, row), twice over, for the forward and the reverse scan; one block
    per (chunk, head group, row) for the cross-chunk and the within-chunk
    per-head passes; one per (chunk, row, dC or dB, DBC_COLUMNS columns of
    ds) for the head sums; one per head (per (head, row) where A is per row)
    for dA.  The head group is the forward's choice
    (``ssd_scan.head_group``: both per-group passes hold one block per SM);
    the groups cover the H heads once, the last one short where the group
    does not divide H, and the dG scratch holds one Q x Q sum per group."""
    Q = min(int(chunk), S)
    if not 1 <= Q <= ssd.MAX_CHUNK or S % Q:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {Q} (1 <= chunk <= "
                         f"{ssd.MAX_CHUNK}); callers pad")
    nc = S // Q
    hg = ssd.head_group(nc, H, Bb, sms)
    groups = -(-H // hg)
    per_group = (nc, groups, Bb)
    grids = (
        (2 * nc, H, Bb),
        (2 * -(-hd * ds // (4 * THREADS)), H, Bb),
        per_group,
        per_group,
        (nc, Bb, 2 * (ds // min(ds, DBC_COLUMNS))),
        (H, Bb if per_row_a else 1, 1),
    )
    scratch = {"lsum": (Bb, nc, H, Q), "state": (Bb, nc, H, hd, ds),
               "dstate": (Bb, nc, H, hd, ds), "dG": (Bb, nc, groups, Q, Q),
               "u": (Bb, nc, H, Q), "q": (Bb, nc, H, Q), "kappa": (Bb, nc, H),
               "dA_part": (Bb, nc, H)}
    return Plan(chunk=Q, chunks=nc, head_group=hg, grids=grids, scratch=scratch)


def build():
    """The kernel library (the forward's source; ``kernels/build.py``)."""
    return ssd.build()


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.ssd_scan_bwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = ([ptr] * 19 + [i32] * 7 + [ctypes.c_longlong, i32, ctypes.POINTER(i32),
                                                 ptr])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def ssd_scan_bwd(x, dt, B, C, A, dy, *, chunk: int = ssd.MAX_CHUNK):
    """Launch the backward: (dx, ddt, dB, dC, dA) of ``ssd_scan`` at the
    output gradient ``dy``.  Takes what the forward takes (x (Bb,S,H,hd), dt
    (Bb,S,H), B/C (Bb,S,ds), A (H,) or (Bb,H)) and dy in x's shape, all
    float32 on one CUDA device; strided inputs are copied to contiguous
    ones.  Returns new contiguous float32 tensors in the inputs' shapes (dA
    in A's)."""
    global launches
    if x.ndim != 4 or dt.ndim != 3 or B.ndim != 3 or C.shape != B.shape or A.ndim not in (1, 2):
        raise ValueError(f"want x (Bb,S,H,hd), dt (Bb,S,H), B/C (Bb,S,ds), A (H,) or (Bb,H); got "
                         f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}, {tuple(A.shape)}")
    Bb, S, H, hd = x.shape
    ds = B.shape[-1]
    if (dt.shape != (Bb, S, H) or B.shape[:2] != (Bb, S) or A.shape not in ((H,), (Bb, H))
            or dy.shape != x.shape):
        raise ValueError(f"dt {tuple(dt.shape)}, B/C {tuple(B.shape)}, A {tuple(A.shape)} or "
                         f"dy {tuple(dy.shape)} do not match x {tuple(x.shape)}")
    if hd not in ssd._HEAD_DIMS or ds not in ssd._STATE_DIMS:
        raise ValueError(f"(hd, ds) = ({hd}, {ds}) not in {ssd._HEAD_DIMS} x {ssd._STATE_DIMS}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C), ("A", A), ("dy", dy)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name} on {t.device}; the kernel takes tensors on one CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 only")
    x, dt, B, C, A, dy = (t.contiguous() for t in (x, dt, B, C, A, dy))
    per_row = A.ndim == 2
    dev = x.device
    pl = plan(Bb, S, H, hd, ds, chunk, per_row, sms=ssd.multiprocessors(dev))
    outs = [torch.empty(t.shape, dtype=torch.float32, device=dev) for t in (x, dt, B, C, A)]
    scratch = {n: torch.empty(shape, dtype=torch.float32, device=dev)
               for n, shape in pl.scratch.items()}
    grid = (ctypes.c_int * 18)(*(n for g in pl.grids for n in g))
    lib = _load()
    with torch.cuda.device(dev):  # the runtime launches on its current device
        err = lib.ssd_scan_bwd(
            *(t.data_ptr() for t in (x, dt, B, C, A, dy)), *(t.data_ptr() for t in outs),
            *(scratch[n].data_ptr() for n in ("lsum", "state", "dstate", "dG", "u", "q", "kappa",
                                              "dA_part")),
            Bb, S, H, hd, ds, pl.chunk, pl.head_group,
            A.stride(0) if per_row and Bb > 1 else 0, int(per_row), grid,
            torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd launch failed: cudaError {err}")
    return tuple(outs)


class _SSDScan(torch.autograd.Function):
    """The forward kernel and the backward kernel."""

    @staticmethod
    def forward(ctx, x, dt, B, C, A, chunk):
        ctx.save_for_backward(x, dt, B, C, A)
        ctx.chunk = chunk
        return ssd.ssd_scan(x, dt, B, C, A, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        return (*ssd_scan_bwd(*ctx.saved_tensors, dy, chunk=ctx.chunk), None)


def ssd_scan_train(x, dt, B, C, A, *, chunk: int = ssd.MAX_CHUNK):
    """The differentiable SSD on the card: the forward kernel, whose backward
    is this kernel."""
    return _SSDScan.apply(x, dt, B, C, A, chunk)
