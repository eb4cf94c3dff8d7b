"""Build and bind the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

The CUDA source replaces the JAX package's Pallas TPU kernel
``kernels/flash_attention.py::flash_attention`` and, on the model path, the
XLA loop ``models/attention.py::chunked_attention``.  It has three variants,
and ``plan`` picks one from shapes and dtypes before the launch (R = S * Gl q
rows per batch row and kv head):

- ``prefill_wgmma`` (bf16 q and kv, R > 16): tensor-core prefill, K/V tiles
  fed by TMA to two wgmma warpgroups;
- ``decode_splitkv`` (R <= 16, every dtype pair): split-kv decode on the CUDA
  cores, its splits combined in the same launch, its position read on the
  device (``pos``: a decode loop's step never waits on the host, and one
  captured graph serves every position), one for the call or one per batch
  row (a sequence-sharded decode's fold), and with ``lse`` each row's
  log-sum-exp beside its output (the partitioner's combine across shards);
- ``prefill_f32`` (float32 q, R > 16): the CUDA-core kernel.

The source's header says what bounds each on an H100 and what its design does
about that.  Given an ``lse`` buffer, the prefill variants also write each q
row's log-sum-exp, which the backward kernel (``flash_attention_bwd.py``)
reads.  The library is built at the first CUDA call
(``kernels/build.py``) and loaded with ``ctypes``.  The kernel launches on
PyTorch's current stream.  ``launches`` counts the launches (one per call),
so a run can show that its attention went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
import pathlib
from typing import NamedTuple, Optional

import torch

from .build import build_library

launches = 0  # kernel launches since the last reset (callers set it to 0)

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
VARIANTS = {"prefill_f32": 0, "prefill_wgmma": 1, "decode_splitkv": 2}
DECODE_ROWS = 16     # R at or below which a call decodes
SMS = 132            # H100 SXM streaming multiprocessors
DECODE_BLOCKS = 2 * SMS  # the decode's grid, at least, where kv_len allows
MIN_SPLIT_KEYS = 64  # keys per split, at least
MAX_SPLITS = 32
_lib = None
_scratch_by_device = {}  # device index -> (partials, tickets) of the split-kv decode
_zero_by_device = {}  # device index -> an int32 zero: the decode's position base by default


class Plan(NamedTuple):
    variant: str
    block_q: int   # q rows per block
    block_k: int   # keys per tile
    splits: int    # kv splits (decode), else 1


@functools.lru_cache(maxsize=4096)
def plan(B: int, S: int, KR: int, Gl: int, T: int, D: int, q_dtype: torch.dtype,
         kv_dtype: torch.dtype, *, causal: bool, q_offset: int = 0,
         kv_len: Optional[int] = None, position_on_device: bool = False) -> Plan:
    """The variant, tiles and split count for a call (pure Python; the same
    choice the launch makes).  The decode's splits are sized by the keys the
    host knows to be visible, or by T where the position lies on the device
    (``position_on_device``)."""
    R = S * Gl
    kv_stop = min(T if kv_len is None else kv_len, T)
    if causal:
        kv_stop = min(kv_stop, q_offset + (R - 1) // Gl + 1)
    if position_on_device:
        kv_stop = T
    if R <= DECODE_ROWS:
        kv_bytes = D * torch.finfo(kv_dtype).bits // 8
        want = -(-DECODE_BLOCKS // (B * KR))
        splits = max(1, min(MAX_SPLITS, want, kv_stop // MIN_SPLIT_KEYS))
        return Plan("decode_splitkv", R, 64 if kv_bytes <= 128 else 32, splits)
    if q_dtype == torch.bfloat16:
        return Plan("prefill_wgmma", 128, 128, 1)
    return Plan("prefill_f32", 64, 64, 1)


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
                       i64p, i64p, i64p, i64p, i32, i32, i32, ptr, i32, ctypes.c_float,
                       i32, i32, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_LONGS = {3: ctypes.c_longlong * 3, 4: ctypes.c_longlong * 4}


@functools.lru_cache(maxsize=1024)
def _stride_array(shape, stride, esz: int, name: str):
    if stride[-1] != 1:
        raise ValueError(f"{name}: the last dim must have unit stride, got {stride}")
    dims = [shape[-1] if n == 1 else s for n, s in zip(shape, stride[:-1])]
    if any(s * esz % 16 for s in dims):
        raise ValueError(f"{name}: strides must be multiples of 16 bytes, got {stride} "
                         f"of {esz}-byte values")
    return _LONGS[len(dims)](*dims)


def _strides(t: torch.Tensor, name: str):
    """Element strides of every dim but the last, as a C ``long long`` array.
    The last dim must have unit stride; the base and every stride must be
    16-byte multiples (the kernel moves 16-byte chunks and TMA boxes).  A dim
    of size 1 is never stepped over: its stride is taken as one row, D.
    Cached by layout: the wrapper runs once per layer and decode step."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: base address {t.data_ptr():#x} is not a multiple of 16 bytes")
    return _stride_array(t.shape, t.stride(), t.element_size(), name)


@functools.lru_cache(maxsize=None)
def _scale(D: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) as the reference applies it: a Python scalar weak-typed to
    q's dtype."""
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=dtype))


def _scratch(device: torch.device, n_partials: int, n_tickets: int):
    """The decode's scratch on ``device``: float32 partials and int32 tickets
    (zeros, which the combine leaves at zero), kept between calls and grown
    as needed.  Launches on one stream run in order, so one set serves them
    all."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    ws, tickets = _scratch_by_device.get(idx, (None, None))
    if ws is None or ws.numel() < n_partials:
        ws = torch.empty(max(n_partials, 1 << 20), dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(max(n_tickets, 1024), dtype=torch.int32, device=device)
    _scratch_by_device[idx] = ws, tickets
    return ws, tickets


def _zero(device: torch.device) -> torch.Tensor:
    """An int32 zero on ``device``, made once: the decode's position base
    when the caller gives the position on the host."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _zero_by_device:
        _zero_by_device[idx] = torch.zeros((), dtype=torch.int32, device=device)
    return _zero_by_device[idx]


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
    q_offset: int = 0, kv_len: Optional[int] = None,
    out: Optional[torch.Tensor] = None, lse: Optional[torch.Tensor] = None,
    pos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the kernel.  q (B,S,KR,Gl,D), k/v (B,T,KR,D), any 16-byte
    aligned strides with a unit-stride head dim.  Writes ``out`` (same shape
    as q, q's dtype; a new contiguous tensor when None) and returns it.
    With ``lse`` (contiguous float32 (B, KR, S * Gl)), the call also writes
    each q row's log-sum-exp m + log(l): for the backward (prefill), or for
    a combine across sequence shards (decode; -1e9 for a row that saw no
    key).  ``pos``, an int32 tensor on q's device, one value or one per
    batch row (contiguous (B,)), is a decode's position on the device: the
    kernel reads the row's value and adds it to ``q_offset`` and ``kv_len``
    (so a decode step at position p passes q_offset 0 and kv_len 1; a row
    whose position is negative sees no key), and its splits are sized by T;
    the host never reads it.

    The split-kv decode keeps one scratch buffer per device: calls that
    decode concurrently on two streams of one device are not supported."""
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
    dev, q_dtype, kv_dtype = q.device, q.dtype, k.dtype
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"q, k, v on {dev}, {k.device}, {v.device}; the kernel takes "
                         "tensors on one CUDA device")
    if q_dtype not in _DTYPES or kv_dtype not in _DTYPES or v.dtype != kv_dtype:
        raise TypeError(f"dtypes q {q_dtype}, k {kv_dtype}, v {v.dtype} not supported")
    if q_dtype == torch.bfloat16 and kv_dtype == torch.float32:
        raise TypeError("bf16 q with f32 kv is not supported")
    if out is None:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    elif out.shape != q.shape or out.dtype != q_dtype or out.device != dev:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} {out.device} does not match q")
    kv_len = T if kv_len is None else int(kv_len)
    q_offset = int(q_offset)
    if q_offset < 0 or kv_len < 1:
        raise ValueError(f"q_offset {q_offset} must be >= 0 and kv_len {kv_len} >= 1")
    if lse is not None and (lse.shape != (B, KR, S * Gl) or lse.dtype != torch.float32
                            or lse.device != dev or not lse.is_contiguous()):
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want contiguous float32 "
                         f"{(B, KR, S * Gl)} on {dev}")
    strides = [_strides(t, name) for name, t in (("q", q), ("k", k), ("v", v), ("out", out))]
    pl = plan(B, S, KR, Gl, T, D, q_dtype, kv_dtype, causal=causal, q_offset=q_offset,
              kv_len=kv_len, position_on_device=pos is not None)
    if pos is not None and (pl.variant != "decode_splitkv" or pos.device != dev
                            or pos.dtype != torch.int32
                            or not (pos.numel() == 1 or (pos.shape == (B,)
                                                         and pos.is_contiguous()))):
        raise ValueError(f"pos ({pos.dtype}, {tuple(pos.shape)} on {pos.device}) is a decode's "
                         f"int32 position on {dev}, one or one per batch row ({B}); the "
                         f"{pl.variant} variant takes host ints")
    if pl.variant == "decode_splitkv" and pos is None:
        pos = _zero(dev)
    ws = tickets = None
    if pl.splits > 1:  # float32 partials (acc, m, l) of every split
        ws, tickets = _scratch(dev, B * KR * pl.splits * pl.block_q * (D + 2), B * KR)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q_dtype], _DTYPES[kv_dtype], B, S, KR, Gl, T, D, *strides,
            int(causal), q_offset, kv_len, None if pos is None else pos.data_ptr(),
            int(pos is not None and pos.numel() > 1), _scale(D, q_dtype),
            VARIANTS[pl.variant], pl.splits,
            None if ws is None else ws.data_ptr(),
            None if tickets is None else tickets.data_ptr(),
            None if lse is None else lse.data_ptr(),
            # PyTorch's current stream as a raw handle, without building a
            # Stream object on every call
            torch._C._cuda_getCurrentRawStream(dev.index))
    fn = _load().flash_attention_fwd
    if dev.index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(dev):  # the runtime launches on its current device
            err = fn(*args)
    launches += 1
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd ({pl.variant}) launch failed: cudaError {err}")
    return out
