"""Halo exchange for windowed operators (paper §4.3, Appendix A.2).

A port of the JAX package's ``core/halo.py`` onto the stacked shards of the
simulated mesh.  Partitioning a convolution along a spatial dimension makes
neighboring partitions need overlapping input ("halo") regions.  Following
the paper:

1. compute per-partition left/right halo sizes — generally *non-constant*
   (linear functions of the partition id, Fig. 9a);
2. exchange the **maximum** halo via CollectivePermute (Steps 1-2 of Fig. 9b);
3. DynamicSlice (offset = f(partition id)) to the region each partition actually
   needs (Step 3);
4. mask out-of-range data with the identity value (Step 4 / §4.1) — for
   convolution that's the zero padding value, handled by explicit edge padding.

Supports arbitrary stride/low/high padding; base/window dilation are not
implemented (the paper's §A.2 cases 2-3).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import mesh_runtime as mr
from .sharding import Mesh


def _halo_bounds(n_shards, local_in, local_out, stride, pad_lo, kernel):
    """Max left/right halo over partitions; needs are linear in partition id.

    Partition i owns inputs  [i*local_in, (i+1)*local_in)
    and computes outputs     [i*local_out, (i+1)*local_out), where output j reads
    inputs [j*stride - pad_lo, j*stride - pad_lo + kernel).
    """
    lefts, rights = [], []
    for i in range(n_shards):
        start_need = i * local_out * stride - pad_lo
        end_need = ((i + 1) * local_out - 1) * stride - pad_lo + kernel
        lefts.append(i * local_in - start_need)
        rights.append(end_need - (i + 1) * local_in)
    return max(0, max(lefts)), max(0, max(rights))


def halo_exchange(x, mesh: Mesh, axis_name: str, dim: int, left: int, right: int,
                  fill=0.0):
    """Concatenate ``left`` elements from the left neighbor and ``right`` from the
    right neighbor along local ``dim`` of the stacked shards ``x``.  Boundary
    partitions are padded with ``fill`` (the identity value — masking per
    §4.1)."""
    n = mesh.axis_size(axis_name)
    idx = mr.axis_index(mesh, axis_name)
    size = x.shape[dim + 1]
    parts = []
    if left > 0:
        # my left halo is the right edge of partition id-1
        src = x.narrow(dim + 1, size - left, left)
        got = mr.ppermute(src, mesh, axis_name, [(j, j + 1) for j in range(n - 1)])
        got = torch.where(mr.device_mask(idx == 0, got), torch.full_like(got, fill), got)
        parts.append(got)
    parts.append(x)
    if right > 0:
        src = x.narrow(dim + 1, 0, right)
        got = mr.ppermute(src, mesh, axis_name, [(j + 1, j) for j in range(n - 1)])
        got = torch.where(mr.device_mask(idx == n - 1, got), torch.full_like(got, fill), got)
        parts.append(got)
    return torch.cat(parts, dim=dim + 1) if len(parts) > 1 else x


def local_conv(x, w, window_strides, padding, same_kernel=True):
    """A convolution of every device's shard (``x`` and ``w`` stacked), with
    explicit (lo, hi) padding per spatial dim.  With ``same_kernel`` every
    device holds the same kernel (replicated) and one convolution takes all
    shards as one batch; else each device convolves with its own."""
    nd = x.ndim - 1
    pad = []
    for lo, hi in reversed(list(padding)):
        pad += [lo, hi]
    flat = x.reshape((-1,) + tuple(x.shape[2:]))
    if any(pad):
        flat = F.pad(flat, pad)
    conv = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[nd]
    if not same_kernel:
        per = flat.reshape(tuple(x.shape[:2]) + tuple(flat.shape[1:]))
        return torch.stack([conv(xi, wi, stride=tuple(window_strides)) for xi, wi in zip(per, w)])
    out = conv(flat, w[0], stride=tuple(window_strides))
    return out.reshape(tuple(x.shape[:2]) + tuple(out.shape[1:]))


def sharded_conv_nd(
    x,
    w,
    *,
    mesh: Mesh,
    sharded: Sequence[Tuple[int, str]],
    window_strides: Sequence[int],
    padding: Sequence[Tuple[int, int]],
):
    """Convolution with multiple spatial dims sharded (recursive per-dim halo).

    ``x`` and ``w`` are stacked shards (``w`` replicated); ``sharded`` is
    [(spatial_dim_index_into_the_local_x, axis_name), ...].  Halo exchange
    composes per-dim: exchange+slice along each sharded dim, then one local
    conv with VALID padding on sharded dims and the original padding elsewhere.
    This is the §4.4 recursive-partitioning structure for Convolution.
    """
    strides = list(window_strides)
    pads = [tuple(p) for p in padding]

    for dim, axis_name in sharded:
        sd = dim - 2
        k = w.shape[3 + sd]
        n = mesh.axis_size(axis_name)
        local_in = x.shape[dim + 1]
        gl = local_in * n
        lo, hi = pads[sd]
        out_len = (gl + lo + hi - k) // strides[sd] + 1
        if out_len % n:
            raise ValueError(f"halo conv: output length {out_len} does not divide into {n}")
        local_out = out_len // n
        left, right = _halo_bounds(n, local_in, local_out, strides[sd], lo, k)
        x = halo_exchange(x, mesh, axis_name, dim, left, right, fill=0.0)
        idx = mr.axis_index(mesh, axis_name)
        offset = idx * (local_out * strides[sd] - local_in) + (left - lo)
        need = (local_out - 1) * strides[sd] + k
        x = mr.dynamic_slice_in_dim(x, offset, need, dim)
        pads[sd] = (0, 0)

    return local_conv(x, w, strides, pads)
