"""A simulated device mesh in one process: the port's counterpart of
``shard_map`` (JAX package ``core/compat.py:74``), of ``axis_size``
(``Mesh.axis_size``) and of the ``jax.lax`` collectives the partitioner calls
inside it.

**Stacked layout.**  A value of the SPMD program is one tensor whose leading
dimension holds every device's local shard, in the order of ``Mesh.devices``
flattened (row-major over the mesh axes, the user's device order of §3.1):
position ``p`` is the device ``mesh.devices.flat[p]``, at mesh coordinates
``np.unravel_index(p, mesh.shape)``.  ``shard``/``unshard`` place tiles by
``Sharding.device_assignment`` (which shard each device id holds), so a mesh
with a permuted device order holds its tiles where the paper says.

A collective over a mesh axis acts within each group of devices that share
the other axes' coordinates, and every one here is an exact tensor operation
on the stacked tensor (a reshape to ``mesh.shape + local shape``, then sums,
concatenations or index moves along the axis).  Local dims are numbered as
in the per-device program (``dim`` 0 is the first dim of a shard).  The
semantics are those of ``jax.lax`` with ``tiled=True``:

* ``all_gather``: concatenation of the group's shards along ``dim``, in
  axis-index order, on every member;
* ``all_to_all``: each member splits ``split_dim`` into n chunks, chunk j
  goes to member j, which concatenates what it receives along
  ``concat_dim`` in source order;
* ``psum`` / ``pmax`` / ``pmin``: the group's reduction on every member;
* ``psum_scatter``: member j keeps chunk j (along ``dim``) of the group sum;
* ``ppermute``: ``(src, dst)`` pairs of axis indices; a member that
  receives nothing gets zeros;
* ``axis_index``: each device's coordinate along the axis;
* ``dynamic_slice_by_axis_index``: member j keeps chunk j of ``dim`` (the
  reshard planner's DynamicSlice), and ``dynamic_slice_in_dim`` a per-device
  start.

``recording()`` counts the collectives run inside it by kind.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from .sharding import Mesh, Sharding, from_partition_spec

_LOG: contextvars.ContextVar[Optional[collections.Counter]] = contextvars.ContextVar(
    "collective_log", default=None)


@contextlib.contextmanager
def recording():
    """Count the collectives run inside the block, by kind (the roofline
    model's names: all-gather, all-to-all, all-reduce, reduce-scatter,
    collective-permute)."""
    log = collections.Counter()
    token = _LOG.set(log)
    try:
        yield log
    finally:
        _LOG.reset(token)


def _record(kind: str) -> None:
    log = _LOG.get()
    if log is not None:
        log[kind] += 1


# ---------------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------------


def _grid(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if x.shape[0] != mesh.size:
        raise ValueError(f"stacked tensor of {x.shape[0]} shards on a mesh of {mesh.size}")
    return x.reshape(tuple(mesh.shape) + tuple(x.shape[1:]))


def _stacked(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return g.reshape((mesh.size,) + tuple(g.shape[len(mesh.shape):]))


def _axis(mesh: Mesh, axis: str) -> Tuple[int, int]:
    return mesh.axis_names.index(axis), mesh.axis_size(axis)


def axis_index(mesh: Mesh, axis: str) -> np.ndarray:
    """Each stacked position's coordinate along ``axis`` (shape ``[mesh.size]``)."""
    k = mesh.axis_names.index(axis)
    return np.unravel_index(np.arange(mesh.size), mesh.shape)[k]


@functools.lru_cache(maxsize=256)
def _on_device(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A small constant tensor (device masks, tile indices), copied to
    ``device`` once: a copy from host memory on every call would wait for
    the device's queue to drain."""
    return torch.tensor(values, dtype=dtype, device=device)


def device_mask(mask: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A per-device boolean as a tensor that broadcasts against ``like``."""
    t = _on_device(tuple(bool(b) for b in np.asarray(mask, bool)), torch.bool, like.device)
    return t.reshape((-1,) + (1,) * (like.ndim - 1))


def replicate(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A global value held whole by every device (a view, no copy)."""
    return x.unsqueeze(0).expand((mesh.size,) + tuple(x.shape))


# ---------------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------------


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    _record("all-gather")
    k, n = _axis(mesh, axis)
    m = len(mesh.shape)
    g = _grid(x, mesh)
    # the axis becomes the major factor of ``dim``
    h = g.movedim(k, m - 1 + dim)
    local = list(x.shape[1:])
    local[dim] *= n
    rest = [s for i, s in enumerate(mesh.shape) if i != k]
    h = h.reshape(rest + local).unsqueeze(k).expand(list(mesh.shape) + local)
    return _stacked(h, mesh)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    _record("all-to-all")
    if split_dim == concat_dim:
        raise ValueError("all_to_all: split and concat dims must differ")
    k, n = _axis(mesh, axis)
    m = len(mesh.shape)
    local = list(x.shape[1:])
    if local[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {local} not divisible by {n}")
    g = _grid(x, mesh).reshape(list(mesh.shape) + local[:split_dim]
                               + [n, local[split_dim] // n] + local[split_dim + 1:])

    def pos(d):  # where local dim d sits after the split
        return m + d + (1 if d > split_dim else 0)

    chunk = m + split_dim
    perm = [chunk if i == k else i for i in range(m)]
    for d in range(len(local)):
        if d == concat_dim:
            perm += [k, pos(d)]  # the source index becomes the major factor
        elif d == split_dim:
            perm.append(chunk + 1)
        else:
            perm.append(pos(d))
    out = list(local)
    out[split_dim] //= n
    out[concat_dim] *= n
    return g.permute(perm).reshape([mesh.size] + out)


_COMBINE = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}


def _reduce(x: torch.Tensor, mesh: Mesh, axes: Iterable[str], op: str) -> torch.Tensor:
    """The group's reduction on every member, in a fixed order: the members
    combined one by one by elementwise ops, in row-major order over the
    reduced mesh axes (the order of ``torch.sum`` over leading dims on the
    CPU).  An element's result then does not depend on the tensor's layout
    or size, so a fused collective (a flattened concatenation of several
    tensors) equals its members' collectives bit for bit.  Sums of 16-bit
    floats are added in float32 and rounded once, and integer sums widen to
    int64, as ``torch.sum`` does."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes:
        return x
    _record("all-reduce")
    g = _grid(x, mesh)
    out_dtype = g.dtype
    if op == "sum":
        if not g.is_floating_point():
            g = g.to(torch.int64)
            out_dtype = torch.int64
        elif g.dtype.itemsize < 4:
            g = g.float()
    members = [g]
    for k in sorted(mesh.axis_names.index(a) for a in axes):
        members = [m for part in members for m in part.split(1, dim=k)]
    combine = _COMBINE[op]
    r = members[0]
    for m in members[1:]:
        r = combine(r, m)
    return _stacked(r.to(out_dtype).expand(g.shape), mesh)


def psum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _reduce(x, mesh, axes, "sum")


def pmax(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _reduce(x, mesh, axes, "max")


def pmin(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    return _reduce(x, mesh, axes, "min")


def psum_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    _record("reduce-scatter")
    k, n = _axis(mesh, axis)
    m = len(mesh.shape)
    local = list(x.shape[1:])
    if local[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {local} not divisible by {n}")
    s = _grid(x, mesh).sum(dim=k)
    rest = [v for i, v in enumerate(mesh.shape) if i != k]
    s = s.reshape(rest + local[:dim] + [n, local[dim] // n] + local[dim + 1:])
    return _stacked(s.movedim(m - 1 + dim, k), mesh)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    _record("collective-permute")
    k, _ = _axis(mesh, axis)
    g = _grid(x, mesh)
    out = torch.zeros_like(g)
    for src, dst in perm:
        out.select(k, dst).copy_(g.select(k, src))
    return _stacked(out, mesh)


def dynamic_slice_by_axis_index(x: torch.Tensor, mesh: Mesh, axis: str,
                                dim: int) -> torch.Tensor:
    """Member j of each group keeps chunk j of ``dim`` (no communication)."""
    k, n = _axis(mesh, axis)
    m = len(mesh.shape)
    local = list(x.shape[1:])
    if local[dim] % n:
        raise ValueError(f"dynamic_slice: dim {dim} of {local} not divisible by {n}")
    g = _grid(x, mesh).reshape(list(mesh.shape) + local[:dim] + [n, local[dim] // n]
                               + local[dim + 1:])
    d = torch.diagonal(g, dim1=k, dim2=m + dim).movedim(-1, k)
    return _stacked(d, mesh)


def dynamic_slice_in_dim(x: torch.Tensor, starts: Sequence[int], size: int,
                         dim: int) -> torch.Tensor:
    """Device p keeps ``size`` elements of ``dim`` from ``starts[p]``."""
    return torch.stack([x[p].narrow(dim, int(s), size) for p, s in enumerate(starts)])


# ---------------------------------------------------------------------------------
# global <-> stacked
# ---------------------------------------------------------------------------------


@functools.lru_cache(maxsize=1024)
def _tiles(s: Sharding) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """The tile (flat index over the tile grid) held at each stacked position."""
    assign = s.device_assignment()
    tile_shape = tuple(s.num_shards(d) for d in range(s.rank))
    tile_of_device = {}
    for idx in np.ndindex(*assign.shape):
        t = int(np.ravel_multi_index(idx[: s.rank], tile_shape)) if s.rank else 0
        tile_of_device[int(assign[idx])] = t
    return np.array([tile_of_device[int(d)] for d in s.mesh.devices.flat]), tile_shape


def _check_divisible(shape, s: Sharding):
    for d, size in enumerate(shape):
        if size % s.num_shards(d):
            raise ValueError(f"dim {d} of {tuple(shape)} does not divide into "
                             f"{s.num_shards(d)} shards ({s}); pad it first (§4.1)")


def shard(x: torch.Tensor, s: Sharding) -> torch.Tensor:
    """The stacked local shards of the global ``x`` under ``s``."""
    if x.ndim != s.rank:
        raise ValueError(f"rank {x.ndim} tensor with a rank {s.rank} sharding")
    _check_divisible(x.shape, s)
    tiles, tile_shape = _tiles(s)
    local = [size // n for size, n in zip(x.shape, tile_shape)]
    r = s.rank
    blocks = x.reshape([v for pair in zip(tile_shape, local) for v in pair])
    blocks = blocks.permute(list(range(0, 2 * r, 2)) + list(range(1, 2 * r, 2)))
    blocks = blocks.reshape([int(np.prod(tile_shape))] + local)
    return blocks[_on_device(tuple(int(t) for t in tiles), torch.long, x.device)]


def shard_slices(shape: Sequence[int], s: Sharding) -> Tuple[Tuple[slice, ...], ...]:
    """The global index each stacked position holds under ``s``: one tuple
    of slices per position, in ``shard``'s order (a sharded read fetches
    exactly these ranges)."""
    _check_divisible(shape, s)
    tiles, tile_shape = _tiles(s)
    local = [size // n for size, n in zip(shape, tile_shape)]
    out = []
    for t in tiles:
        idx = np.unravel_index(int(t), tile_shape) if s.rank else ()
        out.append(tuple(slice(int(i) * l, (int(i) + 1) * l) for i, l in zip(idx, local)))
    return tuple(out)


def unshard(x: torch.Tensor, s: Sharding) -> torch.Tensor:
    """The global tensor whose shards under ``s`` are the stacked ``x``."""
    tiles, tile_shape = _tiles(s)
    first = {}
    for p, t in enumerate(tiles):
        first.setdefault(int(t), p)
    picks = [first[t] for t in range(int(np.prod(tile_shape)))]
    local = list(x.shape[1:])
    r = s.rank
    blocks = x[_on_device(tuple(picks), torch.long, x.device)].reshape(list(tile_shape) + local)
    order = [i for d in range(r) for i in (d, r + d)]
    return blocks.permute(order).reshape([n * l for n, l in zip(tile_shape, local)])


def shard_map(f: Callable, *, mesh: Mesh, in_specs: Sequence, out_specs) -> Callable:
    """Run ``f`` once on the stacked local shards of its global arguments.

    ``in_specs`` holds one partition spec per argument; ``out_specs`` is one
    spec when ``f`` returns a tensor, or a sequence of specs when it returns
    a tuple.  The caller's global tensors are sharded on their own device;
    the outputs come back global.
    """

    def wrapped(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} arguments, {len(in_specs)} in_specs")
        local = [shard(a, from_partition_spec(mesh, a.ndim, spec))
                 for a, spec in zip(args, in_specs)]
        outs = f(*local)
        if isinstance(outs, torch.Tensor):
            return unshard(outs, from_partition_spec(mesh, outs.ndim - 1, out_specs))
        return type(outs)(unshard(o, from_partition_spec(mesh, o.ndim - 1, spec))
                          for o, spec in zip(outs, out_specs))

    return wrapped
