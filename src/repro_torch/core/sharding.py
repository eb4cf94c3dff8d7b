"""GSPMD sharding representation (paper §3.1) and the mesh_split API.

A copy of the JAX package's numpy-only ``repro.core.sharding``.  Three
sharding types, exactly as in the paper:

* REPLICATED — every device has the full data.
* TILED      — a device-ID tensor with the same rank as the data; each data dim is
               sharded along the corresponding device-tensor dim.
* PARTIAL    — "partially tiled": tiled device tensor with one extra trailing
               dimension enumerating the replication subgroup.

On top of the low-level representation sits the user-facing abstraction from the
paper: a logical device **mesh** plus ``mesh_split(tensor_rank, mesh, dims_mapping)``
mapping each tensor dim to a mesh dim (or -1).  Depending on whether the mapping
covers all / some / none of the mesh dims, the result is tiled / partially tiled /
replicated.

Partition specs are the port's own plain tuples (one entry per tensor dim:
``None``, a mesh axis name or a tuple of names, trailing ``None`` trimmed);
the JAX package's ``to_named_sharding`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np


class ShardingType(enum.Enum):
    REPLICATED = "replicated"
    TILED = "tiled"
    PARTIAL = "partially_tiled"  # paper's extension to GShard


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A logical device mesh: an nd-array of device ids with named axes.

    The paper lets the user pick the device order to match the network topology
    (§3.1); we preserve whatever order ``devices`` comes in.
    """

    devices: np.ndarray  # int array, shape == mesh shape
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs one name per axis, "
                             f"got {self.axis_names}")

    # hashed by content (device order matters, §3.1); the digest is cached
    def __hash__(self):
        h = self.__dict__.get("_hash")
        if h is None:
            h = hash((self.devices.tobytes(), self.devices.shape, self.axis_names))
            object.__setattr__(self, "_hash", h)
        return h

    def structural_key(self):
        """Cheap hashable identity for plan-cache keys (content digest, cached)."""
        k = self.__dict__.get("_skey")
        if k is None:
            k = (self.devices.shape, self.axis_names, hash(self))
            object.__setattr__(self, "_skey", k)
        return k

    def __eq__(self, other):
        return (
            isinstance(other, Mesh)
            and self.axis_names == other.axis_names
            and self.devices.shape == other.devices.shape
            and np.array_equal(self.devices, other.devices)
        )

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]

    @staticmethod
    def create(shape: Sequence[int], axis_names: Sequence[str]) -> "Mesh":
        n = int(np.prod(shape))
        return Mesh(np.arange(n).reshape(tuple(shape)), tuple(axis_names))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A sharding property for one tensor (paper §3.1).

    ``dims_mapping`` maps tensor dim -> tuple of mesh axis names it is sharded on
    (a tuple, so one data dim may be sharded over several mesh axes, major to
    minor).  Axes of the mesh not used by any dim are replication axes
    (PARTIAL), unless no dim is mapped at all (REPLICATED).
    """

    mesh: Mesh
    dims_mapping: Tuple[Tuple[str, ...], ...]  # one entry per tensor dim

    def __post_init__(self):
        seen = []
        for axes in self.dims_mapping:
            for a in axes:
                if a not in self.mesh.axis_names:
                    raise ValueError(f"unknown mesh axis {a}")
                if a in seen:
                    raise ValueError(f"mesh axis {a} used twice")
                seen.append(a)

    # ---- classification (paper's three types) ---------------------------------
    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a for axes in self.dims_mapping for a in axes)

    @property
    def replication_axes(self) -> Tuple[str, ...]:
        used = set(self.sharded_axes)
        return tuple(a for a in self.mesh.axis_names if a not in used)

    @property
    def type(self) -> ShardingType:
        if not self.sharded_axes:
            return ShardingType.REPLICATED
        if not self.replication_axes:
            return ShardingType.TILED
        return ShardingType.PARTIAL

    @property
    def rank(self) -> int:
        return len(self.dims_mapping)

    def num_shards(self, dim: int) -> int:
        return int(
            np.prod([self.mesh.axis_size(a) for a in self.dims_mapping[dim]] or [1])
        )

    def is_fully_replicated(self) -> bool:
        return self.type == ShardingType.REPLICATED

    # ---- the low-level device-ID tensor of the paper --------------------------
    def device_assignment(self) -> np.ndarray:
        """Returns the paper's device-ID tensor.

        Shape: one dim per tensor dim (the number of shards along it), plus a
        trailing replication dim if partially tiled.  Built by transposing the mesh
        so sharded axes come first in dims_mapping order, replicated axes last
        (collapsed into the trailing subgroup dim).
        """
        order = []
        tile_shape = []
        for axes in self.dims_mapping:
            n = 1
            for a in axes:
                order.append(self.mesh.axis_names.index(a))
                n *= self.mesh.axis_size(a)
            tile_shape.append(n)
        rep = [self.mesh.axis_names.index(a) for a in self.replication_axes]
        order += rep
        arr = np.transpose(self.mesh.devices, order)
        rep_size = int(np.prod([self.mesh.shape[i] for i in rep] or [1]))
        if rep_size > 1:
            return arr.reshape(tuple(tile_shape) + (rep_size,))
        return arr.reshape(tuple(tile_shape))

    # ---- shard shapes & offsets (paper §3.5 Offset) ----------------------------
    def shard_size(self, global_dim_size: int, dim: int) -> int:
        """Per-shard (padded) size: GSPMD rounds up to a multiple (§4.1)."""
        n = self.num_shards(dim)
        return -(-global_dim_size // n)

    def offset(self, device: int, dim: int, global_dim_size: int) -> int:
        """Offset(S, d, i) from §3.5: where device d's shard starts in dim i."""
        assign = self.device_assignment()
        pos = np.argwhere(assign == device)
        if pos.size == 0:
            raise ValueError(f"device {device} not in mesh")
        idx = pos[0][dim] if dim < assign.ndim else 0
        return int(idx) * self.shard_size(global_dim_size, dim)

    # ---- helpers ----------------------------------------------------------------
    def structural_key(self):
        """Hashable identity used by the plan cache: mesh digest +
        dims_mapping, avoiding the full array comparison of ``__eq__``."""
        return (self.mesh.structural_key(), self.dims_mapping)

    def with_dim(self, dim: int, axes: Tuple[str, ...]) -> "Sharding":
        dm = list(self.dims_mapping)
        dm[dim] = axes
        return Sharding(self.mesh, tuple(dm))

    def __repr__(self):
        parts = [
            "+".join(axes) if axes else "_" for axes in self.dims_mapping
        ]
        return f"S[{','.join(parts)}|{self.type.value}]"


def replicated(mesh: Mesh, rank: int) -> Sharding:
    return Sharding(mesh, tuple(() for _ in range(rank)))


def mesh_split(
    rank: int, mesh: Mesh, dims_mapping: Sequence
) -> Sharding:
    """The paper's primary API (§3.1).

    ``dims_mapping[i]`` is a mesh axis name, a tuple of names, a mesh-dim index,
    or -1/None for "not sharded".  Each mesh dim may appear at most once.
    """
    if len(dims_mapping) != rank:
        raise ValueError(f"mesh_split: {len(dims_mapping)} entries for rank {rank}")
    out = []
    for m in dims_mapping:
        if m is None or (isinstance(m, int) and m == -1):
            out.append(())
        elif isinstance(m, int):
            out.append((mesh.axis_names[m],))
        elif isinstance(m, str):
            out.append((m,))
        else:
            out.append(tuple(mesh.axis_names[x] if isinstance(x, int) else x for x in m))
    return Sharding(mesh, tuple(out))


# ---------------------------------------------------------------------------------
# Compatible-sharding merge (paper §3.5).
# ---------------------------------------------------------------------------------

def merge_shardings(a: Sharding, b: Sharding) -> Optional[Sharding]:
    """Merge two shardings of the same tensor if compatible, else None.

    Compatibility per §3.5: there exists S whose per-device offsets agree with a on
    a's sharded dims and with b on b's sharded dims.  For mesh-based shardings this
    holds iff on every dim where both are sharded they are sharded identically, and
    the remaining sharded dims use disjoint mesh axes.
    """
    if a.mesh is not b.mesh and not np.array_equal(a.mesh.devices, b.mesh.devices):
        return None
    if a.rank != b.rank:
        return None
    used_a = set(a.sharded_axes)
    merged = []
    for da, db in zip(a.dims_mapping, b.dims_mapping):
        if da and db:
            if da != db:
                return None
            merged.append(da)
        elif da:
            merged.append(da)
        elif db:
            if any(x in used_a for x in db):
                return None  # same mesh axis used for a different dim
            merged.append(db)
        else:
            merged.append(())
    return Sharding(a.mesh, tuple(merged))


def is_refinement(new: Sharding, old: Sharding) -> bool:
    """True if ``new`` shards everything ``old`` does (possibly more).

    The propagation pass only ever *refines* shardings, which guarantees a fixed
    point (§3.5 "Iterative, priority-based sharding propagation").
    """
    if new.rank != old.rank:
        return False
    for dn, do in zip(new.dims_mapping, old.dims_mapping):
        if do and dn != do:
            return False
    return True


# ---------------------------------------------------------------------------------
# Partition specs: the port's plain tuples
# ---------------------------------------------------------------------------------

def to_partition_spec(s: Sharding) -> tuple:
    entries = []
    for axes in s.dims_mapping:
        if not axes:
            entries.append(None)
        elif len(axes) == 1:
            entries.append(axes[0])
        else:
            entries.append(tuple(axes))
    # trim trailing Nones (canonical form)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def project_dims_mapping(
    mesh: Mesh, dims_mapping: Sequence[Sequence[str]], shape: Sequence[int]
) -> Sharding:
    """Re-express a ``dims_mapping`` (possibly recorded on a *different* mesh)
    on ``mesh``: keep each axis that exists on ``mesh``, is not already used by
    an earlier dim, and divides the dim given the axes stacked before it; drop
    the rest (they become replication).  This is the elastic-restore
    projection of a checkpoint's recorded layout onto a new mesh.
    """
    shape = tuple(int(s) for s in shape)
    used: set = set()
    out: List[Tuple[str, ...]] = []
    for d, axes in enumerate(tuple(dims_mapping)[: len(shape)]):
        kept: List[str] = []
        n = 1
        for a in axes:
            if (a in mesh.axis_names and a not in used
                    and shape[d] % (n * mesh.axis_size(a)) == 0):
                kept.append(a)
                used.add(a)
                n *= mesh.axis_size(a)
        out.append(tuple(kept))
    out += [()] * (len(shape) - len(out))
    return Sharding(mesh, tuple(out))


def from_partition_spec(mesh: Mesh, rank: int, spec) -> Sharding:
    entries = list(spec) + [None] * (rank - len(spec))
    dm = []
    for e in entries[:rank]:
        if e is None:
            dm.append(())
        elif isinstance(e, str):
            dm.append((e,))
        else:
            dm.append(tuple(e))
    return Sharding(mesh, tuple(dm))


# ---------------------------------------------------------------------------------
# Uneven-shard support (paper §4.1): pad to a shardable multiple + mask.
# ---------------------------------------------------------------------------------

def pad_to_multiple(size: int, parts: int) -> int:
    """GSPMD rounds dim sizes up to a multiple of the partition count."""
    return -(-size // parts) * parts


def padded_waste(size: int, parts: int) -> float:
    return pad_to_multiple(size, parts) / size - 1.0
