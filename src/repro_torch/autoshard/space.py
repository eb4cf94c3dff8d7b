"""Candidate sharding spaces for the autoshard search (Automap/PartIR-style).

A port of the JAX package's ``autoshard/space.py`` onto the port's
``core.sharding`` types.  Per searched tensor, the space is every way of
distributing the mesh axes over the tensor dims (replicated, one dim per
axis, stacked: one dim holding several axes, both orders, and multi-dim
splits), pruned by:

* **divisibility**: the reshard planner requires even shards, so an axis
  whose size does not divide the dim (given the axes already stacked on it)
  is not a candidate;
* the **per-device live-memory model**: a candidate whose local shard alone
  exceeds the memory budget can never appear in a feasible assignment, so
  it is dropped before search (:func:`local_bytes` / :func:`fits_budget`).

``None`` is always part of the per-tensor space: it means "leave this
tensor to propagation", the GSPMD premise that most tensors need no
annotation.  The candidate order is the reference's: by local bytes, then
by ``repr`` (the two packages' ``Sharding.__repr__`` print alike).
"""
from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

from ..core.sharding import Mesh, Sharding, replicated

MaybeSharding = Optional[Sharding]


def _divisible(shape: Tuple[int, ...], dims_mapping, mesh: Mesh) -> bool:
    for d, axes in enumerate(dims_mapping):
        n = 1
        for a in axes:
            n *= mesh.axis_size(a)
            if shape[d] % n:
                return False
    return True


def candidate_shardings(
    shape: Sequence[int],
    mesh: Mesh,
    max_candidates: int = 32,
    dtype_bytes: int = 4,
    budget_bytes: Optional[float] = None,
) -> List[Sharding]:
    """Every divisible placement of mesh axes over ``shape``'s dims.

    Enumerates all assignments of each mesh axis to one tensor dim (or to
    none), in every stacking order, keeps the divisible ones, and sorts by
    local shard size (most-sharded first) so a truncation by
    ``max_candidates`` keeps the memory-relieving candidates.
    ``budget_bytes`` drops candidates whose local shard cannot fit at all.
    """
    shape = tuple(int(s) for s in shape)
    rank = len(shape)
    if rank == 0:
        return [replicated(mesh, 0)]
    out: List[Sharding] = []
    seen = set()
    axes = mesh.axis_names
    # each axis goes to one dim or stays unused: (rank + 1) placements per
    # axis; the stacked order is the axis listing order, so permutations of
    # the axis tuple cover both stacking orders
    for perm in itertools.permutations(axes):
        for placement in itertools.product(range(rank + 1), repeat=len(axes)):
            dm: List[Tuple[str, ...]] = [() for _ in range(rank)]
            for a, p in zip(perm, placement):
                if p < rank:
                    dm[p] = dm[p] + (a,)
            key = tuple(dm)
            if key in seen:
                continue
            seen.add(key)
            if not _divisible(shape, key, mesh):
                continue
            s = Sharding(mesh, key)
            if budget_bytes is not None and local_bytes(shape, dtype_bytes, s) > budget_bytes:
                continue
            out.append(s)
    out.sort(key=lambda s: (local_bytes(shape, 4, s), repr(s)))
    return out[:max_candidates]


def local_bytes(shape: Sequence[int], dtype_bytes: int, sharding: MaybeSharding) -> float:
    """Per-device bytes of one tensor under ``sharding`` (even shards)."""
    b = float(dtype_bytes)
    for d, s in enumerate(shape):
        n = sharding.num_shards(d) if sharding is not None else 1
        b *= -(-s // n)  # ceil: the §4.1 padded shard size
    return b


def assignment_bytes(
    shapes: Sequence[Tuple[int, ...]],
    dtype_bytes: Sequence[int],
    assignment: Sequence[MaybeSharding],
) -> float:
    """Resident per-device bytes of an input assignment (params and batch).

    ``None`` entries are counted replicated: the conservative upper bound
    for a tensor left to propagation (propagation only ever refines, that
    is, shards more).
    """
    return sum(local_bytes(shape, db, s) for shape, db, s in zip(shapes, dtype_bytes, assignment))


def fits_budget(
    shapes: Sequence[Tuple[int, ...]],
    dtype_bytes: Sequence[int],
    assignment: Sequence[MaybeSharding],
    budget_bytes: Optional[float],
) -> bool:
    if budget_bytes is None:
        return True
    return assignment_bytes(shapes, dtype_bytes, assignment) <= budget_bytes


# ---------------------------------------------------------------------------------
# pipeline decision variables (§3.3 stage-stacked pipelining)
# ---------------------------------------------------------------------------------


def pipeline_decisions(mesh: Mesh, num_layers: int, batch: int, pcfg):
    """Enumerate the pipeline points of the search space.

    One decision = (stage mesh axis, stage count, microbatch count).  Stage
    counts are multiples of the axis size (each device row holds an equal
    number of stage slots, so the shifting buffer's ppermute moves exactly
    one boundary row) that divide the layer count and respect
    ``pcfg.max_stages`` (a ``pipeline.PipelineConfig``); microbatch counts
    must divide the batch.  Returns ``pipeline.PipelineDecision`` objects in
    a deterministic order (axis listing, then S, then M).
    """
    from ..pipeline.schedule import PipelineDecision

    axes = pcfg.stage_axes if pcfg.stage_axes is not None else mesh.axis_names
    if pcfg.num_microbatches is not None:
        m_opts = (pcfg.num_microbatches,)
    else:
        m_opts = tuple(pcfg.microbatch_options)
    out = []
    for ax in axes:
        if ax not in mesh.axis_names:
            continue
        n = mesh.axis_size(ax)
        if n < 2:
            continue
        s = n
        while s <= pcfg.max_stages:
            if num_layers % s == 0:
                for m in m_opts:
                    if m >= 1 and batch % m == 0:
                        out.append(PipelineDecision(ax, s, m))
            s += n
    return out


def swap_axes(s: MaybeSharding, a: str, b: str) -> MaybeSharding:
    """Exchange two mesh axes everywhere in one sharding (a search move)."""
    if s is None:
        return None
    table = {a: b, b: a}
    return Sharding(s.mesh, tuple(tuple(table.get(x, x) for x in axes)
                                  for axes in s.dims_mapping))


def flip_dims(s: Sharding, d1: int, d2: int) -> Sharding:
    """Exchange the axis tuples of two dims (a batch-against-model flip)."""
    dm = list(s.dims_mapping)
    dm[d1], dm[d2] = dm[d2], dm[d1]
    return Sharding(s.mesh, tuple(dm))
