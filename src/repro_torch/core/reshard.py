"""Resharding (paper §4.5) on the simulated mesh's stacked shards.

GSPMD always produces a valid partitioned graph; when operand shardings don't
match an op's supported cases it inserts resharding:

* AllGather   — replicate a sharded dimension,
* AllToAll    — switch which dimension a mesh axis shards,
* DynamicSlice— shard a replicated dimension (offset = f(partition id)).

Which sequence of those steps to use is decided by the cost-model planner
(``collective_planner.plan_reshard``); ``reshard_local`` is the
plan-then-execute convenience the dynamic partitioner uses.  All dims are
assumed evenly divisible (uneven dims are padded to multiples beforehand,
§4.1 — see ``sharding.pad_to_multiple``).
"""
from __future__ import annotations

from typing import Tuple

from .collective_planner import execute_program, plan_reshard
from .sharding import Sharding


def reshard_local(x, cur: Sharding, tgt: Sharding):
    """Take the stacked shards ``x`` (one row per device) from ``cur`` to ``tgt``."""
    if not cur.rank == tgt.rank == x.ndim - 1:
        raise ValueError(f"reshard_local: {cur} -> {tgt} on stacked shards {tuple(x.shape)}")
    prog = plan_reshard(cur, tgt, tuple(x.shape[1:]), dtype_bytes=x.element_size())
    return execute_program(x, prog)


def shard_shape(global_shape: Tuple[int, ...], s: Sharding) -> Tuple[int, ...]:
    return tuple(
        dim // s.num_shards(i) for i, dim in enumerate(global_shape)
    )
