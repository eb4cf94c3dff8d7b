"""Manually partitioned subgraphs (paper §3.4).

Inside a manual region the user writes shard-sized code; outside, the program
is partitioned automatically, with conversion nodes at the boundary.  On the
simulated mesh a manual region is ``mesh_runtime.shard_map``: the function
sees the stacked local shards of every device and calls the mesh runtime's
collectives itself.  The reference's *subgroup* form (manual on some mesh
axes, automatic on the rest) needs its own design on the simulated mesh
(an automatic partition inside each manual group) and is ROADMAP A10b; the
port's pipelining (``repro_torch.pipeline``) does not use it.
"""
from __future__ import annotations

from typing import Sequence

from .mesh_runtime import shard_map
from .sharding import Mesh


def manual(fn, mesh: Mesh, in_specs, out_specs, auto_axes: Sequence[str] = ()):
    """Enter manual-partitioning mode for ``fn`` (paper §3.4)."""
    if auto_axes:
        raise NotImplementedError(
            "manual(auto_axes=...): manual subgroups are not ported yet (ROADMAP A10b)")
    return shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs)
