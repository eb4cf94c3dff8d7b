"""Roofline cost model, first part: the per-collective wire-byte model that
the reshard planner (``core/collective_planner.py``) and the einsum planner
(``core/einsum_rules.py``) minimise.

A port of the JAX package's ``analysis/roofline.py::collective_wire_bytes``.
Time-valued pricing (peak rates, link bandwidth, launch overheads) arrives
with compiled plans and a machine profile fitted on the H100; nothing here
carries a device constant.

Given the per-device *input* bytes B of a collective over a group of n
devices (ring algorithms, per device):

  AllGather      (n-1)·B        output is n·B per device; each device
                                 forwards every remote shard once
  AllToAll       (n-1)/n·B      only the remote-destined fraction moves
  AllReduce      2·(n-1)/n·B    reduce-scatter + all-gather phases
  ReduceScatter  (n-1)/n·B      half of AllReduce — §4.2's key saving
  CollectivePermute  B          one neighbour hop
  DynamicSlice   0              local addressing, no wire traffic
"""
from __future__ import annotations


def collective_wire_bytes(kind: str, group_size: int, in_bytes: float) -> float:
    """Modeled per-device wire bytes for one collective (ring algorithm)."""
    n = int(group_size)
    if n <= 1:
        return 0.0
    if kind == "all-gather":
        return (n - 1) * in_bytes
    if kind == "all-to-all":
        return (n - 1) / n * in_bytes
    if kind == "all-reduce":
        return 2.0 * (n - 1) / n * in_bytes
    if kind == "reduce-scatter":
        return (n - 1) / n * in_bytes
    if kind == "collective-permute":
        return in_bytes
    if kind == "dynamic-slice":
        return 0.0
    raise ValueError(f"unknown collective kind {kind!r}")
