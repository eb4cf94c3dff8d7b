"""Sharding representation.  For now only the uneven-shard size helper; the
mesh/sharding types arrive with the partitioner slices (ROADMAP A1)."""
from __future__ import annotations


def pad_to_multiple(size: int, parts: int) -> int:
    """GSPMD rounds dim sizes up to a multiple of the partition count (§4.1)."""
    return -(-size // parts) * parts
