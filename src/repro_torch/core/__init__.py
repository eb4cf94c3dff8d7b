"""repro_torch.core — the paper's contribution: GSPMD sharding representation,
auto-completion (propagation) and SPMD partitioning on a simulated mesh."""

from .sharding import (
    Mesh,
    Sharding,
    ShardingType,
    mesh_split,
    merge_shardings,
    is_refinement,
    replicated,
    to_partition_spec,
    from_partition_spec,
    pad_to_multiple,
    padded_waste,
)
from .annotate import annotate, mesh_split_annotate
from .propagation import propagate, Propagation
from .apply import gspmd_jit
