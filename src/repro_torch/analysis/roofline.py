"""Roofline cost model: the per-collective wire-byte model that the reshard
planner (``core/collective_planner.py``) and the einsum planner
(``core/einsum_rules.py``) minimise, and the time-valued pricing of
compiled plans (``core/plan.py::PlanCost``).

A port of the JAX package's ``analysis/roofline.py`` (``RooflineParams``,
``overlap_time_s``, ``collective_wire_bytes``, ``collective_time_s``,
``DEFAULT_PARAMS``).  The reference's ``RooflineParams`` defaults to TPU
v5e-class constants; the port's class has no defaults and carries no device
constant: every field is required, and a function here that prices time
takes its params explicitly.  ``DEFAULT_PARAMS`` is the machine profile
fitted on an NVIDIA H100 by ``python -m repro_torch.obs profile`` and
committed with the package (``obs/h100_profile.json``); the entry points
and ``spmd_partition`` price with it when neither the caller nor
``$REPRO_TORCH_MACHINE_PROFILE`` names another (``obs/profile.py::
resolve_profile``).  The modeled quantities that need no constant (wire
bytes, launches, flops, peak bytes) are priced without one.

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

import dataclasses
import hashlib
import json
import os
from typing import Dict


@dataclasses.dataclass(frozen=True)
class RooflineParams:
    """Machine constants for every time-valued roofline formula.

    ``peak_flops`` (FLOP/s per device), ``hbm_bw`` (B/s per device),
    ``ici_bw`` (B/s per link), ``collective_launch_s`` (fixed cost of one
    collective launch) and ``overlap_efficiency`` (the fraction of the
    smaller of the compute and collective terms an overlapping schedule
    hides).  Frozen, so it can ride in cache keys.
    """

    peak_flops: float
    hbm_bw: float
    ici_bw: float
    collective_launch_s: float
    overlap_efficiency: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "RooflineParams":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: float(v) for k, v in d.items() if k in fields})

    def digest(self) -> str:
        """Stable short hash of the constants (a cache-key ingredient)."""
        payload = json.dumps(self.as_dict(), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


PROFILE_FILE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "obs", "h100_profile.json")


def __getattr__(name):
    """``DEFAULT_PARAMS``, read from ``PROFILE_FILE`` at its first use.

    The port's default constants: the profile fitted on an NVIDIA H100 (its
    name and power limit are the file's "device").  ``peak_flops``,
    ``ici_bw`` and ``collective_launch_s`` are fitted to tight-timed plan
    steps of a matmul chain on the simulated (2, 4) mesh, so they price what
    the port runs: ``peak_flops`` is one simulated device's share of the
    card (a step's FLOPs are one device's; the card runs all eight), and
    ``ici_bw`` prices the *simulated* mesh's collectives, which are copies
    on one card, not NVLink.  ``hbm_bw`` is an HBM copy timed with CUDA
    events; ``overlap_efficiency`` is 0, since one stream runs the simulated
    collectives and the products in series."""
    if name == "DEFAULT_PARAMS":
        with open(PROFILE_FILE) as f:
            params = RooflineParams.from_dict(json.load(f)["params"])
        globals()["DEFAULT_PARAMS"] = params
        return params
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def overlap_time_s(compute_s: float, comm_s: float, params: RooflineParams) -> float:
    """Max-of-terms roofline time for one scheduled slot: the dominant term
    plus the unhidden fraction of the smaller one,

        max(compute_s, comm_s) + (1 - overlap_efficiency) · min(...)
    """
    hi = compute_s if compute_s >= comm_s else comm_s
    lo = compute_s + comm_s - hi
    return hi + (1.0 - params.overlap_efficiency) * lo


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


def collective_time_s(kind: str, group_size: int, in_bytes: float,
                      params: RooflineParams) -> float:
    """Modeled wall time of one collective launch: the fixed launch cost plus
    wire time."""
    return params.collective_launch_s + collective_wire_bytes(
        kind, group_size, in_bytes) / params.ici_bw


def fusion_bucket_bytes(params: RooflineParams) -> float:
    """Bucket-size cap for collective fusion (``core/plan_opt.py``).

    Fusing k members saves (k-1) launch costs but adds one extra HBM round
    trip of the bucket (concatenate before, split after): about 2·B/hbm_bw
    seconds for a B-byte bucket.  The copy stops paying for one saved launch
    at B = collective_launch_s · hbm_bw / 2.  There is no default machine:
    with no ``params`` this raises, as ``PlanCost`` does."""
    if params is None:
        raise ValueError(
            "fusion_bucket_bytes: no machine profile (RooflineParams) to size fusion "
            "buckets with: the port has no default constants; pass profile= to "
            "compile_plan / lower_plan / spmd_partition, or bucket_bytes= to optimize_plan")
    return params.collective_launch_s * params.hbm_bw / 2.0
