"""Mesh constructors.

``make_production_mesh`` is a FUNCTION (not a module constant).  Single pod:
(16,16) ("data","model") = 256 devices; multi-pod: (2,16,16)
("pod","data","model") = 512.  These are logical meshes: the partitioner
simulates them on one card (``core/mesh_runtime.py``).
"""
from __future__ import annotations

from repro_torch.core.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh.create(shape, axes)


def make_test_mesh(shape=(2, 4), axes=("data", "model")) -> Mesh:
    """Small mesh for partitioner tests."""
    return Mesh.create(shape, axes)
