"""Elastic meshes, the restore-target half (a partial port of the JAX
package's ``launch/elastic.py``).

Surviving a device loss in GSPMD is "re-derive the mesh, re-solve the
annotations, reshard the state".  This module holds what a cross-mesh
restore needs today:

* :func:`derive_mesh`: the largest ``("data", "model")`` mesh over a number
  of devices (the port's simulated ``Mesh``; there is no separate runtime
  mesh);
* :func:`state_partition_specs`: the partition-spec tree of the train
  loop's state (params by their declared specs, the optimizer state
  sharded like the params, the step replicated), the target layout of a
  restore and the layout ``train/loop.py`` records in its manifests;
* :func:`specs_by_key`: that tree flattened to the checkpoint's leaf keys.

The recovery loop itself (``ElasticCoordinator``), the fault schedules of
``FaultInjector``, the ``DeviceLossError`` / ``DeviceReturnError`` errors
and ``sharding_problem`` are ROADMAP A14b: the coordinator re-solves the
assignment through ``repro_torch.autoshard`` (``solve_problem``
warm-started from its last dump by ``remap_assignment`` /
``expand_assignment``), and every fault and recovery it handles is an
``obs`` control event and counter (``repro_torch/obs``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.sharding import Mesh


def derive_mesh(n_devices: int, model_parallel: Optional[int] = None) -> Mesh:
    """The largest ``(data, model)`` mesh over ``n_devices`` devices.

    ``model_parallel`` (default ``min(16, n_devices)``) is clamped to the
    largest divisor of ``n_devices`` not above it, so a world that lost a
    device still derives a mesh.
    """
    n = int(n_devices)
    mp = min(model_parallel or min(16, n), n)
    while n % mp:
        mp -= 1
    return Mesh.create((n // mp, mp), ("data", "model"))


def state_partition_specs(cfg, st, opt, tc) -> Dict[str, Any]:
    """Partition-spec tree (tuples) shaped like the train loop's state:
    params by their declared specs, the optimizer state sharded like the
    params (``opt_state_specs``), the step replicated, and the error
    feedback like the params when ``tc.compress_grads``."""
    from ..models import api
    from ..models.layers import tree_shapes, tree_specs
    from ..train.optimizer import opt_state_specs
    from ..core.tree import tree_map

    tree = api.param_tree(cfg, st)
    pspecs = tree_specs(tree)
    ospecs = opt_state_specs(opt, pspecs, tree_shapes(tree, cfg.param_dtype))
    fill = lambda t: tree_map(lambda s: () if s is None else tuple(s), t)
    spec_state = {"params": fill(pspecs), "opt": fill(ospecs), "step": ()}
    if tc.compress_grads:
        spec_state["ef"] = fill(pspecs)
    return spec_state


def specs_by_key(spec_state) -> Dict[str, Any]:
    """A spec tree flattened to the checkpoint's ``/``-joined leaf keys."""
    from ..train.checkpoint import _flatten_with_paths

    return dict(_flatten_with_paths(spec_state))
