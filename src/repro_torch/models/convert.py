"""Carry weights across from the JAX package.

``params_from_numpy`` takes the JAX package's param tree (nested dicts whose
leaves are numpy arrays, layer leaves stacked along a leading L dim) and
returns the port's params on ``device``.  Names map one to one, for every
ported family (the MoE family's router, its experts with their leading E
dim and superblock keys ``"0".."sb-1"`` among them); each leaf is stored
in the dtype its declaration gives
(``layers.stored_dtype``): ``dtype`` (``cfg.dtype`` by default, as serving
stores them; ``cfg.param_dtype`` for training's float32 master weights), or
float32 for the leaves the reference reads in float32 (norm scales, the MoE
router, Mamba2's ``A_log``, ``dt_bias``, ``D`` and ``norm``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import STRATEGY_2D_FINALIZED, ModelConfig, Strategy
from . import api
from .layers import Params, stored_dtype, tree_map_params


def params_from_numpy(np_tree, cfg: ModelConfig, device,
                      st: Strategy = STRATEGY_2D_FINALIZED,
                      dtype: Optional[str] = None) -> Params:
    """With no mesh, param shapes do not depend on the strategy."""
    store = dtype or cfg.dtype

    def leaf(decl, path):
        node = np_tree
        for key in path:
            if key not in node:
                raise KeyError(f"reference params lack {'/'.join(path)}")
            node = node[key]
        arr = np.array(node, dtype=np.float32)  # a writable copy
        if arr.shape != decl["shape"]:
            raise ValueError(
                f"{'/'.join(path)}: reference shape {arr.shape} != {decl['shape']}")
        return torch.from_numpy(arr).to(device=device, dtype=stored_dtype(decl, store))

    out = tree_map_params(leaf, api.param_tree(cfg, st))
    extra = _leaf_paths(np_tree) - _leaf_paths(out)
    if extra:
        raise KeyError(f"reference params the port does not declare: {sorted(extra)}")
    return out


def _leaf_paths(tree, path=()):
    if not isinstance(tree, dict):
        return {"/".join(path)}
    return set().union(*(_leaf_paths(v, path + (k,)) for k, v in tree.items()))
