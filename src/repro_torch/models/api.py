"""Family dispatch: one uniform interface over the model families.

Every family exposes:
  param_tree(cfg, st)                          declarative param tree
  decode_step(cfg, st, params, token, cache, pos) -> (logits, cache)
  cache_shapes(cfg, st, batch, max_len)        dict of cache array shapes

The port has the dense family so far; the others raise and name the ROADMAP
item that brings them.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, Strategy
from . import attention as attn_mod
from . import transformer

_PENDING = {
    "moe": "A12",
    "hybrid": "A12",
    "ssm": "A8",
    "encdec": "A12",
    "vlm": "A12",
}


def family_module(cfg: ModelConfig):
    if cfg.family == "dense":
        return transformer
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP {_PENDING[cfg.family]})")
    raise KeyError(cfg.family)


def param_tree(cfg: ModelConfig, st: Strategy):
    return family_module(cfg).param_tree(cfg, st)


def forward(cfg: ModelConfig, st: Strategy, params, tokens):
    return family_module(cfg).forward(cfg, st, params, tokens)


def decode_step(cfg: ModelConfig, st: Strategy, params, token, cache, pos: int):
    return family_module(cfg).decode_step(cfg, st, params, token, cache, pos)


def cache_shapes(cfg: ModelConfig, st: Strategy, batch: int, max_len: int) -> Dict[str, tuple]:
    family_module(cfg)
    shape = attn_mod.init_cache_shapes(cfg, st, batch, max_len)
    return {"k": shape, "v": shape}
