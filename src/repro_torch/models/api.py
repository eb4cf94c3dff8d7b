"""Family dispatch: one uniform interface over the model families.

Every family exposes:
  param_tree(cfg, st)                          declarative param tree
  forward(cfg, st, params, tokens)             logits (B,S,V)
  loss_fn(cfg, st, params, batch)              scalar loss of a batch
  decode_step(cfg, st, params, token, cache, pos) -> (logits, cache)
  cache_shapes(cfg, st, batch, max_len)        dict of cache array shapes

The port has the dense and ssm families so far; the others raise and name
the ROADMAP item that brings them.
"""
from __future__ import annotations

from typing import Dict

from ..configs.base import ModelConfig, Strategy
from . import ssm_lm, transformer

_PENDING = {
    "moe": "A12",
    "hybrid": "A12",
    "encdec": "A12",
    "vlm": "A12",
}


def family_module(cfg: ModelConfig):
    if cfg.family == "dense":
        return transformer
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP {_PENDING[cfg.family]})")
    raise KeyError(cfg.family)


def param_tree(cfg: ModelConfig, st: Strategy):
    return family_module(cfg).param_tree(cfg, st)


def forward(cfg: ModelConfig, st: Strategy, params, tokens):
    """Logits (B,S,V); the dense family's aux loss (0 without MoE) is dropped."""
    if cfg.family == "dense":
        return transformer.forward(cfg, st, params, tokens)[0]
    return family_module(cfg).forward(cfg, st, params, tokens)


def loss_fn(cfg: ModelConfig, st: Strategy, params, batch):
    """batch {"tokens": (B,S), "labels": (B,S)} -> scalar float32 loss."""
    return family_module(cfg).loss_fn(cfg, st, params, batch)


def decode_step(cfg: ModelConfig, st: Strategy, params, token, cache, pos: int):
    return family_module(cfg).decode_step(cfg, st, params, token, cache, pos)


def cache_shapes(cfg: ModelConfig, st: Strategy, batch: int, max_len: int) -> Dict[str, tuple]:
    return family_module(cfg).cache_shapes(cfg, st, batch, max_len)
