"""Architecture registry and shape cases (pure data).

``input_specs`` (abstract model inputs) arrives with the dry-run slice.
``reduced_config`` lives in the JAX package's ``launch/train.py``; the port
keeps it here, where both of its entry points (``launch/serve.py`` and
``launch/train.py``) take it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

from .base import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCase("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCase("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCase("long_500k", 524288, 1, "decode"),
}


def arch_ids() -> Tuple[str, ...]:
    return tuple(ARCHS.keys())


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f".{ARCHS[arch]}", package=__package__)
    return mod.CONFIG


def default_strategy(arch: str) -> str:
    cfg = get_config(arch)
    return "moe_2d" if cfg.moe and cfg.family == "moe" else "2d_finalized"


ARCHS = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "command-r-35b": "command_r_35b",
    "nemotron-4-340b": "nemotron_4_340b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-base": "whisper_base",
    "internvl2-1b": "internvl2_1b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mamba2-130m": "mamba2_130m",
}

# sub-quadratic archs that run long_500k
LONG_CONTEXT_OK = {"jamba-1.5-large-398b", "mamba2-130m"}


def cell_supported(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "full quadratic attention at 524k context — skipped per spec"
    return True, ""


def reduced_config(cfg: ModelConfig, k: int) -> ModelConfig:
    """Divide layers/width/vocab by ~k for small runs (k <= 1: full size)."""
    if k <= 1:
        return cfg
    kw = dict(
        num_layers=max(cfg.num_layers // k, 2),
        d_model=max(cfg.d_model // k, 64),
        d_ff=max(cfg.d_ff // k, 128) if cfg.d_ff else 0,
        vocab_size=max(cfg.vocab_size // k, 512),
        num_heads=max(cfg.num_heads // max(k // 2, 1), 2) if cfg.num_heads else 0,
        attn_chunk=256,
    )
    if cfg.num_kv_heads:
        kw["num_kv_heads"] = min(max(cfg.num_kv_heads // max(k // 2, 1), 1), kw["num_heads"])
        while kw["num_heads"] % kw["num_kv_heads"]:
            kw["num_kv_heads"] -= 1
    if cfg.moe:
        kw["num_experts"] = max(cfg.num_experts // k, 4)
        kw["top_k"] = min(cfg.top_k, kw["num_experts"])
        if cfg.moe_every > 1:  # keep superblock divisibility
            sb = cfg.moe_every
            kw["num_layers"] = max(kw["num_layers"] // sb * sb, sb)
    if cfg.encoder_layers:
        kw["encoder_layers"] = max(cfg.encoder_layers // k, 2)
    if cfg.num_prefix_tokens:
        kw["num_prefix_tokens"] = max(cfg.num_prefix_tokens // k, 4)
    if cfg.family == "hybrid":
        kw["num_layers"] = max((cfg.num_layers // k) // 8 * 8, 8)
    return cfg.with_(**kw)
