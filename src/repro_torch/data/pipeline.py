"""Deterministic, resumable data pipeline (port of the JAX package's
``data/pipeline.py``).

Batches are a pure function of (seed, step, process index), so a run that
skips to step N sees exactly the batches an uninterrupted run would have.
The ``arithmetic`` pattern and the file-backed variant (a memory-mapped
int32 token file) are numpy in the reference and give the same batches
here.  The ``uniform`` pattern draws from numpy's ``Generator`` keyed on
(seed, step, process index) where the reference draws with ``jax.random``
(threefry), which the port does not emulate: the same distribution and
determinism, not the same tokens (ROADMAP Queue C).  Per-host sharding: each
process materializes only its slice of the global batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: Optional[str] = None  # file-backed when set
    pattern: str = "uniform"    # uniform | arithmetic (learnable: t+1 = t+step)


class TokenPipeline:
    def __init__(self, cfg: DataConfig, process_index: int = 0, process_count: int = 1):
        if cfg.global_batch % process_count:
            raise ValueError(f"global batch {cfg.global_batch} is not a multiple of "
                             f"{process_count} processes")
        if cfg.pattern not in ("uniform", "arithmetic"):
            raise ValueError(f"unknown data pattern {cfg.pattern!r}")
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=np.int32, mode="r")

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The batch for global step ``step`` (deterministic)."""
        c = self.cfg
        B, S = self.local_batch, c.seq_len
        row0 = step * c.global_batch + self.process_index * B
        if self._mm is not None:
            need = B * (S + 1)
            start = (row0 * (S + 1)) % max(len(self._mm) - need, 1)
            toks = np.asarray(self._mm[start:start + need]).reshape(B, S + 1)
        elif c.pattern == "arithmetic":
            # fully learnable: token[t+1] = (token[t] + stride) mod V
            rng = np.random.default_rng(c.seed + step * 1000 + self.process_index)
            start = rng.integers(0, c.vocab_size, (B, 1))
            stride = rng.integers(1, 17, (B, 1))
            toks = ((start + stride * np.arange(S + 1)) % c.vocab_size).astype(np.int32)
        else:
            rng = np.random.default_rng([c.seed, step, self.process_index])
            toks = rng.integers(0, c.vocab_size, (B, S + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
