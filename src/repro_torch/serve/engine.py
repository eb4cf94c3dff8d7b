"""Batched serving engine: a continuous-batching-lite slot model.

Fixed B decode slots; finished sequences are replaced from the request queue
between decode steps.  The semantics are the JAX package's
``serve/engine.py`` exactly: one shared ``pos`` for all slots, prompts fed
token by token through decode, a refilled slot starting at the current
``pos`` over its previous occupant's cache rows or state (ROADMAP R5), and a
stop at ``max_len - 1``.  Caches start as the reference allocates them:
bfloat16 whatever ``cfg.dtype`` is, except the SSM state ``s`` in float32.
The step's position is a 0-d int32 tensor on the params' device, set from
the host's count before each step (no step waits on the device for it).
With no mesh the dense decode step writes its kv cache in place and the
Mamba2 step returns new state tensors in the reference's dtypes.

Constructed under ``core.compat.set_mesh(mesh)``, the engine runs its decode
step as one SPMD program on that (simulated) mesh, as the reference's jitted
step runs under its mesh: ``models/api.py::partitionable_decode`` (params by
their specs, the token on "data", the cache by ``api.cache_specs``, the
position as data) through ``spmd_partition`` on the params' device, its
plan optimized and verified as the reference's is, priced by
``plan_profile`` (``None``: ``$REPRO_TORCH_MACHINE_PROFILE``, then the
committed H100 profile; ``obs/profile.py::resolve_profile``);
``optimize=False`` keeps the unoptimized (verified) plan.  The plan is
compiled at the first step and serves every later one (``runner.plans``).
The cache stays a global tensor, sharded and gathered by the runner at
each step; the runner is ``engine.runner``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, Strategy
from ..core.compat import get_abstract_mesh
from ..models import api


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, st: Strategy, params, batch_slots: int,
                 max_len: int, rng: Optional[torch.Generator] = None, plan_profile=None,
                 optimize: bool = True):
        self.cfg, self.st, self.params = cfg, st, params
        self.B, self.T = batch_slots, max_len
        self.device = params["embed"]["embedding"].device
        self.mesh = get_abstract_mesh()
        shapes = api.cache_shapes(cfg, st, batch_slots, max_len)
        dtypes = {k: api.cache_dtype(k) for k in shapes}
        if self.mesh is not None and "conv" in dtypes:
            # the step returns its conv buffer in the promotion of the
            # buffer's and the model's dtypes (float32 in a float32 model,
            # as the reference's after its first step): start there, so
            # that every step has one input signature and so one plan
            dtypes["conv"] = torch.promote_types(dtypes["conv"], getattr(torch, cfg.dtype))
        self.cache = {k: torch.zeros(v, dtype=dtypes[k], device=self.device)
                      for k, v in shapes.items()}
        self.pos = 0
        self._pos = torch.zeros((), dtype=torch.int32, device=self.device)
        # Gumbel noise for temperature sampling; torch's generator does not
        # reproduce jax.random's bits
        self.rng = rng if rng is not None else torch.Generator().manual_seed(0)
        self.runner = None
        if self.mesh is not None:
            from ..core.partitioner import spmd_partition

            self.runner = spmd_partition(api.partitionable_decode(cfg, st, self.mesh), self.mesh,
                                         optimize=optimize, verify=True,
                                         profile=plan_profile, device=str(self.device))

    def _decode(self, tokens: np.ndarray):
        token = torch.as_tensor(tokens, device=self.device)
        self._pos.fill_(self.pos)
        if self.runner is not None:
            return self.runner(self.params, token, self.cache, self._pos)
        return api.decode_step(self.cfg, self.st, self.params, token, self.cache, self._pos)

    def _sample(self, logits, temperature):
        logits = logits[:, -1].float().cpu().numpy()
        if temperature <= 0:
            return logits.argmax(-1)
        u = torch.rand(logits.shape, generator=self.rng, dtype=torch.float64)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float64).tiny)))
        return (logits / temperature + g.numpy()).argmax(-1)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Greedy/temperature decoding for up to B requests at a time."""
        queue = list(requests)
        active: List[Optional[Request]] = [None] * self.B
        tokens = np.zeros((self.B, 1), np.int64)
        while queue or any(a is not None for a in active):
            for i in range(self.B):
                if active[i] is None and queue:
                    active[i] = queue.pop(0)
                    active[i]._cursor = 0
            if all(a is None for a in active):
                break
            for i, a in enumerate(active):
                if a is None:
                    continue
                if a._cursor < len(a.prompt):
                    tokens[i, 0] = a.prompt[a._cursor]
                else:
                    tokens[i, 0] = a.out[-1] if a.out else 0
            logits, self.cache = self._decode(tokens)
            nxt = self._sample(logits, max(a.temperature if a else 0 for a in active))
            for i, a in enumerate(active):
                if a is None:
                    continue
                a._cursor += 1
                if a._cursor >= len(a.prompt):
                    a.out.append(int(nxt[i]))
                    if len(a.out) >= a.max_new_tokens:
                        a.done = True
                        active[i] = None
            self.pos += 1
            if self.pos >= self.T - 1:
                break
        return requests
