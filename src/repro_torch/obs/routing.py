"""MoE routing, observed: each MoE layer's router logits and top-k experts
recorded as a run takes them, a run made to take another run's experts, and
the flips between two runs' routing.

Routing is a discontinuous function of the router logits: two runs of the
same model whose activations differ by rounding (a kernel against its plain
version, a partitioned program against the unsharded one) pick another
expert wherever a token's k-th and (k+1)-th logits lie closer than that
difference, and a flip moves the capacity slots of every later token of
both experts.  So two runs are compared by their routing first: the flips
are counted and each must be sound (its margin within the logits' own
change), and values are held where the routing agrees, or with one run's
routing forced on the other (``RoutingSpy(record, forced=)``).
"""
from __future__ import annotations

from typing import Dict

import torch


class RoutingSpy:
    """Within it, ``models/moe.py::route`` appends each call's router logits
    (float32, (B, S, E)) and top-k experts ((B, S, K)) to ``record``, in call
    order (under graph capture, as graph values).  With ``forced`` (L
    calls' expert ids, (L, B, S, K)) call i takes ``forced[i]`` instead of
    its own top-k, their probabilities gathered from its own softmax and
    renormalised as ``route`` does: the same program with another run's
    routing, its gradients flowing as through the top-k."""

    def __init__(self, record: list, forced=None):
        self.record, self.forced = record, forced

    def __enter__(self):
        from ..models import moe

        self._moe, self._route = moe, moe.route

        def spy(cfg, p, x):
            gates, probs, top_p, top_e = self._route(cfg, p, x)
            if self.forced is not None:
                top_e = self.forced[len(self.record)].reshape(top_e.shape)
                top_p = probs.gather(-1, top_e)
                top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
            self.record.append((gates.detach(), top_e))
            return gates, probs, top_p, top_e

        moe.route = spy
        return self.record

    def __exit__(self, *exc):
        self._moe.route = self._route


def stacked(record: list):
    """A record's router logits (L, B, S, E) and experts (L, B, S, K)."""
    return (torch.stack([g for g, _ in record]), torch.stack([e for _, e in record]))


def with_routing(program, forced=None):
    """``program`` returning also its MoE layers' routing: ``(out, logits
    (L,B,S,E), experts (L,B,S,K))``, so that a captured program (the
    partitioner's) hands it back."""
    def fn(*args):
        record = []
        with RoutingSpy(record, forced):
            out = program(*args)
        return (out, *stacked(record))

    return fn


def routing_flips(logits_a, experts_a, logits_b, experts_b) -> Dict:
    """Two runs' routing, call by call ((L, B, S, E) router logits and (L,
    B, S, K) experts): the tokens whose top-k sets differ, per call; the
    smallest top-k margin among them (run a's gap between its k-th and
    (k+1)-th logits); the largest margin over twice the token's largest
    logit change (a flip is sound where it is at most 1: no gap wider than
    that can close); and, per batch row, the first position whose routing
    differs in any call (S where none does: with routing groups of rows,
    the slots and causal attention look back only, so the prefix before it
    is untouched by any flip)."""
    K = experts_a.shape[-1]
    differs = (experts_a.sort(-1).values != experts_b.sort(-1).values).any(-1)  # (L,B,S)
    top = logits_a.topk(min(K + 1, logits_a.shape[-1]), dim=-1).values  # K = E: no flip
    margin = top[..., K - 1] - top[..., -1]
    own = 2 * (logits_a - logits_b).abs().amax(-1)
    S = differs.shape[-1]
    pos = torch.arange(S, device=differs.device).expand_as(differs)
    first = torch.where(differs, pos, torch.full_like(pos, S)).amin(-1).amin(0)  # (B,)
    flips = int(differs.sum())
    return {"flips": flips, "per_call": differs.sum((1, 2)).tolist(),
            "tokens": differs.shape[1] * S,
            "min_margin": margin[differs].min().item() if flips else None,
            "max_margin_over_own_diff": (margin[differs] / own[differs].clamp_min(1e-30))
            .max().item() if flips else 0.0,
            "max_logit_diff": (logits_a - logits_b).abs().max().item(),
            "first_flip_per_row": first.tolist()}
