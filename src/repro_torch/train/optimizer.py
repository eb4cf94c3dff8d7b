"""Optimizers (port of the JAX package's ``train/optimizer.py``).

Adafactor (Shazeer & Stern) is the paper's optimizer (§5.1); AdamW and SGD
serve the smaller examples.  Every update is float32 math on the float32
master weights, leaf by leaf, as in the reference.  Where the reference
returns new params and state (and donates the old ones to ``jit``), the
port updates both in place under ``torch.no_grad()`` and returns them.

``opt_state_specs`` (the optimizer state's partition specs) arrives with the
sharded strategies (ROADMAP A6, sharded).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.tree import leaves_with_paths, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable    # params -> state
    update: Callable  # (grads, state, params, step) -> (params, state), in place


def _rms(x):
    return torch.sqrt(x.square().mean() + 1e-30)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _step_t(step: int, device) -> torch.Tensor:
    """step + 1 as a float32 scalar, as the reference computes it."""
    return torch.tensor(float(step), dtype=torch.float32, device=device) + 1.0


# ---------------------------------------------------------------------------------
# Adafactor (factored second moments for >=2D params)
# ---------------------------------------------------------------------------------


def make_adafactor(
    lr: float = 1e-2,
    min_dim_factored: int = 2,
    decay_pow: float = 0.8,
    clip_threshold: float = 1.0,
    eps: float = 1e-30,
    weight_decay: float = 0.0,
) -> Optimizer:
    def factored(shape) -> bool:
        return len(shape) >= min_dim_factored and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        def mk(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if factored(p.shape):
                return {"vr": z(p.shape[:-1]), "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        return {"mu": tree_map(mk, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        for path, g in leaves_with_paths(grads):
            s, p = _at(state["mu"], path), _at(params, path)
            beta2 = 1.0 - _step_t(step, g.device) ** (-decay_pow)
            g = g.float()
            g2 = g.square() + eps
            if factored(p.shape):
                vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = (vr[..., None]
                         / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)[..., None]
                         ) * vc[..., None, :]
                u = g * torch.rsqrt(denom + eps)
                s["vr"].copy_(vr)
                s["vc"].copy_(vc)
            else:
                v = beta2 * s["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(v + eps)
                s["v"].copy_(v)
            u = u / torch.clamp_min(_rms(u) / clip_threshold, 1.0)
            pf = p.float()
            newp = pf - lr * torch.clamp_min(_rms(pf), 1e-3) * u
            if weight_decay:
                newp = newp - lr * weight_decay * pf
            p.copy_(newp.to(p.dtype))
        return params, state

    return Optimizer("adafactor", init, update)


# ---------------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------------


def make_adamw(
    lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        for path, g in leaves_with_paths(grads):
            m, v, p = _at(state["m"], path), _at(state["v"], path), _at(params, path)
            t = _step_t(step, g.device)
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g.square())
            mh = m / (1 - b1 ** t)
            vh = v / (1 - b2 ** t)
            pf = p.float()
            p.copy_((pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)).to(p.dtype))
        return params, state

    return Optimizer("adamw", init, update)


def make_sgd(lr: float = 0.1, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if not momentum:
            return {}
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        for path, g in leaves_with_paths(grads):
            p = _at(params, path)
            if momentum:
                m = _at(state["m"], path)
                m.copy_(momentum * m + g.float())
                g = m
            p.copy_((p.float() - lr * g.float()).to(p.dtype))
        return params, state

    return Optimizer("sgd", init, update)


OPTIMIZERS = {"adafactor": make_adafactor, "adamw": make_adamw, "sgd": make_sgd}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)
