"""Optimizers (port of the JAX package's ``train/optimizer.py``).

Adafactor (Shazeer & Stern) is the paper's optimizer (§5.1); AdamW and SGD
serve the smaller examples.  Every update is float32 math on the float32
master weights, leaf by leaf, as in the reference.  Each optimizer's
per-leaf arithmetic is one pure function (``leaf_update``: gradient, the
leaf's state, the param and the step as a float32 tensor -> new param and
new state).  ``apply`` returns new params and state, as the reference's
``update`` does (the partitioned train step runs it); ``update`` writes the
same results into the params and state in place under ``torch.no_grad()``
(the eager step, where the reference donates its buffers to ``jit``).
``state_spec`` / ``opt_state_specs`` give the state's partition specs:
sharded like the params, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..core.tree import leaves_with_paths, tree_from_paths, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable         # params -> state
    leaf_update: Callable  # (g, leaf state, p, t) -> (new p, new leaf state); pure
    state_spec: Callable   # (param spec, param shape) -> the leaf state's specs

    def apply(self, grads, state, params, step):
        """(new params, new state): pure; ``step`` a 0-d tensor."""
        t = step.to(torch.float32) + 1.0
        out = [(path, self.leaf_update(g, _leaf_state(state, path), _at(params, path), t))
               for path, g in leaves_with_paths(grads)]
        return (tree_from_paths((path, p) for path, (p, _) in out),
                _state_from(state, [(path, s) for path, (_, s) in out]))

    @torch.no_grad()
    def update(self, grads, state, params, step: int):
        """``apply``'s results written into ``params`` and ``state``; returns
        them."""
        for path, g in leaves_with_paths(grads):
            s, p = _leaf_state(state, path), _at(params, path)
            newp, news = self.leaf_update(g, s, p, _step_t(step, g.device))
            for k, v in news.items():
                s[k].copy_(v)
            p.copy_(newp)
        return params, state


def _rms(x):
    return torch.sqrt(x.square().mean() + 1e-30)


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaf_state(state, path) -> dict:
    """One leaf's state: Adafactor keeps a tree of per-leaf dicts under
    "mu"; the others a tree per state key."""
    if "mu" in state:
        return _at(state["mu"], path)
    return {k: _at(tree, path) for k, tree in state.items()}


def _state_from(state, pairs) -> dict:
    """The state tree (shaped like ``state``) of per-leaf (path, state) pairs."""
    if "mu" in state:
        return {"mu": tree_from_paths(pairs)}
    return {k: tree_from_paths((path, s[k]) for path, s in pairs) for k in state}


def _step_t(step: int, device) -> torch.Tensor:
    """step + 1 as a float32 scalar, as the reference computes it."""
    return torch.tensor(float(step), dtype=torch.float32, device=device) + 1.0


def _pad(spec, shape) -> list:
    return list(spec) + [None] * (len(shape) - len(spec))


def _trim(entries) -> tuple:
    entries = list(entries)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


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

    def leaf_update(g, s, p, t):
        beta2 = 1.0 - t ** (-decay_pow)
        g = g.float()
        g2 = g.square() + eps
        if factored(p.shape):
            vr = beta2 * s["vr"] + (1 - beta2) * g2.mean(dim=-1)
            vc = beta2 * s["vc"] + (1 - beta2) * g2.mean(dim=-2)
            denom = (vr[..., None]
                     / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps)[..., None]
                     ) * vc[..., None, :]
            u = g * torch.rsqrt(denom + eps)
            ns = {"vr": vr, "vc": vc}
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(v + eps)
            ns = {"v": v}
        u = u / torch.clamp_min(_rms(u) / clip_threshold, 1.0)
        pf = p.float()
        newp = pf - lr * torch.clamp_min(_rms(pf), 1e-3) * u
        if weight_decay:
            newp = newp - lr * weight_decay * pf
        return newp.to(p.dtype), ns

    def state_spec(spec, shape):
        e = _pad(spec, shape)
        if factored(shape):
            return {"vr": _trim(e[:-1]), "vc": _trim(e[:-2] + e[-1:])}
        return {"v": _trim(e)}

    return Optimizer("adafactor", init, leaf_update, state_spec)


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

    def leaf_update(g, s, p, t):
        g = g.float()
        m = b1 * s["m"] + (1 - b1) * g
        v = b2 * s["v"] + (1 - b2) * g.square()
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        pf = p.float()
        return (pf - lr * (mh / (torch.sqrt(vh) + eps) + weight_decay * pf)).to(p.dtype), \
            {"m": m, "v": v}

    def state_spec(spec, shape):
        return {"m": _trim(spec), "v": _trim(spec)}

    return Optimizer("adamw", init, leaf_update, state_spec)


def make_sgd(lr: float = 0.1, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if not momentum:
            return {}
        return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)}

    def leaf_update(g, s, p, t):
        if momentum:
            m = momentum * s["m"] + g.float()
            return (p.float() - lr * m).to(p.dtype), {"m": m}
        return (p.float() - lr * g.float()).to(p.dtype), {}

    def state_spec(spec, shape):
        return {"m": _trim(spec)} if momentum else {}

    return Optimizer("sgd", init, leaf_update, state_spec)


OPTIMIZERS = {"adafactor": make_adafactor, "adamw": make_adamw, "sgd": make_sgd}


def get_optimizer(name: str, **kw) -> Optimizer:
    return OPTIMIZERS[name](**kw)


def opt_state_specs(opt: Optimizer, param_specs, param_shapes):
    """The optimizer state's partition-spec tree (tuples), sharded like the
    params: ``param_specs`` a spec tree (``models.layers.tree_specs``),
    ``param_shapes`` a tree of shapes or tensors of the same structure."""
    per_leaf = [(path, opt.state_spec(spec, tuple(getattr(_at(param_shapes, path), "shape",
                                                          _at(param_shapes, path)))))
                for path, spec in leaves_with_paths(param_specs)]
    if opt.name == "adafactor":
        return {"mu": tree_from_paths(per_leaf)}
    keys = {k for _, s in per_leaf for k in s}
    return {k: tree_from_paths((path, s[k]) for path, s in per_leaf) for k in sorted(keys)}
