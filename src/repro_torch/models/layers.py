"""Shared model layers: param declarations, norms, MLPs, embeddings, RoPE and
the layer loop.

Layers are plain functions over explicit param trees (nested dicts of
tensors), mirroring the JAX package.  Rounding points follow it exactly:
``rms_norm`` and ``rope`` compute in float32 and round to the activation dtype
once, and every matmul weight and bias is used in ``cfg.dtype``.  The JAX
package casts those f32 params to ``cfg.dtype`` at every use; the port stores
them in ``cfg.dtype`` once, which gives the same values.  Leaves the JAX
package reads in float32 (norm scales; the SSM's ``A_log``, ``dt_bias`` and
``D``) stay float32 (``dtype="float32"`` in their declaration).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from ..configs.base import ModelConfig, Strategy
from ..core.sharding import pad_to_multiple

Params = Dict[str, Any]


# ---------------------------------------------------------------------------------
# param declaration helpers
# ---------------------------------------------------------------------------------


def pspec(shape, spec, init="normal", fan_in=None, dtype=None):
    """Declarative param: shape, logical partition spec (a tuple), init kind
    and fan-in.  ``dtype=None`` stores the param in the compute dtype; leaves
    read in float32 pass ``"float32"``."""
    return {
        "__param__": True,
        "shape": tuple(shape),
        "spec": spec,
        "init": init,
        "fan_in": fan_in,
        "dtype": dtype,
    }


def is_param(x) -> bool:
    return isinstance(x, dict) and x.get("__param__") is True


def tree_map_params(fn: Callable, tree, path=()):
    """Apply ``fn(decl, path)`` to every param declaration of ``tree``."""
    if is_param(tree):
        return fn(tree, path)
    return {k: tree_map_params(fn, v, path + (k,)) for k, v in tree.items()}


def stored_dtype(decl, cfg_dtype: str) -> torch.dtype:
    return getattr(torch, decl["dtype"] or cfg_dtype)


def tree_init(tree, gen: torch.Generator, *, dtype: str, device) -> Params:
    """Materialize params from ``gen`` (a generator on ``device``): normal
    with std 1/sqrt(fan_in), drawn in float32, stored per ``stored_dtype``."""

    def mk(p, _path):
        shape, out = p["shape"], stored_dtype(p, dtype)
        if p["init"] == "zeros":
            return torch.zeros(shape, dtype=out, device=device)
        if p["init"] == "ones":
            return torch.ones(shape, dtype=out, device=device)
        fan_in = p["fan_in"] or (shape[0] if shape else 1)
        std = 1.0 / math.sqrt(max(fan_in, 1))
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
        return (x * std).to(out)

    return tree_map_params(mk, tree)


# ---------------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------------


def rms_norm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope(q, positions, dh, base=10000.0):
    """Rotary embedding on the last dim; positions (B, S)."""
    half = dh // 2
    freqs = torch.exp(
        -math.log(base)
        * torch.arange(0, half, dtype=torch.float32, device=q.device) / half
    )
    ang = positions[..., None].float() * freqs  # (B,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.ndim < q.ndim:
        cos, sin = cos.unsqueeze(-2), sin.unsqueeze(-2)
    q1, q2 = q[..., :half], q[..., half:]
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return out.to(q.dtype)


def mlp_params(cfg: ModelConfig, st: Strategy, d_ff: int = 0):
    d_ff = d_ff or cfg.d_ff
    M = cfg.d_model
    if cfg.mlp == "swiglu":
        return {
            "wi_gate": pspec((M, d_ff), st.w("embed", "mlp"), fan_in=M),
            "wi_up": pspec((M, d_ff), st.w("embed", "mlp"), fan_in=M),
            "wo": pspec((d_ff, M), st.w("mlp", "embed"), fan_in=d_ff),
        }
    return {
        "wi": pspec((M, d_ff), st.w("embed", "mlp"), fan_in=M),
        "wo": pspec((d_ff, M), st.w("mlp", "embed"), fan_in=d_ff),
    }


def silu(x):
    """``jax.nn.silu`` as XLA's CPU expansion computes it: x * sigmoid(x) with
    the logistic expanded as 1 / (1 + exp(-x)), rounded to x's dtype after
    every op."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp_forward(cfg: ModelConfig, st: Strategy, p: Params, x):
    """x: (..., M) activations in compute dtype."""
    if "wi_gate" in p:
        g = x @ p["wi_gate"]
        u = x @ p["wi_up"]
        h = silu(g) * u
    else:
        g = x @ p["wi"]
        if cfg.mlp == "gelu":
            h = torch.nn.functional.gelu(g, approximate="tanh")
        elif cfg.mlp == "relu2":
            h = torch.relu(g).square()
        else:
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return h @ p["wo"]


# ---------------------------------------------------------------------------------
# embedding / unembedding with padded vocab (paper §4.1 pad-and-mask)
# ---------------------------------------------------------------------------------


def padded_vocab(cfg: ModelConfig, st: Strategy) -> int:
    tp = st.axis_size("vocab", "weight")
    return pad_to_multiple(cfg.vocab_size, max(tp, 1))


def embed_params(cfg: ModelConfig, st: Strategy):
    V = padded_vocab(cfg, st)
    return {
        "embedding": pspec((V, cfg.d_model), st.w("vocab", "embed"), fan_in=cfg.d_model),
    }


def embed_lookup(cfg: ModelConfig, st: Strategy, p: Params, tokens):
    out = torch.nn.functional.embedding(tokens, p["embedding"])
    return st.constrain(out, "batch", "seq", "embed")


def unembed_logits(cfg: ModelConfig, st: Strategy, p: Params, x):
    logits = x @ p["embedding"].t()
    return st.constrain(logits, "batch", "seq", "vocab")


def softmax_xent(cfg: ModelConfig, st: Strategy, logits, labels):
    """Mean cross entropy in float32, padded vocab masked (§4.1)."""
    V = logits.shape[-1]
    logits = logits.float()
    if V > cfg.vocab_size:
        mask = torch.arange(V, device=logits.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    return (lse - picked).mean()


def streamed_xent(cfg: ModelConfig, st: Strategy, x, embedding, labels):
    """The loss per chunk of ``cfg.xent_chunk`` positions, with logits in the
    compute dtype: the (B,S,V) float32 logits never exist at once.  The
    max-subtracted log-sum-exp is float32 over the compute-dtype logits, and
    the chunks' sums add up in order, as the JAX package's scan does."""
    B, S, M = x.shape
    Q = cfg.xent_chunk
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of xent_chunk {Q}")
    V = embedding.shape[0]
    mask = (torch.arange(V, device=x.device) < cfg.vocab_size) if V > cfg.vocab_size else None
    emb = embedding.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for n in range(S // Q):
        xc, lc = x[:, n * Q:(n + 1) * Q], labels[:, n * Q:(n + 1) * Q]
        logits = st.constrain(xc @ emb.t(), "batch", "seq", "vocab")
        if mask is not None:
            logits = torch.where(mask, logits, torch.full_like(logits, -1e4))
        mx = logits.amax(dim=-1, keepdim=True)
        z = (logits - mx).float()
        lse = torch.log(torch.exp(z).sum(dim=-1)) + mx[..., 0].float()
        picked = logits.float().gather(-1, lc[..., None])[..., 0]
        total = total + (lse - picked).sum()
    return total / (B * S)


# ---------------------------------------------------------------------------------
# layer stack
# ---------------------------------------------------------------------------------


def layer_slice(params_stacked, i: int) -> Params:
    """Layer ``i`` of a stacked param tree (views, no copy)."""
    if isinstance(params_stacked, dict):
        return {k: layer_slice(v, i) for k, v in params_stacked.items()}
    return params_stacked[i]


def num_stacked(params_stacked) -> int:
    while isinstance(params_stacked, dict):
        params_stacked = next(iter(params_stacked.values()))
    return params_stacked.shape[0]


def stack_layers(layer_fn, params_stacked, x, cfg: ModelConfig, extra=None):
    """Run a stack of identical layers as a Python loop (the JAX package's
    ``scan_layers=False`` semantics; serving needs no remat).
    ``params_stacked`` leaves have leading dim L."""
    for i in range(num_stacked(params_stacked)):
        x = layer_fn(layer_slice(params_stacked, i), x, extra)
    return x


def stacked(tree, n: int):
    """Stack a param-declaration tree n times along a new leading dim."""

    def mk(p, _path):
        spec = (None,) + tuple(p["spec"]) if p["spec"] is not None else (None,)
        return {**p, "shape": (n,) + p["shape"], "spec": spec}

    return tree_map_params(mk, tree)
