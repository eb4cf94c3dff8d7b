"""Shared model layers: param declarations, norms, MLPs, embeddings, RoPE and
the layer loop (``stack_layers``, a scan under capture where
``cfg.scan_layers``, ``core/scan.py``).

Layers are plain functions over explicit param trees (nested dicts of
tensors), mirroring the JAX package.  Rounding points follow it exactly:
``rms_norm`` and ``rope`` compute in float32 and round to the activation dtype
once, and every matmul weight and bias is cast to ``cfg.dtype`` at its use
(``at_use``), as the JAX package casts its float32 params.  Training stores
every leaf in ``cfg.param_dtype`` (float32 master weights, which the
optimizer updates); serving may store them in ``cfg.dtype`` once, where the
cast at use is a no-op and gives the same values.  Leaves the JAX package
reads in float32 (norm scales; the SSM's ``A_log``, ``dt_bias`` and ``D``)
are float32 in either case (``dtype="float32"`` in their declaration).
"""
from __future__ import annotations

import collections
import math
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, Strategy
from ..core.scan import scan_or_loop
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


def tree_specs(tree):
    """The partition-spec tree (tuples) of a param-declaration tree."""
    return tree_map_params(lambda p, _path: p["spec"], tree)


def tree_shapes(tree, store: str):
    """Meta tensors of each leaf's shape and stored dtype (``stored_dtype``
    with ``store``): a param tree to capture or price a program with, no
    memory behind it."""
    return tree_map_params(
        lambda p, _path: torch.empty(p["shape"], dtype=stored_dtype(p, store), device="meta"),
        tree)


def annotate_spec(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``t`` annotated by ``spec`` filtered to ``mesh``
    (``configs.base.spec_sharding``): how a program hands the partitioner
    an input's sharding at entry."""
    from ..configs.base import spec_sharding
    from ..core.annotate import annotate

    return annotate(t, spec_sharding(spec, tuple(t.shape), mesh))


def annotate_tree(tree, params, mesh) -> Params:
    """``params`` with every leaf annotated by its declaration's spec in
    ``tree`` (``annotate_spec``)."""

    def leaf(decl, path):
        t = params
        for k in path:
            t = t[k]
        return annotate_spec(t, decl["spec"], mesh)

    return tree_map_params(leaf, tree)


def stored_dtype(decl, store: str) -> torch.dtype:
    """The dtype a leaf is stored in: its declaration's, else ``store``
    (``cfg.param_dtype`` to train, ``cfg.dtype`` to serve)."""
    return getattr(torch, decl["dtype"] or store)


def tree_init(tree, gen: torch.Generator, *, dtype: str, device) -> Params:
    """Materialize params from ``gen`` (a generator on ``device``): normal
    with std 1/sqrt(fan_in), drawn in float32, stored per ``stored_dtype``
    with ``dtype`` as the store dtype."""

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


def at_use(w, cfg: ModelConfig):
    """A weight or bias in the compute dtype (a no-op where it is stored so)."""
    return w.to(getattr(torch, cfg.dtype))


def widen(x):
    """x at the reference's float32 rounding points: float32, or its own
    dtype where that is wider (float64, which a float64 model keeps)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def rms_norm(x, scale, eps=1e-6):
    xf = widen(x)
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * widen(scale)).to(x.dtype)


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
        g = x @ at_use(p["wi_gate"], cfg)
        u = x @ at_use(p["wi_up"], cfg)
        h = silu(g) * u
    else:
        g = x @ at_use(p["wi"], cfg)
        if cfg.mlp == "gelu":
            h = torch.nn.functional.gelu(g, approximate="tanh")
        elif cfg.mlp == "relu2":
            h = torch.relu(g).square()
        else:
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return h @ at_use(p["wo"], cfg)


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
    out = at_use(torch.nn.functional.embedding(tokens, p["embedding"]), cfg)
    return st.constrain(out, "batch", "seq", "embed")


def unembed_logits(cfg: ModelConfig, st: Strategy, p: Params, x):
    """Logits (B,S,V).  Under a mesh the product is vocab-parallel: x whole
    along M and the table split only on its rows (annotations, no-ops with
    no mesh), so the partitioner's einsum gathers x's M and the table's M
    rather than the vocab, and the logits and their gradient stay split on
    the vocab (the reference leaves this choice to XLA)."""
    x = st.constrain(x, "batch", "seq", None)
    emb = st.constrain(at_use(p["embedding"], cfg), "vocab", None)
    logits = x @ emb.t()
    return st.constrain(logits, "batch", "seq", "vocab")


def softmax_xent(cfg: ModelConfig, st: Strategy, logits, labels):
    """Mean cross entropy in float32, padded vocab masked (§4.1)."""
    V = logits.shape[-1]
    logits = widen(logits)
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
    the chunks' sums add up in order, as the JAX package's scan does: the
    chunk loop is ``scan_or_loop`` over the chunks (one scan node under
    capture with ``cfg.scan_layers``)."""
    B, S, M = x.shape
    Q = cfg.xent_chunk
    if S % Q:
        raise ValueError(f"sequence {S} is not a multiple of xent_chunk {Q}")
    V = embedding.shape[0]
    emb = embedding.to(x.dtype)
    consts = (emb,)
    if V > cfg.vocab_size:
        consts += (torch.arange(V, device=x.device) < cfg.vocab_size,)

    def body(total, chunk, emb, *mask):
        xc, lc = chunk
        logits = st.constrain(xc @ emb.t(), "batch", "seq", "vocab")
        if mask:
            logits = torch.where(mask[0], logits, torch.full_like(logits, -1e4))
        mx = logits.amax(dim=-1, keepdim=True).detach()  # the reference's stop_gradient
        z = widen(logits - mx)
        lse = torch.log(torch.exp(z).sum(dim=-1)) + widen(mx[..., 0])
        picked = widen(logits).gather(-1, lc[..., None])[..., 0]
        return total + (lse - picked).sum(), None

    n = S // Q
    chunks = (x.reshape(B, n, Q, M).movedim(1, 0), labels.reshape(B, n, Q).movedim(1, 0))
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    total, _ = scan_or_loop(body, total, chunks, cfg, consts=consts)
    return total / (B * S)


# ---------------------------------------------------------------------------------
# layer stack
# ---------------------------------------------------------------------------------


def layer_slice(params_stacked, i: int) -> Params:
    """Layer ``i`` of a stacked param tree (views, no copy)."""
    if isinstance(params_stacked, dict):
        return {k: layer_slice(v, i) for k, v in params_stacked.items()}
    return params_stacked[i]


# ``checkpoint_dots_with_no_batch_dims``: the products without batch dims,
# the 2-D ``mm``/``addmm`` that projections and MLPs lower to
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


class _SaveDots(TorchDispatchMode):
    """The forward of a "dots" checkpoint: every op runs, and the outputs of
    the products without batch dims are kept, in order."""

    def __init__(self, saved: collections.deque):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _DOTS:
            self.saved.append(out.detach())
        return out


class _ReuseDots(TorchDispatchMode):
    """The recompute of a "dots" checkpoint: every op runs again (attention
    among them) except the kept products, whose outputs it hands back."""

    def __init__(self, saved: collections.deque):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _DOTS:
            return self.saved.popleft()
        return func(*args, **(kwargs or {}))


def _dots_contexts():
    saved = collections.deque()
    return _SaveDots(saved), _ReuseDots(saved)


def stack_layers(layer_fn, params_stacked, x, cfg: ModelConfig, extra=None):
    """Run a stack of identical layers, as the JAX package's ``stack_layers``:
    ``scan_or_loop`` over the layers (one scan node under graph capture with
    ``cfg.scan_layers``, the body one layer; else, and always outside
    capture, a Python loop, the layers' params sliced by one ``unbind`` per
    leaf).  ``params_stacked`` leaves have leading dim L; ``extra`` is every
    layer's loop-invariant input (the positions), the scan's const.  Where
    autograd records, each layer is rematerialized per ``cfg.remat`` as the
    reference's ``jax.checkpoint`` of the body does: "full" recomputes the
    whole layer in the backward, "dots" saves only the products without
    batch dims, "none" saves everything.  Remat changes memory and launches,
    not values.  The layers draw no random numbers, so no generator state
    is saved for the recompute (under graph capture there is no real
    generator to read).  "dots" keeps its products by its own pair of
    dispatch modes (``_SaveDots``, ``_ReuseDots``), which act the same
    eagerly and under graph capture: there the recompute is a second copy
    of the layer's other ops in the graph (its flash forward and
    annotations among them), where ``torch.utils.checkpoint``'s own
    selective policy, seeing a proxy mode, would keep every output and
    leave the recompute to a compiler."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")

    def body(carry, lp, *consts):
        extra = consts[0] if consts else None
        if cfg.remat == "none" or not torch.is_grad_enabled():
            return layer_fn(lp, carry, extra), None
        ctx = {} if cfg.remat == "full" else {"context_fn": _dots_contexts}
        return checkpoint(layer_fn, lp, carry, extra, use_reentrant=False,
                          preserve_rng_state=False, **ctx), None

    x, _ = scan_or_loop(body, x, params_stacked, cfg, consts=() if extra is None else (extra,))
    return x


def stacked(tree, n: int):
    """Stack a param-declaration tree n times along a new leading dim."""

    def mk(p, _path):
        spec = (None,) + tuple(p["spec"]) if p["spec"] is not None else (None,)
        return {**p, "shape": (n,) + p["shape"], "spec": spec}

    return tree_map_params(mk, tree)
