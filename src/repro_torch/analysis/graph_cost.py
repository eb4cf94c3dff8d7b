"""Analytic FLOP counting over a captured aten graph: the counterpart of the
JAX package's ``analysis/jaxpr_cost.py::count_flops``.

Products (``mm``, ``bmm``, ``addmm``) and convolutions are counted exactly;
elementwise arithmetic at 1 flop per output element; reductions at 1 flop
per input element; the flash-attention operators at 4·B·H·S·T·D (the
forward's two products; ``flash_attention``, ``flash_decode`` and
``flash_attention_fwd``) and 2.5 times that (the backward's five), halved for
a causal mask; the SSD scan as ``ssd_flops`` counts it, its gradient as
``ssd_bwd_flops``; the MoE routing ops that work along one dim (softmax and
its gradient, topk, sort, scatter, searchsorted; ``rules.ALONG_DIM``) at 1
flop per element of their (first) result, as the elementwise ops; a scan
node (``core/scan.py``) as its body's at trip count.  Data movement (views,
permutes, copies, casts) counts nothing.  ``core/plan.py::plan_cost``
divides the total by the mesh size for the ideal per-device balance point.

The graph spells some ops otherwise than a jaxpr: ``addmm`` holds its bias
add (the reference counts a separate ``add``), a convolution its bias, and
``aten.mean`` is one reduction (the reference's ``mean`` is a sum and a
divide).
"""
from __future__ import annotations

import numpy as np
import torch.fx

from ..core.rules import (ALONG_DIM, FLASH, FLASH_BWD, FLASH_DECODE, FLASH_FWD, REDUCE, SCANS, SSD,
                          SSD_BWD, lower)

ELEMENTWISE_1FLOP = {"aten." + n for n in (
    "add", "sub", "rsub", "mul", "div", "maximum", "minimum", "neg", "abs", "exp", "log",
    "tanh", "sigmoid", "rsqrt", "sqrt", "where", "pow", "erf", "sin", "cos", "sign",
    "floor", "ceil", "round", "square", "relu", "reciprocal", "clamp_min", "clamp_max")}


def _nelems(shape) -> float:
    return float(np.prod(shape)) if shape else 1.0


def eqn_flops(eqn) -> float:
    """FLOPs of one equation on global shapes."""
    name = eqn.name
    if name in (FLASH_FWD, FLASH_BWD):
        B, S, KR, Gl, D = eqn.in_avals[0].shape
        f = flash_bwd_flops if name == FLASH_BWD else flash_flops
        return f(B, S, KR * Gl, eqn.in_avals[1].shape[1], D, eqn.params["causal"])
    if name == SSD_BWD:
        Bb, S, H, hd = eqn.in_avals[0].shape
        return ssd_bwd_flops(Bb, S, H, hd, eqn.in_avals[2].shape[-1], eqn.params["chunk"])
    if name in SCANS:
        return eqn.params["length"] * count_flops(eqn.params["body"].graph)
    if name in ALONG_DIM:
        return _nelems((eqn.out_avals or eqn.tuple_avals)[0].shape)
    if not eqn.out_avals:
        return 0.0
    out = eqn.out_avals[0].shape
    if name in ("aten.mm", "aten.bmm", "aten.addmm"):
        (lc, _), _ = eqn.params["dimension_numbers"]
        k = _nelems([eqn.in_avals[-2].shape[c] for c in lc])
        bias = _nelems(out) if name == "aten.addmm" else 0.0
        return 2.0 * _nelems(out) * k + bias
    if name == "aten.convolution":
        rhs = eqn.in_avals[1].shape
        bias = _nelems(out) if eqn.params["has_bias"] else 0.0
        return 2.0 * _nelems(out) * (_nelems(rhs) / rhs[0]) + bias
    if name in (FLASH, FLASH_DECODE):
        B, S, KR, Gl, D = eqn.in_avals[0].shape
        return flash_flops(B, S, KR * Gl, eqn.in_avals[1].shape[1], D, eqn.params["causal"])
    if name == SSD:
        Bb, S, H, hd = eqn.in_avals[0].shape
        return ssd_flops(Bb, S, H, hd, eqn.in_avals[2].shape[-1], eqn.params["chunk"])
    if name in ELEMENTWISE_1FLOP:
        return _nelems(out)
    if name in REDUCE:
        return _nelems(eqn.in_avals[0].shape)
    return 0.0


def flash_flops(B, S, H, T, D, causal: bool) -> float:
    """4·B·H·S·T·D for the two products, halved for a causal mask."""
    f = 4.0 * B * H * S * T * D
    return f / 2 if causal else f


def decode_combine_flops(B, S, H, D) -> float:
    """A sequence-sharded decode's combine on each device: per q row the
    weight e^(lse - M) (a subtract and an exp), then per output element a
    multiply by the weight and, after the psums, a divide."""
    return 2.0 * B * S * H + 2.0 * B * S * H * D


def flash_bwd_flops(B, S, H, T, D, causal: bool) -> float:
    """2.5 times the forward's: five products of 2·B·H·S·T·D (S = qK^T
    recomputed, dP = dO V^T, dq = dS K, dk = dS^T q, dv = P^T dO), halved
    for a causal mask."""
    return 2.5 * flash_flops(B, S, H, T, D, causal)


def ssd_flops(Bb, S, H, hd, ds, chunk) -> float:
    """What the chunked SSD needs, with Q = min(chunk, S) and nc = S / Q
    chunks: the causal half (t >= s) of G = C B^T once per (batch row,
    chunk); per (batch row, head) the causal half of W x in every chunk, and
    C S^T and the state update in all chunks but one (the state is zero
    entering the first chunk, and the one leaving the last is never read)."""
    Q = min(chunk, S)
    nc = S // Q
    causal = Q * (Q + 1) // 2
    return float(Bb * nc * 2 * ds * causal + Bb * H * (
        nc * 2 * hd * causal + (nc - 1) * (2 * Q * ds * hd + 2 * Q * hd * ds)))


def ssd_bwd_flops(Bb, S, H, hd, ds, chunk) -> float:
    """What the SSD's gradient needs, with Q = min(chunk, S) and nc = S / Q:
    per (batch row, chunk) the causal halves of G = C B^T, dG B and dG^T C;
    per (batch row, head) the causal halves of dW = dy x^T and W^T dy in
    every chunk, and in all chunks but one five Q x hd x ds products (the
    chunk state, each chunk's own gradient of the state entering it, dy
    S_in for dC, x dS_next for dB and B dS_next^T for dx)."""
    Q = min(chunk, S)
    nc = S // Q
    causal = Q * (Q + 1) // 2
    return float(Bb * nc * 3 * 2 * ds * causal + Bb * H * (
        nc * 2 * 2 * hd * causal + (nc - 1) * 5 * 2 * Q * hd * ds))


def count_flops(graph: torch.fx.Graph) -> float:
    """Total FLOPs for one evaluation of the captured graph (global,
    unsharded)."""
    return sum(eqn_flops(lower(n)) for n in graph.nodes if n.op == "call_function")
