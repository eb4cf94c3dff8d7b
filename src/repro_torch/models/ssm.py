"""Mamba2 (SSD — state space duality, arXiv:2405.21060) block: the chunked
forward and the recurrent decode step, as the JAX package's ``models/ssm.py``.

``ssm_forward`` runs the SSD through ``kernels/ops.py::ssd`` (the
hand-written CUDA kernel for CUDA tensors, the step-for-step plain version
for CPU tensors) where the reference calls ``ssd_scan_ref``; under autograd
its gradient is the backward kernel on the card (``ssd_scan_bwd.py``) and
autograd through the plain version on the CPU, where the reference takes
XLA's autodiff.
``ssm_decode`` is the exact recurrence, one token at a time, with no scan.

Rounding points follow the reference: the projections and the causal conv
in ``cfg.dtype`` (each matrix cast at use, so that float32 master weights
train as the reference's do); B, C, dt, A, D, the scan and the gated norm's statistics
in float32 (``layers.widen``: a float64 model keeps float64 there, which the
partitioned step's float64 check in ``chip_smoke.py`` runs).  The conv is spelled as the reference's K shifted products and
adds, rounding after each, not as ``conv1d`` (which would also bring cuDNN's
TF32 on the card); ``jax.nn.softplus`` is ``logaddexp(x, 0)``.  With no mesh
``Hp == H`` and ``_pad_heads`` returns its input; under a mesh it pads the
heads to the axis that shards them, as the reference does, and the padded
heads' dt is masked to 0.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig, Strategy
from ..core.sharding import pad_to_multiple
from ..kernels import ops
from .layers import Params, at_use, pspec, silu, widen


def ssm_dims(cfg: ModelConfig, st: Strategy):
    d_in = cfg.ssm_expand * cfg.d_model
    hd = cfg.ssm_head_dim
    H = d_in // hd
    tp = st.axis_size("heads")
    Hp = pad_to_multiple(H, max(tp, 1))
    return d_in, hd, H, Hp


def ssm_params(cfg: ModelConfig, st: Strategy):
    """The reference reads ``dt_bias``, ``A_log``, ``D`` and ``norm`` in
    float32; the matrices and ``conv_w`` in ``cfg.dtype``."""
    M, ds = cfg.d_model, cfg.ssm_state
    d_in, hd, H, Hp = ssm_dims(cfg, st)
    h = st.w_div("heads", H)
    hdx = None if h else "mlp"
    f32 = "float32"
    return {
        "wz": pspec((M, H, hd), st.w("embed", h, hdx), fan_in=M),
        "wx": pspec((M, H, hd), st.w("embed", h, hdx), fan_in=M),
        "wB": pspec((M, ds), st.w("embed", "mlp"), fan_in=M),
        "wC": pspec((M, ds), st.w("embed", "mlp"), fan_in=M),
        "wdt": pspec((M, H), st.w("embed", h), fan_in=M),
        "dt_bias": pspec((H,), st.w(h), init="zeros", dtype=f32),
        "A_log": pspec((H,), st.w(h), init="zeros", dtype=f32),
        "D": pspec((H,), st.w(h), init="ones", dtype=f32),
        "conv_w": pspec((cfg.ssm_conv, H, hd), st.w(None, h, hdx), fan_in=cfg.ssm_conv),
        "norm": pspec((H, hd), st.w(h, hdx), init="ones", dtype=f32),
        "wo": pspec((H, hd, M), st.w(h, hdx, "embed"), fan_in=d_in),
    }


def _pad_heads(x, H, Hp, axis):
    if Hp == H:
        return x
    shape = list(x.shape)
    shape[axis] = Hp - H
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _causal_conv(x, w):
    """Depthwise causal conv: x (B,S,Hp,hd), w (K,Hp,hd)."""
    K, S = w.shape[0], x.shape[1]
    out = torch.zeros_like(x)
    for k in range(K):
        shift = K - 1 - k
        xs = F.pad(x, (0, 0, 0, 0, shift, 0))[:, :S]
        out = out + xs * w[k]
    return out


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _heads_proj(x, w):
    """einsum("...m,mhp->...hp"): x (..., M) @ w (M, H, hd)."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _gated_norm(cfg, p, y, z, H, Hp):
    """y (f32, heads last but one) gated by silu(z) and RMS-normed per head
    with ``norm``, in the reference's rounding points."""
    dt_ = getattr(torch, cfg.dtype)
    y = y.to(dt_) * silu(z)
    norm = _pad_heads(widen(p["norm"]), H, Hp, 0)
    var = widen(y).square().mean(dim=-1, keepdim=True)
    return (widen(y) * torch.rsqrt(var + 1e-6) * norm).to(dt_)


def _inputs(cfg, st, p, x, head_axis):
    """The projections of x and the per-head constants, padded to Hp."""
    d_in, hd, H, Hp = ssm_dims(cfg, st)
    z = _pad_heads(_heads_proj(x, at_use(p["wz"], cfg)), H, Hp, head_axis)
    xr = _pad_heads(_heads_proj(x, at_use(p["wx"], cfg)), H, Hp, head_axis)
    Bm = widen(x @ at_use(p["wB"], cfg))
    Cm = widen(x @ at_use(p["wC"], cfg))
    dt_raw = _pad_heads(widen(x @ at_use(p["wdt"], cfg)) + widen(p["dt_bias"]), H, Hp,
                        head_axis)
    conv_w = _pad_heads(at_use(p["conv_w"], cfg), H, Hp, 1)
    A = _pad_heads(-torch.exp(widen(p["A_log"])), H, Hp, 0)
    D = _pad_heads(widen(p["D"]), H, Hp, 0)
    dt = _softplus(dt_raw) * (torch.arange(Hp, device=x.device) < H)  # mask padded heads
    return z, xr, Bm, Cm, dt, conv_w, A, D


def ssm_forward(cfg: ModelConfig, st: Strategy, p: Params, x, chunk: int = 128):
    """x (B,S,M) -> (B,S,M)."""
    d_in, hd, H, Hp = ssm_dims(cfg, st)
    z, xr, Bm, Cm, dt, conv_w, A, D = _inputs(cfg, st, p, x, 2)
    z = st.constrain(z, "batch", "seq", "heads", None)
    xr = st.constrain(xr, "batch", "seq", "heads", None)

    xr = silu(_causal_conv(xr, conv_w))
    y = ops.ssd(widen(xr), dt, Bm, Cm, A, chunk=chunk)
    y = y + D[None, None, :, None] * widen(xr)
    y = st.constrain(_gated_norm(cfg, p, y, z, H, Hp), "batch", "seq", "heads", None)

    wo = _pad_heads(at_use(p["wo"], cfg), H, Hp, 0)  # zero rows: mask padded heads
    out = y.flatten(2) @ wo.flatten(0, 1)
    return st.constrain(out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------------
# decode: recurrent state update
# ---------------------------------------------------------------------------------


def ssm_state_shapes(cfg: ModelConfig, st: Strategy, batch: int):
    d_in, hd, H, Hp = ssm_dims(cfg, st)
    return {
        "s": (batch, Hp, hd, cfg.ssm_state),
        "conv": (batch, cfg.ssm_conv - 1, Hp, hd),
    }


def ssm_decode(cfg: ModelConfig, st: Strategy, p: Params, x, state):
    """x (B,1,M); state {"s": (B,Hp,hd,ds), "conv": (B,K-1,Hp,hd)}.  Returns
    (out (B,1,M), new state) with new tensors, as the reference does: the
    conv buffer is the concatenation of the old one with this token's
    input, so its dtype is their promotion (float32 in a float32 model that
    starts from the engine's bfloat16 buffer)."""
    d_in, hd, H, Hp = ssm_dims(cfg, st)
    z, xr, Bm, Cm, dt, conv_w, A, D = _inputs(cfg, st, p, x[:, 0], 1)

    # conv over the buffered last K-1 inputs + current: one contraction over
    # K, products exact in float32, summed in float32 and rounded once
    buf = torch.cat([state["conv"], xr[:, None]], dim=1)  # (B,K,Hp,hd)
    conv = (buf.float() * conv_w.float()).sum(dim=1)
    xr = silu(conv.to(torch.promote_types(buf.dtype, conv_w.dtype)))
    new_conv = buf[:, 1:]

    a = torch.exp(dt * A)  # (B,Hp)
    s = state["s"] * a[..., None, None] + (dt[..., None] * xr.float())[
        ..., None
    ] * Bm[:, None, None, :]
    y = torch.einsum("bhpd,bd->bhp", s, Cm) + D[None, :, None] * xr.float()
    y = _gated_norm(cfg, p, y, z, H, Hp)
    wo = _pad_heads(at_use(p["wo"], cfg), H, Hp, 0)
    out = (y.flatten(1) @ wo.flatten(0, 1))[:, None]
    return out, {"s": s, "conv": new_conv}
