"""GQA attention with GSPMD-friendly padded-head layout.

Same layout as the JAX package's ``models/attention.py``: q is
(B,S,KR,Gl,D) and k/v (B,T,KR,D), where KR are the layout kv heads and Gl the
(padded) q heads per layout kv head.  With no mesh the kv axis has size 1, so
``head_layout`` gives r = 1, Gp = G: no kv replication and no q-head padding.
Under a mesh whose kv axis outnumbers the kv heads (§4.1), each kv head is
broadcast r times and each group of q heads padded from G to Gp with zero
rows, whose W_O columns are zero too, so they add exactly nothing.

``chunked_attention`` is where the JAX package runs its XLA online-softmax
loop.  In the port it dispatches to the hand-written flash-attention kernel
(``kernels/ops.py``) for CUDA tensors and to the step-for-step plain version
for CPU tensors.  Under graph capture it is the operator
``repro_torch::flash_attention`` (no gradient) or the pair
``repro_torch::flash_attention_fwd`` / ``_bwd`` (with one), which the
partitioner shards.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig, Strategy
from ..kernels import ops
from .layers import Params, at_use, pspec, rope

NEG_INF = -1e9


def head_layout(cfg: ModelConfig, st: Strategy):
    """(K, G, r, Gp, KR): kv heads, q-per-kv, replicas, padded group, layout heads."""
    N, K = cfg.num_heads, cfg.num_kv_heads
    tp = st.axis_size("kv")
    G = N // K
    if K >= tp:
        assert K % tp == 0, f"kv heads {K} not divisible by axis {tp}"
        return K, G, 1, G, K
    assert tp % K == 0, f"axis {tp} not divisible by kv heads {K}"
    r = tp // K
    Gp = -(-G // r) * r
    return K, G, r, Gp, K * r


def attn_params(cfg: ModelConfig, st: Strategy):
    M, N, K, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh
    h = st.w_div("heads", N)
    hd = "mlp" if h is None else None  # head_dim rides the Y axis as fallback
    hk = st.w_div("heads", K)
    p = {
        "wq": pspec((M, N, Dh), st.w("embed", h, hd), fan_in=M),
        "wk": pspec((M, K, Dh), st.w("embed", hk, None if hk else "mlp"), fan_in=M),
        "wv": pspec((M, K, Dh), st.w("embed", hk, None if hk else "mlp"), fan_in=M),
        "wo": pspec((N, Dh, M), st.w(h, hd, "embed"), fan_in=N * Dh),
    }
    if cfg.qkv_bias:
        p["bq"] = pspec((N, Dh), st.w(h, hd), init="zeros")
        p["bk"] = pspec((K, Dh), st.w(hk), init="zeros")
        p["bv"] = pspec((K, Dh), st.w(hk), init="zeros")
    return p


def _pad_group(x, G: int, Gp: int, dim: int):
    """Zero rows appended to the q-head group dim: G -> Gp."""
    if Gp == G:
        return x
    pad = [0, 0] * (x.ndim - 1 - dim) + [0, Gp - G]
    return torch.nn.functional.pad(x, pad)


def project_qkv(cfg: ModelConfig, st: Strategy, p: Params, xq, xkv, positions):
    """Returns q (B,S,KR,Gl,D), k,v (B,T,KR,D) in the padded layout; KR = K
    and Gl = G with no mesh."""
    K, G, r, Gp, KR = head_layout(cfg, st)
    Gl = Gp // r
    q = (xq @ at_use(p["wq"], cfg).flatten(1)).unflatten(-1, p["wq"].shape[1:])
    k = (xkv @ at_use(p["wk"], cfg).flatten(1)).unflatten(-1, p["wk"].shape[1:])
    v = (xkv @ at_use(p["wv"], cfg).flatten(1)).unflatten(-1, p["wv"].shape[1:])
    if cfg.qkv_bias:
        q = q + at_use(p["bq"], cfg)
        k = k + at_use(p["bk"], cfg)
        v = v + at_use(p["bv"], cfg)
    if cfg.rope and positions is not None:
        # where the heads do not divide the axis, the head dim rides it
        # (attn_params' fallback); rope's halves need it whole, so it is
        # gathered here by annotation, as the layout below needs it anyway
        if st.w_div("heads", cfg.num_heads) is None:
            q = st.constrain(q, "batch", "seq", None, None)
        if st.w_div("heads", K) is None:
            k = st.constrain(k, "batch", "seq", None, None)
        q = rope(q, positions, cfg.dh)
        k = rope(k, positions, cfg.dh)
    B, S = q.shape[:2]
    T = k.shape[1]
    q = q.reshape(B, S, K, G, cfg.dh)
    if Gp != G:
        # §4.1: (K, G) does not divide the kv axis until padded; the head
        # dims stay unsharded across the pad, as in the reference
        q = st.constrain(q, "batch", "seq", None, None, None)
        q = _pad_group(q, G, Gp, dim=3)
        q = st.constrain(q, "batch", "seq", None, None, None)
    if (KR, Gl) != (K, G):
        q = q.reshape(B, S, KR, Gl, cfg.dh)
    q = st.constrain(q, "batch", "seq", "kv", None, None)
    if r > 1:
        k = k[:, :, :, None, :].expand(B, T, K, r, cfg.dh).reshape(B, T, KR, cfg.dh)
        v = v[:, :, :, None, :].expand(B, T, K, r, cfg.dh).reshape(B, T, KR, cfg.dh)
    k = st.constrain(k, "batch", "seq", "kv", None)
    v = st.constrain(v, "batch", "seq", "kv", None)
    return q, k, v


def out_projection(cfg: ModelConfig, st: Strategy, p: Params, attn):
    """attn: (B,S,KR,Gl,D) padded layout -> (B,S,M) through W_O, padded
    with zero columns for the padded heads."""
    K, G, r, Gp, KR = head_layout(cfg, st)
    B, S = attn.shape[:2]
    # one (n d) contraction: torch.einsum over two dims sums in another order
    attn = attn.reshape(B, S, K * Gp * cfg.dh)
    wo = at_use(p["wo"], cfg)
    if Gp != G:
        wo = _pad_group(wo.reshape(K, G, cfg.dh, cfg.d_model), G, Gp, dim=1)
    out = attn @ wo.reshape(K * Gp * cfg.dh, cfg.d_model)
    return st.constrain(out, "batch", "seq", "embed")


def chunked_attention(
    q, k, v, *, causal: bool, chunk: int, q_offset: int = 0,
    kv_len: Optional[int] = None,
):
    """Online-softmax attention.  q: (B,S,KR,Gl,D); k,v: (B,T,KR,D).

    ``q_offset`` is the absolute position of q[0] (decode/prefill
    continuation); ``kv_len`` masks the valid cache prefix when decoding into
    a longer preallocated cache.  ``chunk`` is the plain version's kv chunk;
    the CUDA kernel uses its own tile.
    """
    return ops.attention_model_layout(
        q, k, v, causal=causal, chunk=chunk, q_offset=q_offset, kv_len=kv_len
    )


def self_attention(cfg: ModelConfig, st: Strategy, p: Params, x, positions, *, causal=True):
    """Full-sequence self-attention (training / prefill)."""
    q, k, v = project_qkv(cfg, st, p, x, x, positions)
    attn = chunked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    return out_projection(cfg, st, p, attn)


# ---------------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------------


def init_cache_shapes(cfg: ModelConfig, st: Strategy, batch, max_len, layers=None):
    K, G, r, Gp, KR = head_layout(cfg, st)
    L = layers if layers is not None else cfg.num_layers
    return (L, batch, max_len, KR, cfg.dh)


def decode_attention(cfg: ModelConfig, st: Strategy, p: Params, x, ck, cv, pos):
    """One-token decode.  x: (B,1,M); ck/cv: (B,T,KR,D) layer cache; pos:
    absolute position, a 0-d int32 tensor on x's device (the kernel reads it
    there, so no step waits on the host and one captured graph serves every
    position).  Returns (out, ck, cv).

    Run eagerly, the new kv row is written into ``ck``/``cv`` in place: the
    counterpart of the JAX engine donating the cache to its jitted decode
    step.  Under graph capture the write is functional (``index_copy``, the
    counterpart of the reference's ``dynamic_update_slice_in_dim``) and
    returns new caches, annotated as the reference's are."""
    B = x.shape[0]
    q, k, v = project_qkv(cfg, st, p, x, x, pos.expand(B, 1))
    at = pos.reshape(1).long()
    k, v = k.to(ck.dtype), v.to(cv.dtype)
    if ops._capturing(ck):
        ck, cv = ck.index_copy(1, at, k), cv.index_copy(1, at, v)
    else:
        ck.index_copy_(1, at, k)
        cv.index_copy_(1, at, v)
    seq_ax = "kv_seq" if cfg.shard_kv_seq else None
    ck = st.constrain(ck, "batch", seq_ax, "kv", None)
    cv = st.constrain(cv, "batch", seq_ax, "kv", None)
    # one kv chunk, as in the JAX package: the kernel splits the keys below
    # pos + 1, the plain version masks the rest
    attn = ops.flash_decode(q, ck, cv, pos, ck.shape[1])
    return out_projection(cfg, st, p, attn), ck, cv


def prefill_attention(cfg: ModelConfig, st: Strategy, p: Params, x, positions):
    """Prefill: full self-attention AND return the kv to seed a cache."""
    q, k, v = project_qkv(cfg, st, p, x, x, positions)
    attn = chunked_attention(q, k, v, causal=cfg.causal, chunk=cfg.attn_chunk)
    return out_projection(cfg, st, p, attn), k, v
