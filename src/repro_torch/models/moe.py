"""Mixture-of-Experts layer (paper §5.4/§5.5, GShard-style token-choice routing).

A port of the JAX package's ``models/moe.py``, the same arithmetic op for op.
Sharding follows the paper's hybrid configuration: the expert dim E is
sharded on X (the data axis), the per-expert H on Y.  Tokens enter
batch-sharded on X; the dispatched (B, E, C, M) tensor is re-annotated with
E on X, which the partitioner lowers to the characteristic **AllToAll**
(Figure 8), and the expert outputs are annotated back.

Routing is float32: the router product, softmax, top-k and the
renormalisation.  The slot of each assignment within its expert comes from
a stable sort of the flat expert ids, a ``searchsorted`` of each expert's
first slot and the inverse permutation, so no (tokens x E x C) one-hot
exists.  Dispatch is one ``scatter_add`` into a (B, E*C, M) buffer and
combine one ``gather`` from it, both at the flat index ``e*C + slot``:
every kept slot receives exactly one token (a dropped one adds zero at its
expert's slot 0), so the sum is exact and the same from run to run.  The
reference's ``jax.nn.one_hot`` in the aux loss is a comparison with
``arange(E)`` here (``torch.nn.functional.one_hot`` checks its range on
the host, which graph capture cannot follow).  The expert products are
einsums over the expert dim: plain batched products, as the reference's are
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig, Strategy
from .layers import Params, mlp_params, pspec, silu


def capacity(cfg: ModelConfig, tokens_per_batch: int) -> int:
    """Slots per expert in one routing group: tokens * K * capacity_factor / E,
    rounded up to a multiple of 4, at least 4."""
    c = int(tokens_per_batch * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(4, -(-c // 4) * 4)


def moe_params(cfg: ModelConfig, st: Strategy):
    """The router (read in float32, so stored in float32) and the experts'
    MLP weights with a leading E dim."""
    E = cfg.num_experts
    return {
        "router": pspec((cfg.d_model, E), st.w("embed_vec"), fan_in=cfg.d_model,
                        dtype="float32"),
        "experts": mlp_params(cfg, st, d_ff=cfg.expert_d_ff, expert_dims=(E,)),
    }


def route(cfg: ModelConfig, p: Params, x):
    """x (B, S, M) -> (router logits (B,S,E), probs (B,S,E), top_p (B,S,K)
    renormalised, top_e (B,S,K) int64), all of it float32."""
    gates = x.float() @ p["router"].float()
    probs = torch.softmax(gates, dim=-1)
    top_p, top_e = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    return gates, probs, top_p, top_e


def slots(flat_e, E: int):
    """Each assignment's slot within its expert, in token order: (B, SK)
    flat expert ids -> (B, SK) positions.  The stable sort keeps the
    assignments of one expert in token order; the first slot of each expert
    is its ``searchsorted`` start; the inverse permutation puts the sorted
    positions back."""
    B, SK = flat_e.shape
    sorted_e, perm = torch.sort(flat_e, dim=1, stable=True)
    experts = torch.arange(E, device=flat_e.device).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")
    pos_sorted = torch.arange(SK, device=flat_e.device) - torch.gather(starts, 1, sorted_e)
    inv = torch.argsort(perm, dim=1)
    return torch.gather(pos_sorted, 1, inv)


def _experts(cfg: ModelConfig, st: Strategy, ep: Params, disp, expert_sharded: bool):
    """The per-expert MLP on the dispatched (B, E, C, M) tokens."""
    dt = disp.dtype
    if "wi_gate" in ep:
        g = torch.einsum("becm,emh->bech", disp, ep["wi_gate"].to(dt))
        u = torch.einsum("becm,emh->bech", disp, ep["wi_up"].to(dt))
        h = silu(g) * u
    else:
        g = torch.einsum("becm,emh->bech", disp, ep["wi"].to(dt))
        if cfg.mlp == "relu2":
            h = torch.relu(g).square()
        elif cfg.mlp == "gelu":
            h = torch.nn.functional.gelu(g, approximate="tanh")
        else:
            raise ValueError(f"unknown mlp {cfg.mlp!r}")
    if expert_sharded:
        h = st.constrain(h, "moe_batch", "expert", None, "expert_mlp")
    h = torch.einsum("bech,ehm->becm", h, ep["wo"].to(dt))
    if expert_sharded:
        h = st.constrain(h, "moe_batch", "expert", None, "embed")
    return h


def moe_forward(cfg: ModelConfig, st: Strategy, p: Params, x):
    """x: (B, S, M) -> (out (B, S, M), aux_loss).

    Routing groups are batch rows when S is large (GShard-style); for short
    sequences (decode: S=1) the tokens are POOLED across the batch, so that
    the capacity floor does not multiply into E x C dead slots per token."""
    B0, S0, M = x.shape
    E, K = cfg.num_experts, cfg.top_k
    pooled = S0 * K < 2 * E and B0 > 1
    if pooled:
        x = x.reshape(1, B0 * S0, M)
        x = st.constrain(x, None, "batch", "embed")  # tokens stay data-sharded
    B, S, M = x.shape
    C = capacity(cfg, S)
    dt = x.dtype

    _, probs, top_p, top_e = route(cfg, p, x)
    # aux load-balance loss (GShard): mean fraction * mean prob per expert
    me = probs.mean(dim=(0, 1))
    first = top_e[..., 0, None] == torch.arange(E, device=x.device)
    ce = first.float().mean(dim=(0, 1))
    aux_loss = E * torch.sum(me * ce)

    flat_e = top_e.reshape(B, S * K)
    mypos = slots(flat_e, E)
    keep = mypos < C
    index = flat_e * C + torch.where(keep, mypos, torch.zeros_like(mypos))
    index = index[..., None].expand(B, S * K, M)

    # --- dispatch: one scatter into (B, E*C, M) --------------------------------
    xk = x[:, :, None, :].expand(B, S, K, M).reshape(B, S * K, M)
    w = (top_p.reshape(B, S * K) * keep).to(dt)
    src = xk * keep[..., None].to(dt)
    disp = torch.zeros((B, E * C, M), dtype=dt, device=x.device).scatter_add(1, index, src)
    disp = st.constrain(disp.reshape(B, E, C, M), "batch", None, None, "embed")
    # re-annotated with E sharded: the partitioner lowers this to an
    # AllToAll (Figure 8a).  Where the strategy does not shard the experts
    # the dispatch stays batch-sharded and there is no AllToAll at all.
    expert_sharded = st.axis_size("expert", "act") > 1
    if expert_sharded:
        disp = st.constrain(disp, "moe_batch", "expert", None, "embed")

    h = _experts(cfg, st, p["experts"], disp, expert_sharded)
    h = st.constrain(h, "batch", None, None, "embed")  # AllToAll back

    # --- combine: one gather from (B, E*C, M) ----------------------------------
    out_tok = torch.gather(h.reshape(B, E * C, M), 1, index) * w[..., None]
    out = out_tok.reshape(B, S, K, M).sum(dim=2)
    if pooled:
        out = out.reshape(B0, S0, M)
    out = st.constrain(out, "batch", "seq", "embed")
    return out, aux_loss


def dispatch_alltoalls(plan) -> Dict[str, int]:
    """The AllToAlls of a partition plan (``core/plan.py::PartitionPlan``)
    that move a rank-4 (B, E, C, M) dispatch tensor from batch-sharded to
    expert-sharded (``"to_experts"``: concat dim 0, split dim 1) and back
    (``"to_batch"``), counted per execution: a scan body's at its trip
    count.  A gradient program holds each of them twice per MoE layer (the
    forward's and the backward's of the other)."""
    out = {"to_experts": 0, "to_batch": 0}

    def walk(p, times):
        for step in p.steps:
            if step.inner is not None:
                walk(step.inner, times * int(step.call.get("trips", 1)))
            if step.kind != "reshard" or step.program is None or len(step.lshape) != 4:
                continue
            for c in step.program.steps:
                if c.op == "all_to_all" and (c.dim, c.dim2) == (0, 1):
                    out["to_experts"] += times
                elif c.op == "all_to_all" and (c.dim, c.dim2) == (1, 0):
                    out["to_batch"] += times

    walk(plan, 1)
    return out
