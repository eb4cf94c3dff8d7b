"""Decoder-only Transformer LM (paper §5.1's subject model), dense or with
MoE FFN layers (§5.4/§5.5, ``models/moe.py``): the forward pass, the loss
and the cached decode step.

A config with ``moe_every == 1`` puts an MoE FFN in every layer; with
``moe_every = k > 1`` the stack is of k-layer **superblocks** (dense layers,
then one MoE layer last), keyed ``"0".."k-1"``, and the layer loop runs over
superblocks: params with a leading L/k dim, caches (L/k, k, B, T, KR, D).
A shared expert (``cfg.shared_expert``) is a dense MLP beside the MoE FFN,
its output added.  Each MoE layer returns its aux loss; the stack sums
them, and the loss adds ``aux_coef`` times the sum."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, Strategy
from ..core.scan import scan
from ..kernels import ops
from . import attention as attn
from .layers import (
    Params,
    annotate_spec,
    annotate_tree,
    embed_lookup,
    embed_params,
    layer_slice,
    mlp_forward,
    mlp_params,
    pspec,
    rms_norm,
    softmax_xent,
    stack_layers,
    stacked,
    streamed_xent,
    unembed_logits,
)
from .moe import moe_forward, moe_params


def superblock(cfg: ModelConfig) -> int:
    """Scan unit: MoE-every-k archs scan over k-layer superblocks."""
    return cfg.moe_every if (cfg.moe and cfg.moe_every > 1) else 1


def layer_param_tree(cfg: ModelConfig, st: Strategy, use_moe: bool = None):
    """One layer's params: an MoE FFN (``"moe"``, with the shared expert's
    ``"mlp"`` where ``cfg.shared_expert``) where ``use_moe``, else a dense
    ``"mlp"``; ``use_moe=None`` is every layer's MoE where ``moe_every`` is 1."""
    if use_moe is None:
        use_moe = cfg.moe and cfg.moe_every == 1
    p = {
        "ln1": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
        "attn": attn.attn_params(cfg, st),
        "ln2": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
    }
    if use_moe:
        p["moe"] = moe_params(cfg, st)
        if cfg.shared_expert:
            p["mlp"] = mlp_params(cfg, st)
    else:
        p["mlp"] = mlp_params(cfg, st)
    return p


def param_tree(cfg: ModelConfig, st: Strategy):
    sb = superblock(cfg)
    if sb == 1:
        layers = stacked(layer_param_tree(cfg, st), cfg.num_layers)
    else:
        if cfg.num_layers % sb:
            raise ValueError(f"{cfg.name}: {cfg.num_layers} layers in superblocks of {sb}")
        block = {str(i): layer_param_tree(cfg, st, use_moe=(i == sb - 1)) for i in range(sb)}
        layers = stacked(block, cfg.num_layers // sb)
    return {
        "embed": embed_params(cfg, st),
        "layers": layers,
        "final_ln": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
    }


def _ffn(cfg: ModelConfig, st: Strategy, lp: Params, h):
    """The layer's FFN on the normed h: (y, aux); aux is 0 for a dense layer."""
    if "moe" in lp:
        y, aux = moe_forward(cfg, st, lp["moe"], h)
        if "mlp" in lp:
            y = y + mlp_forward(cfg, st, lp["mlp"], h)
        return y, aux
    return mlp_forward(cfg, st, lp["mlp"], h), torch.zeros((), device=h.device)


def decoder_layer(cfg: ModelConfig, st: Strategy, lp: Params, x, positions):
    """Returns (x, aux_loss); aux is 0 for a dense layer."""
    h = rms_norm(x, lp["ln1"])
    h = attn.self_attention(cfg, st, lp["attn"], h, positions, causal=cfg.causal)
    x = st.constrain(x + h, "batch", "seq", "embed")
    h = rms_norm(x, lp["ln2"])
    y, aux = _ffn(cfg, st, lp, h)
    return st.constrain(x + y, "batch", "seq", "embed"), aux


def block_layer(cfg: ModelConfig, st: Strategy, lp: Params, x, positions):
    """One scan unit: a layer, or a superblock's layers in order, their aux
    losses summed."""
    sb = superblock(cfg)
    if sb == 1:
        return decoder_layer(cfg, st, lp, x, positions)
    aux = torch.zeros((), device=x.device)
    for i in range(sb):
        x, a = decoder_layer(cfg, st, lp[str(i)], x, positions)
        aux = aux + a
    return x, aux


def partitionable_layer(cfg: ModelConfig, st: Strategy, mesh):
    """``decoder_layer`` as a program for the partitioner
    (``core/partitioner.py::spmd_partition``): ``fn(lp, x, positions)``
    annotates x, positions and every weight at entry by ``st``'s activation
    and weight specs, filtered to ``mesh``, and runs the layer."""
    decls = layer_param_tree(cfg, st)

    def fn(lp, x, positions):
        lp = annotate_tree(decls, lp, mesh)
        x = annotate_spec(x, st.a("batch", "seq", "embed"), mesh)
        positions = annotate_spec(positions, st.a("batch", "seq"), mesh)
        return decoder_layer(cfg, st, lp, x, positions)

    return fn


def backbone(cfg: ModelConfig, st: Strategy, params: Params, tokens):
    """Embedding + layer stack + final norm: tokens (B,S) -> (pre-logits
    (B,S,M), aux_loss)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_lookup(cfg, st, params["embed"], tokens)

    def layer_fn(lp, carry, extra):
        x, aux = carry
        x, a = block_layer(cfg, st, lp, x, extra)
        return x, aux + a

    x, aux = stack_layers(
        layer_fn, params["layers"], (x, torch.zeros((), device=x.device)), cfg,
        extra=positions,
    )
    return rms_norm(x, params["final_ln"]), aux


def forward(cfg: ModelConfig, st: Strategy, params: Params, tokens):
    """tokens (B,S) -> (logits (B,S,V), aux_loss)."""
    x, aux = backbone(cfg, st, params, tokens)
    return unembed_logits(cfg, st, params["embed"], x), aux


def loss_fn(cfg: ModelConfig, st: Strategy, params: Params, batch, aux_coef=0.01):
    """Mean next-token cross entropy plus ``aux_coef`` times the aux loss;
    streamed over sequence chunks when ``cfg.xent_chunk`` is set."""
    if cfg.xent_chunk:
        x, aux = backbone(cfg, st, params, batch["tokens"])
        return (
            streamed_xent(cfg, st, x, params["embed"]["embedding"], batch["labels"])
            + aux_coef * aux
        )
    logits, aux = forward(cfg, st, params, batch["tokens"])
    return softmax_xent(cfg, st, logits, batch["labels"]) + aux_coef * aux


# ---------------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------------


def decode_layer(cfg: ModelConfig, st: Strategy, lp: Params, x, ck, cv, pos):
    h = rms_norm(x, lp["ln1"])
    h, ck, cv = attn.decode_attention(cfg, st, lp["attn"], h, ck, cv, pos)
    x = x + h
    h = rms_norm(x, lp["ln2"])
    return x + _ffn(cfg, st, lp, h)[0], ck, cv


def decode_block(cfg: ModelConfig, st: Strategy, lp: Params, x, ck, cv, pos):
    """One scan unit of the decode step: a layer, or a superblock's layers
    over its (sb, B, T, KR, D) caches (in place eagerly; under capture
    their new rows stacked and annotated as the reference's are)."""
    sb = superblock(cfg)
    if sb == 1:
        return decode_layer(cfg, st, lp, x, ck, cv, pos)
    cks, cvs = [], []
    for i in range(sb):
        x, cki, cvi = decode_layer(cfg, st, lp[str(i)], x, ck[i], cv[i], pos)
        cks.append(cki)
        cvs.append(cvi)
    if ops._capturing(x):
        seq_ax = "kv_seq" if cfg.shard_kv_seq else None
        ck = st.constrain(torch.stack(cks), None, "batch", seq_ax, "kv", None)
        cv = st.constrain(torch.stack(cvs), None, "batch", seq_ax, "kv", None)
    return x, ck, cv


def cache_shapes(cfg: ModelConfig, st: Strategy, batch: int, max_len: int):
    """kv caches (L, B, T, KR, D), or (L/sb, sb, B, T, KR, D) in superblocks."""
    sb = superblock(cfg)
    shape = attn.init_cache_shapes(cfg, st, batch, max_len)
    if sb > 1:
        shape = (shape[0] // sb, sb) + shape[1:]
    return {"k": shape, "v": shape}


def decode_step(cfg: ModelConfig, st: Strategy, params: Params, token, cache, pos):
    """One decode step.  token (B,1) int; cache {"k","v"}: (L,B,T,KR,D), or
    (L/sb,sb,B,T,KR,D) in superblocks; pos an int or a 0-d int32 tensor
    (kept on the device: the engine's).  Run eagerly, the cache is updated
    in place at ``pos`` and returned, layer by layer.  Under graph capture
    the step returns a new cache: with ``cfg.scan_layers`` the layer loop
    is a scan over (block params, block caches) whose ys are the blocks'
    new caches, as the reference's; else the blocks' new caches stacked."""
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    x = embed_lookup(cfg, st, params["embed"], token)
    if cfg.scan_layers and ops._capturing(x):
        def body(x, layer, pos):
            lp, ck, cv = layer
            x, ck, cv = decode_block(cfg, st, lp, x, ck, cv, pos)
            return x, (ck, cv)

        x, (k, v) = scan(body, x, (params["layers"], cache["k"], cache["v"]), consts=(pos,),
                         unroll=cfg.scan_unroll)
        cache = {"k": k, "v": v}
    else:
        ks, vs = [], []
        for i in range(cache["k"].shape[0]):
            x, ck, cv = decode_block(
                cfg, st, layer_slice(params["layers"], i), x,
                cache["k"][i], cache["v"][i], pos,
            )
            ks.append(ck)
            vs.append(cv)
        if ops._capturing(x):
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    x = rms_norm(x, params["final_ln"])
    logits = unembed_logits(cfg, st, params["embed"], x)
    return logits, cache
