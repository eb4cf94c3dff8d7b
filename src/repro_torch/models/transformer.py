"""Dense decoder-only Transformer LM (paper §5.1's subject model): the forward
pass, the loss and the cached decode step.  MoE layers arrive in a later
slice (ROADMAP A12)."""
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


def _require_dense(cfg: ModelConfig):
    if cfg.moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE FFN layers are not ported yet (ROADMAP A12)")


def layer_param_tree(cfg: ModelConfig, st: Strategy):
    _require_dense(cfg)
    return {
        "ln1": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
        "attn": attn.attn_params(cfg, st),
        "ln2": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
        "mlp": mlp_params(cfg, st),
    }


def param_tree(cfg: ModelConfig, st: Strategy):
    return {
        "embed": embed_params(cfg, st),
        "layers": stacked(layer_param_tree(cfg, st), cfg.num_layers),
        "final_ln": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
    }


def decoder_layer(cfg: ModelConfig, st: Strategy, lp: Params, x, positions):
    """Returns (x, aux_loss); aux is 0 for a dense layer."""
    h = rms_norm(x, lp["ln1"])
    h = attn.self_attention(cfg, st, lp["attn"], h, positions, causal=cfg.causal)
    x = st.constrain(x + h, "batch", "seq", "embed")
    h = rms_norm(x, lp["ln2"])
    y = mlp_forward(cfg, st, lp["mlp"], h)
    return st.constrain(x + y, "batch", "seq", "embed"), torch.zeros((), device=x.device)


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
    _require_dense(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x = embed_lookup(cfg, st, params["embed"], tokens)

    def layer_fn(lp, carry, extra):
        x, aux = carry
        x, a = decoder_layer(cfg, st, lp, x, extra)
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
    return x + mlp_forward(cfg, st, lp["mlp"], h), ck, cv


def cache_shapes(cfg: ModelConfig, st: Strategy, batch: int, max_len: int):
    shape = attn.init_cache_shapes(cfg, st, batch, max_len)
    return {"k": shape, "v": shape}


def decode_step(cfg: ModelConfig, st: Strategy, params: Params, token, cache, pos):
    """One decode step.  token (B,1) int; cache {"k","v"}: (L,B,T,KR,D); pos
    an int or a 0-d int32 tensor (kept on the device: the engine's).  Run
    eagerly, the cache is updated in place at ``pos`` and returned, layer by
    layer.  Under graph capture the step returns a new cache: with
    ``cfg.scan_layers`` the layer loop is a scan over (layer params, layer
    caches) whose ys are the layers' new caches, as the reference's; else
    the layers' new caches stacked."""
    _require_dense(cfg)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
    x = embed_lookup(cfg, st, params["embed"], token)
    if cfg.scan_layers and ops._capturing(x):
        def body(x, layer, pos):
            lp, ck, cv = layer
            x, ck, cv = decode_layer(cfg, st, lp, x, ck, cv, pos)
            return x, (ck, cv)

        x, (k, v) = scan(body, x, (params["layers"], cache["k"], cache["v"]), consts=(pos,),
                         unroll=cfg.scan_unroll)
        cache = {"k": k, "v": v}
    else:
        ks, vs = [], []
        for i in range(cache["k"].shape[0]):
            x, ck, cv = decode_layer(
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
