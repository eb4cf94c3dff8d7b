"""Pure-SSM LM (mamba2-130m): embed -> L × (norm + SSD block) -> norm -> logits,
as the JAX package's ``models/ssm_lm.py``.  The forward (and so the loss)
runs the SSD kernel once per layer; the decode step is recurrent and runs
none."""
from __future__ import annotations

from ..configs.base import ModelConfig, Strategy
from ..core.scan import scan_or_loop
from .layers import (
    Params, embed_lookup, embed_params, pspec, rms_norm, softmax_xent, stack_layers, stacked,
    unembed_logits,
)
from .ssm import ssm_decode, ssm_forward, ssm_params, ssm_state_shapes


def layer_tree(cfg: ModelConfig, st: Strategy):
    return {
        "ln": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
        "mixer": ssm_params(cfg, st),
    }


def param_tree(cfg: ModelConfig, st: Strategy):
    return {
        "embed": embed_params(cfg, st),
        "layers": stacked(layer_tree(cfg, st), cfg.num_layers),
        "final_ln": pspec((cfg.d_model,), st.w("embed_vec"), init="ones", dtype="float32"),
    }


def forward(cfg: ModelConfig, st: Strategy, params: Params, tokens):
    """tokens (B,S) -> logits (B,S,V)."""
    x = embed_lookup(cfg, st, params["embed"], tokens)

    def layer_fn(lp, x, _):
        h = rms_norm(x, lp["ln"])
        return st.constrain(x + ssm_forward(cfg, st, lp["mixer"], h), "batch", "seq", "embed")

    x = stack_layers(layer_fn, params["layers"], x, cfg)
    x = rms_norm(x, params["final_ln"])
    return unembed_logits(cfg, st, params["embed"], x)


def loss_fn(cfg: ModelConfig, st: Strategy, params: Params, batch):
    logits = forward(cfg, st, params, batch["tokens"])
    return softmax_xent(cfg, st, logits, batch["labels"])


def cache_shapes(cfg: ModelConfig, st: Strategy, batch: int, max_len: int):
    ss = ssm_state_shapes(cfg, st, batch)
    L = cfg.num_layers
    return {"s": (L,) + ss["s"], "conv": (L,) + ss["conv"]}


def decode_step(cfg: ModelConfig, st: Strategy, params: Params, token, cache, pos: int):
    """One decode step.  token (B,1) int; cache {"s": (L,B,Hp,hd,ds),
    "conv": (L,B,K-1,Hp,hd)}.  Returns the logits and a new cache, the
    layers' new states as the ys of ``scan_or_loop`` over (layer params,
    layer states), as the reference's."""
    x = embed_lookup(cfg, st, params["embed"], token)

    def body(x, layer):
        lp, s, conv = layer
        h = rms_norm(x, lp["ln"])
        h, new = ssm_decode(cfg, st, lp["mixer"], h, {"s": s, "conv": conv})
        return x + h, (new["s"], new["conv"])

    x, (s, conv) = scan_or_loop(body, x, (params["layers"], cache["s"], cache["conv"]), cfg)
    x = rms_norm(x, params["final_ln"])
    logits = unembed_logits(cfg, st, params["embed"], x)
    return logits, {"s": s, "conv": conv}
