"""Family dispatch: one uniform interface over the model families.

Every family exposes:
  param_tree(cfg, st)                          declarative param tree
  forward(cfg, st, params, tokens)             logits (B,S,V)
  loss_fn(cfg, st, params, batch)              scalar loss of a batch
  decode_step(cfg, st, params, token, cache, pos) -> (logits, cache)
  cache_shapes(cfg, st, batch, max_len)        dict of cache array shapes

and, for any family, ``cache_specs`` / ``abstract_cache`` (the reference's)
and the programs the partitioner runs under a mesh: ``partitionable_loss``
(the loss, no gradient), ``partitionable_pipelined_loss`` (the same loss
with the layer stack pipelined, GSPMD §3.3) and ``partitionable_decode``
(one serve step, its position a tensor).  The port has the dense and ssm
families so far; the others raise and name the ROADMAP item that brings
them.

Families with a homogeneous layer stack also declare a **stackable-layer
boundary** (:func:`pipeline_boundary`): the prologue / layer body /
epilogue decomposition that ``repro_torch.pipeline`` rewrites into
stage-stacked form.  A config opts out with ``stackable_layers=False``.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..configs.base import X, ModelConfig, Strategy
from ..core.compat import set_mesh
from . import ssm_lm, transformer
from .layers import annotate_spec, annotate_tree

_PENDING = {
    "moe": "A12",
    "hybrid": "A12",
    "encdec": "A12",
    "vlm": "A12",
}


def family_module(cfg: ModelConfig):
    if cfg.family == "dense":
        return transformer
    if cfg.family == "ssm":
        return ssm_lm
    if cfg.family in _PENDING:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP {_PENDING[cfg.family]})")
    raise KeyError(cfg.family)


def param_tree(cfg: ModelConfig, st: Strategy):
    return family_module(cfg).param_tree(cfg, st)


def forward(cfg: ModelConfig, st: Strategy, params, tokens):
    """Logits (B,S,V); the dense family's aux loss (0 without MoE) is dropped."""
    if cfg.family == "dense":
        return transformer.forward(cfg, st, params, tokens)[0]
    return family_module(cfg).forward(cfg, st, params, tokens)


def loss_fn(cfg: ModelConfig, st: Strategy, params, batch):
    """batch {"tokens": (B,S), "labels": (B,S)} -> scalar float32 loss."""
    return family_module(cfg).loss_fn(cfg, st, params, batch)


def decode_step(cfg: ModelConfig, st: Strategy, params, token, cache, pos):
    """pos: an int, or a 0-d int32 tensor on the device (the engine's)."""
    return family_module(cfg).decode_step(cfg, st, params, token, cache, pos)


def cache_shapes(cfg: ModelConfig, st: Strategy, batch: int, max_len: int) -> Dict[str, tuple]:
    return family_module(cfg).cache_shapes(cfg, st, batch, max_len)


class PipelineBoundary(NamedTuple):
    """The stackable-layer region of one family's training loss.

    ``prologue(params, tokens) -> x`` (the embedding; full batch),
    ``layer(lp, x, extra) -> x`` (ONE homogeneous layer: the same shape in
    and out, no aux carry), ``epilogue(params, x, batch) -> loss`` (final
    norm, logits, cross entropy).  ``layers_key`` names the stacked-params
    subtree (leaves with a leading layer dim) that the pipeline
    stage-stacks."""

    prologue: Callable
    layer: Callable
    epilogue: Callable
    layers_key: str


def pipeline_boundary(cfg: ModelConfig, st: Strategy) -> Optional[PipelineBoundary]:
    """The family's stackable-layer boundary, or None where the stack is not
    homogeneous (MoE, hybrid, encdec, vlm) or the config declares
    ``stackable_layers=False``.  Decided from the config alone, before any
    family module is reached (the families not ported yet raise there)."""
    from .layers import embed_lookup, rms_norm, softmax_xent, streamed_xent, unembed_logits

    if not cfg.stackable_layers or cfg.moe or cfg.family not in ("dense", "ssm"):
        return None

    def prologue(params, tokens):
        return embed_lookup(cfg, st, params["embed"], tokens)

    def epilogue(params, x, batch):
        x = rms_norm(x, params["final_ln"])
        if cfg.xent_chunk:
            return streamed_xent(cfg, st, x, params["embed"]["embedding"], batch["labels"])
        logits = unembed_logits(cfg, st, params["embed"], x)
        return softmax_xent(cfg, st, logits, batch["labels"])

    if cfg.family == "dense":
        def layer(lp, x, positions):
            return transformer.decoder_layer(cfg, st, lp, x, positions)[0]
    else:
        from .ssm import ssm_forward

        def layer(lp, x, _extra):
            h = rms_norm(x, lp["ln"])
            return st.constrain(x + ssm_forward(cfg, st, lp["mixer"], h), "batch", "seq", "embed")

    return PipelineBoundary(prologue, layer, epilogue, "layers")


def cache_specs(cfg: ModelConfig, st: Strategy) -> Dict[str, tuple]:
    """The spec (a plain tuple, trailing Nones dropped) of each cache entry,
    its leading layer dim unsharded: kv caches on ("batch", seq, "kv", None),
    seq on "kv_seq" where ``cfg.shard_kv_seq``; the SSM state on ("batch",
    "heads", None, None) and its conv buffer on ("batch", None, "heads",
    None).  Under a mesh the strategy drops the axes the mesh lacks."""
    seq_ax = "kv_seq" if cfg.shard_kv_seq else None
    logical = {"k": ("batch", seq_ax, "kv", None), "v": ("batch", seq_ax, "kv", None),
               "s": ("batch", "heads", None, None), "conv": ("batch", None, "heads", None)}
    return {name: st.a(*((None,) * (len(shape) - len(logical[name])) + logical[name]))
            for name, shape in cache_shapes(cfg, st, 1, 2).items()}


def cache_dtype(name: str) -> torch.dtype:
    """The reference's cache dtypes: bfloat16, the SSM state ``s`` float32."""
    return torch.float32 if name == "s" else torch.bfloat16


def abstract_cache(cfg: ModelConfig, st: Strategy, batch: int, max_len: int):
    """The cache as meta tensors of the reference's shapes and dtypes (what
    ``core/plan.py::lower_plan`` prices a decode step on); ``cache_specs``
    gives their specs."""
    return {name: torch.empty(shape, dtype=cache_dtype(name), device="meta")
            for name, shape in cache_shapes(cfg, st, batch, max_len).items()}


def partitionable_loss(cfg: ModelConfig, st: Strategy, mesh):
    """``loss_fn`` as a program for the partitioner: ``fn(params, batch)``
    annotates every param by its declared spec and the batch on "data" (X,
    filtered to ``mesh``), and returns the loss (no gradient)."""
    with set_mesh(mesh):
        decls = param_tree(cfg, st)

    def program(params, batch):
        with set_mesh(mesh):
            params = annotate_tree(decls, params, mesh)
            batch = {k: annotate_spec(v, (X,), mesh) for k, v in batch.items()}
            return loss_fn(cfg, st, params, batch)

    return program


def partitionable_pipelined_loss(cfg: ModelConfig, st: Strategy, mesh, decision):
    """``pipeline.pipelined_loss_fn`` as a program for the partitioner, the
    glue of ``partitionable_loss`` with stage-stacked layer params:
    ``fn(params, batch)`` takes ``params["layers"]`` with leaves (S, L/S,
    ...) (``pipeline.stage_stack_params``), annotates them as
    (``decision.stage_axis``, None, *declared spec), every other param by
    its declared spec and the batch on "data" (X, filtered to ``mesh``),
    and returns the pipelined loss (no gradient); outside the pipelined
    region the stage axis also carries the batch (``pipeline.stage_batch``)."""
    from ..pipeline.stages import pipelined_loss_fn
    from .layers import tree_map_params

    with set_mesh(mesh):
        decls = param_tree(cfg, st)
    staged = tree_map_params(
        lambda p, _path: {**p, "shape": (decision.num_stages, p["shape"][0] // decision.num_stages)
                          + tuple(p["shape"][1:]),
                          "spec": (decision.stage_axis,) + tuple(p["spec"])},
        decls["layers"])

    def program(params, batch):
        with set_mesh(mesh):
            params = {**annotate_tree({k: v for k, v in decls.items() if k != "layers"},
                                      {k: v for k, v in params.items() if k != "layers"}, mesh),
                      "layers": annotate_tree(staged, params["layers"], mesh)}
            batch = {k: annotate_spec(v, (X,), mesh) for k, v in batch.items()}
            return pipelined_loss_fn(cfg, st, params, batch, decision, mesh)

    return program


def partitionable_decode(cfg: ModelConfig, st: Strategy, mesh):
    """``decode_step`` as a program for the partitioner: ``fn(params, token,
    cache, pos)`` annotates the params by their declared specs, the token on
    "data" and the cache by ``cache_specs`` (filtered to ``mesh``), as the
    reference's dry-run lowers its serve step, and runs one step at the 0-d
    int32 position ``pos``, which stays data: one program serves every
    position.  Returns (logits, new cache)."""
    with set_mesh(mesh):
        decls, specs = param_tree(cfg, st), cache_specs(cfg, st)

    def program(params, token, cache, pos):
        with set_mesh(mesh):
            params = annotate_tree(decls, params, mesh)
            token = annotate_spec(token, (X,), mesh)
            cache = {k: annotate_spec(v, specs[k], mesh) for k, v in cache.items()}
            return decode_step(cfg, st, params, token, cache, pos)

    return program
