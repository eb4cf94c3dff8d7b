"""Model/config dataclasses and sharding strategies (paper Table 1 & §5).

A ``Strategy`` is the user-annotation layer of GSPMD: it maps *logical* tensor
dimensions (batch, embed, heads, mlp, vocab, expert, ...) to mesh axes,
separately for weights and activations — the columns of the paper's Table 1.

A ``Strategy`` reads the ambient mesh (``core.compat.set_mesh``), as the JAX
package's reads ``jax.set_mesh``'s: under a mesh its specs drop the axes the
mesh lacks, ``constrain`` annotates the activation (``core.annotate``, by
``filter_spec_by_shape``'s spec) for the partitioner, and ``axis_size``
multiplies the mesh's axis sizes.  With no mesh, ``axis_size`` is 1,
``constrain`` returns its input unchanged and specs are the unfiltered rule
lookups (as tuples).  ``filter_spec_by_shape`` and ``spec_sharding`` place
a spec on a given mesh, which is how a program annotates its inputs for
the partitioner (``models/transformer.py::partitionable_layer``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..core.compat import get_abstract_mesh

# X / Y in the paper's terms:
X = ("pod", "data")
Y = ("model",)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | relu2 | gelu
    rope: bool = True
    causal: bool = True
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_every: int = 1  # every k-th layer uses MoE FFN
    capacity_factor: float = 1.25
    shared_expert: bool = False
    moe_d_ff: int = 0  # expert hidden size (0 -> d_ff)
    # SSM / hybrid
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0  # hybrid: one attention layer per `attn_every` layers
    # encoder-decoder
    encoder_layers: int = 0
    cross_attention: bool = False
    # vlm / audio stub frontends
    num_prefix_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "dots"  # none | dots | full
    scan_layers: bool = True
    # pipeline (§3.3): the layer stack is homogeneous, so the pipeline
    # subsystem may stage-stack it.  Configs whose stack interleaves
    # heterogeneous blocks declare False.
    stackable_layers: bool = True
    scan_unroll: int = 1
    attn_chunk: int = 1024  # kv-chunked attention block size
    shard_kv_seq: bool = False  # decode: shard the kv-cache SEQ dim on X
                                # (flash-decode; used when batch < data axis)
    # §Perf levers (beyond-paper optimizations; default off = paper-faithful)
    gather_norm_input: bool = False  # force the per-layer AllGather to happen
                                     # on bf16 residuals, not f32 norm internals
    xent_chunk: int = 0              # chunk the softmax-xent over seq
    _grad_accum: int = 1             # microbatch count for the train step

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------------
# Strategy: logical-dim -> mesh-axes rules
# ---------------------------------------------------------------------------------

Rules = Dict[str, Tuple[str, ...]]
Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One of the paper's sharding configurations, as logical-axis rules."""

    name: str
    weight_rules: Rules
    act_rules: Rules

    def _spec(self, rules: Rules, logical: Tuple[Optional[str], ...]) -> Spec:
        mesh = get_abstract_mesh()
        have = set(mesh.axis_names) if mesh is not None else None
        entries = []
        for name in logical:
            axes = rules.get(name, ()) if name else ()
            if have is not None:
                axes = tuple(a for a in axes if a in have)
            if not axes:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(axes)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def w(self, *logical) -> Spec:
        """Partition spec (a tuple) for a weight with the given logical dims."""
        return self._spec(self.weight_rules, logical)

    def a(self, *logical) -> Spec:
        return self._spec(self.act_rules, logical)

    def constrain(self, x, *logical):
        """Annotate an activation (a no-op outside a mesh).  Axes that do not
        divide the dim size are dropped (§4.1 fallback: replicate rather
        than fail)."""
        mesh = get_abstract_mesh()
        if mesh is None:
            return x
        from ..core.annotate import annotate

        return annotate(x, spec_sharding(self.a(*logical), tuple(x.shape), mesh))

    def w_div(self, name: str, size: int):
        """Logical name if ``size`` divides evenly over its mesh axes, else None."""
        n = self.axis_size(name, "weight")
        return name if n > 0 and size % n == 0 else None

    def axis_size(self, logical_name: str, kind: str = "act") -> int:
        """Product of mesh-axis sizes a logical dim is sharded over (1 with no
        mesh): what the padded vocab and head layout are sized by."""
        mesh = get_abstract_mesh()
        if mesh is None:
            return 1
        rules = self.act_rules if kind == "act" else self.weight_rules
        sizes = dict(zip(mesh.axis_names, mesh.shape))
        n = 1
        for a in rules.get(logical_name, ()):
            n *= sizes.get(a, 1)
        return n


def filter_spec_by_shape(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes the mesh lacks, axes that don't divide the
    corresponding dim size, and axes already used by an earlier dim (first
    dim wins; §4.1 fallback).  ``Strategy._spec`` under a mesh already drops
    the mesh's missing axes, as the reference's does; a spec built with no
    mesh has them dropped here: X = ("pod", "data") is ("data",) on a
    ("data", "model") mesh."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    entries = []
    used = set()
    for i, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if entry is None:
            entries.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        kept = []
        n = 1
        for a in axes:
            if a in sizes and a not in used and shape[i] % (n * sizes[a]) == 0:
                kept.append(a)
                used.add(a)
                n *= sizes[a]
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def spec_sharding(spec: Spec, shape, mesh):
    """A ``Strategy.w(...)`` / ``Strategy.a(...)`` spec as a ``Sharding`` of a
    tensor of ``shape`` on ``mesh`` (filtered by ``filter_spec_by_shape``)."""
    from ..core.sharding import from_partition_spec

    return from_partition_spec(mesh, len(shape), filter_spec_by_shape(spec, shape, mesh))


def _strategy(name, weight_rules, act_rules):
    return Strategy(name, dict(weight_rules), dict(act_rules))


# Common weight rules (Table 1: weights sharded on both X and Y — weight-update
# sharding on X + in-layer model parallelism on Y).
_W_2D = {
    "embed": X,        # M dim of weights -> X
    "heads": Y,        # N dim -> Y
    "kv": Y,           # padded kv-head layout dim -> Y
    "mlp": Y,          # H dim -> Y
    "vocab": Y,        # vocabulary -> Y
    "expert": ("data",),      # E dim -> data (§5.5); pod takes per-expert M
    "expert_embed": ("pod",), # per-expert M -> pod (multi-pod only)
    "expert_mlp": Y,   # per-expert H -> Y
    "ssm_inner": Y,    # mamba d_inner
    "stage": ("pod",), # pipeline stage dim (when used)
}

# §5.1 Table 1 — the three attempts differ only in activation rules.
STRATEGY_2D_ATTEMPT1 = _strategy(
    "2d_attempt1",
    _W_2D,
    {"batch": (), "embed": X, "heads": Y, "kv": Y, "mlp": Y, "vocab": Y,
     "expert": ("data",), "moe_batch": ("pod",), "ssm_inner": Y, "seq": (),
     "kv_seq": X},
)
STRATEGY_2D_ATTEMPT2 = _strategy(
    "2d_attempt2",
    _W_2D,
    {"batch": X, "embed": (), "heads": Y, "kv": Y, "mlp": Y, "vocab": Y,
     "expert": ("data",), "moe_batch": ("pod",), "ssm_inner": Y, "seq": (),
     "kv_seq": X},
)
STRATEGY_2D_FINALIZED = _strategy(
    "2d_finalized",
    _W_2D,
    {"batch": X, "embed": Y, "heads": Y, "kv": Y, "mlp": Y, "vocab": Y,
     "expert": ("data",), "moe_batch": ("pod",), "ssm_inner": Y, "seq": (),
     "kv_seq": X},
)

# §5.4: 1D expert sharding — experts across the whole mesh, data-parallel elsewhere
STRATEGY_MOE_1D = _strategy(
    "moe_1d",
    {"embed": (), "heads": (), "mlp": (), "vocab": (),
     "expert": X + Y, "expert_mlp": (), "kv": ()},
    {"batch": X + Y, "embed": (), "heads": (), "mlp": (), "vocab": (),
     "expert": X + Y, "seq": (), "kv_seq": X},
)

# §5.5 hybrid: like 2d_finalized; expert dim on X, expert H/N on Y
STRATEGY_MOE_2D = _strategy(
    "moe_2d", _W_2D, STRATEGY_2D_FINALIZED.act_rules
)

# §Perf / Table 3: narrow models waste the Y axis — use ALL axes for data
# parallelism; weights stay fully sharded (ZeRO gather-on-demand).
STRATEGY_FSDP_1D = _strategy(
    "fsdp_1d",
    _W_2D,
    {"batch": X + Y, "embed": (), "heads": (), "kv": (), "mlp": (),
     "vocab": Y, "expert": (), "moe_batch": (), "ssm_inner": (), "seq": (),
     "kv_seq": X},
)

# §Perf: MoE variant — batch over (pod,data), experts on the model axis, no
# in-layer model parallelism (expert ffns are tiny on narrow MoEs).
STRATEGY_MOE_NARROW = _strategy(
    "moe_narrow",
    {**_W_2D, "expert": ("model",), "expert_mlp": (), "expert_embed": (),
     "heads": (), "kv": (), "mlp": ()},
    {"batch": X, "embed": (), "heads": (), "kv": (), "mlp": (),
     "vocab": Y, "expert": ("model",), "moe_batch": (), "ssm_inner": (),
     "seq": (), "kv_seq": X},
)

STRATEGIES = {
    s.name: s
    for s in (
        STRATEGY_2D_ATTEMPT1,
        STRATEGY_2D_ATTEMPT2,
        STRATEGY_2D_FINALIZED,
        STRATEGY_MOE_1D,
        STRATEGY_MOE_2D,
        STRATEGY_FSDP_1D,
        STRATEGY_MOE_NARROW,
    )
}


def get_strategy(name: str) -> Strategy:
    return STRATEGIES[name]
