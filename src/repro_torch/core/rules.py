"""Per-operator sharding propagation rules (paper §3.5), keyed by aten ops.

A port of the JAX package's ``core/rules.py``.  The reference keys its rules
by jaxpr primitive names; a captured aten graph has other operators, so each
aten op is keyed here by its overload packet (``"aten.mm"``) and
:func:`lower` reads what the rule needs from the node (the counterpart of an
equation's params): ``mm``/``bmm``/``addmm`` get ``dimension_numbers``,
``permute``/``transpose``/``t`` a ``permutation``, ``unsqueeze``/``expand``
``broadcast_dimensions``, the reductions their ``axes``.

Each rule looks at the current (possibly None) shardings of an op's tensor
operands and output and proposes refinements for the opposite side.  Rules
never *remove* sharding — the propagation pass only refines (merge of
compatible shardings), which guarantees a fixed point.

Priorities (lower = propagates earlier), as in the reference:
  0  elementwise ops and annotations (no comm if consistent; most intuitive)
  0  broadcast (unsqueeze, expand): the paper's high priority backward
  1  transpose, reshape, pad/slice/cat and other data-formatting ops
  2  mm/bmm/addmm, convolution, reductions (dimension-changing)
  3  everything else (no rule -> no propagation)

Where an aten graph differs from a jaxpr:

* aten broadcasts operands implicitly (right-aligned ranks, size-1 dims),
  where a jaxpr inserts ``broadcast_in_dim`` first; the elementwise rule
  maps each operand dim to the output dim it broadcasts to, and only dims of
  equal size carry sharding — what ``rule_broadcast_in_dim`` then
  ``rule_elementwise`` do in the reference;
* reductions may keep their dims (``keepdim``);
* ``slice`` has the same-rank rule, as the reference's ``slice``;
  ``alias``/``detach``/``clone`` are elementwise, as the reference's ``copy``;
* ops that return a tuple (``unbind``, the flash operator pair) map each
  result to the ``getitem`` node that reads it (``Eqn.tuple_outs``);
* ``repro_torch::stage_shift`` (``core/shift.py``) passes every dim's
  sharding through, the stage dim's included, and aligns the injected row
  with the state's trailing dims (the reference's ``rule_stage_shift``);
* the ops a captured training step adds: ``stack``, ``unbind``, ``select``,
  ``select_backward`` and ``slice_backward`` keep the sharding of the dims
  they do not touch; ``logsumexp`` is a reduction; ``embedding``,
  ``embedding_dense_backward``, ``gather`` and ``scatter_add`` carry the
  sharding of their pass-through dims, and the partitioner lets their
  indexed dim stay sharded (a masked local lookup plus a psum, or a masked
  local scatter).  The reference has no rule for ``gather``/``scatter`` and
  takes its fallback, where XLA partitions its model layer; the port has no
  XLA behind it, so these rules stand in for XLA's partitioning of the
  sharded loss (ROADMAP Queue C);
* factory ops (``ones``, ``zeros``, ``arange``, ...) are created replicated,
  like the reference's ``iota``;
* the SSD scan (``repro_torch::ssd_scan``) maps batch, heads and the head
  dim between x, dt, B, C, A and y (S and the state dim replicated), and
  its gradient (``repro_torch::ssd_scan_bwd``) the same between the
  forward's operands, dy and the five gradients (dB and dC keep only the
  batch, dA only the heads: the partitioned op sums the rest);
  ``index_copy``, the decode step's cache write, keeps every dim of the
  cache, the written one too;
* the flash-attention operators (``repro_torch::flash_attention``, its
  decode sibling ``flash_decode`` with a 0-d position, and the
  pair ``flash_attention_fwd`` / ``flash_attention_bwd`` of differentiable
  attention, which the reference's jaxpr has no counterpart of: its
  attention is an XLA loop) map batch and layout kv heads between q
  (B,S,KR,Gl,D), k/v (B,T,KR,D), the output and its gradients, and the
  log-sum-exp (B,KR,S*Gl); S, T, Gl and D stay replicated.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.fx.operator_schemas import normalize_function

from .sharding import Sharding, merge_shardings

MaybeS = Optional[Sharding]

ANNOTATE = "repro_torch.annotate"
FLASH = "repro_torch.flash_attention"
FLASH_FWD = "repro_torch.flash_attention_fwd"
FLASH_BWD = "repro_torch.flash_attention_bwd"
FLASH_DECODE = "repro_torch.flash_decode"
SSD = "repro_torch.ssd_scan"
SSD_BWD = "repro_torch.ssd_scan_bwd"
STAGE_SHIFT = "repro_torch.stage_shift"
SCAN = "repro_torch.scan"
SCAN_FWD = "repro_torch.scan_fwd"
SCANS = (SCAN, SCAN_FWD)


# ---------------------------------------------------------------------------------
# aten node -> equation (the rule's view of one op)
# ---------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Aval:
    shape: Tuple[int, ...]
    dtype: Any

    @property
    def ndim(self) -> int:
        return len(self.shape)


def aval(node) -> Optional[Aval]:
    """The node's shape and dtype, or None when it is not a tensor.  Kept in
    the node's meta beside the value it was read from: propagation asks for
    it tens of thousands of times per program."""
    if not isinstance(node, torch.fx.Node):
        return None
    v = node.meta.get("val")
    hit = node.meta.get("_repro_aval")
    if hit is not None and hit[0] is v:
        return hit[1]
    a = Aval(tuple(int(s) for s in v.shape), v.dtype) if isinstance(v, torch.Tensor) else None
    node.meta["_repro_aval"] = (v, a)
    return a


@dataclasses.dataclass
class Eqn:
    node: Any
    name: str  # the op's overload packet, e.g. "aten.mm"
    invars: list  # tensor operand nodes, in argument order
    in_avals: List[Aval]
    out_avals: List[Aval]  # [] when the op returns a tuple
    params: Dict[str, Any]
    # a tuple result: each element's aval and the getitem node that reads it
    # (None where nothing does)
    tuple_avals: List[Optional[Aval]] = dataclasses.field(default_factory=list)
    tuple_outs: List[Any] = dataclasses.field(default_factory=list)


def op_name(node) -> str:
    t = node.target
    if t is operator.getitem:
        return "getitem"
    if isinstance(t, torch._ops.HigherOrderOperator):
        return f"higher_order.{t.name()}"
    packet = getattr(t, "_overloadpacket", None)
    return str(packet) if packet is not None else str(t)


def kwargs_of(node) -> Dict[str, Any]:
    """The node's arguments by schema name, defaults filled in."""
    r = normalize_function(node.target, tuple(node.args), dict(node.kwargs),
                           normalize_to_only_use_kwargs=True)
    return dict(r.kwargs) if r is not None else dict(node.kwargs)


def _norm(d: int, rank: int) -> int:
    return d + rank if d < 0 else d


def _tensor_args(args) -> list:
    out = []
    for a in args:
        if isinstance(a, (list, tuple)):
            out += _tensor_args(a)
        elif aval(a) is not None:
            out.append(a)
    return out


def lower(node) -> Eqn:
    """The equation view of a ``call_function`` node.  A scan node
    (``repro_torch::scan`` or ``scan_fwd``, ``core/scan.py``) gets the
    reference's params from its registry entry: ``num_consts``,
    ``num_carry``, ``length``, ``reverse`` and the ``body`` (a
    ``compat.Captured``); its invars are the consts, the init and the xs."""
    name = op_name(node)
    if name.startswith("higher_order."):
        raise NotImplementedError(
            f"{name}: torch's control-flow operators are not partitioned; loops are "
            "repro_torch.core.scan.scan")
    invars = _tensor_args(list(node.args) + list(node.kwargs.values()))
    in_avals = [aval(v) for v in invars]
    out = aval(node)
    out_avals = [out] if out is not None else []
    params: Dict[str, Any] = {}
    tuple_avals, tuple_outs = [], []
    val = node.meta.get("val")
    if out is None and isinstance(val, (list, tuple)):
        tuple_avals = [Aval(tuple(int(d) for d in t.shape), t.dtype)
                       if isinstance(t, torch.Tensor) else None for t in val]
        tuple_outs = [None] * len(val)
        for u in node.users:
            if u.target is operator.getitem:
                tuple_outs[u.args[1]] = u
    if name in SCANS:
        from .scan import body_of

        body = body_of(node.args[0])
        params = {"num_consts": body.num_consts, "num_carry": body.num_carry,
                  "length": body.length, "reverse": body.reverse, "body": body.captured}
    fn = _PARAMS.get(name)
    if fn is not None and (out is not None or tuple_avals):
        params = fn(node, in_avals, out if out is not None else tuple_avals)
    if name == "aten.convolution":
        invars, in_avals = invars[:2], in_avals[:2]  # the bias joins after the product
    return Eqn(node, name, invars, in_avals, out_avals, params, tuple_avals, tuple_outs)


def _permute_params(node, ins, out):
    return {"permutation": tuple(_norm(d, out.ndim) for d in kwargs_of(node)["dims"])}


def _transpose_params(node, ins, out):
    kw = kwargs_of(node)
    r = out.ndim
    perm = list(range(r))
    a, b = _norm(kw["dim0"], r), _norm(kw["dim1"], r)
    perm[a], perm[b] = perm[b], perm[a]
    return {"permutation": tuple(perm)}


def _t_params(node, ins, out):
    return {"permutation": (1, 0) if out.ndim == 2 else tuple(range(out.ndim))}


def _unsqueeze_params(node, ins, out):
    d = _norm(kwargs_of(node)["dim"], out.ndim)
    return {"broadcast_dimensions": tuple(i if i < d else i + 1 for i in range(ins[0].ndim)),
            "shape": out.shape}


def _expand_params(node, ins, out):
    r, R = ins[0].ndim, out.ndim
    return {"broadcast_dimensions": tuple(range(R - r, R)), "shape": out.shape}


def _reduce_params(node, ins, out):
    kw = kwargs_of(node)
    rank = ins[0].ndim
    dims = kw.get("dim")
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        axes = tuple(range(rank))
    elif isinstance(dims, int):
        axes = (_norm(dims, rank),)
    else:
        axes = tuple(sorted(_norm(d, rank) for d in dims))
    keepdim = bool(kw.get("keepdim", False)) and rank > 0
    if keepdim:
        out_to_in = tuple(None if i in axes else i for i in range(rank))
    else:
        out_to_in = tuple(i for i in range(rank) if i not in axes)
    return {"axes": axes, "keepdim": keepdim, "out_to_in": out_to_in}


def _mm_params(node, ins, out):
    return {"dimension_numbers": (((1,), (0,)), ((), ()))}


def _bmm_params(node, ins, out):
    return {"dimension_numbers": (((2,), (1,)), ((0,), (0,)))}


def _addmm_params(node, ins, out):
    kw = kwargs_of(node)
    return {"dimension_numbers": (((1,), (0,)), ((), ())),
            "beta": kw.get("beta", 1), "alpha": kw.get("alpha", 1)}


@dataclasses.dataclass(frozen=True)
class ConvDims:
    """aten's fixed NC-spatial layout, in the reference's ``ConvDimensionNumbers``
    terms."""

    lhs_spec: Tuple[int, ...]
    rhs_spec: Tuple[int, ...]
    out_spec: Tuple[int, ...]


def _conv_params(node, ins, out):
    kw = kwargs_of(node)
    spec = tuple(range(out.ndim))
    nsp = out.ndim - 2
    pad = list(kw["padding"]) * (nsp if len(kw["padding"]) == 1 else 1)
    return {"dimension_numbers": ConvDims(spec, spec, spec),
            "window_strides": tuple(kw["stride"]) * (nsp if len(kw["stride"]) == 1 else 1),
            "padding": tuple((p, p) for p in pad),
            "dilation": tuple(kw["dilation"]), "transposed": bool(kw["transposed"]),
            "groups": int(kw["groups"]), "has_bias": kw["bias"] is not None}


def _cat_params(node, ins, out):
    return {"modified_dims": (_norm(kwargs_of(node).get("dim", 0), out.ndim),)}


def _slice_params(node, ins, out):
    kw = kwargs_of(node)
    d = _norm(kw.get("dim", 0), out.ndim)
    size = ins[0].shape[d]
    start, end, step = kw.get("start"), kw.get("end"), kw.get("step", 1)
    start = 0 if start is None else _norm(start, size)
    end = size if end is None else min(_norm(end, size), size)
    full = start == 0 and end >= size and step == 1
    return {"modified_dims": () if full else (d,)}


def _pad_params(node, ins, out):
    pad = list(kwargs_of(node)["pad"])
    r = out.ndim
    mod = tuple(sorted({r - 1 - i // 2 for i, p in enumerate(pad) if p}))
    return {"modified_dims": mod}


def _flash_params(node, ins, out):
    kw = kwargs_of(node)
    return {"causal": bool(kw["causal"]), "q_offset": int(kw["q_offset"]),
            "kv_len": kw["kv_len"], "chunk": int(kw["chunk"])}


def _dim_param(node, rank: int) -> int:
    return _norm(kwargs_of(node).get("dim", 0), rank)


def _drop_dim_params(node, ins, out):
    """unbind and select: the dim they remove (and select's index)."""
    return {"dim": _dim_param(node, ins[0].ndim), "index": kwargs_of(node).get("index")}


def _stack_params(node, ins, out):
    return {"dim": _dim_param(node, out.ndim)}


def _select_backward_params(node, ins, out):
    kw = kwargs_of(node)
    return {"dim": _norm(kw["dim"], out.ndim), "index": kw["index"]}


def _slice_backward_params(node, ins, out):
    kw = kwargs_of(node)
    return {"dim": _norm(kw["dim"], out.ndim), "start": kw["start"], "end": kw["end"],
            "step": kw["step"], "modified_dims": (_norm(kw["dim"], out.ndim),)}


def _gather_params(node, ins, out):
    return {"dim": _dim_param(node, ins[0].ndim)}


def _flip_params(node, ins, out):
    return {"modified_dims": tuple(sorted(_norm(d, out.ndim) for d in kwargs_of(node)["dims"]))}


# ---------------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------------


def _merge_many(shs: Sequence[MaybeS]) -> MaybeS:
    out: MaybeS = None
    for s in shs:
        if s is None:
            continue
        if out is None:
            out = s
        else:
            m = merge_shardings(out, s)
            out = m if m is not None else out
    return out


def _project(s: Sharding, dim_map: Sequence[Optional[int]], out_rank: int) -> Sharding:
    """Build a rank-``out_rank`` sharding where out dim j gets s.dims_mapping[i]
    whenever dim_map[j] == i (None -> unsharded).  Drops duplicate axis uses."""
    dm: List[Tuple[str, ...]] = [() for _ in range(out_rank)]
    used = set()
    for j, i in enumerate(dim_map):
        if i is None:
            continue
        axes = s.dims_mapping[i]
        if axes and not any(a in used for a in axes):
            dm[j] = axes
            used.update(axes)
    return Sharding(s.mesh, tuple(dm))


def _bcast_map(in_shape, out_shape) -> List[Optional[int]]:
    """out dim -> operand dim for aten's implicit (right-aligned) broadcast;
    a size-1 operand dim broadcast to a larger one maps to nothing."""
    off = len(out_shape) - len(in_shape)
    return [j - off if j >= off and in_shape[j - off] == out_shape[j] else None
            for j in range(len(out_shape))]


def _invert(dim_map: Sequence[Optional[int]], in_rank: int) -> List[Optional[int]]:
    inv: List[Optional[int]] = [None] * in_rank
    for j, i in enumerate(dim_map):
        if i is not None:
            inv[i] = j
    return inv


# ---------------------------------------------------------------------------------
# elementwise
# ---------------------------------------------------------------------------------

ELEMENTWISE = {
    "aten." + n for n in (
        "add", "sub", "rsub", "mul", "div", "pow", "maximum", "minimum", "remainder",
        "fmod", "atan2", "neg", "sign", "floor", "ceil", "round", "trunc", "abs", "exp",
        "exp2", "log", "log1p", "log2", "expm1", "tanh", "sigmoid", "sin", "cos", "tan",
        "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh", "atanh", "sqrt", "rsqrt",
        "reciprocal", "square", "erf", "erfc", "erfinv", "isfinite", "isnan", "isinf",
        "logical_not", "logical_and", "logical_or", "logical_xor", "bitwise_not",
        "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
        "bitwise_right_shift", "eq", "ne", "ge", "gt", "le", "lt", "where", "clamp",
        "clamp_min", "clamp_max", "nextafter", "_to_copy", "clone", "copy", "detach",
        "alias", "lift_fresh_copy", "relu", "silu", "gelu", "hardtanh", "leaky_relu",
        "elu", "softplus", "logaddexp", "xlogy", "lerp", "addcmul", "addcdiv",
        "masked_fill", "fill", "zeros_like", "ones_like", "full_like", "empty_like",
        "tanh_backward", "sigmoid_backward", "threshold_backward", "silu_backward",
        "gelu_backward", "hardtanh_backward", "leaky_relu_backward", "elu_backward",
        "softplus_backward")
} | {ANNOTATE}


def rule_elementwise(eqn, in_sh: List[MaybeS], out_sh: List[MaybeS], direction):
    out_shape = eqn.out_avals[0].shape
    rank = len(out_shape)
    maps = [_bcast_map(a.shape, out_shape) for a in eqn.in_avals]
    cands = [_project(s, m, rank) for s, m in zip(in_sh, maps) if s is not None]
    cands += [s for s in out_sh if s is not None and s.rank == rank]
    m = _merge_many(cands)
    if m is None:
        return in_sh, out_sh
    new_in = [_project(m, _invert(mp, a.ndim), a.ndim)
              for mp, a in zip(maps, eqn.in_avals)]
    return new_in, [m for _ in out_sh]


# ---------------------------------------------------------------------------------
# structural ops
# ---------------------------------------------------------------------------------


def rule_transpose(eqn, in_sh, out_sh, direction):
    perm = eqn.params["permutation"]
    (s_in,), (s_out,) = in_sh, out_sh
    if direction == "fwd" and s_in is not None:
        # output dim j comes from input dim perm[j]
        new = _project(s_in, list(perm), len(perm))
        return in_sh, [new]
    if direction == "bwd" and s_out is not None:
        inv = [0] * len(perm)
        for j, i in enumerate(perm):
            inv[i] = j
        new = _project(s_out, inv, len(perm))
        return [new], out_sh
    return in_sh, out_sh


def rule_broadcast_in_dim(eqn, in_sh, out_sh, direction):
    bcast = eqn.params["broadcast_dimensions"]
    in_aval = eqn.in_avals[0]
    out_aval = eqn.out_avals[0]
    (s_in,), (s_out,) = in_sh, out_sh
    if direction == "fwd" and s_in is not None:
        dim_map = [None] * out_aval.ndim
        for i, j in enumerate(bcast):
            if in_aval.shape[i] == out_aval.shape[j]:
                dim_map[j] = i
        return in_sh, [_project(s_in, dim_map, out_aval.ndim)]
    if direction == "bwd" and s_out is not None:
        dim_map = [None] * in_aval.ndim
        for i, j in enumerate(bcast):
            if in_aval.shape[i] == out_aval.shape[j]:
                dim_map[i] = j
        return [_project(s_out, dim_map, in_aval.ndim)], out_sh
    return in_sh, out_sh


def _reshape_dim_map(in_shape, out_shape):
    """Greedy factor-block matching: returns (in->out) and (out->in) partial maps
    for dims whose size is preserved at the front of a matching block."""
    in_to_out = {}
    out_to_in = {}
    i = j = 0
    while i < len(in_shape) and j < len(out_shape):
        # skip size-1 dims
        if in_shape[i] == 1 and (j >= len(out_shape) or out_shape[j] != 1):
            i += 1
            continue
        if out_shape[j] == 1 and in_shape[i] != 1:
            j += 1
            continue
        pi, pj = in_shape[i], out_shape[j]
        bi, bj = [i], [j]
        ii, jj = i, j
        while pi != pj:
            if pi < pj:
                ii += 1
                pi *= in_shape[ii]
                bi.append(ii)
            else:
                jj += 1
                pj *= out_shape[jj]
                bj.append(jj)
        # block [bi] of input matches block [bj] of output
        if len(bi) == 1 and len(bj) == 1:
            in_to_out[bi[0]] = bj[0]
            out_to_in[bj[0]] = bi[0]
        else:
            # major (first) dims correspond if equal size
            if in_shape[bi[0]] == out_shape[bj[0]]:
                in_to_out[bi[0]] = bj[0]
                out_to_in[bj[0]] = bi[0]
            # merged dim: sharding on the major input dim maps to the merged
            # output dim (and vice versa) when sizes allow clean tiling; we only
            # propagate the major-dim case (GSPMD supports more via resharding).
            elif len(bj) == 1:  # merge
                in_to_out[bi[0]] = bj[0]
            elif len(bi) == 1:  # split
                out_to_in[bj[0]] = bi[0]
        i, j = bi[-1] + 1, bj[-1] + 1
    return in_to_out, out_to_in


def rule_reshape(eqn, in_sh, out_sh, direction):
    in_aval = eqn.in_avals[0]
    out_aval = eqn.out_avals[0]
    (s_in,), (s_out,) = in_sh, out_sh
    i2o, o2i = _reshape_dim_map(in_aval.shape, out_aval.shape)
    if direction == "fwd" and s_in is not None:
        dim_map = [None] * out_aval.ndim
        for i, j in i2o.items():
            # divisibility check for merge case
            n = s_in.num_shards(i)
            if out_aval.shape[j] % max(n, 1) == 0:
                dim_map[j] = i
        return in_sh, [_project(s_in, dim_map, out_aval.ndim)]
    if direction == "bwd" and s_out is not None:
        dim_map = [None] * in_aval.ndim
        for j, i in o2i.items():
            n = s_out.num_shards(j)
            if in_aval.shape[i] % max(n, 1) == 0:
                dim_map[i] = j
        return [_project(s_out, dim_map, in_aval.ndim)], out_sh
    return in_sh, out_sh


def rule_same_rank_passthrough(eqn, in_sh, out_sh, direction):
    """pad, slice, flip, cat and cumulative formatting ops: dims keep
    identity; the partitioner does the data movement (§4.3)."""
    rank = eqn.out_avals[0].ndim
    cands = [
        s
        for a, s in zip(eqn.in_avals + eqn.out_avals, in_sh + out_sh)
        if s is not None and a.ndim == rank
    ]
    m = _merge_many(cands)
    if m is None:
        return in_sh, out_sh
    new_in = [m if a.ndim == rank else s for a, s in zip(eqn.in_avals, in_sh)]
    return new_in, [m for _ in out_sh]


def rule_reduce(eqn, in_sh, out_sh, direction):
    in_aval = eqn.in_avals[0]
    out_rank = eqn.out_avals[0].ndim
    out_to_in = eqn.params["out_to_in"]
    (s_in,) = in_sh[:1]
    (s_out,) = out_sh[:1]
    if direction == "fwd" and s_in is not None:
        return in_sh, [_project(s_in, out_to_in, out_rank)]
    if direction == "bwd" and s_out is not None:
        new_in = list(in_sh)
        new_in[0] = _project(s_out, _invert(out_to_in, in_aval.ndim), in_aval.ndim)
        return new_in, out_sh
    return in_sh, out_sh


# ---------------------------------------------------------------------------------
# dot_general — the Einsum of §3.2 / Figure 3 (aten's mm and bmm)
# ---------------------------------------------------------------------------------


def rule_dot_general(eqn, in_sh, out_sh, direction):
    ((lc, rc), (lb, rb)) = eqn.params["dimension_numbers"]
    l_aval, r_aval = eqn.in_avals[-2], eqn.in_avals[-1]
    out_rank = eqn.out_avals[0].ndim
    l_sh, r_sh = in_sh[-2:]
    (s_out,) = out_sh
    l_nc = [i for i in range(l_aval.ndim) if i not in lc and i not in lb]
    r_nc = [i for i in range(r_aval.ndim) if i not in rc and i not in rb]
    # output layout: batch dims, then lhs non-contracting, then rhs non-contracting
    if direction == "fwd" and (l_sh is not None or r_sh is not None):
        proposals = []
        if l_sh is not None:
            dim_map = [None] * out_rank
            for j, i in enumerate(lb):
                dim_map[j] = i
            for k, i in enumerate(l_nc):
                dim_map[len(lb) + k] = i
            proposals.append(_project(l_sh, dim_map, out_rank))
        if r_sh is not None:
            dim_map = [None] * out_rank
            for j, i in enumerate(rb):
                dim_map[j] = i
            for k, i in enumerate(r_nc):
                dim_map[len(rb) + len(l_nc) + k] = i
            proposals.append(_project(r_sh, dim_map, out_rank))
        m = _merge_many(proposals)  # Figure 3: merged from both inputs
        if m is not None:
            return in_sh, [m]
        return in_sh, out_sh
    if direction == "bwd" and s_out is not None:
        new_l, new_r = l_sh, r_sh
        dim_map = [None] * l_aval.ndim
        for j, i in enumerate(lb):
            dim_map[i] = j
        for k, i in enumerate(l_nc):
            dim_map[i] = len(lb) + k
        cand = _project(s_out, dim_map, l_aval.ndim)
        new_l = cand if new_l is None else (merge_shardings(new_l, cand) or new_l)
        dim_map = [None] * r_aval.ndim
        for j, i in enumerate(rb):
            dim_map[i] = j
        for k, i in enumerate(r_nc):
            dim_map[i] = len(rb) + len(l_nc) + k
        cand = _project(s_out, dim_map, r_aval.ndim)
        new_r = cand if new_r is None else (merge_shardings(new_r, cand) or new_r)
        return list(in_sh[:-2]) + [new_l, new_r], out_sh
    return in_sh, out_sh


def rule_addmm(eqn, in_sh, out_sh, direction):
    """bias + lhs·rhs: the product's rule on (lhs, rhs), the bias broadcast
    into the output as an elementwise operand."""
    new_in, new_out = rule_dot_general(eqn, in_sh, out_sh, direction)
    (s_out,) = new_out
    bias = eqn.in_avals[0]
    bmap = _bcast_map(bias.shape, eqn.out_avals[0].shape)
    if direction == "fwd" and in_sh[0] is not None:
        prop = _project(in_sh[0], bmap, len(bmap))
        s_out = prop if s_out is None else (merge_shardings(s_out, prop) or s_out)
        return new_in, [s_out]
    if direction == "bwd" and s_out is not None:
        new_in = [_project(s_out, _invert(bmap, bias.ndim), bias.ndim)] + list(new_in[1:])
    return new_in, new_out


def rule_conv(eqn, in_sh, out_sh, direction):
    dn = eqn.params["dimension_numbers"]
    lhs_spec, rhs_spec, out_spec = dn.lhs_spec, dn.rhs_spec, dn.out_spec
    # lhs_spec = (batch, feature, *spatial)
    out_rank = eqn.out_avals[0].ndim
    (l_sh, r_sh) = in_sh
    (s_out,) = out_sh
    if direction == "fwd" and l_sh is not None:
        dim_map = [None] * out_rank
        dim_map[out_spec[0]] = lhs_spec[0]  # batch
        for k in range(len(lhs_spec) - 2):  # spatial dims pass through (halo)
            dim_map[out_spec[2 + k]] = lhs_spec[2 + k]
        return in_sh, [_project(l_sh, dim_map, out_rank)]
    if direction == "bwd" and s_out is not None:
        l_rank = eqn.in_avals[0].ndim
        dim_map = [None] * l_rank
        dim_map[lhs_spec[0]] = out_spec[0]
        for k in range(l_rank - 2):
            dim_map[lhs_spec[2 + k]] = out_spec[2 + k]
        cand = _project(s_out, dim_map, l_rank)
        new_l = cand if l_sh is None else (merge_shardings(l_sh, cand) or l_sh)
        return [new_l, r_sh], out_sh
    return in_sh, out_sh


# ---------------------------------------------------------------------------------
# flash attention: batch and kv heads
# ---------------------------------------------------------------------------------


def flash_heads(s: Sharding) -> Sharding:
    """The rank-2 (batch, kv heads) sharding of a q, k, v or output sharding:
    dims 0 and 2 in all four."""
    return _project(s, [0, 2], 2)


def flash_layout(bh: Sharding, rank: int) -> Sharding:
    """A (batch, kv heads) sharding placed on a rank-5 q/output or a rank-4
    k/v, every other dim replicated (a 0-d position: replicated)."""
    if rank == 0:
        return Sharding(bh.mesh, ())
    return _project(bh, [0, None, 1] + [None] * (rank - 3), rank)


def decode_seq_axes(k_sh: MaybeS, q_aval) -> Tuple[str, ...]:
    """The mesh axes sharding a decode's cache on its sequence (dim 1 of
    k), which the decode keeps; none where q holds more than one row
    (S > 1: attention over a sharded T gathers it)."""
    if k_sh is None or not k_sh.rank or q_aval.shape[1] != 1:
        return ()
    return tuple(k_sh.dims_mapping[1])


def decode_layout(bh: Sharding, seq: Tuple[str, ...], rank: int) -> Sharding:
    """``flash_layout`` with batch giving up the sequence's axes and a rank-4
    k/v keeping them on its sequence dim."""
    bh = Sharding(bh.mesh, tuple(tuple(a for a in d if a not in seq) for d in bh.dims_mapping))
    out = flash_layout(bh, rank)
    if rank != 4 or not seq:
        return out
    dims = list(out.dims_mapping)
    dims[1] = tuple(seq)
    return Sharding(out.mesh, tuple(dims))


def rule_flash_attention(eqn, in_sh, out_sh, direction):
    """``flash_attention`` and ``flash_decode``: batch and kv heads shared by
    q, k, v and the output; the decode's 0-d position stays replicated, and
    a decode's cache sharded on its sequence keeps that sharding while the
    batch gives those axes up (the reference's ``shard_kv_seq``, which XLA
    partitions with small all-reduces of the softmax statistics)."""
    m = _merge_many([flash_heads(s) for s in list(in_sh) + list(out_sh)
                     if s is not None and s.rank])
    if m is None:
        return in_sh, out_sh
    seq = decode_seq_axes(in_sh[1], eqn.in_avals[0]) if eqn.name == FLASH_DECODE else ()
    return ([decode_layout(m, seq, a.ndim) for a in eqn.in_avals],
            [decode_layout(m, seq, 5)])


def _heads(s: Sharding, rank: int) -> Sharding:
    """(batch, kv heads) of a flash operand: dims 0 and 1 of the rank-3
    log-sum-exp (B, KR, S*Gl), dims 0 and 2 of the others."""
    return _project(s, [0, 1], 2) if rank == 3 else flash_heads(s)


def _heads_layout(bh: Sharding, rank: int) -> Sharding:
    return _project(bh, [0, 1, None], 3) if rank == 3 else flash_layout(bh, rank)


def rule_flash_pair(eqn, in_sh, out_sh, direction):
    """The differentiable flash operators: batch and kv heads shared by every
    operand and result."""
    avals = list(eqn.in_avals) + list(eqn.tuple_avals)
    m = _merge_many([_heads(s, a.ndim) for s, a in zip(list(in_sh) + list(out_sh), avals)
                     if s is not None])
    if m is None:
        return in_sh, out_sh
    return ([_heads_layout(m, a.ndim) for a in eqn.in_avals],
            [_heads_layout(m, a.ndim) for a in eqn.tuple_avals])


# ---------------------------------------------------------------------------------
# the SSD scan: batch, heads and head dim
# ---------------------------------------------------------------------------------

# each operand's dims as dims of the scan's (batch, heads, head dim) layout:
# x and y (B,S,H,hd), dt (B,S,H), B and C (B,S,ds), A (H,), or (B,H) with a
# row of heads per batch row (a vmapped call's fold, ``kernels/ops.py``).
# The sequence and the state dim ds stay replicated; hd may be sharded,
# since the scan is separable over it.
_SSD_DIMS = {4: (0, None, 1, 2), 3: (0, None, 1), 2: (0, 1), 1: (1,)}


def _ssd_dims(a, i: int):
    """Operand ``i``'s dims in the scan layout (B and C are operands 2 and 3)."""
    return (0, None, None) if i in (2, 3) else _SSD_DIMS[a.ndim]


def ssd_heads(s: Sharding, dims) -> Sharding:
    """The rank-3 (batch, heads, head dim) sharding of an SSD operand."""
    return _project(s, _invert(list(dims), 3), 3)


def ssd_layout(bhp: Sharding, dims) -> Sharding:
    return _project(bhp, list(dims), len(dims))


def rule_ssd(eqn, in_sh, out_sh, direction):
    """Batch, heads and head dim shared by x, dt, B, C, A and y."""
    dims = [_ssd_dims(a, i) for i, a in enumerate(eqn.in_avals)] + [_SSD_DIMS[4]]
    m = _merge_many([ssd_heads(s, d) for s, d in zip(list(in_sh) + list(out_sh), dims)
                     if s is not None])
    if m is None:
        return in_sh, out_sh
    return [ssd_layout(m, d) for d in dims[:-1]], [ssd_layout(m, dims[-1])]


def ssd_bwd_dims(eqn):
    """The scan-layout dims of the gradient's operands (x, dt, B, C, A, dy)
    and of its results (dx, ddt, dB, dC, dA)."""
    return ([_ssd_dims(a, i) for i, a in enumerate(eqn.in_avals)],
            [_ssd_dims(a, i) for i, a in enumerate(eqn.tuple_avals)])


def rule_ssd_bwd(eqn, in_sh, out_sh, direction):
    """Batch, heads and head dim shared by the operands and the gradients."""
    ins, outs = ssd_bwd_dims(eqn)
    m = _merge_many([ssd_heads(s, d) for s, d in zip(list(in_sh) + list(out_sh), ins + outs)
                     if s is not None])
    if m is None:
        return in_sh, out_sh
    return [ssd_layout(m, d) for d in ins], [ssd_layout(m, d) for d in outs]


# ---------------------------------------------------------------------------------
# ops of the captured training step: a dim dropped or inserted, index ops
# ---------------------------------------------------------------------------------


def drop_map(rank: int, dim: int) -> List[Optional[int]]:
    """For a result of rank ``rank - 1`` with ``dim`` removed: result dim ->
    operand dim."""
    return [j if j < dim else j + 1 for j in range(rank - 1)]


def insert_map(rank: int, dim: int) -> List[Optional[int]]:
    """For a result of rank ``rank + 1`` with a new ``dim``: result dim ->
    operand dim (None at ``dim``)."""
    return [None if j == dim else (j if j < dim else j - 1) for j in range(rank + 1)]


def _mapped(in_sh, out_sh, in_avals, out_avals, maps):
    """A rule over ops whose every result dim maps to one dim of each operand
    (``maps[i][j]``: result dim j -> dim of operand i, or None): merge every
    side's projection onto the result, then project it back."""
    rank = out_avals[0].ndim
    cands = [_project(s, m, rank) for s, m in zip(in_sh, maps) if s is not None]
    cands += [s for s in out_sh if s is not None]
    m = _merge_many(cands)
    if m is None:
        return in_sh, out_sh
    new_in = [_project(m, _invert(mp, a.ndim), a.ndim) for mp, a in zip(maps, in_avals)]
    return new_in, [m for _ in out_sh]


def rule_drop_dim(eqn, in_sh, out_sh, direction):
    """unbind (each result) and select: the removed dim's sharding dropped,
    the others carried."""
    a = eqn.in_avals[0]
    return _mapped(in_sh, out_sh, eqn.in_avals, eqn.out_avals or eqn.tuple_avals,
                   [drop_map(a.ndim, eqn.params["dim"])])


def rule_insert_dim(eqn, in_sh, out_sh, direction):
    """stack (every operand) and select_backward (the gradient): the new dim
    replicated, the others carried."""
    d = eqn.params["dim"]
    maps = [insert_map(a.ndim, d) for a in eqn.in_avals]
    return _mapped(in_sh, out_sh, eqn.in_avals, eqn.out_avals, maps)


def rule_keep_unmodified(eqn, in_sh, out_sh, direction):
    """slice_backward: every dim but the sliced one carried."""
    rank = eqn.out_avals[0].ndim
    mod = set(eqn.params["modified_dims"])
    mp = [None if j in mod else j for j in range(rank)]
    return _mapped(in_sh, out_sh, eqn.in_avals, eqn.out_avals, [mp])


def index_maps(eqn) -> List[List[Optional[int]]]:
    """Result dim -> operand dim for the index ops' pass-through dims (the
    indexed dim maps to nothing):

    * embedding(weight (V, M), indices (...)) -> (..., M);
    * embedding_dense_backward(grad (..., M), indices (...)) -> (V, M);
    * gather(input, dim, index) -> index's shape;
    * scatter_add(self, dim, index, src) -> self's shape.

    A dim maps between operands of equal size only."""
    name, ins = eqn.name, eqn.in_avals
    out = eqn.out_avals[0]
    if name == "aten.embedding":
        w, idx = ins
        k = idx.ndim
        return [[None] * k + [1], list(range(k)) + [None]]
    if name == "aten.embedding_dense_backward":
        g, idx = ins
        k = idx.ndim
        return [[None, k], [None, None]]
    d = eqn.params["dim"]

    def same(a):
        return [j if j != d and a.shape[j] == out.shape[j] else None for j in range(out.ndim)]

    if name == "aten.gather":
        inp, idx = ins
        return [same(inp), [j if j != d else None for j in range(out.ndim)]]
    s, idx, src = ins  # scatter_add: self keeps every dim, the indexed one too
    return [list(range(out.ndim)), same(idx), same(src)]


def rule_index(eqn, in_sh, out_sh, direction):
    return _mapped(in_sh, out_sh, eqn.in_avals, eqn.out_avals, index_maps(eqn))


def index_copy_maps(eqn) -> List[List[Optional[int]]]:
    """index_copy(self, dim, index, source) -> self's shape: every dim of
    self carried, the written one too; source's dims but the written one
    (its length is the index's); the index replicated."""
    d, rank = eqn.params["dim"], eqn.out_avals[0].ndim
    return [list(range(rank)), [None] * rank, [j if j != d else None for j in range(rank)]]


def rule_index_copy(eqn, in_sh, out_sh, direction):
    """The cache write of a decode step, the counterpart of the reference's
    ``dynamic_update_slice_in_dim``: the written dim keeps its sharding (the
    partitioner writes each device's rows, masked where that dim is
    sharded), the source follows the other dims."""
    return _mapped(in_sh, out_sh, eqn.in_avals, eqn.out_avals, index_copy_maps(eqn))


# ---------------------------------------------------------------------------------
# registry + priorities
# ---------------------------------------------------------------------------------

SAME_RANK = {"aten.constant_pad_nd", "aten.flip", "aten.cat", "aten.slice",
             "aten.cumsum", "aten.cumprod"}
TRANSPOSE = {"aten.permute", "aten.transpose", "aten.t"}
BROADCAST = {"aten.unsqueeze", "aten.expand"}
RESHAPE = {"aten.view", "aten._unsafe_view", "aten.reshape", "aten.squeeze"}
REDUCE = {"aten.sum", "aten.mean", "aten.amax", "aten.amin", "aten.prod",
          "aten.any", "aten.all", "aten.logsumexp"}
ARGMINMAX = {"aten.argmax", "aten.argmin"}
DOT = {"aten.mm", "aten.bmm"}
# created replicated, like the reference's iota
FACTORY = {"aten." + n for n in (
    "ones", "zeros", "full", "empty", "arange", "scalar_tensor", "eye", "linspace",
    "randn", "rand", "randint", "new_ones", "new_zeros", "new_full", "new_empty")}

_PARAMS = {
    "aten.permute": _permute_params,
    "aten.transpose": _transpose_params,
    "aten.t": _t_params,
    "aten.unsqueeze": _unsqueeze_params,
    "aten.expand": _expand_params,
    "aten.mm": _mm_params,
    "aten.bmm": _bmm_params,
    "aten.addmm": _addmm_params,
    "aten.convolution": _conv_params,
    "aten.cat": _cat_params,
    "aten.slice": _slice_params,
    "aten.constant_pad_nd": _pad_params,
    "aten.flip": _flip_params,
    FLASH: _flash_params,
    FLASH_FWD: lambda node, ins, out: {"causal": bool(kwargs_of(node)["causal"]),
                                       "chunk": int(kwargs_of(node)["chunk"])},
    FLASH_BWD: lambda node, ins, out: {"causal": bool(kwargs_of(node)["causal"])},
    "aten.unbind": _drop_dim_params,
    "aten.select": _drop_dim_params,
    "aten.stack": _stack_params,
    "aten.select_backward": _select_backward_params,
    "aten.slice_backward": _slice_backward_params,
    "aten.gather": _gather_params,
    "aten.scatter_add": _gather_params,
    "aten.index_copy": _gather_params,
    FLASH_DECODE: lambda node, ins, out: {"causal": False,
                                          "chunk": int(kwargs_of(node)["chunk"])},
    SSD: lambda node, ins, out: {"chunk": int(kwargs_of(node)["chunk"])},
    SSD_BWD: lambda node, ins, out: {"chunk": int(kwargs_of(node)["chunk"])},
    STAGE_SHIFT: lambda node, ins, out: {"reverse": bool(kwargs_of(node)["reverse"])},
}
for _n in REDUCE | ARGMINMAX:
    _PARAMS[_n] = _reduce_params

def rule_stage_shift(eqn, in_sh, out_sh, direction):
    """§3.3 shifting buffer (``repro_torch::stage_shift``): the shift moves
    data *along* the stage dim, so every dim's sharding passes straight
    through (the stage dim's included: each slot moves globally, landing on
    the neighbour shard by a ppermute at partition time).  The injected row
    ``x`` (one rank lower) aligns with the state's trailing dims."""
    s_state, s_x = in_sh
    (s_out,) = out_sh
    cands = [s for s in (s_state, s_out) if s is not None]
    if s_x is not None:
        # the injected row lifted to the state's rank with an unsharded stage
        # dim; the merge fails (None) where x uses the stage axis: left alone
        cands.append(Sharding(s_x.mesh, ((),) + s_x.dims_mapping))
    m = _merge_many(cands)
    if m is None:
        return in_sh, out_sh
    return [m, Sharding(m.mesh, m.dims_mapping[1:])], [m]


RULES = {}
PRIORITY = {}

for name in ELEMENTWISE:
    RULES[name] = rule_elementwise
    PRIORITY[name] = 0
for name in SAME_RANK:
    RULES[name] = rule_same_rank_passthrough
    PRIORITY[name] = 1
for name in TRANSPOSE:
    RULES[name] = rule_transpose
    PRIORITY[name] = 1
for name in BROADCAST:
    RULES[name] = rule_broadcast_in_dim
    PRIORITY[name] = 0  # paper: backward through Broadcast is high prio
for name in RESHAPE:
    RULES[name] = rule_reshape
    PRIORITY[name] = 1
for name in REDUCE | ARGMINMAX:
    RULES[name] = rule_reduce
    PRIORITY[name] = 2
for name in DOT:
    RULES[name] = rule_dot_general
    PRIORITY[name] = 2
RULES["aten.addmm"] = rule_addmm
PRIORITY["aten.addmm"] = 2
RULES["aten.convolution"] = rule_conv
PRIORITY["aten.convolution"] = 2
for name in (FLASH, FLASH_DECODE):
    RULES[name] = rule_flash_attention
    PRIORITY[name] = 2
RULES[SSD] = rule_ssd
PRIORITY[SSD] = 2
RULES[SSD_BWD] = rule_ssd_bwd
PRIORITY[SSD_BWD] = 2
for name in (FLASH_FWD, FLASH_BWD):
    RULES[name] = rule_flash_pair
    PRIORITY[name] = 2
INDEX = {"aten.embedding", "aten.embedding_dense_backward", "aten.gather", "aten.scatter_add"}
for name, rule in (("aten.unbind", rule_drop_dim), ("aten.select", rule_drop_dim),
                   ("aten.stack", rule_insert_dim), ("aten.select_backward", rule_insert_dim),
                   ("aten.slice_backward", rule_keep_unmodified),
                   ("aten.index_copy", rule_index_copy),
                   *((n, rule_index) for n in INDEX)):
    RULES[name] = rule
    PRIORITY[name] = 1

RULES[STAGE_SHIFT] = rule_stage_shift
PRIORITY[STAGE_SHIFT] = 1

MAX_PRIORITY = 3
