"""The SPMD partitioner (paper §4), dynamic reference path.

A port of the JAX package's ``core/partitioner.py`` (``SpmdPartitioner`` and
``spmd_partition(..., compile_plans=False)``).  A program written against
global shapes with ``annotate`` hints is captured to an aten graph
(``compat.capture``), its shardings are completed (``propagation.py``), and
the graph then runs as one SPMD program over the local shards of a
simulated mesh (``mesh_runtime.py``: every value is the stack of all
devices' shards), with explicit collectives:

* mm / bmm / addmm — einsum partitioning with recursive grouping (§4.4) via
                     ``einsum_rules.partitioned_einsum`` (AllReduce /
                     ReduceScatter / AllGather as required);
* elementwise      — operands resharded to the merged sharding, computed
                     locally (aten's implicit broadcast: a size-1 or missing
                     dim stays replicated on that operand);
* reductions       — local reduce + psum (pmax, pmin) over mesh axes sharding
                     reduced dims; a mean divides the psum by the group size;
* convolution      — halo exchange on sharded spatial dims (§4.3);
* formatting       — pad/slice/cat/flip keep the sharding of the dims they do
                     not touch and gather the rest (§4.5);
* flash attention  — the ``repro_torch::flash_attention`` op on batch- and
                     kv-head-sharded operands (S, T and D gathered), one
                     kernel launch for all devices (``flash_local``), and
                     so the differentiable pair ``flash_attention_fwd`` /
                     ``_bwd`` and the decode step's ``flash_decode`` at a
                     tensor position (``LocalOp`` decisions, below); a
                     decode over a sequence-sharded cache keeps it sharded
                     and combines the shards with small all-reduces;
* SSD scan         — ``repro_torch::ssd_scan`` on batch-, head- and
                     head-dim-sharded operands, one call for all devices
                     with each device's A per folded row, and its gradient
                     ``repro_torch::ssd_scan_bwd`` the same way, its sums
                     over heads, head dim and rows completed by psums;
* cache write      — ``index_copy`` writes each device's rows, masked
                     where the written dim is sharded;
* index ops        — embedding, its gradient, gather and scatter_add with
                     the indexed dim sharded: masked local lookups plus a
                     psum, or masked local scatters, no gather of the table;
* logsumexp        — local max, pmax, local sum of exp, psum;
* stack / unbind / select and their gradients — the dim they insert,
                     remove or slice replicated, the others kept;
* factories        — replicated, a sharded constant fill at its local shape;
* annotate         — explicit resharding to the user's annotation (its
                     unspecified dims as completion left them);
* scan             — the body (``core/scan.py``) partitioned under its
                     completed shardings (``Propagation.sub``), each operand
                     resharded to the body's input sharding (an x's with its
                     leading scan dim unsharded), the body run once per trip
                     on the stacked shards' trip slices, the carry kept in
                     its carry-in sharding, the ys stacked on an unsharded
                     leading dim (``scan_body_shardings``).

An op with no handler takes ``_fallback``: gather every operand, run the op
on the global values, reshard to the propagated sharding — GSPMD semantics,
exactly as in the reference.  The §3.3 stage shift
(``repro_torch::stage_shift``) takes it here, as in the reference's
dynamic partitioner, which has no handler for it either: its ppermute
lowering is the compiled plan's (``plan.py::PlanBuilder._stage_shift``).
The partitioner records the op names that took it (``fallbacks``), so a
run shows where the reference would gather.

The decisions and local computations of every handler are module-level
functions shared with the compiled-plan path (``core/plan.py``): this path
makes every decision anew on each call, as the reference's dynamic path
does; ``spmd_partition(..., compile_plans=True)`` (the default) makes them
once per input signature into a ``PartitionPlan`` and executes it on every
call.
"""
from __future__ import annotations

import dataclasses
import functools
import string
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.fx
from torch.utils._pytree import tree_flatten

from ..analysis import graph_cost  # a module import: graph_cost imports core.rules
from ..kernels.ops import (flash_attention_bwd_op, flash_attention_fwd_op, flash_decode,
                           a_per_row, flash_decode_partial, flash_forward, ssd, ssd_scan_bwd_op)
from . import mesh_runtime as mr
from .annotate import ANNOTATE_OP, decode
from .compat import capture
from .device import resolve_device
from .einsum_rules import partitioned_einsum
from .halo import local_conv, sharded_conv_nd
from .propagation import PropagationResult, add0, drop0, propagate
from .reshard import reshard_local, shard_shape
from .rules import (BROADCAST, DOT, ELEMENTWISE, FACTORY, FLASH, FLASH_BWD, FLASH_DECODE, SCANS,
                    FLASH_FWD, REDUCE, RESHAPE, SSD, SSD_BWD, TRANSPOSE, _SSD_DIMS, _bcast_map,
                    _heads, _heads_layout, _invert, _project, _reshape_dim_map, _ssd_dims,
                    decode_layout, decode_seq_axes, flash_heads, flash_layout, index_copy_maps,
                    index_maps, insert_map, kwargs_of, lower, ssd_bwd_dims, ssd_heads,
                    ssd_layout)
from .sharding import Mesh, Sharding, merge_shardings, replicated


# the reductions that combine local results across devices (the rest gather),
# by the collective that combines them
REDUCE_OP = {"aten.sum": "add", "aten.mean": "add", "aten.amax": "max", "aten.amin": "min"}
COLLECTIVE = {"add": mr.psum, "max": mr.pmax, "min": mr.pmin}


def _substitute(x, value_of):
    """Node arguments with every Node replaced by ``value_of(node)``."""
    if isinstance(x, torch.fx.Node):
        return value_of(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_substitute(a, value_of) for a in x)
    return x


# ---------------------------------------------------------------------------------
# per-op decisions and local compute, shared by both paths
# ---------------------------------------------------------------------------------
#
# Every handler splits into a decision (target shardings, collectives, output
# sharding: a function of the op, its shapes and its operands' shardings,
# never of data) and a local computation on stacked shards.  The dynamic
# ``SpmdPartitioner`` below makes the decision and computes at once on every
# call; ``core/plan.py::PlanBuilder`` makes each decision once and records
# the computation as a plan step.


def run_node(node, value_of):
    """The node's op on the values ``value_of`` gives its Node arguments."""
    return node.target(*_substitute(node.args, value_of),
                       **{k: _substitute(a, value_of) for k, a in node.kwargs.items()})


def dot_spec(eqn) -> str:
    """mm / bmm / addmm's ``dimension_numbers`` as an einsum spec."""
    (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
    lrank, rrank = eqn.in_avals[-2].ndim, eqn.in_avals[-1].ndim
    letters = iter(string.ascii_lowercase)
    l_names = [next(letters) for _ in range(lrank)]
    r_names = [None] * rrank
    for i, j in zip(lb, rb):
        r_names[j] = l_names[i]
    for i, j in zip(lc, rc):
        r_names[j] = l_names[i]
    for j in range(len(r_names)):
        if r_names[j] is None:
            r_names[j] = next(letters)
    l_nc = [i for i in range(len(l_names)) if i not in lc and i not in lb]
    r_nc = [j for j in range(len(r_names)) if j not in rc and j not in rb]
    out_names = [l_names[i] for i in lb] + [l_names[i] for i in l_nc] + [r_names[j] for j in r_nc]
    return f"{''.join(l_names)},{''.join(r_names)}->{''.join(out_names)}"


def align(v, rank: int, out_rank: int):
    """A stacked operand of rank ``rank`` shaped to broadcast against a
    stacked result of rank ``out_rank`` as aten would: a rank-0 operand
    becomes the 0-d value (replicated, so every device holds the same),
    keeping aten's type promotion for 0-d tensors."""
    if rank == out_rank:
        return v
    if rank == 0:
        return v[0]
    return v.reshape((v.shape[0],) + (1,) * (out_rank - rank) + tuple(v.shape[1:]))


def elementwise_targets(eqn, shardings, mesh: Mesh):
    """The result's sharding (the merge of the operands' on the dims they
    carry into the output) and each operand's target.  A size-1 broadcast
    dim stays replicated on that operand: every shard needs its value."""
    out_shape = eqn.out_avals[0].shape
    rank = len(out_shape)
    maps = [_bcast_map(a.shape, out_shape) for a in eqn.in_avals]
    tgt = None
    for s, mp in zip(shardings, maps):
        m = _project(s, mp, rank)
        tgt = m if tgt is None else (merge_shardings(tgt, m) or tgt)
    if tgt is None:
        tgt = replicated(mesh, rank)
    return tgt, [_project(tgt, _invert(mp, a.ndim), a.ndim)
                 for mp, a in zip(maps, eqn.in_avals)]


def elementwise_local(eqn):
    """The op on stacked operands, given in ``eqn.invars`` order."""
    node, invars = eqn.node, eqn.invars
    ranks = [a.ndim for a in eqn.in_avals]
    out_rank = eqn.out_avals[0].ndim

    def run(*vals):
        local = {v: align(x, r, out_rank) for v, x, r in zip(invars, vals, ranks)}
        return run_node(node, local.__getitem__)

    return run


def reduce_decision(eqn, sh: Sharding, mesh: Mesh):
    """(psum axes, gather first, output sharding): a sum, mean, max or min
    over sharded dims reduces locally and then across the devices; prod,
    any and all gather the operand first."""
    name, axes = eqn.name, eqn.params["axes"]
    psum_axes = tuple(a for d in axes for a in sh.dims_mapping[d])
    gather_first = bool(psum_axes) and name not in REDUCE_OP
    src = replicated(mesh, sh.rank) if gather_first else sh
    osh = Sharding(mesh, tuple(
        src.dims_mapping[i] if i is not None else () for i in eqn.params["out_to_in"]))
    return (() if gather_first else psum_axes), gather_first, osh


def local_reduce(name, val, axes, keepdim, out_dtype):
    if not axes:  # a 0-d operand: nothing to reduce
        return val.to(out_dtype)
    dims = [a + 1 for a in axes]
    if name in ("aten.sum", "aten.mean"):
        fn = torch.sum if name == "aten.sum" else torch.mean
        return fn(val, dim=dims, keepdim=keepdim, dtype=out_dtype)
    if name in ("aten.amax", "aten.amin"):
        fn = torch.amax if name == "aten.amax" else torch.amin
        return fn(val, dim=dims, keepdim=keepdim)
    # prod / any / all reduce one dim at a time, innermost first
    fn = {"aten.prod": torch.prod, "aten.any": torch.any, "aten.all": torch.all}[name]
    out = val
    for d in sorted(dims, reverse=True):
        out = fn(out, dim=d, keepdim=keepdim)
    return out.to(out_dtype)


def group_size(mesh: Mesh, axes) -> int:
    return int(np.prod([mesh.axis_size(a) for a in axes]))


def transpose_sharding(eqn, sh: Sharding, mesh: Mesh) -> Sharding:
    return Sharding(mesh, tuple(sh.dims_mapping[i] for i in eqn.params["permutation"]))


def broadcast_sharding(eqn, sh: Sharding, mesh: Mesh) -> Sharding:
    """A broadcast dim keeps its operand dim's sharding where sizes match."""
    bcast, gshape = eqn.params["broadcast_dimensions"], eqn.params["shape"]
    dm = [() for _ in gshape]
    in_shape = eqn.in_avals[0].shape
    for i, j in enumerate(bcast):
        if in_shape[i] == gshape[j]:
            dm[j] = sh.dims_mapping[i]
    return Sharding(mesh, tuple(dm))


def broadcast_local(val, bcast, local_shape):
    placed = [1] * len(local_shape)
    for i, j in enumerate(bcast):
        placed[j] = val.shape[1 + i]
    return val.reshape([val.shape[0]] + placed).expand([val.shape[0]] + list(local_shape))


def local_reshape_ok(in_shape, out_shape, sh: Sharding, want: Sharding) -> bool:
    """A reshape of each shard is the shard of the reshape when every
    sharded dim is the major dim of a matching factor block on both sides,
    sharded the same way (the maps propagation itself uses)."""
    i2o, o2i = _reshape_dim_map(in_shape, out_shape)
    pairs = set(i2o.items()) | {(i, j) for j, i in o2i.items()}
    for i, axes in enumerate(sh.dims_mapping):
        if axes and not any(p == i and want.dims_mapping[q] == axes for p, q in pairs):
            return False
    for j, axes in enumerate(want.dims_mapping):
        if axes and not any(q == j and sh.dims_mapping[p] == axes for p, q in pairs):
            return False
    return True


def reshape_carried(in_shape, out_shape, sh: Sharding, want: Sharding) -> Optional[Sharding]:
    """Where a reshape of each shard and then slices alone reach ``want``, the
    sharding the local reshape gives (every sharded input dim's axes on the
    output dim that heads its factor block, ``want`` adding axes after
    them); None otherwise, and the reshape gathers."""
    i2o, o2i = _reshape_dim_map(in_shape, out_shape)
    pairs = set(i2o.items()) | {(i, j) for j, i in o2i.items()}
    dims = [()] * len(out_shape)
    for i, axes in enumerate(sh.dims_mapping):
        if not axes:
            continue
        q = next((q for p, q in sorted(pairs) if p == i), None)
        if q is None or out_shape[q] % group_size(sh.mesh, axes):
            return None
        dims[q] = axes
    if any(w[:len(m)] != m for m, w in zip(dims, want.dims_mapping)):
        return None
    mid = Sharding(sh.mesh, tuple(dims))
    return mid if local_reshape_ok(in_shape, out_shape, sh, mid) else None


def conv_target(eqn, ls: Sharding, mesh: Mesh) -> Optional[Sharding]:
    """The input layout the convolution runs in exactly (one axis per sharded
    spatial dim, where the output divides; feature sharding only without
    spatial sharding), or None for the fallback (base or window dilation,
    transposed and grouped convolutions, §A.2)."""
    p = eqn.params
    if any(d != 1 for d in p["dilation"]) or p["transposed"] or p["groups"] != 1:
        return None
    strides, padding = p["window_strides"], p["padding"]
    keep = list(ls.dims_mapping)
    for d in range(2, ls.rank):
        axes = keep[d][:1]
        if axes:
            n = mesh.axis_size(axes[0])
            k = eqn.in_avals[1].shape[d]
            lo, hi = padding[d - 2]
            out_len = (eqn.in_avals[0].shape[d] + lo + hi - k) // strides[d - 2] + 1
            if out_len % n:
                axes = ()
        keep[d] = axes
    if keep[1] and any(keep[2:]):
        keep[1] = ()
    return Sharding(mesh, tuple(keep))


def conv_feature_local(lv, rv, mesh: Mesh, ax, strides, padding):
    """Feature-dim sharded: each device's slice of the kernel's input
    features against its shard (Megatron-style); the caller psums."""
    for a in ax:
        rv = mr.dynamic_slice_by_axis_index(rv, mesh, a, 1)
    return local_conv(lv, rv, strides, padding, same_kernel=False)


def conv_halo_local(lv, rv, mesh: Mesh, ls: Sharding, strides, padding):
    """Spatial dims sharded: halo exchange, then the local convolution."""
    sharded = [(d, ls.dims_mapping[d][0]) for d in range(2, ls.rank) if ls.dims_mapping[d]]
    return sharded_conv_nd(lv, rv, mesh=mesh, sharded=sharded,
                           window_strides=strides, padding=padding)


def annotation_target(node, prop) -> Sharding:
    """The sharding an annotation node holds its value in: its own, with
    any unspecified dim (§3.5 partial specification, e.g. the dim a vmapped
    annotation inserts) as completion left it."""
    tgt, unspec = decode(*node.args[1:])
    done = prop.get(node)
    if not unspec or done is None:
        return tgt
    return Sharding(tgt.mesh, tuple(done.dims_mapping[d] if d in unspec else tgt.dims_mapping[d]
                                    for d in range(tgt.rank)))


def conv_bias(out, bv):
    return out + bv.reshape((bv.shape[0], 1, bv.shape[1]) + (1,) * (out.ndim - 3))


def flash_targets(eqn, shardings, want: Optional[Sharding], mesh: Mesh):
    """The (batch, kv heads) layout the flash-attention op runs in: the
    completed output sharding's, else the merge of the operands'.  Any axis
    on S, T, Gl or D is gathered.  Returns the targets of q, k, v and the
    output's sharding."""
    cands = [want] if want is not None else [s for s in shardings if s.rank]
    bh = None
    for s in cands:
        m = flash_heads(s)
        bh = m if bh is None else (merge_shardings(bh, m) or bh)
    return [flash_layout(bh, a.ndim) for a in eqn.in_avals], flash_layout(bh, 5)


def _fold(x):
    """Stacked (n, B, ...) as (n·B, ...): a view when the two dims merge; a
    copy where they do not, or where the kernel's 16-byte alignment of the
    base and strides (unit-stride head dim) would not hold."""
    y = x.reshape((-1,) + tuple(x.shape[2:]))
    esz = y.element_size()
    if (y.stride(-1) != 1 or y.data_ptr() % 16
            or any(s * esz % 16 for n, s in zip(y.shape[:-1], y.stride()[:-1]) if n > 1)):
        y = y.contiguous()
    return y


def flash_local(q, k, v, params):
    """One launch for every device: the stacked device dim is folded into
    the batch (q (n, B, S, KR, Gl, D) runs as (n·B, S, KR, Gl, D))."""
    out = flash_forward(_fold(q), _fold(k), _fold(v), params["causal"],
                        params["q_offset"], params["kv_len"], params["chunk"])
    return out.reshape(q.shape)


# ---------------------------------------------------------------------------------
# ops decided as one local computation: LocalOp
# ---------------------------------------------------------------------------------
#
# The differentiable flash operators, the factories, the ops of a captured
# training step that drop, insert or slice a dim, ``logsumexp`` and the index
# ops.  Each ``decide_*`` function takes the equation, its operands'
# current shardings, the completed sharding of its result (a list for a
# tuple result) and the mesh, and returns a ``LocalOp``, or None where the
# op must take the fallback.  Both paths reshard each operand to its target
# and run ``fn`` on the stacked shards; ``fn`` runs the op's collectives
# itself (the masked lookups' psums, logsumexp's pmax and psum).


@dataclasses.dataclass
class LocalOp:
    targets: list  # each operand's target sharding, in ``eqn.invars`` order
    out: object  # the result's sharding (a list for a tuple result)
    fn: object  # the local computation on the resharded stacked operands
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)  # run by fn
    flops: float = 0.0  # per-device local FLOPs


def _want(eqn, prop) -> object:
    """The completed sharding of the result, a list for a tuple result."""
    if eqn.out_avals:
        return prop.get(eqn.node)
    return [prop.get(o) for o in eqn.tuple_outs]


def _sharding(mesh: Mesh, dims) -> Sharding:
    return Sharding(mesh, tuple(tuple(a) for a in dims))


def _without(sh: Sharding, axes) -> Sharding:
    """``sh`` with the mesh axes ``axes`` taken off every dim."""
    return _sharding(sh.mesh, [tuple(a for a in d if a not in axes) for d in sh.dims_mapping])


@functools.lru_cache(maxsize=256)
def _offsets(sh: Sharding, dim: int, size: int) -> tuple:
    """Each stacked position's offset along ``dim`` of a tensor of global
    ``size`` there, under ``sh``."""
    return tuple(sh.offset(int(d), dim, size) for d in sh.mesh.devices.flat)


def _offsets_like(sh: Sharding, dim: int, size: int, like: torch.Tensor) -> torch.Tensor:
    """The offsets as a tensor that broadcasts against the stacked ``like``."""
    t = mr._on_device(_offsets(sh, dim, size), torch.long, like.device)
    return t.reshape((-1,) + (1,) * (like.ndim - 1))


# -- the flash operator pair ---------------------------------------------------------


def _flash_pair_targets(eqn, shardings, want, mesh: Mesh):
    """Batch and kv heads of the result's completed shardings (else of the
    operands'), on every operand and result; S, T, Gl and D gathered."""
    avals = list(eqn.tuple_avals)
    cands = [(s, a) for s, a in zip(want or [], avals) if s is not None] or \
        list(zip(shardings, eqn.in_avals))
    bh = None
    for s, a in cands:
        m = _heads(s, a.ndim)
        bh = m if bh is None else (merge_shardings(bh, m) or bh)
    return ([_heads_layout(bh, a.ndim) for a in eqn.in_avals],
            [_heads_layout(bh, a.ndim) for a in avals])


def decide_flash(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """The no-gradient forward: ``flash_targets``, one launch (``flash_local``)."""
    targets, osh = flash_targets(eqn, shardings, want, mesh)
    params = eqn.params
    B, S, KR, Gl, D = shard_shape(eqn.in_avals[0].shape, targets[0])
    return LocalOp(targets, osh, lambda q, k, v: flash_local(q, k, v, params),
                   flops=graph_cost.flash_flops(B, S, KR * Gl, eqn.in_avals[1].shape[1], D,
                                     params["causal"]))


def decide_flash_decode(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """A decode step's attention at a tensor position: ``flash_targets`` (the
    0-d position replicated), one launch for every device, the stacked
    device dim folded into the batch as ``flash_local``; the kernel reads
    the position (every device's copy is the same) on the device.

    Where the cache is sharded on its sequence (``rules.decode_seq_axes``:
    the reference's ``shard_kv_seq``), the cache stays sharded and the
    batch gives up those axes: one launch for every device still, each
    folded row at the position relative to its shard's first key
    (``flash_decode_partial``; a row before its shard sees no key), and the
    shards combined by their log-sum-exps (``combine_decode``): a pmax, then
    psums of the weighted outputs and of the weights."""
    seq = decode_seq_axes(shardings[1], eqn.in_avals[0])
    targets, osh = flash_targets(eqn, shardings, want, mesh)
    chunk = eqn.params["chunk"]
    if seq:
        bh = flash_heads(osh)
        targets = [decode_layout(bh, seq, a.ndim) for a in eqn.in_avals]
        osh = decode_layout(bh, seq, 5)
    B, S, KR, Gl, D = shard_shape(eqn.in_avals[0].shape, targets[0])
    T = eqn.in_avals[1].shape[1]
    flops = graph_cost.flash_flops(B, S, KR * Gl, shard_shape((T,), _sharding(mesh, [seq]))[0],
                                   D, False)
    if not seq:
        def fn(q, k, v, pos):
            return flash_decode(_fold(q), _fold(k), _fold(v), pos[0], chunk).reshape(q.shape)

        return LocalOp(targets, osh, fn, flops=flops)

    def fn(q, k, v, pos):
        n, b = q.shape[:2]
        # each device's rows at the position relative to its shard
        rel = pos.long() - _offsets_like(targets[1], 1, T, pos)
        rows = rel.to(torch.int32)[:, None].expand(n, b).reshape(n * b)
        out, lse = flash_decode_partial(_fold(q), _fold(k), _fold(v), rows, chunk)
        return combine_decode(out.reshape(q.shape), lse.reshape((n, b) + tuple(lse.shape[1:])),
                              mesh, seq)

    return LocalOp(targets, osh, fn, collectives={"all-reduce": 3},
                   flops=flops + graph_cost.decode_combine_flops(B, S, KR * Gl, D))


def combine_decode(out, lse, mesh: Mesh, axes):
    """The shards' partial decodes as one: out (n, B, S, KR, Gl, D) each
    normalised over its own keys, lse (n, B, KR, S * Gl) their float32
    log-sum-exps (-1e9 where a shard saw no key).  M = pmax(lse); each
    shard weighs by w = e^(lse - M); the result, sum(w out) / sum(w) by two
    psums over ``axes``, is rounded to out's dtype once."""
    n, B, S, KR, Gl, D = out.shape
    M = mr.pmax(lse, mesh, axes)
    w = torch.exp(lse - M).reshape(n, B, KR, S, Gl).permute(0, 1, 3, 2, 4)[..., None]
    num = mr.psum(w * out.float(), mesh, axes)
    return (num / mr.psum(w, mesh, axes)).to(out.dtype)


def decide_ssd(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """One call of the SSD scan (three kernel launches on the card) for every
    device: batch, heads and head dim of the completed output sharding (else
    the merge of the operands'), S and the state dim gathered; the stacked
    device dim folded into the batch, with each device's A repeated over its
    rows (or its per-row A merged), which the kernel reads per row (A (n·B,
    H), ``ops.a_per_row``)."""
    dims = [_ssd_dims(a, i) for i, a in enumerate(eqn.in_avals)]
    cands = [(want, _SSD_DIMS[4])] if want is not None else list(zip(shardings, dims))
    bhp = None
    for s, d in cands:
        m = ssd_heads(s, d)
        bhp = m if bhp is None else (merge_shardings(bhp, m) or bhp)
    targets = [ssd_layout(bhp, d) for d in dims]
    chunk = eqn.params["chunk"]
    Bb, S, H, hd = shard_shape(eqn.in_avals[0].shape, targets[0])

    def fn(x, dt, B, C, A):
        y = ssd(_fold(x), _fold(dt), _fold(B), _fold(C), a_per_row(A, *x.shape[:2]),
                chunk=chunk)
        return y.reshape(x.shape)

    return LocalOp(targets, ssd_layout(bhp, _SSD_DIMS[4]), fn,
                   flops=graph_cost.ssd_flops(Bb, S, H, hd, eqn.in_avals[2].shape[-1], chunk))


def decide_ssd_bwd(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """One call of the SSD's backward (six launches on the card) for every
    device, laid out as ``decide_ssd``: batch, heads and head dim of dx's
    completed sharding (else the merge of the operands'), the device dim
    folded into the batch with A per row.  Each device's dB and dC are
    sums over its heads and head-dim slice, ddt and dA sums over its
    head-dim slice, and its dA (one per folded row) a sum over its rows;
    the op completes them itself: dB and dC psum over the axes sharding
    heads or the head dim, ddt over those sharding the head dim, and dA,
    summed over each device's rows, over those sharding the batch or the
    head dim.  Where A has a row of heads per batch row (B, H), so has dA:
    it is not summed over rows, and psums over the head-dim axes only."""
    ins, outs = ssd_bwd_dims(eqn)
    dx_want = want[0] if want else None
    cands = [(dx_want, outs[0])] if dx_want is not None else list(zip(shardings, ins))
    bhp = None
    for s, d in cands:
        m = ssd_heads(s, d)
        bhp = m if bhp is None else (merge_shardings(bhp, m) or bhp)
    batch, heads, hdim = (tuple(a) for a in bhp.dims_mapping)
    chunk = eqn.params["chunk"]
    targets = [ssd_layout(bhp, d) for d in ins]
    Bb, S, H, hd = shard_shape(eqn.in_avals[0].shape, targets[0])
    per_row = eqn.in_avals[4].ndim == 2
    sums = {"dB": heads + hdim, "dC": heads + hdim, "ddt": hdim,
            "dA": hdim if per_row else batch + hdim}

    def fn(x, dt, B, C, A, dy):
        n, b = x.shape[:2]
        dx, ddt, dB, dC, dA = ssd_scan_bwd_op(_fold(x), _fold(dt), _fold(B), _fold(C),
                                              a_per_row(A, n, b), _fold(dy), chunk)
        dA = dA.reshape(A.shape) if per_row else dA.reshape(n, b, -1).sum(1)
        out = {"dB": dB.reshape(B.shape), "dC": dC.reshape(C.shape), "ddt": ddt.reshape(dt.shape),
               "dA": dA}
        out = {k: mr.psum(v, mesh, sums[k]) for k, v in out.items()}
        return [dx.reshape(x.shape), out["ddt"], out["dB"], out["dC"], out["dA"]]

    return LocalOp(targets, [ssd_layout(bhp, d) for d in outs], fn,
                   collectives={"all-reduce": sum(1 for a in sums.values() if a)},
                   flops=graph_cost.ssd_bwd_flops(Bb, S, H, hd, eqn.in_avals[2].shape[-1], chunk))


def decide_index_copy(eqn, shardings, want, mesh: Mesh) -> Optional[LocalOp]:
    """The decode step's cache write, ``self.index_copy(d, index, source)``:
    where dim d is not sharded each device writes its shard's rows locally;
    where it is (a sequence-sharded cache), each device writes a one-row
    source where the index falls in its range (a masked local write: a
    select against the global position of each local row), and no device
    gathers the cache.  A sharded dim with more than one index row takes
    the fallback."""
    d = eqn.params["dim"]
    maps = index_copy_maps(eqn)
    base = want if want is not None else shardings[0]
    targets = [_project(base, _invert(mp, a.ndim), a.ndim)
               for mp, a in zip(maps, eqn.in_avals)]
    A = base.dims_mapping[d]
    if not A:
        return LocalOp(targets, base, lambda x, idx, src: x.index_copy(d + 1, idx[0], src))
    if eqn.in_avals[1].shape != (1,):
        return None
    size = eqn.out_avals[0].shape[d]

    def fn(x, idx, src):
        n_l = x.shape[d + 1]
        rows = torch.arange(n_l, device=x.device).reshape((1, n_l) + (1,) * (x.ndim - d - 2))
        at = idx.reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(rows + _offsets_like(base, d, size, x) == at, src.to(x.dtype), x)

    return LocalOp(targets, base, fn)


def decide_flash_fwd(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """One launch of the forward (with the log-sum-exp) for every device:
    the stacked device dim folded into the batch, as ``flash_local``."""
    targets, outs = _flash_pair_targets(eqn, shardings, want, mesh)
    causal, chunk = eqn.params["causal"], eqn.params["chunk"]
    B, S, KR, Gl, D = shard_shape(eqn.in_avals[0].shape, targets[0])

    def fn(q, k, v):
        out, lse = flash_attention_fwd_op(_fold(q), _fold(k), _fold(v), causal, chunk)
        return [out.reshape(q.shape), lse.reshape(tuple(q.shape[:2]) + tuple(lse.shape[1:]))]

    return LocalOp(targets, outs, fn, flops=graph_cost.flash_flops(
        B, S, KR * Gl, eqn.in_avals[1].shape[1], D, causal))


def decide_flash_bwd(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """One call of the backward for every device, folded as the forward."""
    targets, outs = _flash_pair_targets(eqn, shardings, want, mesh)
    causal = eqn.params["causal"]
    B, S, KR, Gl, D = shard_shape(eqn.in_avals[0].shape, targets[0])

    def fn(q, k, v, out, lse, dout):
        dq, dk, dv = flash_attention_bwd_op(*(_fold(t) for t in (q, k, v, out, lse, dout)),
                                            causal)
        return [dq.reshape(q.shape), dk.reshape(k.shape), dv.reshape(v.shape)]

    return LocalOp(targets, outs, fn, flops=graph_cost.flash_bwd_flops(
        B, S, KR * Gl, eqn.in_avals[1].shape[1], D, causal))


# -- factories -----------------------------------------------------------------------

# constant fills: every shard of the result is the same constant, so a
# sharded result is created shard by shard
FILLS = {"aten.zeros", "aten.ones", "aten.full", "aten.empty", "aten.new_zeros",
         "aten.new_ones", "aten.new_full", "aten.new_empty"}


def decide_factory(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """Created replicated (as the reference's iota); a constant fill whose
    completed sharding is sharded is created at its local shape instead.
    A tensor operand (``new_zeros``' template) gives only dtype and device:
    it is read where it is."""
    node = eqn.node
    out = eqn.out_avals[0]
    osh = want if (eqn.name in FILLS and want is not None) else replicated(mesh, out.ndim)
    local = shard_shape(out.shape, osh)
    size_at = 1 if eqn.name.startswith("aten.new_") else 0
    invars = eqn.invars

    def fn(*vals):
        first = dict(zip(invars, (v[0] for v in vals)))
        args = list(_substitute(node.args, first.__getitem__))
        kwargs = {k: _substitute(a, first.__getitem__) for k, a in node.kwargs.items()}
        if eqn.name in FILLS:
            if "size" in kwargs:
                kwargs["size"] = list(local)
            else:
                args[size_at] = list(local)
        return mr.replicate(node.target(*args, **kwargs), mesh)

    return LocalOp(list(shardings), osh, fn)


# -- ops that drop, insert or slice a dim --------------------------------------------


def decide_drop_dim(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """unbind (a list of results) and select: the removed dim gathered first,
    the others kept."""
    d, i = eqn.params["dim"], eqn.params["index"]
    tgt = shardings[0].with_dim(d, ())
    out = _sharding(mesh, [a for j, a in enumerate(tgt.dims_mapping) if j != d])
    if eqn.name == "aten.select":
        return LocalOp([tgt], out, lambda x: x.select(d + 1, i))
    return LocalOp([tgt], [out] * len(eqn.tuple_avals), lambda x: list(x.unbind(d + 1)))


def _inserted(eqn, shardings, want, mesh: Mesh):
    """The operand layout (every operand's) and the result's sharding of an
    op that inserts dim ``d``: the result's completed sharding where it has
    one, else the first operand's, with ``d`` replicated."""
    d = eqn.params["dim"]
    rank = eqn.out_avals[0].ndim
    base = want if want is not None else _project(shardings[0], insert_map(rank - 1, d), rank)
    out = base.with_dim(d, ())
    tgt = _sharding(mesh, [a for j, a in enumerate(out.dims_mapping) if j != d])
    return tgt, out


def decide_stack(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    tgt, out = _inserted(eqn, shardings, want, mesh)
    d = eqn.params["dim"]
    return LocalOp([tgt] * len(shardings), out, lambda *xs: torch.stack(xs, d + 1))


def decide_select_backward(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    tgt, out = _inserted(eqn, shardings, want, mesh)
    d, i = eqn.params["dim"], eqn.params["index"]
    local = shard_shape(eqn.out_avals[0].shape, out)
    return LocalOp([tgt], out, lambda g: torch.ops.aten.select_backward(
        g, (g.shape[0],) + local, d + 1, i))


def decide_slice_backward(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    p = eqn.params
    d = p["dim"]
    base = want if want is not None else shardings[0]
    out = base.with_dim(d, ())
    local = shard_shape(eqn.out_avals[0].shape, out)
    return LocalOp([out], out, lambda g: torch.ops.aten.slice_backward(
        g, (g.shape[0],) + local, d + 1, p["start"], p["end"], p["step"]))


# -- logsumexp over sharded dims -----------------------------------------------------


def decide_logsumexp(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """The local max, its pmax over the axes sharding the reduced dims, the
    local sum of exp(x - max), its psum, and log + max: no gather."""
    (sh,) = shardings
    axes, keepdim = eqn.params["axes"], eqn.params["keepdim"]
    psum_axes = tuple(a for d in axes for a in sh.dims_mapping[d])
    osh = Sharding(mesh, tuple(sh.dims_mapping[i] if i is not None else ()
                               for i in eqn.params["out_to_in"]))
    dims = [a + 1 for a in axes]
    if not psum_axes:
        return LocalOp([sh], osh, lambda x: torch.logsumexp(x, dims, keepdim))

    def fn(x):
        m = mr.pmax(torch.amax(x, dims, keepdim=True), mesh, psum_axes)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        total = mr.psum(torch.exp(x - m).sum(dims, keepdim=True), mesh, psum_axes)
        out = torch.log(total) + m
        return out if keepdim else out.squeeze(dims)

    return LocalOp([sh], osh, fn, collectives={"all-reduce": 2})


# -- index ops with a sharded indexed dim --------------------------------------------


def _pass_through(eqn, shardings, want, mesh: Mesh):
    """The result's sharding for an index op: its completed sharding (else
    the merge of the operands' pass-through dims), without the axes that
    shard the indexed dim of the table or input (``idx_axes``)."""
    maps = index_maps(eqn)
    rank = eqn.out_avals[0].ndim
    base = want
    if base is None:
        base = replicated(mesh, rank)
        for s, mp in zip(shardings, maps):
            base = merge_shardings(base, _project(s, mp, rank)) or base
    return base, maps


def _targets(eqn, out: Sharding, maps, mesh: Mesh) -> list:
    """Each operand's target: the result's sharding on the dims it maps to."""
    return [_project(out, _invert(mp, a.ndim), a.ndim) for mp, a in zip(maps, eqn.in_avals)]


def decide_embedding(eqn, shardings, want, mesh: Mesh) -> Optional[LocalOp]:
    """Rows of the table sharded on axes A: each device looks up the ids in
    its row range (others read as zero) and a psum over A completes the
    rows; the table is never gathered."""
    kw = kwargs_of(eqn.node)
    if kw.get("padding_idx", -1) != -1 or kw.get("scale_grad_by_freq") or kw.get("sparse"):
        return None
    w_sh = shardings[0]
    A = w_sh.dims_mapping[0]
    base, maps = _pass_through(eqn, shardings, want, mesh)
    out = _without(base, A)
    targets = _targets(eqn, out, maps, mesh)
    targets[0] = targets[0].with_dim(0, A)
    V = eqn.in_avals[0].shape[0]
    wt = targets[0]

    def fn(w, idx):
        n, Vl = w.shape[0], w.shape[1]
        local = idx - _offsets_like(wt, 0, V, idx)
        valid = (local >= 0) & (local < Vl)
        rows = torch.where(valid, local, torch.zeros_like(local)) + Vl * torch.arange(
            n, device=idx.device).reshape((-1,) + (1,) * (idx.ndim - 1))
        got = torch.nn.functional.embedding(rows, w.reshape((n * Vl,) + tuple(w.shape[2:])))
        got = torch.where(valid[..., None], got, torch.zeros_like(got))
        return mr.psum(got, mesh, A) if A else got

    return LocalOp(targets, out, fn, collectives={"all-reduce": 1} if A else {})


def decide_embedding_backward(eqn, shardings, want, mesh: Mesh) -> Optional[LocalOp]:
    """The table's gradient, rows sharded on axes A: each device adds its
    gradient rows into the table rows in its range (a masked local scatter),
    and a psum over the axes that shard the ids completes the sums."""
    kw = kwargs_of(eqn.node)
    if kw.get("padding_idx", -1) != -1 or kw.get("scale_grad_by_freq"):
        return None
    V, M = eqn.out_avals[0].shape
    g_sh = shardings[0]
    k = eqn.in_avals[1].ndim
    base = want if want is not None else replicated(mesh, 2)
    A = base.dims_mapping[0]
    m_axes = tuple(a for a in g_sh.dims_mapping[k] if a not in A)
    batch = [tuple(a for a in g_sh.dims_mapping[j] if a not in A and a not in m_axes)
             for j in range(k)]
    out = _sharding(mesh, [A, m_axes])
    g_t = _sharding(mesh, batch + [m_axes])
    idx_t = _sharding(mesh, batch)
    P = tuple(a for d in batch for a in d)

    def fn(g, idx):
        n = g.shape[0]
        Vl, Ml = V // out.num_shards(0), g.shape[-1]
        local = idx - _offsets_like(out, 0, V, idx)
        valid = (local >= 0) & (local < Vl)
        rows = torch.where(valid, local, torch.zeros_like(local)) + Vl * torch.arange(
            n, device=idx.device).reshape((-1,) + (1,) * (idx.ndim - 1))
        g = torch.where(valid[..., None], g, torch.zeros_like(g))
        table = torch.zeros((n * Vl, Ml), dtype=g.dtype, device=g.device)
        table.index_add_(0, rows.reshape(-1), g.reshape(-1, Ml))
        table = table.reshape(n, Vl, Ml)
        return mr.psum(table, mesh, P) if P else table

    return LocalOp([g_t, idx_t], out, fn, collectives={"all-reduce": 1} if P else {})


def decide_gather(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """``input`` sharded on the gathered dim by axes A: each device picks the
    indices in its range (others read as zero) and a psum over A completes
    the picks; the input is never gathered."""
    d = eqn.params["dim"]
    A = shardings[0].dims_mapping[d]
    base, maps = _pass_through(eqn, shardings, want, mesh)
    out = _without(base, A).with_dim(d, ())
    targets = _targets(eqn, out, maps, mesh)
    targets[0] = targets[0].with_dim(d, A)
    size = eqn.in_avals[0].shape[d]
    it = targets[0]

    def fn(x, idx):
        n_l = x.shape[d + 1]
        local = idx - _offsets_like(it, d, size, idx)
        valid = (local >= 0) & (local < n_l)
        got = torch.gather(x, d + 1, torch.where(valid, local, torch.zeros_like(local)))
        got = torch.where(valid, got, torch.zeros_like(got))
        return mr.psum(got, mesh, A) if A else got

    return LocalOp(targets, out, fn, collectives={"all-reduce": 1} if A else {})


def decide_scatter_add(eqn, shardings, want, mesh: Mesh) -> LocalOp:
    """``self`` sharded on the scattered dim by axes A: each device adds the
    values whose indices fall in its range (a masked local scatter); no
    collective."""
    d = eqn.params["dim"]
    base, maps = _pass_through(eqn, shardings, want, mesh)
    A = base.dims_mapping[d]
    targets = _targets(eqn, base, maps, mesh)
    size = eqn.out_avals[0].shape[d]

    def fn(x, idx, src):
        n_l = x.shape[d + 1]
        local = idx - _offsets_like(base, d, size, idx)
        valid = (local >= 0) & (local < n_l)
        src = torch.where(valid, src, torch.zeros_like(src))
        return x.scatter_add(d + 1, torch.where(valid, local, torch.zeros_like(local)), src)

    return LocalOp(targets, base, fn)


LOCAL_OPS = {
    FLASH: decide_flash,
    FLASH_FWD: decide_flash_fwd,
    FLASH_BWD: decide_flash_bwd,
    FLASH_DECODE: decide_flash_decode,
    SSD: decide_ssd,
    SSD_BWD: decide_ssd_bwd,
    "aten.index_copy": decide_index_copy,
    "aten.unbind": decide_drop_dim,
    "aten.select": decide_drop_dim,
    "aten.stack": decide_stack,
    "aten.select_backward": decide_select_backward,
    "aten.slice_backward": decide_slice_backward,
    "aten.logsumexp": decide_logsumexp,
    "aten.embedding": decide_embedding,
    "aten.embedding_dense_backward": decide_embedding_backward,
    "aten.gather": decide_gather,
    "aten.scatter_add": decide_scatter_add,
    **{name: decide_factory for name in FACTORY},
}


# ---------------------------------------------------------------------------------
# scan: the body under its completed shardings
# ---------------------------------------------------------------------------------


def scan_body_shardings(eqn, prop: PropagationResult, shardings, mesh: Mesh):
    """(each outer operand's target sharding, the body propagation with
    every body input's sharding filled in), from the body's completion
    that ``prop`` keeps for the node (``prop.sub``): an operand goes in the
    sharding the body's completion gave its input (an x's with the leading
    scan dim unsharded put back); where the completion left the input open,
    the operand keeps its own (an x's leading dim unsharded)."""
    nc, nk = eqn.params["num_consts"], eqn.params["num_carry"]
    body, inner = eqn.params["body"], prop.sub[eqn.node]
    env = dict(inner.env)
    targets = []
    for i, (s, bv) in enumerate(zip(shardings, body.invars)):
        stacked = i >= nc + nk
        declared = inner.get(bv)
        if declared is None:
            declared = (drop0(s) if stacked else s) or replicated(mesh, 0)
            env[bv] = declared
        targets.append(add0(declared) if stacked else declared)
    return targets, PropagationResult(inner.graph, mesh, env, inner.sub)


def trip_order(eqn):
    L = eqn.params["length"]
    return range(L - 1, -1, -1) if eqn.params["reverse"] else range(L)


# ---------------------------------------------------------------------------------
# fallback analysis: which dims does a formatting op actually modify?
# ---------------------------------------------------------------------------------
#
# §4.5: pad/slice/cat/flip only rewrite data along *some* dims; every other
# dim is elementwise, so its sharding can be kept.  The fallback then gathers
# only the mesh axes on modified dims instead of fully replicating.  (The
# reference's ``core/plan.py::fallback_keep_sharding``; aten's formatting ops
# name their dims relative to the tensor, so no argument needs rewriting for
# local execution.)

_KEEP_SHARDING = {"aten.cat", "aten.flip", "aten.constant_pad_nd", "aten.slice"}


def fallback_keep_sharding(eqn, in_shardings, mesh: Mesh) -> Optional[Sharding]:
    """If the op only modifies some dims, the operand sharding with the
    unmodified dims kept; else None (gather all)."""
    if eqn.name not in _KEEP_SHARDING or not eqn.out_avals:
        return None
    rank = eqn.out_avals[0].ndim
    if rank == 0:
        return None
    modified = set(eqn.params["modified_dims"])
    kept: Optional[Sharding] = None
    for a, s in zip(eqn.in_avals, in_shardings):
        if a.ndim != rank:
            continue
        masked = Sharding(mesh, tuple(
            () if d in modified else s.dims_mapping[d] for d in range(rank)))
        if kept is None:
            kept = masked
        else:
            m = merge_shardings(kept, masked)
            kept = m if m is not None else kept
    if kept is None or kept.is_fully_replicated():
        return None  # nothing to keep; plain gather-all is equivalent
    return kept


def gathers(src: Sharding, dst: Sharding) -> bool:
    """Whether a reshard from ``src`` to ``dst`` gathers a sharded dim (drops
    a mesh axis from a dim)."""
    return any(a not in d for s, d in zip(src.dims_mapping, dst.dims_mapping) for a in s)


def fallback_local(eqn):
    """The op run on each device's shards (``torch.vmap`` over the stacked
    dim), operands in ``eqn.invars`` order."""
    node, invars = eqn.node, eqn.invars

    def one_device(*shards):
        m = dict(zip(invars, shards))
        return run_node(node, m.__getitem__)

    return torch.vmap(one_device)


def fallback_global(eqn, mesh: Mesh):
    """The op on the whole (replicated) operands, replicated again; a tuple
    result is a list of replicated values."""
    node, invars = eqn.node, eqn.invars

    def run(*vals):
        whole = dict(zip(invars, (x[0] for x in vals)))
        out = run_node(node, whole.__getitem__)
        if isinstance(out, (list, tuple)):
            return [mr.replicate(o, mesh) if isinstance(o, torch.Tensor) else o for o in out]
        return mr.replicate(out, mesh) if isinstance(out, torch.Tensor) else out

    return run


class SpmdPartitioner:
    """Evaluates a captured graph on stacked local shards, inserting
    collectives per §4, deciding every op anew on each call."""

    def __init__(self, prop: PropagationResult, mesh: Mesh):
        self.prop = prop
        self.mesh = mesh
        # local values + their current shardings
        self.vals: Dict[torch.fx.Node, object] = {}
        self.shardings: Dict[torch.fx.Node, object] = {}
        self.fallbacks: List[str] = []  # op names that took _fallback, in order
        self.fallback_gathers: List[str] = []  # those that gathered a sharded dim

    # -- var access -------------------------------------------------------------
    def read(self, v):
        return self.vals[v], self.shardings[v]

    def write(self, v, val, sh):
        self.vals[v] = val
        self.shardings[v] = sh

    def _to(self, val, cur: Sharding, tgt: Sharding):
        if cur.dims_mapping == tgt.dims_mapping:
            return val
        return reshard_local(val, cur, tgt)

    # -- the partitioning pass ----------------------------------------------------
    def run(self, captured, *args):
        """Run the graph on the stacked shards ``args`` of its invars (under
        their completed shardings); returns the outvars' stacked shards and
        shardings."""
        inputs = iter(args)
        for node in captured.graph.nodes:
            if node.op == "placeholder":
                a = next(inputs)
                self.write(node, a, self.prop.get(node) or replicated(self.mesh, a.ndim - 1))
            elif node.op == "get_attr":
                c = captured.constant(node)
                self.write(node, mr.replicate(c, self.mesh), replicated(self.mesh, c.ndim))
            elif node.op == "call_function":
                self.eqn(lower(node))
        outs, shs = [], []
        for v in captured.outvars:
            if not isinstance(v, torch.fx.Node):
                outs.append(v)
                shs.append(None)
                continue
            val, sh = self.read(v)
            want = self.prop.get(v) or replicated(self.mesh, sh.rank)
            outs.append(self._to(val, sh, want))
            shs.append(want)
        return outs, shs

    def eqn(self, eqn):
        name = eqn.name
        node = eqn.node
        if node.target is ANNOTATE_OP:
            val, sh = self.read(node.args[0])
            tgt = annotation_target(node, self.prop)
            self.write(node, self._to(val, sh, tgt), tgt)
        elif name == "getitem":
            vals, shs = self.read(node.args[0])
            i = node.args[1]
            self.write(node, vals[i], shs[i])
        elif name in DOT:
            self.write(node, *self._dot_values(eqn))
        elif name == "aten.addmm":
            self._addmm(eqn)
        elif name in ELEMENTWISE and eqn.out_avals:
            self._elementwise(eqn)
        elif name in SCANS:
            self._scan(eqn)
        elif name in LOCAL_OPS and self._local(eqn):
            pass
        elif name in REDUCE:
            self._reduce(eqn)
        elif name in TRANSPOSE:
            val, sh = self.read(eqn.invars[0])
            out = val.permute((0,) + tuple(p + 1 for p in eqn.params["permutation"]))
            self.write(node, out, transpose_sharding(eqn, sh, self.mesh))
        elif name in BROADCAST:
            val, sh = self.read(eqn.invars[0])
            osh = broadcast_sharding(eqn, sh, self.mesh)
            out = broadcast_local(val, eqn.params["broadcast_dimensions"],
                                  shard_shape(tuple(eqn.params["shape"]), osh))
            self.write(node, out, osh)
        elif name in RESHAPE:
            self._reshape(eqn)
        elif name == "aten.convolution":
            self._conv(eqn)
        else:
            # fallback: gather everything, run globally, re-slice to inferred sharding
            self._fallback(eqn)

    # -- op handlers ----------------------------------------------------------------
    def _dot_values(self, eqn):
        lv, ls = self.read(eqn.invars[-2])
        rv, rs = self.read(eqn.invars[-1])
        return partitioned_einsum(dot_spec(eqn), lv, rv, ls, rs, self.prop.get(eqn.node),
                                  preferred_element_type=eqn.out_avals[0].dtype)

    def _addmm(self, eqn):
        z, zsh = self._dot_values(eqn)
        bv, bs = self.read(eqn.invars[0])
        out_shape = eqn.out_avals[0].shape
        bmap = _bcast_map(eqn.in_avals[0].shape, out_shape)
        bv = align(self._to(bv, bs, _project(zsh, _invert(bmap, bs.rank), bs.rank)),
                   bs.rank, len(out_shape))
        beta, alpha = eqn.params["beta"], eqn.params["alpha"]
        out = (bv if beta == 1 else beta * bv) + (z if alpha == 1 else alpha * z)
        self.write(eqn.node, out, zsh)

    def _elementwise(self, eqn):
        tgt, targets = elementwise_targets(eqn, [self.shardings[v] for v in eqn.invars],
                                           self.mesh)
        vals = [self._to(*self.read(v), t) for v, t in zip(eqn.invars, targets)]
        self.write(eqn.node, elementwise_local(eqn)(*vals), tgt)

    def _reduce(self, eqn):
        val, sh = self.read(eqn.invars[0])
        name = eqn.name
        psum_axes, gather_first, osh = reduce_decision(eqn, sh, self.mesh)
        if gather_first:  # prod/any/all: gather first instead
            val = self._to(val, sh, replicated(self.mesh, sh.rank))
        out = local_reduce(name, val, eqn.params["axes"], eqn.params["keepdim"],
                           eqn.out_avals[0].dtype)
        if psum_axes:
            out = COLLECTIVE[REDUCE_OP[name]](out, self.mesh, psum_axes)
            if name == "aten.mean":
                out = out / group_size(self.mesh, psum_axes)
        self.write(eqn.node, out, osh)

    def _reshape(self, eqn):
        val, sh = self.read(eqn.invars[0])
        want = self.prop.get(eqn.node)
        gshape = eqn.out_avals[0].shape
        if want is not None and local_reshape_ok(eqn.in_avals[0].shape, gshape, sh, want):
            out = val.reshape((val.shape[0],) + shard_shape(tuple(gshape), want))
            self.write(eqn.node, out, want)
            return
        mid = reshape_carried(eqn.in_avals[0].shape, gshape, sh, want) if want is not None else None
        if mid is not None:  # reshape each shard, then slice
            out = val.reshape((val.shape[0],) + shard_shape(tuple(gshape), mid))
            self.write(eqn.node, self._to(out, mid, want), want)
            return
        # fallback: gather, reshape, re-slice
        val = self._to(val, sh, replicated(self.mesh, sh.rank))
        out = val.reshape((val.shape[0],) + tuple(gshape))
        osh = want or replicated(self.mesh, len(gshape))
        out = self._to(out, replicated(self.mesh, len(gshape)), osh)
        self.write(eqn.node, out, osh)

    def _conv(self, eqn):
        p = eqn.params
        lv, ls = self.read(eqn.invars[0])
        tgt = conv_target(eqn, ls, self.mesh)
        if tgt is None:
            self._fallback(eqn)
            return
        rv, rs = self.read(eqn.invars[1])
        # kernel replicated; lhs may be sharded on batch and/or spatial dims
        rv = self._to(rv, rs, replicated(self.mesh, rs.rank))
        lv, ls = self._to(lv, ls, tgt), tgt
        strides, padding = p["window_strides"], p["padding"]
        if ls.dims_mapping[1]:
            ax = ls.dims_mapping[1]
            out = mr.psum(conv_feature_local(lv, rv, self.mesh, ax, strides, padding),
                          self.mesh, ax)
            osh = Sharding(self.mesh, (ls.dims_mapping[0], ()) + ((),) * (ls.rank - 2))
        else:
            out = conv_halo_local(lv, rv, self.mesh, ls, strides, padding)
            osh = ls
        if p["has_bias"]:
            bv, bs = self.read(eqn.node.args[2])
            out = conv_bias(out, self._to(bv, bs, replicated(self.mesh, 1)))
        self.write(eqn.node, out, osh)

    def _local(self, eqn) -> bool:
        """A ``LocalOp`` decision and its computation; False where the op
        must take the fallback instead."""
        d = LOCAL_OPS[eqn.name](eqn, [self.shardings[v] for v in eqn.invars],
                                _want(eqn, self.prop), self.mesh)
        if d is None:
            return False
        vals = [self._to(*self.read(v), t) for v, t in zip(eqn.invars, d.targets)]
        self.write(eqn.node, d.fn(*vals), d.out)
        return True

    def _scan(self, eqn):
        """The body partitioned anew on every trip (``scan_body_shardings``);
        the ys written into their slots of stacked buffers."""
        nc, nk = eqn.params["num_consts"], eqn.params["num_carry"]
        body, L = eqn.params["body"], eqn.params["length"]
        targets, inner = scan_body_shardings(eqn, self.prop,
                                             [self.shardings[v] for v in eqn.invars], self.mesh)
        vals = [self._to(*self.read(v), t) for v, t in zip(eqn.invars, targets)]
        consts, carry, xs = vals[:nc], vals[nc:nc + nk], vals[nc + nk:]
        cin = targets[nc:nc + nk]
        bufs, ysh = None, []
        for n, t in enumerate(trip_order(eqn)):
            part = SpmdPartitioner(inner, self.mesh)
            outs, shs = part.run(body, *consts, *carry, *(x[:, t] for x in xs))
            if not n:
                self.fallbacks += part.fallbacks
                self.fallback_gathers += part.fallback_gathers
            carry = [self._to(o, s, c) for o, s, c in zip(outs[:nk], shs[:nk], cin)]
            if bufs is None:
                bufs = [y.new_empty((y.shape[0], L) + tuple(y.shape[1:])) for y in outs[nk:]]
                ysh = [add0(s) for s in shs[nk:]]
            for b, y in zip(bufs, outs[nk:]):
                b[:, t] = y
        self.write(eqn.node, carry + bufs, list(cin) + ysh)

    def _fallback(self, eqn):
        """Gather → op → reshard to the propagated sharding (§4.5).

        For formatting ops whose touched dims are known (pad / slice / cat /
        flip), only the mesh axes on *modified* dims are gathered; unmodified
        dims keep their sharding and the op runs locally.  Unknown ops still
        fully replicate.
        """
        node = eqn.node
        self.fallbacks.append(eqn.name)
        in_sh = [self.shardings[v] for v in eqn.invars]
        kept_sh = fallback_keep_sharding(eqn, in_sh, self.mesh)
        targets = [kept_sh if kept_sh is not None and a.ndim == kept_sh.rank
                   else replicated(self.mesh, a.ndim) for a in eqn.in_avals]
        if any(gathers(s, t) for s, t in zip(in_sh, targets)):
            self.fallback_gathers.append(eqn.name)
        vals = [self._to(*self.read(v), t) for v, t in zip(eqn.invars, targets)]
        if kept_sh is not None:
            out = fallback_local(eqn)(*vals)
            osh = Sharding(self.mesh, tuple(
                kept_sh.dims_mapping[d] if d < kept_sh.rank else ()
                for d in range(out.ndim - 1)))
            want = self.prop.get(node) or osh
            self.write(node, self._to(out, osh, want), want)
            return
        out = fallback_global(eqn, self.mesh)(*vals)
        if isinstance(out, torch.Tensor):
            rep = replicated(self.mesh, out.ndim - 1)
            want = self.prop.get(node) or rep
            self.write(node, self._to(out, rep, want), want)
        elif isinstance(out, list):  # results read back by getitem nodes
            self.write(node, out, [replicated(self.mesh, o.ndim - 1)
                                   if isinstance(o, torch.Tensor) else None for o in out])
        else:
            self.write(node, out, None)


# ---------------------------------------------------------------------------------
# the runner and its caches
# ---------------------------------------------------------------------------------


@dataclasses.dataclass
class PlanCacheStats:
    """Hit/miss counters for a plan cache, lock-guarded so concurrent runners
    cannot drop updates between the read and the write of a bare ``+= 1``."""

    hits: int = 0
    misses: int = 0
    # labels this cache in the metrics registry: hits and misses also land in
    # its ``plan_cache.<scope>.{hits,misses}`` counters (None: no feed)
    scope: Optional[str] = None
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False,
    )

    def record_hit(self) -> None:
        with self._lock:
            self.hits += 1
        if self.scope:
            from ..obs.metrics import inc

            inc(f"plan_cache.{self.scope}.hits")

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1
        if self.scope:
            from ..obs.metrics import inc

            inc(f"plan_cache.{self.scope}.misses")

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {"hits": self.hits, "misses": self.misses, "hit_rate": self.hit_rate}

    def reset(self) -> None:
        with self._lock:
            self.hits = 0
            self.misses = 0


@dataclasses.dataclass
class _CacheEntry:
    captured: object  # compat.Captured: the graph the shardings refer to
    prop: PropagationResult
    plan: Optional[object] = None  # plan.PartitionPlan on the compiled path
    # host seconds of the build: capture, completion and plan compilation
    build_s: Dict[str, float] = dataclasses.field(default_factory=dict)


def _aval_key(a) -> tuple:
    return (tuple(a.shape), str(a.dtype))


# The per-runner cache skips capture, propagation and plan compilation for
# repeated calls; the process cache shares an entry across ``spmd_partition``
# call sites that partition the same program, keyed by the captured graph's
# content digest.

_PROCESS_CACHE: Dict[tuple, _CacheEntry] = {}
_PROCESS_STATS = PlanCacheStats(scope="process")


def process_plan_cache_stats() -> PlanCacheStats:
    return _PROCESS_STATS


def clear_process_plan_cache() -> None:
    _PROCESS_CACHE.clear()
    _PROCESS_STATS.reset()


def spmd_partition(fn, mesh: Mesh, compile_plans: bool = True, optimize: bool = True,
                   process_cache: bool = True, autoshard=None, verify=None, guard=None,
                   trace=None, profile=None, device="cuda"):
    """Partition ``fn`` and return a callable that runs the SPMD program on the
    simulated ``mesh``.

    The user writes ``fn`` against global shapes with ``annotate`` hints.  On
    the first call for an input signature the runner captures ``fn``,
    completes the shardings (propagation pass) and, on the compiled path,
    lowers the result into a ``plan.PartitionPlan``; all of it is cached.
    Every call shards its global tensor arguments onto ``device`` by the
    completed input shardings, runs the partitioned program over the stacked
    shards, and returns global tensors, as the reference's ``shard_map``
    does.

    The keywords are the reference's.  ``compile_plans=True`` (the default)
    executes the cached plan: steady-state calls capture, propagate and
    decide nothing.  ``compile_plans=False`` is the dynamic path
    (``SpmdPartitioner``), which decides every op anew on each call.  On
    compiled plans: ``optimize=True`` (the default) runs the whole-program
    optimizer (``plan_opt.py``).  ``profile`` prices the plan: a
    ``RooflineParams``, a fitted ``obs.profile.MachineProfile`` or a
    profile JSON path; None falls back to ``$REPRO_TORCH_MACHINE_PROFILE``
    and then to the profile fitted on an H100 and committed with the
    package (``obs.profile.resolve_profile``).  The resolved profile's
    digest keys the process cache, and applying it emits a
    ``profile_applied`` control event.  ``verify`` runs the static verifier
    (``plan_verify.py``): None (the default) and True verify, False does
    not.  ``guard`` (a ``plan.GuardConfig``) appends the numerics-sentinel
    epilogue; the runner strips the guard vector from the outputs and
    raises ``plan.NumericsFault``, naming the leaves, when a guarded output
    is non-finite or above ``guard.max_abs``; it needs
    ``compile_plans=True``.  ``trace`` (an ``obs.trace.TraceConfig``) opts
    the runner into plan-step tracing (``runner.tracer``: the modeled
    timeline of each compiled plan and, with ``trace.measured``, a span per
    plan step of every call; see ``obs/trace.py``); it needs
    ``compile_plans=True``, ``TraceConfig(enabled=False)`` is the same as
    no config (the same cache key and runner), and a traced runner stays
    out of the process cache.  ``autoshard`` (an
    ``autoshard.AutoshardConfig``) searches the captured program's input
    shardings instead of reading them from ``annotate`` seeds
    (``autoshard.solve_jaxpr_cached``, once per program, mesh, config and
    profile in the process); the search prices with the config's profile,
    else with the one the plan is priced by, and a search that finds no
    feasible assignment raises ``ValueError``.
    ``process_cache=False`` opts this runner out of the process-level
    cache.  ``device`` is "cuda" unless the caller asks for "cpu" (no
    fallback from one to the other).

    The runner exposes ``cache_stats`` (hits/misses), ``plans`` (cache key →
    entry: the captured graph, the completed shardings, compiled,
    ``plan``, and ``build_s``, the seconds of capture, completion and plan
    compilation), and, after each call, ``fallbacks`` (the op names that took
    the fallback, in graph order), ``fallback_gathers`` (those of them that
    gathered a sharded dim) and ``collectives`` (the collectives run, by
    kind).
    """
    if guard is not None and not compile_plans:
        raise ValueError("spmd_partition: guard= requires compile_plans=True")
    if trace is not None and not trace.enabled:
        trace = None  # a disabled config is no tracing: the same runner
    if trace is not None and not compile_plans:
        raise ValueError("spmd_partition: trace= requires compile_plans=True")
    tracer = None
    if trace is not None:
        from ..obs.trace import Tracer

        tracer = Tracer(trace)
        process_cache = False  # the tracer is runner-local state
    dev = resolve_device(device)
    mkey = mesh.structural_key()
    cache: Dict[tuple, _CacheEntry] = {}
    stats = PlanCacheStats(scope="runner")

    def _build(flat, args):
        from ..obs.profile import resolve_profile

        # resolved per build, so that an edit of $REPRO_TORCH_MACHINE_PROFILE
        # is picked up; its digest keys the process cache
        prof = resolve_profile(profile)
        t0 = time.perf_counter()
        captured = capture(fn, *args)
        t1 = time.perf_counter()
        pkey: Optional[tuple] = None
        if process_cache:
            pkey = (captured.digest(), mkey, tuple(_aval_key(a) for a in flat), compile_plans,
                    optimize, autoshard.cache_key() if autoshard is not None else None,
                    verify, guard, prof.digest())
            entry = _PROCESS_CACHE.get(pkey)
            if entry is not None:
                _PROCESS_STATS.record_hit()
                return entry
            _PROCESS_STATS.record_miss()
        in_seeds = None
        if autoshard is not None:
            from ..autoshard.api import solve_jaxpr_cached

            config = (autoshard if autoshard.profile is not None
                      else dataclasses.replace(autoshard, profile=prof))
            found = solve_jaxpr_cached(captured, mesh, config)
            if not found.evaluation.feasible:
                # never drop the caller's constraints (an unmeetable budget)
                raise ValueError(
                    "autoshard: no feasible assignment found "
                    f"({found.evaluation.reason or 'search exhausted'}); relax "
                    "AutoshardConfig.budget_bytes or widen the search (top_n / sa_steps / "
                    "max_candidates)")
            in_seeds = found.assignment
        prop = propagate(captured, mesh, in_shardings=in_seeds).result()
        t2 = time.perf_counter()
        plan = None
        if compile_plans:
            from .plan import compile_plan

            plan = compile_plan(captured, prop, mesh, optimize=optimize, verify=verify,
                                guard=guard, profile=prof)
            from ..obs.trace import control_event

            control_event("profile_applied", digest=prof.digest(), mesh=list(mesh.shape))
            if tracer is not None:
                tracer.on_plan(plan)  # the modeled lane
        entry = _CacheEntry(captured, prop, plan, {
            "capture_s": t1 - t0, "completion_s": t2 - t1,
            "plan_compile_s": time.perf_counter() - t2})
        if pkey is not None:
            _PROCESS_CACHE[pkey] = entry
        return entry

    def runner(*args):
        flat, in_spec = tree_flatten(args)
        if not all(isinstance(a, torch.Tensor) for a in flat):
            raise TypeError("spmd_partition: every argument leaf must be a tensor")
        flat = [a.to(dev) for a in flat]
        key = (mkey, tuple(_aval_key(a) for a in flat), str(in_spec))
        entry = cache.get(key)
        if entry is None:
            stats.record_miss()
            entry = _build(flat, in_spec.unflatten(flat))
            cache[key] = entry
        else:
            stats.record_hit()
        captured, plan = entry.captured, entry.plan
        if plan is not None:
            local = [mr.shard(a, s) for a, s in zip(flat, plan.in_shardings)]
            step_tracer = tracer if tracer is not None and tracer.config.measured else None
            with mr.recording() as log:
                outs = plan.execute(*local, tracer=step_tracer)
            shs = plan.out_shardings
            fallbacks, gathered = plan.fallbacks, plan.fallback_gathers
        else:
            prop = entry.prop
            local = [mr.shard(a, prop.get(v) or replicated(mesh, a.ndim))
                     for a, v in zip(flat, captured.invars)]
            part = SpmdPartitioner(prop, mesh)
            with mr.recording() as log:
                outs, shs = part.run(captured, *local)
            fallbacks, gathered = part.fallbacks, part.fallback_gathers
        runner.fallbacks = list(fallbacks)
        runner.fallback_gathers = list(gathered)
        runner.collectives = dict(log)
        outs = [mr.unshard(o, s) if s is not None else o for o, s in zip(outs, shs)]
        if plan is not None and plan.guard is not None:
            from .plan import NumericsFault, guard_faults

            gi = plan.guard
            gvec = outs.pop(gi.out_index)
            runner.calls += 1
            faults = guard_faults(gi.config, gvec.cpu().numpy(), gi.leaves)
            if faults:
                raise NumericsFault(runner.calls - 1, faults)
        return captured.unflatten(outs)

    runner.calls = 0
    runner.cache_stats = stats
    runner.plans = cache
    runner.tracer = tracer
    runner.fallbacks = []
    runner.fallback_gathers = []
    runner.collectives = {}
    return runner
