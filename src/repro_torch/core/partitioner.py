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
* annotate         — explicit resharding to the user's annotation.

An op with no handler takes ``_fallback``: gather every operand, run the op
on the global values, reshard to the propagated sharding — GSPMD semantics,
exactly as in the reference.  The partitioner records the op names that
took it (``fallbacks``), so a run shows where the reference would gather.

The compiled-plan path (``core/plan.py``), for which this path is the
executable specification, is not ported yet (ROADMAP A5, compiled plans);
``spmd_partition(..., compile_plans=True)`` raises.
"""
from __future__ import annotations

import dataclasses
import string
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.fx
from torch.utils._pytree import tree_flatten

from . import mesh_runtime as mr
from .annotate import ANNOTATE_OP, decode
from .compat import capture
from .device import resolve_device
from .einsum_rules import partitioned_einsum
from .halo import local_conv, sharded_conv_nd
from .propagation import PropagationResult, propagate
from .reshard import reshard_local, shard_shape
from .rules import (BROADCAST, DOT, ELEMENTWISE, FACTORY, REDUCE, RESHAPE, TRANSPOSE,
                    _bcast_map, _invert, _project, _reshape_dim_map, lower)
from .sharding import Mesh, Sharding, merge_shardings, replicated


# the reductions that combine local results across devices (the rest gather)
_CROSS_DEVICE_REDUCE = {"aten.sum": mr.psum, "aten.mean": mr.psum, "aten.amax": mr.pmax,
                        "aten.amin": mr.pmin}


def _substitute(x, value_of):
    """Node arguments with every Node replaced by ``value_of(node)``."""
    if isinstance(x, torch.fx.Node):
        return value_of(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_substitute(a, value_of) for a in x)
    return x


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


class SpmdPartitioner:
    """Evaluates a captured graph on stacked local shards, inserting
    collectives per §4."""

    def __init__(self, prop: PropagationResult, mesh: Mesh):
        self.prop = prop
        self.mesh = mesh
        # local values + their current shardings
        self.vals: Dict[torch.fx.Node, object] = {}
        self.shardings: Dict[torch.fx.Node, object] = {}
        self.fallbacks: List[str] = []  # op names that took _fallback, in order

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
            tgt, _ = decode(*node.args[1:])
            self.write(node, self._to(val, sh, tgt), tgt)
            return
        if name == "getitem":
            vals, shs = self.read(node.args[0])
            i = node.args[1]
            self.write(node, vals[i], shs[i])
            return
        if name in DOT:
            self._dot(eqn)
            return
        if name == "aten.addmm":
            self._addmm(eqn)
            return
        if name in ELEMENTWISE and eqn.out_avals:
            self._elementwise(eqn)
            return
        if name in REDUCE:
            self._reduce(eqn)
            return
        if name in TRANSPOSE:
            self._transpose(eqn)
            return
        if name in BROADCAST:
            self._broadcast(eqn)
            return
        if name in RESHAPE:
            self._reshape(eqn)
            return
        if name == "aten.convolution":
            self._conv(eqn)
            return
        if name in FACTORY:
            out = node.target(*node.args, **node.kwargs)
            self.write(node, mr.replicate(out, self.mesh), replicated(self.mesh, out.ndim))
            return
        # fallback: gather everything, run globally, re-slice to inferred sharding
        self._fallback(eqn)

    # -- op handlers ----------------------------------------------------------------
    def _dot_values(self, eqn, want):
        (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
        lv, ls = self.read(eqn.invars[-2])
        rv, rs = self.read(eqn.invars[-1])
        # express the dot as an einsum spec
        letters = iter(string.ascii_lowercase)
        l_names = [next(letters) for _ in range(ls.rank)]
        r_names = [None] * rs.rank
        for i, j in zip(lb, rb):
            r_names[j] = l_names[i]
        for i, j in zip(lc, rc):
            r_names[j] = l_names[i]
        for j in range(len(r_names)):
            if r_names[j] is None:
                r_names[j] = next(letters)
        l_nc = [i for i in range(len(l_names)) if i not in lc and i not in lb]
        r_nc = [j for j in range(len(r_names)) if j not in rc and j not in rb]
        out_names = (
            [l_names[i] for i in lb] + [l_names[i] for i in l_nc] + [r_names[j] for j in r_nc]
        )
        spec = f"{''.join(l_names)},{''.join(r_names)}->{''.join(out_names)}"
        return partitioned_einsum(spec, lv, rv, ls, rs, want,
                                  preferred_element_type=eqn.out_avals[0].dtype)

    def _dot(self, eqn):
        out, osh = self._dot_values(eqn, self.prop.get(eqn.node))
        self.write(eqn.node, out, osh)

    def _addmm(self, eqn):
        z, zsh = self._dot_values(eqn, self.prop.get(eqn.node))
        bv, bs = self.read(eqn.invars[0])
        out_shape = eqn.out_avals[0].shape
        bmap = _bcast_map(eqn.in_avals[0].shape, out_shape)
        bv = self._align(self._to(bv, bs, _project(zsh, _invert(bmap, bs.rank), bs.rank)),
                         bs.rank, len(out_shape))
        beta, alpha = eqn.params["beta"], eqn.params["alpha"]
        out = (bv if beta == 1 else beta * bv) + (z if alpha == 1 else alpha * z)
        self.write(eqn.node, out, zsh)

    def _align(self, v, rank: int, out_rank: int):
        """A stacked operand of rank ``rank`` shaped to broadcast against a
        stacked result of rank ``out_rank`` as aten would: a rank-0 operand
        becomes the 0-d value (replicated, so every device holds the same),
        keeping aten's type promotion for 0-d tensors."""
        if rank == out_rank:
            return v
        if rank == 0:
            return v[0]
        return v.reshape((v.shape[0],) + (1,) * (out_rank - rank) + tuple(v.shape[1:]))

    def _elementwise(self, eqn):
        out_shape = eqn.out_avals[0].shape
        rank = len(out_shape)
        maps = [_bcast_map(a.shape, out_shape) for a in eqn.in_avals]
        # size-1 broadcast dims must stay replicated on that operand: every
        # shard needs the single value
        tgt = None
        for v, mp in zip(eqn.invars, maps):
            m = _project(self.shardings[v], mp, rank)
            tgt = m if tgt is None else (merge_shardings(tgt, m) or tgt)
        if tgt is None:
            tgt = replicated(self.mesh, rank)
        local = {}
        for v, mp, a in zip(eqn.invars, maps, eqn.in_avals):
            val, sh = self.read(v)
            val = self._to(val, sh, _project(tgt, _invert(mp, a.ndim), a.ndim))
            local[v] = self._align(val, a.ndim, rank)
        node = eqn.node
        out = node.target(*_substitute(node.args, local.__getitem__),
                          **{k: _substitute(a, local.__getitem__) for k, a in node.kwargs.items()})
        self.write(node, out, tgt)

    def _reduce(self, eqn):
        val, sh = self.read(eqn.invars[0])
        axes, keepdim = eqn.params["axes"], eqn.params["keepdim"]
        name = eqn.name
        psum_axes = tuple(a for d in axes for a in sh.dims_mapping[d])
        gather_first = bool(psum_axes) and name not in _CROSS_DEVICE_REDUCE
        if gather_first:  # prod/any/all: gather first instead
            val = self._to(val, sh, replicated(self.mesh, sh.rank))
            sh = replicated(self.mesh, sh.rank)
        out = self._local_reduce(name, val, axes, keepdim, eqn.out_avals[0].dtype)
        if psum_axes and not gather_first:
            out = _CROSS_DEVICE_REDUCE[name](out, self.mesh, psum_axes)
            if name == "aten.mean":
                out = out / int(np.prod([self.mesh.axis_size(a) for a in psum_axes]))
        osh = Sharding(self.mesh, tuple(
            sh.dims_mapping[i] if i is not None else () for i in eqn.params["out_to_in"]))
        self.write(eqn.node, out, osh)

    @staticmethod
    def _local_reduce(name, val, axes, keepdim, out_dtype):
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

    def _transpose(self, eqn):
        val, sh = self.read(eqn.invars[0])
        perm = eqn.params["permutation"]
        out = val.permute((0,) + tuple(p + 1 for p in perm))
        osh = Sharding(self.mesh, tuple(sh.dims_mapping[i] for i in perm))
        self.write(eqn.node, out, osh)

    def _broadcast(self, eqn):
        val, sh = self.read(eqn.invars[0])
        bcast = eqn.params["broadcast_dimensions"]
        gshape = eqn.params["shape"]
        out_rank = len(gshape)
        dm = [() for _ in range(out_rank)]
        in_shape = eqn.in_avals[0].shape
        for i, j in enumerate(bcast):
            if in_shape[i] == gshape[j]:
                dm[j] = sh.dims_mapping[i]
        osh = Sharding(self.mesh, tuple(dm))
        local_shape = shard_shape(tuple(gshape), osh)
        placed = [1] * out_rank
        for i, j in enumerate(bcast):
            placed[j] = val.shape[1 + i]
        out = val.reshape([val.shape[0]] + placed).expand([val.shape[0]] + list(local_shape))
        self.write(eqn.node, out, osh)

    def _reshape(self, eqn):
        val, sh = self.read(eqn.invars[0])
        want = self.prop.get(eqn.node)
        gshape = eqn.out_avals[0].shape
        if want is not None and self._local_reshape_ok(eqn.in_avals[0].shape, gshape, sh, want):
            out = val.reshape((val.shape[0],) + shard_shape(tuple(gshape), want))
            self.write(eqn.node, out, want)
            return
        # fallback: gather, reshape, re-slice
        val = self._to(val, sh, replicated(self.mesh, sh.rank))
        out = val.reshape((val.shape[0],) + tuple(gshape))
        osh = want or replicated(self.mesh, len(gshape))
        out = self._to(out, replicated(self.mesh, len(gshape)), osh)
        self.write(eqn.node, out, osh)

    @staticmethod
    def _local_reshape_ok(in_shape, out_shape, sh: Sharding, want: Sharding) -> bool:
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

    def _conv(self, eqn):
        p = eqn.params
        if any(d != 1 for d in p["dilation"]) or p["transposed"] or p["groups"] != 1:
            self._fallback(eqn)  # base/window dilation are not implemented (§A.2)
            return
        lv, ls = self.read(eqn.invars[0])
        rv, rs = self.read(eqn.invars[1])
        # kernel replicated; lhs may be sharded on batch and/or spatial dims
        rv = self._to(rv, rs, replicated(self.mesh, rs.rank))
        rank = ls.rank
        strides, padding = p["window_strides"], p["padding"]
        # one axis per sharded spatial dim, and only where the output divides
        keep = list(ls.dims_mapping)
        for d in range(2, rank):
            axes = keep[d][:1]
            if axes:
                n = self.mesh.axis_size(axes[0])
                k = eqn.in_avals[1].shape[d]
                lo, hi = padding[d - 2]
                out_len = (eqn.in_avals[0].shape[d] + lo + hi - k) // strides[d - 2] + 1
                if out_len % n:
                    axes = ()
            keep[d] = axes
        if keep[1] and any(keep[2:]):
            keep[1] = ()  # feature-sharded contraction only without spatial sharding
        tgt = Sharding(self.mesh, tuple(keep))
        lv, ls = self._to(lv, ls, tgt), tgt
        if ls.dims_mapping[1]:
            # feature-dim sharded: contract locally then psum (Megatron-style)
            ax = ls.dims_mapping[1]
            rv_local = rv
            for a in ax:
                rv_local = mr.dynamic_slice_by_axis_index(rv_local, self.mesh, a, 1)
            out = local_conv(lv, rv_local, strides, padding, same_kernel=False)
            out = mr.psum(out, self.mesh, ax)
            osh = Sharding(self.mesh, (ls.dims_mapping[0], ()) + ((),) * (rank - 2))
        else:
            sharded = [(d, ls.dims_mapping[d][0]) for d in range(2, rank) if ls.dims_mapping[d]]
            out = sharded_conv_nd(lv, rv, mesh=self.mesh, sharded=sharded,
                                  window_strides=strides, padding=padding)
            osh = ls
        if p["has_bias"]:
            bv, bs = self.read(eqn.node.args[2])
            bv = self._to(bv, bs, replicated(self.mesh, 1))
            out = out + bv.reshape((bv.shape[0], 1, bv.shape[1]) + (1,) * (rank - 2))
        self.write(eqn.node, out, osh)

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
        if kept_sh is not None:
            rank = kept_sh.rank
            local = {}
            for v, a in zip(eqn.invars, eqn.in_avals):
                val, sh = self.read(v)
                local[v] = self._to(val, sh, kept_sh if a.ndim == rank
                                    else replicated(self.mesh, a.ndim))
            order = list(local)

            def one_device(*shards):
                m = dict(zip(order, shards))
                return node.target(*_substitute(node.args, m.__getitem__),
                                   **{k: _substitute(a, m.__getitem__)
                                      for k, a in node.kwargs.items()})

            out = torch.vmap(one_device)(*(local[v] for v in order))
            osh = Sharding(self.mesh, tuple(
                kept_sh.dims_mapping[d] if d < rank else () for d in range(out.ndim - 1)))
            want = self.prop.get(node) or osh
            self.write(node, self._to(out, osh, want), want)
            return
        whole = {}
        for v in eqn.invars:
            val, sh = self.read(v)
            whole[v] = self._to(val, sh, replicated(self.mesh, sh.rank))[0]
        out = node.target(*_substitute(node.args, whole.__getitem__),
                          **{k: _substitute(a, whole.__getitem__) for k, a in node.kwargs.items()})
        if isinstance(out, torch.Tensor):
            rep = replicated(self.mesh, out.ndim)
            want = self.prop.get(node) or rep
            self.write(node, self._to(mr.replicate(out, self.mesh), rep, want), want)
        elif isinstance(out, (list, tuple)):  # results read back by getitem nodes
            vals = [mr.replicate(o, self.mesh) if isinstance(o, torch.Tensor) else o
                    for o in out]
            shs = [replicated(self.mesh, o.ndim) if isinstance(o, torch.Tensor) else None
                   for o in out]
            self.write(node, vals, shs)
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
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False,
    )

    def record_hit(self) -> None:
        with self._lock:
            self.hits += 1

    def record_miss(self) -> None:
        with self._lock:
            self.misses += 1

    def reset(self) -> None:
        with self._lock:
            self.hits = 0
            self.misses = 0


@dataclasses.dataclass
class _CacheEntry:
    captured: object  # compat.Captured: the graph the shardings refer to
    prop: PropagationResult


def _aval_key(a) -> tuple:
    return (tuple(a.shape), str(a.dtype))


# The per-runner cache skips capture and propagation for repeated calls; the
# process cache shares an entry across ``spmd_partition`` call sites that
# partition the same program, keyed by the captured graph's content digest.

_PROCESS_CACHE: Dict[tuple, _CacheEntry] = {}
_PROCESS_STATS = PlanCacheStats()


def process_plan_cache_stats() -> PlanCacheStats:
    return _PROCESS_STATS


def clear_process_plan_cache() -> None:
    _PROCESS_CACHE.clear()
    _PROCESS_STATS.reset()


def _refuse(option: str, item: str, what: str):
    raise NotImplementedError(
        f"spmd_partition({option}=...) needs {what}, which is not ported yet (ROADMAP {item})")


def spmd_partition(fn, mesh: Mesh, compile_plans: bool = True, optimize: bool = True,
                   process_cache: bool = True, autoshard=None, verify=None, guard=None,
                   trace=None, profile=None, device="cuda"):
    """Partition ``fn`` and return a callable that runs the SPMD program on the
    simulated ``mesh``.

    The user writes ``fn`` against global shapes with ``annotate`` hints.  On
    the first call for an input signature the runner captures ``fn``,
    completes the shardings (propagation pass) and caches both; every call
    shards its global tensor arguments onto ``device`` by the completed
    input shardings, runs the partitioned program over the stacked shards
    (``SpmdPartitioner``), and returns global tensors, as the reference's
    ``shard_map`` does.

    The keywords are the reference's.  This slice has the dynamic path only:
    ``compile_plans=True`` (the reference's default), ``autoshard``,
    ``guard``, ``trace`` and ``profile`` raise ``NotImplementedError`` naming
    their ROADMAP item; ``optimize`` and ``verify`` apply to compiled plans
    only, as in the reference.  ``process_cache=False`` opts this runner out
    of the process-level cache.  ``device`` is "cuda" unless the caller asks
    for "cpu" (no fallback from one to the other).

    The runner exposes ``cache_stats`` (hits/misses), ``plans`` (cache key →
    captured graph and completed shardings), and, after each call,
    ``fallbacks`` (the op names that took ``_fallback``, in graph order) and
    ``collectives`` (the collectives run, by kind).
    """
    if autoshard is not None:
        _refuse("autoshard", "A11", "the autoshard search")
    if guard is not None:
        _refuse("guard", "A9", "the plan guard epilogue")
    if trace is not None:
        _refuse("trace", "A15", "plan-step tracing (obs/trace.py)")
    if profile is not None:
        _refuse("profile", "A15", "a fitted machine profile (obs/profile.py)")
    if compile_plans:
        _refuse("compile_plans", "A5, compiled plans",
                "core/plan.py (compile_plan/lower_plan); pass compile_plans=False")
    dev = resolve_device(device)
    cache: Dict[tuple, _CacheEntry] = {}
    stats = PlanCacheStats()

    def _build(flat, args):
        captured = capture(fn, *args)
        pkey: Optional[tuple] = None
        if process_cache:
            pkey = (captured.digest(), mesh.structural_key(),
                    tuple(_aval_key(a) for a in flat))
            entry = _PROCESS_CACHE.get(pkey)
            if entry is not None:
                _PROCESS_STATS.record_hit()
                return entry
            _PROCESS_STATS.record_miss()
        entry = _CacheEntry(captured, propagate(captured, mesh).result())
        if pkey is not None:
            _PROCESS_CACHE[pkey] = entry
        return entry

    def runner(*args):
        flat, in_spec = tree_flatten(args)
        if not all(isinstance(a, torch.Tensor) for a in flat):
            raise TypeError("spmd_partition: every argument leaf must be a tensor")
        flat = [a.to(dev) for a in flat]
        args = in_spec.unflatten(flat)
        key = (mesh.structural_key(), tuple(_aval_key(a) for a in flat), str(in_spec))
        entry = cache.get(key)
        if entry is None:
            stats.record_miss()
            entry = _build(flat, args)
            cache[key] = entry
        else:
            stats.record_hit()
        captured, prop = entry.captured, entry.prop
        local = [mr.shard(a, prop.get(v) or replicated(mesh, a.ndim))
                 for a, v in zip(flat, captured.invars)]
        part = SpmdPartitioner(prop, mesh)
        with mr.recording() as log:
            outs, shs = part.run(captured, *local)
        runner.fallbacks = list(part.fallbacks)
        runner.collectives = dict(log)
        return captured.unflatten([mr.unshard(o, s) if s is not None else o
                                   for o, s in zip(outs, shs)])

    runner.cache_stats = stats
    runner.plans = cache
    runner.fallbacks = []
    runner.collectives = {}
    return runner
