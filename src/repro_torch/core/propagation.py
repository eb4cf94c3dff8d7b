"""Sharding auto-completion over captured aten graphs (paper §3.5).

A port of the JAX package's ``core/propagation.py``, on the graph that
``compat.capture`` records instead of a jaxpr.  Implements the paper's
iterative, priority-based propagation:

* alternating forward (input→output) and backward (output→input) sweeps;
* per-operator, per-direction priorities (elementwise first, dimension-changing
  ops later, Broadcast prefers backward);
* merging of compatible shardings (Figure 3);
* only-refine updates, so a fixed point is guaranteed;
* user annotations (``repro_torch::annotate`` nodes) are preserved verbatim,
  except on their declared ``unspecified_dims`` (partial specification, §3.5).

``make_fx`` inlines calls; the one sub-program a graph holds is the body of
a scan node (``core/scan.py``), which propagates by the reference's
``_apply_scan``: an inner propagation over the body, seeded with its own
annotations, the outer operands' shardings (an x's without its leading
scan dim) and the outer results' (a y's likewise), run to a fixed point of
the carry (carry-out refines carry-in and back), and reflected out, the
stacked xs and ys with their leading dim unsharded.  The inner
propagations are kept per scan node (``PropagationResult.sub``), for the
partitioner to partition the body under them.

The result maps every tensor node of the graph to a ``Sharding``; the
partitioner (partitioner.py) runs the graph on local shards under it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch.fx

from .annotate import ANNOTATE_OP, decode
from .rules import MAX_PRIORITY, PRIORITY, RULES, SCANS, aval, lower
from .sharding import Mesh, Sharding, merge_shardings

MaybeS = Optional[Sharding]


class Propagation:
    """One propagation problem over one captured graph."""

    def __init__(self, graph: torch.fx.Graph, mesh: Mesh):
        self.graph = graph
        self.mesh = mesh
        self.env: Dict[torch.fx.Node, Sharding] = {}
        self.locked: Dict[torch.fx.Node, frozenset] = {}  # locked dims per node
        self.changed = False
        self.sub: Dict[torch.fx.Node, "Propagation"] = {}  # scan node -> its body's
        # scan node -> the outer shardings its body last reached a fixed point
        # under, reflected out with no change: a visit under the same ones
        # would change nothing, so it is skipped
        self.settled: Dict[torch.fx.Node, tuple] = {}
        self.invars = [n for n in graph.nodes if n.op == "placeholder"]
        out = next(n for n in graph.nodes if n.op == "output")
        outs = out.args[0]
        self.outvars = list(outs) if isinstance(outs, (list, tuple)) else [outs]
        self.eqns = [lower(n) for n in graph.nodes if n.op == "call_function"]

    # -- env access ---------------------------------------------------------------
    def get(self, v) -> MaybeS:
        if not isinstance(v, torch.fx.Node):
            return None  # a Literal
        return self.env.get(v)

    def refine(self, v, s: MaybeS) -> None:
        """Merge ``s`` into v's sharding; refuses to alter locked dims.

        Mesh axes that do not divide the dim size are dropped (§4.1 fallback:
        replicate rather than fail) — the partitioner's reshard planner
        requires even shards, so propagating a non-dividing axis would only
        produce an unlowerable plan.  Stacked axes are cut at the first
        non-dividing position (shards stack product-wise).
        """
        if s is None or not isinstance(v, torch.fx.Node):
            return
        cur = self.env.get(v)
        if cur is not None and cur.dims_mapping == s.dims_mapping:
            # masking, the locks and the merge below could only keep cur or
            # find it incompatible: either way v keeps its sharding
            return
        a = aval(v)
        if a is None or a.ndim != s.rank:
            return
        dm, masked = [], False
        for d, axes in enumerate(s.dims_mapping):
            kept, n = [], 1
            for ax in axes:
                n *= s.mesh.axis_size(ax)
                if a.shape[d] % n:
                    masked = True
                    break
                kept.append(ax)
            dm.append(tuple(kept))
        if masked:
            s = Sharding(s.mesh, tuple(dm))
        locked = self.locked.get(v)
        if locked:
            # locked dims keep their seeded mapping
            dm = list(s.dims_mapping)
            used = set()
            for d in range(s.rank):
                if d in locked:
                    dm[d] = cur.dims_mapping[d]
                    used.update(dm[d])
            # drop unlocked entries that now collide with a locked axis
            for d in range(s.rank):
                if d not in locked:
                    if any(ax in used for ax in dm[d]):
                        dm[d] = ()
                    else:
                        used.update(dm[d])
            try:
                s = Sharding(s.mesh, tuple(dm))
            except ValueError:
                return
        if cur is None:
            self.env[v] = s
            self.changed = True
            return
        m = merge_shardings(cur, s)
        if m is not None and m.dims_mapping != cur.dims_mapping:
            self.env[v] = m
            self.changed = True

    # -- seeding ------------------------------------------------------------------
    def seed_annotations(self) -> None:
        for eqn in self.eqns:
            if eqn.node.target is ANNOTATE_OP:
                s, unspec = decode(*eqn.node.args[1:])
                locked = frozenset(d for d in range(s.rank) if d not in unspec)
                for v in (eqn.node.args[0], eqn.node):
                    if not isinstance(v, torch.fx.Node):
                        continue
                    self.env[v] = s
                    self.locked[v] = locked

    def seed_io(self, in_sh: List[MaybeS] = None, out_sh: List[MaybeS] = None):
        if in_sh:
            for v, s in zip(self.invars, in_sh):
                self.refine(v, s)
        if out_sh:
            for v, s in zip(self.outvars, out_sh):
                self.refine(v, s)

    # -- one eqn ------------------------------------------------------------------
    def _apply_eqn(self, eqn, direction: str) -> None:
        if eqn.node.target is ANNOTATE_OP:
            # identity: merge across the annotation (respecting locks via refine)
            x = eqn.node.args[0]
            self.refine(eqn.node, self.get(x))
            self.refine(x, self.get(eqn.node))
            return
        if eqn.name in SCANS:
            self._apply_scan(eqn)
            return
        rule = RULES.get(eqn.name)
        if rule is None or not (eqn.out_avals or eqn.tuple_outs):
            return
        # a tuple result's shardings live on the getitem nodes that read it
        outs = [eqn.node] if eqn.out_avals else eqn.tuple_outs
        in_sh = [self.get(v) for v in eqn.invars]
        out_sh = [self.get(o) for o in outs]
        new_in, new_out = rule(eqn, in_sh, out_sh, direction)
        for v, s in zip(eqn.invars, new_in):
            self.refine(v, s)
        for o, s in zip(outs, new_out):
            self.refine(o, s)

    # -- scan -----------------------------------------------------------------------
    def inner(self, eqn) -> "Propagation":
        """The scan body's propagation for this node, seeded with the body's
        annotations on first use."""
        p = self.sub.get(eqn.node)
        if p is None:
            p = self.sub[eqn.node] = Propagation(eqn.params["body"].graph, self.mesh)
            p.seed_annotations()
        return p

    def _outer_key(self, eqn) -> tuple:
        return tuple(None if s is None else s.dims_mapping
                     for s in [self.get(v) for v in eqn.invars]
                     + [self.get(o) for o in eqn.tuple_outs])

    def _apply_scan(self, eqn) -> None:
        key = self._outer_key(eqn)
        if self.settled.get(eqn.node) == key:
            return
        nc, nk = eqn.params["num_consts"], eqn.params["num_carry"]
        inner = self.inner(eqn)
        body_in, body_out = inner.invars, inner.outvars
        consts, init, xs = eqn.invars[:nc], eqn.invars[nc:nc + nk], eqn.invars[nc + nk:]
        outs = list(eqn.tuple_outs)
        final, ys = outs[:nk], outs[nk:]
        converged = False
        for _ in range(4):  # the carry's fixed point, bounded
            before = {v: s.dims_mapping for v, s in inner.env.items()}
            inner.seed_io([self.get(v) for v in consts] + [self.get(v) for v in init]
                          + [drop0(self.get(v)) for v in xs],
                          [self.get(v) for v in final] + [drop0(self.get(v)) for v in ys])
            inner.run(max_rounds=4)
            for i in range(nk):
                cin, cout = body_in[nc + i], body_out[i]
                inner.refine(cin, inner.get(cout))
                inner.refine(cout, inner.get(cin))
            if {v: s.dims_mapping for v, s in inner.env.items()} == before:
                converged = True
                break
        for ov, iv in zip(consts + init, body_in[:nc + nk]):
            self.refine(ov, inner.get(iv))
        for ov, iv in zip(xs, body_in[nc + nk:]):
            self.refine(ov, add0(inner.get(iv)))
        for ov, iv in zip(final, body_out[:nk]):
            self.refine(ov, inner.get(iv))
        for ov, iv in zip(ys, body_out[nk:]):
            self.refine(ov, add0(inner.get(iv)))
        if converged and self._outer_key(eqn) == key:
            self.settled[eqn.node] = key
        else:
            self.settled.pop(eqn.node, None)

    # -- the sweeps ---------------------------------------------------------------
    def run(self, max_rounds: int = 32) -> Dict[torch.fx.Node, Sharding]:
        for _ in range(max_rounds):
            round_changed = False
            for p in range(MAX_PRIORITY + 1):
                self.changed = False
                for eqn in self.eqns:  # forward sweep
                    if self._prio(eqn) <= p:
                        self._apply_eqn(eqn, "fwd")
                for eqn in reversed(self.eqns):  # backward sweep
                    if self._prio(eqn) <= p:
                        self._apply_eqn(eqn, "bwd")
                if self.changed:
                    round_changed = True
            if not round_changed:
                break
        return self.env

    @staticmethod
    def _prio(eqn) -> int:
        if eqn.node.target is ANNOTATE_OP:
            return 0
        if eqn.name in SCANS:
            return 2
        return PRIORITY.get(eqn.name, MAX_PRIORITY)

    def result(self) -> "PropagationResult":
        """Freeze this propagation into a :class:`PropagationResult`."""
        return PropagationResult(self.graph, self.mesh, dict(self.env),
                                 {n: p.result() for n, p in self.sub.items()})


def drop0(s: MaybeS) -> MaybeS:
    """A stacked value's sharding without its leading (scan) dim."""
    if s is None or s.rank == 0:
        return None
    return Sharding(s.mesh, s.dims_mapping[1:])


def add0(s: MaybeS) -> MaybeS:
    """A trip's sharding with the leading scan dim, unsharded, put back."""
    if s is None:
        return None
    return Sharding(s.mesh, ((),) + s.dims_mapping)


@dataclasses.dataclass(frozen=True)
class PropagationResult:
    """Immutable view of a finished propagation: the partitioner's input.
    ``sub`` holds each scan node's body propagation."""

    graph: torch.fx.Graph
    mesh: Mesh
    env: Dict[torch.fx.Node, Sharding]
    sub: Dict[torch.fx.Node, "PropagationResult"] = dataclasses.field(default_factory=dict)

    def get(self, v) -> MaybeS:
        if not isinstance(v, torch.fx.Node):
            return None
        return self.env.get(v)


def propagate(
    captured,
    mesh: Mesh,
    in_shardings: List[MaybeS] = None,
    out_shardings: List[MaybeS] = None,
) -> Propagation:
    """Complete shardings for every tensor node of a captured program (§3.5)."""
    p = Propagation(captured.graph, mesh)
    p.seed_annotations()
    p.seed_io(in_shardings, out_shardings)
    p.run()
    return p
