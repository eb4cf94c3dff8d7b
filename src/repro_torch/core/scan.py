"""The scan node: the port's counterpart of ``jax.lax.scan`` (ROADMAP A9b).

``scan(body, init, xs, consts=..., length=..., reverse=..., unroll=...)``
has ``lax.scan``'s semantics on pytrees of tensors: ``body(carry, x,
*consts)`` returns ``(carry, y)``; the result is the last carry and the
``y``s stacked on a new leading dim.  ``consts`` are the loop-invariant
tensors the body reads (the rope tables, masks, the params of a microbatch
loop): the body must read every outside tensor through them, as a jaxpr's
scan takes its closed-over values as ``num_consts`` operands.

Outside graph capture the body runs in a Python loop, the ``x``s sliced by
one ``unbind`` per leaf (one autograd node, as the unrolled layer loop
takes them) and the ``y``s stacked at the end, so eager paths launch what
they launched before.  Under capture (``core/compat.py::capture``) the
loop is one operator node:

* ``repro_torch::scan(key, consts, init, xs)``: the body is captured once
  (``make_fx`` on fake tensors of the outer tensors' shapes, dtypes and
  device, the outer capture's modes set aside) into a registry keyed by its
  digest (``Captured.digest`` and the loop's shape); the node's fake
  implementation gives the outputs' shapes, its real one runs the body
  graph trip by trip and writes each trip's ``y`` into its slot of a buffer
  allocated once;
* ``repro_torch::scan_fwd``, where a gradient is being recorded through
  the loop: the body's forward and backward are captured as one graph and
  split.  The forward body is the ancestors of the body's outputs (and the
  ``getitem``s of its tuple results); the reverse body is the rest that
  the gradients read; the residuals are the forward values it reads, emitted as extra
  stacked ``y``s of the forward scan, except those computed from the
  consts alone (a layer's params sliced out of a stage-stacked const,
  their casts), which the reverse body computes again rather than reading
  one stacked copy per trip.  The registered gradient of
  ``scan_fwd`` is a ``repro_torch::scan`` over the reverse body with the
  opposite direction: its carry the cotangents of the carry and the sums of
  the consts' gradients, its ``x``s the residuals, the forward's ``x``s and
  the cotangents of the ``y``s, its ``y``s the ``x``s' gradients.  Under
  remat the recompute of ``torch.utils.checkpoint`` is not an ancestor of
  the outputs, so it stays in the reverse body, and "dots"
  (``models/layers.py::_SaveDots``) leaves only the products as residuals:
  the scanned program launches what the unrolled one does.

``unroll`` (an int k) runs k iterations of the body per trip of the node,
as ``lax.scan``'s; ``unroll=True`` unrolls the whole loop (a Python loop
under capture too).  The partitioner reads the node by the registry entry
(``body_of``): ``core/rules.py::lower`` gives it the reference's params
(``num_consts``, ``num_carry``, ``length``, ``reverse``, the body).
"""
from __future__ import annotations

import dataclasses
import hashlib
import operator
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.fx
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils._pytree import tree_flatten, tree_unflatten

from .compat import Captured


@dataclasses.dataclass
class ScanGrad:
    """How a ``scan_fwd`` node differentiates: the reverse body's key and
    which inputs and outputs take part (masks over consts, carry, xs, ys)."""

    bwd_key: str
    consts: Tuple[bool, ...]  # a const's gradient is summed over the trips
    carry: Tuple[bool, ...]  # a carry leaf's cotangent is carried back
    xs: Tuple[bool, ...]  # an x's gradient is a y of the reverse scan
    ys: Tuple[bool, ...]  # a y's cotangent is read by the reverse body
    n_ys: int  # the body's own ys; the residuals follow them


@dataclasses.dataclass
class ScanBody:
    """One registered loop: the body graph (placeholders consts, carry, the
    trip's xs; outputs carry, the trip's ys) and its shape."""

    captured: Captured
    num_consts: int
    num_carry: int
    length: int
    reverse: bool
    outs: Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]  # the node's outputs
    grad: Optional[ScanGrad] = None


_BODIES: Dict[str, ScanBody] = {}


def body_of(key: str) -> ScanBody:
    """The registry entry a scan node's key names."""
    return _BODIES[key]


def _register(body: ScanBody, extra: str = "") -> str:
    h = hashlib.sha256(body.captured.digest().encode())
    h.update(f"{body.num_consts}:{body.num_carry}:{body.length}:{body.reverse}:{extra}".encode())
    key = h.hexdigest()[:32]
    _BODIES.setdefault(key, body)
    return key


# ---------------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------------


def _fresh(outs: List[torch.Tensor], inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Outputs that share no storage with an input (an operator's outputs
    may not alias its inputs): a carry passed through unchanged is copied."""
    ptrs = {t.untyped_storage().data_ptr() for t in inputs if t.numel()}
    return [o.clone() if o.numel() and o.untyped_storage().data_ptr() in ptrs else o
            for o in outs]


def _run(body: ScanBody, consts, init, xs) -> List[torch.Tensor]:
    """The loop on real tensors: the body graph once per trip, each trip's
    ys written into their slots of buffers allocated at the first trip."""
    gm, nk, L = body.captured.gm, body.num_carry, body.length
    carry, bufs = list(init), None
    for t in (range(L - 1, -1, -1) if body.reverse else range(L)):
        outs = list(gm(*consts, *carry, *(x[t] for x in xs)))
        carry, ys = outs[:nk], outs[nk:]
        if bufs is None:
            bufs = [y.new_empty((L,) + tuple(y.shape)) for y in ys]
        for b, y in zip(bufs, ys):
            b[t] = y
    return _fresh(carry + (bufs or []), list(consts) + list(init) + list(xs))


def _fake(body: ScanBody, consts, init, xs) -> List[torch.Tensor]:
    dev = next(t.device for t in (*init, *xs, *consts))
    return [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in body.outs]


@torch.library.custom_op("repro_torch::scan", mutates_args=())
def scan_op(key: str, consts: List[torch.Tensor], init: List[torch.Tensor],
            xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A registered loop (``body_of(key)``) as an operator: the final carry,
    then the stacked ys.  It has no gradient (``scan_fwd_op`` has)."""
    return _run(_BODIES[key], consts, init, xs)


@scan_op.register_fake
def _(key, consts, init, xs):
    return _fake(_BODIES[key], consts, init, xs)


@torch.library.custom_op("repro_torch::scan_fwd", mutates_args=())
def scan_fwd_op(key: str, consts: List[torch.Tensor], init: List[torch.Tensor],
                xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """The forward of a differentiable loop: the final carry, the stacked
    ys, then the stacked residuals its registered gradient reads."""
    return _run(_BODIES[key], consts, init, xs)


@scan_fwd_op.register_fake
def _(key, consts, init, xs):
    return _fake(_BODIES[key], consts, init, xs)


def _fwd_setup(ctx, inputs, output):
    key, consts, init, xs = inputs
    body = _BODIES[key]
    nk, g = body.num_carry, body.grad
    ctx.key = key
    ctx.n = (len(consts), len(xs))
    ctx.outs = [(tuple(o.shape), o.dtype, o.device) for o in output[:nk + g.n_ys]]
    ctx.const_meta = [(tuple(c.shape), c.dtype, c.device) for c in consts]
    ctx.save_for_backward(*consts, *xs, *output[nk + g.n_ys:])
    ctx.set_materialize_grads(False)  # the residuals take no cotangent


def _zeros(grad, meta):
    shape, dtype, device = meta
    return grad if grad is not None else torch.zeros(shape, dtype=dtype, device=device)


def _fwd_backward(ctx, grads):
    body = _BODIES[ctx.key]
    nk, g = body.num_carry, body.grad
    nc, nx = ctx.n
    saved = ctx.saved_tensors
    consts, xs, res = saved[:nc], saved[nc:nc + nx], saved[nc + nx:]
    d_carry = [_zeros(grads[i], ctx.outs[i]) for i in range(nk) if g.carry[i]]
    d_ys = [_zeros(grads[nk + j], ctx.outs[nk + j]) for j in range(g.n_ys) if g.ys[j]]
    acc = [torch.zeros(*m[:1], dtype=m[1], device=m[2])
           for m, on in zip(ctx.const_meta, g.consts) if on]
    outs = scan_op(g.bwd_key, list(consts), d_carry + acc, list(res) + list(xs) + d_ys)
    it = iter(outs)
    d_init = [next(it) if on else None for on in g.carry]
    d_consts = [next(it) if on else None for on in g.consts]
    d_xs = [next(it) if on else None for on in g.xs]
    return None, d_consts, d_init, d_xs


scan_fwd_op.register_autograd(_fwd_backward, setup_context=_fwd_setup)


# ---------------------------------------------------------------------------------
# capture of a body
# ---------------------------------------------------------------------------------


def _flat(tree):
    """The tree's tensor leaves and its structure; ``None`` leaves are no
    leaves (JAX's pytrees hold None as an empty node: a body's ys may be
    None)."""
    leaves, spec = tree_flatten(tree)
    keep = tuple(leaf is not None for leaf in leaves)
    return [leaf for leaf in leaves if leaf is not None], (spec, keep)


def _unflat(vals, structure):
    spec, keep = structure
    it = iter(vals)
    return tree_unflatten([next(it) if k else None for k in keep], spec)


def _capturing(tensors) -> bool:
    return get_proxy_mode() is not None or any(isinstance(t, FakeTensor) for t in tensors)


def _floating(t) -> bool:
    return t.dtype.is_floating_point or t.dtype.is_complex


def _meta(t, drop: int = 0) -> Tuple[Tuple[int, ...], torch.dtype, torch.device]:
    """A tensor's (shape without its first ``drop`` dims, dtype, device)."""
    return tuple(int(d) for d in t.shape[drop:]), t.dtype, t.device


def _trace(fn: Callable, like: Sequence[tuple], grad: Sequence[bool]):
    """``make_fx`` of ``fn`` on fake tensors of the (shape, dtype, device)
    triples ``like`` (``grad`` marks those that require grad), outside the
    modes of any capture in progress."""
    with _disable_current_modes():
        mode = FakeTensorMode()
        with mode:
            args = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype, dev in like]
        for a, g in zip(args, grad):
            if g:
                a.requires_grad_(True)
        return make_fx(fn, tracing_mode="fake")(*args)


def _val(n):
    return n.meta.get("val") if isinstance(n, torch.fx.Node) else None


def _copy_placeholder(graph: torch.fx.Graph, src: torch.fx.Node, name: str) -> torch.fx.Node:
    p = graph.placeholder(name)
    p.meta = dict(src.meta)
    return p


def _split_joint(joint: torch.fx.GraphModule, n_in: Tuple[int, int, int], n_cot: int,
                 n_prim: int, masks: Dict[str, Tuple[bool, ...]]):
    """The joint graph (placeholders consts, carry, xs, then the cotangents;
    outputs the primal outputs, then the gradients of the inputs ``masks``
    selects) split into a forward graph (outputs the primal outputs and the
    residuals) and a reverse body (placeholders consts | cotangents of the
    carry, the consts' accumulators | residuals, xs, cotangents of the ys;
    outputs the carry's gradients, the accumulators plus the consts'
    gradients, the xs' gradients)."""
    g = joint.graph
    ph = [n for n in g.nodes if n.op == "placeholder"]
    nc, nk, nx = n_in
    c_ph, k_ph, x_ph = ph[:nc], ph[nc:nc + nk], ph[nc + nk:nc + nk + nx]
    cot_ph = ph[nc + nk + nx:]
    out = next(n for n in g.nodes if n.op == "output")
    outs = list(out.args[0])
    prim, grads = outs[:n_prim], outs[n_prim:]

    fwd: set = set()
    stack = [o for o in prim if isinstance(o, torch.fx.Node)]
    while stack:
        n = stack.pop()
        if n in fwd or n.op == "placeholder":
            continue
        fwd.add(n)
        stack.extend(n.all_input_nodes)
    for n in g.nodes:  # a tuple result's reads go with it
        if n.op == "call_function" and n.target is operator.getitem and n.args[0] in fwd:
            fwd.add(n)
    # the reverse body's nodes: what the gradients read outside the forward
    # (the joint may hold dead nodes, such as a vmap rule's unfold of a
    # result only the forward returns; they would run, and keep their
    # operands as residuals, every trip)
    need: set = set()
    stack = [a for a in grads if isinstance(a, torch.fx.Node)]
    while stack:
        n = stack.pop()
        if n in need or n in fwd or n.op != "call_function":
            continue
        need.add(n)
        stack.extend(n.all_input_nodes)
    rest = [n for n in g.nodes if n in need]
    k_set = set(k_ph)
    # forward values computed from the consts alone (a layer's params sliced
    # out of a stage-stacked const, their casts, factories): the reverse
    # body computes them again from its own consts rather than reading
    # them stacked trip by trip
    const_only: Dict[torch.fx.Node, bool] = {p: True for p in c_ph}
    for n in g.nodes:
        if n.op == "get_attr":
            const_only[n] = True
        elif n.op == "call_function":
            const_only[n] = all(const_only.get(a, False) for a in n.all_input_nodes)

    residuals: List[torch.fx.Node] = []
    again: set = set()
    seen = set()

    def note(a):
        if (isinstance(a, torch.fx.Node) and a not in seen
                and ((a in fwd and a.op != "get_attr") or a in k_set)):
            seen.add(a)
            if a in fwd and const_only.get(a, False):
                stack = [a]
                while stack:
                    n = stack.pop()
                    if n not in again and n.op == "call_function":
                        again.add(n)
                        stack.extend(n.all_input_nodes)
            else:
                residuals.append(a)

    for n in rest:
        for a in n.all_input_nodes:
            note(a)
    for a in grads:
        note(a)
    for r in residuals:
        if not isinstance(_val(r), torch.Tensor):
            raise NotImplementedError(f"scan: the residual {r} is not a tensor")

    # -- the forward graph -----------------------------------------------------------
    fg = torch.fx.Graph()
    env: Dict[torch.fx.Node, torch.fx.Node] = {}
    for i, p in enumerate(c_ph + k_ph + x_ph):
        env[p] = _copy_placeholder(fg, p, f"in_{i}")
    for n in g.nodes:
        if n in fwd:
            env[n] = fg.node_copy(n, lambda a: env[a])
    fg.output([env[o] if isinstance(o, torch.fx.Node) else o for o in prim]
              + [env[r] for r in residuals])

    # -- the reverse body ----------------------------------------------------------
    bg = torch.fx.Graph()
    benv: Dict[torch.fx.Node, torch.fx.Node] = {}
    for i, p in enumerate(c_ph):
        benv[p] = _copy_placeholder(bg, p, f"const_{i}")
    n_dc = sum(masks["carry"])
    for i, p in enumerate(cot_ph[:n_dc]):
        benv[p] = _copy_placeholder(bg, p, f"dcarry_{i}")
    accs = [_copy_placeholder(bg, p, f"acc_{i}")
            for i, (p, on) in enumerate(zip(c_ph, masks["consts"])) if on]
    for i, r in enumerate(residuals):
        benv[r] = _copy_placeholder(bg, r, f"res_{i}")
    for i, p in enumerate(x_ph):
        benv[p] = _copy_placeholder(bg, p, f"x_{i}")
    for i, p in enumerate(cot_ph[n_dc:]):
        benv[p] = _copy_placeholder(bg, p, f"dy_{i}")
    rest_set = set(rest) | again
    for n in g.nodes:
        if n in rest_set or (n.op == "get_attr" and n not in benv
                             and any(u in rest_set for u in n.users)):
            benv[n] = bg.node_copy(n, lambda a: benv[a])

    def grad_of(a):
        return benv[a] if isinstance(a, torch.fx.Node) else a

    it = iter(grads)
    d_consts = [grad_of(next(it)) if on else None for on in masks["consts"]]
    d_carry = [grad_of(next(it)) if on else None for on in masks["carry"]]
    d_xs = [grad_of(next(it)) if on else None for on in masks["xs"]]
    summed = []
    for acc, d in zip(accs, [d for d in d_consts if d is not None]):
        s = bg.call_function(torch.ops.aten.add.Tensor, (acc, d))
        s.meta = dict(acc.meta)
        summed.append(s)
    bg.output([d for d in d_carry if d is not None] + summed
              + [d for d in d_xs if d is not None])
    fwd_gm = torch.fx.GraphModule(joint, fg)
    bwd_gm = torch.fx.GraphModule(joint, bg)
    return fwd_gm, bwd_gm, residuals


def _captured_scan(call, init_f, init_spec, xs_f, xs_spec, c_f, c_spec, L: int, reverse: bool):
    """The loop as one node of the capture in progress (``scan_op``, or
    ``scan_fwd_op`` where a gradient is being recorded through it)."""
    nc, nk, nx = len(c_f), len(init_f), len(xs_f)
    info: Dict[str, object] = {}

    def body_flat(*flat):
        c, k, x = flat[:nc], flat[nc:nc + nk], flat[nc + nk:]
        carry, y = call(_unflat(list(k), init_spec), _unflat(list(x), xs_spec),
                        _unflat(list(c), c_spec))
        kf, kspec = _flat(carry)
        yf, yspec = _flat(y)
        info.update(k_spec=kspec, y_spec=yspec, n_y=len(yf),
                    out_grad=tuple(t.requires_grad for t in kf + yf))
        return list(kf) + list(yf)

    grad_on = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*c_f, *init_f, *xs_f))
    c_grad = tuple(grad_on and t.requires_grad and _floating(t) for t in c_f)
    k_grad = tuple(grad_on and t.requires_grad and _floating(t) for t in init_f)
    x_grad = tuple(grad_on and t.requires_grad and _floating(t) for t in xs_f)
    like = [_meta(t) for t in (*c_f, *init_f)] + [_meta(x, 1) for x in xs_f]
    while True:  # a carry leaf that leaves a trip needing grad enters the next one so
        fwd = _trace(body_flat, like, c_grad + k_grad + x_grad)
        more = tuple(k or (grad_on and _floating(t) and bool(r))
                     for k, t, r in zip(k_grad, init_f, info["out_grad"][:nk]))
        if more == k_grad:
            break
        k_grad = more
    if info["k_spec"] != init_spec:
        raise TypeError(f"scan: the body's carry {info['k_spec']} is not the init's {init_spec}")
    outs = [n for n in fwd.graph.nodes if n.op == "output"][0].args[0]
    vals = [_val(o) for o in outs]
    for v, t in zip(vals[:nk], init_f):
        if tuple(v.shape) != tuple(t.shape) or v.dtype != t.dtype:
            raise TypeError(f"scan: a carry leaf leaves the body as {tuple(v.shape)} {v.dtype}, "
                            f"it entered as {tuple(t.shape)} {t.dtype}")
    n_y = info["n_y"]
    carry_meta = tuple((tuple(t.shape), t.dtype) for t in init_f)
    y_meta = tuple(((L,) + tuple(v.shape), v.dtype) for v in vals[nk:])
    if not any(info["out_grad"]):
        body = ScanBody(Captured(fwd), nc, nk, L, reverse, carry_meta + y_meta)
        outs = scan_op(_register(body), list(c_f), list(init_f), list(xs_f))
    else:
        y_grad = tuple(bool(r) and _floating(v) for r, v in zip(info["out_grad"][nk:], vals[nk:]))
        dc_like = [_meta(t) for t, on in zip(init_f, k_grad) if on]
        dy_like = [_meta(v) for v, on in zip(vals[nk:], y_grad) if on]

        def joint(*flat):
            prim = body_flat(*flat[:nc + nk + nx])
            cots = list(flat[nc + nk + nx:])
            dc, dy = iter(cots[:len(dc_like)]), iter(cots[len(dc_like):])
            pairs = []
            for i, o in enumerate(prim[:nk]):
                d = next(dc) if k_grad[i] else None
                if d is not None and o.requires_grad:
                    pairs.append((o, d))
            for j, o in enumerate(prim[nk:]):
                if y_grad[j]:
                    d = next(dy)
                    if o.requires_grad:
                        pairs.append((o, d))
            ins = flat[:nc + nk + nx]
            wrt = [t for t, on in zip(ins, c_grad + k_grad + x_grad) if on]
            got = torch.autograd.grad([o for o, _ in pairs], wrt, [d for _, d in pairs],
                                      allow_unused=True)
            got = [torch.zeros_like(w) if d is None else d for w, d in zip(wrt, got)]
            return list(prim) + got

        with torch.enable_grad():
            jgm = _trace(joint, like + dc_like + dy_like,
                         c_grad + k_grad + x_grad + (False,) * (len(dc_like) + len(dy_like)))
        masks = {"consts": c_grad, "carry": k_grad, "xs": x_grad}
        fwd_gm, bwd_gm, residuals = _split_joint(jgm, (nc, nk, nx), len(dc_like) + len(dy_like),
                                                 nk + n_y, masks)
        res_meta = tuple(((L,) + tuple(_val(r).shape), _val(r).dtype) for r in residuals)
        bwd_meta = (tuple(m for m, on in zip(carry_meta, k_grad) if on)
                    + tuple((tuple(t.shape), t.dtype) for t, on in zip(c_f, c_grad) if on)
                    + tuple(((L,) + tuple(t.shape[1:]), t.dtype)
                            for t, on in zip(xs_f, x_grad) if on))
        bwd = ScanBody(Captured(bwd_gm), nc, sum(k_grad) + sum(c_grad), L, not reverse,
                       bwd_meta)
        bwd_key = _register(bwd)
        grad = ScanGrad(bwd_key, c_grad, k_grad, x_grad, y_grad, n_y)
        body = ScanBody(Captured(fwd_gm), nc, nk, L, reverse, carry_meta + y_meta + res_meta,
                        grad)
        key = _register(body, f"grad:{bwd_key}:{c_grad}{k_grad}{x_grad}{y_grad}")
        outs = scan_fwd_op(key, list(c_f), list(init_f), list(xs_f))
    carry = _unflat(list(outs[:nk]), init_spec)
    ys = _unflat(list(outs[nk:nk + n_y]), info["y_spec"])
    return carry, ys


def _loop(call, init, xs_f, xs_spec, c, L: int, reverse: bool):
    slices = [x.unbind(0) for x in xs_f]
    carry, ys = init, [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        carry, ys[t] = call(carry, _unflat([s[t] for s in slices], xs_spec), c)
    if not L:
        return carry, None
    flat = [_flat(y) for y in ys]
    if not flat[0][0]:
        return carry, ys[0]
    stacked = [torch.stack([f[0][i] for f in flat]) for i in range(len(flat[0][0]))]
    return carry, _unflat(stacked, flat[0][1])


def scan(body: Callable, init, xs, *, consts=(), length: Optional[int] = None,
         reverse: bool = False, unroll=1):
    """``lax.scan(body, init, xs, length, reverse, unroll)`` with the body's
    loop-invariant tensors given as ``consts``: ``body(carry, x, *consts)
    -> (carry, y)``; returns ``(carry, ys)``.  Outside capture a Python
    loop; under capture one ``repro_torch::scan`` (or ``scan_fwd``) node
    whose body is captured once."""
    consts = tuple(consts)
    xs_f, xs_spec = _flat(xs)
    init_f, init_spec = _flat(init)
    c_f, c_spec = _flat(consts)
    L = length if length is not None else (int(xs_f[0].shape[0]) if xs_f else None)
    if L is None:
        raise ValueError("scan: no xs and no length")
    if any(int(x.shape[0]) != L for x in xs_f):
        raise ValueError(f"scan: xs' leading dims {[tuple(x.shape) for x in xs_f]} are not "
                         f"all the length {L}")

    def call(carry, x, c):
        return body(carry, x, *c)

    if unroll is True or not L or not _capturing([*init_f, *xs_f, *c_f]):
        return _loop(call, init, xs_f, xs_spec, consts, L, reverse)
    k = int(unroll)
    if k > 1:
        if L % k:
            raise ValueError(f"scan: unroll {k} does not divide the length {L}")
        inner = call

        def call(carry, x, c, inner=inner):  # noqa: F811 - k trips of the body per trip
            return _loop(inner, carry, _flat(x)[0], xs_spec, c, k, reverse)

        xs_f = [x.reshape((L // k, k) + tuple(x.shape[1:])) for x in xs_f]
        carry, ys = _captured_scan(call, init_f, init_spec, xs_f, xs_spec, c_f, c_spec, L // k,
                                   reverse)
        return carry, _merge_unrolled(ys, L)
    return _captured_scan(call, init_f, init_spec, xs_f, xs_spec, c_f, c_spec, L, reverse)


def _merge_unrolled(ys, L: int):
    f, spec = _flat(ys)
    return _unflat([y.reshape((L,) + tuple(y.shape[2:])) for y in f], spec)


def scan_or_loop(body: Callable, carry, xs, cfg, consts=()):
    """``scan`` when ``cfg.scan_layers`` (with ``cfg.scan_unroll``), else an
    unrolled Python loop with the ys stacked: the reference's
    ``models/layers.py::scan_or_loop``.  Both give the same values; under
    capture the first is one node, the second the body's ops once per
    trip."""
    if cfg.scan_layers:
        return scan(body, carry, xs, consts=consts, unroll=cfg.scan_unroll)
    return scan(body, carry, xs, consts=consts, unroll=True)
