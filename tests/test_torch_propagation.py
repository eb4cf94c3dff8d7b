"""Sharding completion in the port (captured aten graphs) against the JAX
package's propagation over jaxprs (paper §3.2, §3.5, §3.6, Figures 3-4).

The programs of tests/test_propagation.py, written once in torch and once in
jax.numpy.  An aten graph and a jaxpr of the same function have different
intermediates, so the two are compared where they must agree: the completed
shardings of the program's inputs, its outputs and every annotated value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Mesh as JMesh
from repro.core import annotate as jannotate
from repro.core import mesh_split as jsplit
from repro.core import propagate as jpropagate
from repro.core.annotate import annotate_p
from repro_torch.core import Mesh, annotate, gspmd_jit, mesh_split, propagate
from repro_torch.core.annotate import ANNOTATE_OP
from repro_torch.core.compat import assert_close, capture

MESH = Mesh.create((2, 4), ("x", "y"))
JMESH = JMesh.create((2, 4), ("x", "y"))


def _dm(s):
    return None if s is None else s.dims_mapping


def port_shardings(fn, *shapes):
    cap = capture(fn, *(torch.ones(s) for s in shapes))
    prop = propagate(cap, MESH)
    anns = [n for n in cap.graph.nodes if n.target is ANNOTATE_OP]
    return ([_dm(prop.get(v)) for v in cap.invars], [_dm(prop.get(v)) for v in cap.outvars],
            [_dm(prop.get(n)) for n in anns]), prop


def ref_shardings(fn, *shapes):
    closed = jax.make_jaxpr(fn)(*(jnp.ones(s) for s in shapes))
    prop = jpropagate(closed, JMESH)
    anns = [e.outvars[0] for e in closed.jaxpr.eqns if e.primitive is annotate_p]
    return ([_dm(prop.get(v)) for v in closed.jaxpr.invars],
            [_dm(prop.get(v)) for v in closed.jaxpr.outvars],
            [_dm(prop.get(v)) for v in anns])


def check_parity(tfn, jfn, *shapes):
    got, prop = port_shardings(tfn, *shapes)
    want = ref_shardings(jfn, *shapes)
    assert got == want
    return got, prop


def test_dot_merge_figure3():
    """§3.2: bd(x,_) × df(_,y) -> bf(x,y) — merged from both inputs."""

    def f(bd, df):
        bd = annotate(bd, mesh_split(2, MESH, ["x", -1]))
        df = annotate(df, mesh_split(2, MESH, [-1, "y"]))
        return bd @ df

    def g(bd, df):
        bd = jannotate(bd, jsplit(2, JMESH, ["x", -1]))
        df = jannotate(df, jsplit(2, JMESH, [-1, "y"]))
        return jnp.dot(bd, df)

    (_, outs, _), _ = check_parity(f, g, (8, 16), (16, 32))
    assert outs == [(("x",), ("y",))]


def test_elementwise_priority_figure4():
    """Figure 4: the BD-shaped tensors around an elementwise op all get the
    same sharding (elementwise has the highest priority)."""

    def f(x, w):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]))
        w = annotate(w, mesh_split(2, MESH, [-1, "y"]))
        y = x @ w
        return y, torch.tanh(y)

    def g(x, w):
        x = jannotate(x, jsplit(2, JMESH, ["x", -1]))
        w = jannotate(w, jsplit(2, JMESH, [-1, "y"]))
        y = jnp.dot(x, w)
        return y, jnp.tanh(y)

    (_, outs, _), _ = check_parity(f, g, (4, 8), (8, 8))
    assert outs == [(("x",), ("y",))] * 2


def test_backward_propagation_through_broadcast():
    def f(b):
        return annotate(b[None, :].expand(16, 8), mesh_split(2, MESH, ["x", "y"]))

    def g(b):
        return jannotate(jnp.broadcast_to(b[None, :], (16, 8)), jsplit(2, JMESH, ["x", "y"]))

    (ins, _, _), _ = check_parity(f, g, (8,))
    assert ins == [(("y",),)]


def test_annotation_preserved():
    """User annotations are never overwritten (§3.5)."""

    def f(x):
        return annotate(x, mesh_split(2, MESH, ["y", -1])) * 2.0

    def g(x):
        return jannotate(x, jsplit(2, JMESH, ["y", -1])) * 2.0

    (_, outs, _), _ = check_parity(f, g, (8, 8))
    assert outs[0][0] == ("y",)


def test_partial_specification():
    """unspecified_dims may be refined by propagation (§3.5)."""

    def f(x, w):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]), unspecified_dims=[1])
        w = annotate(w, mesh_split(2, MESH, [-1, "y"]))
        return annotate(x @ w, mesh_split(2, MESH, ["x", "y"]))

    def g(x, w):
        x = jannotate(x, jsplit(2, JMESH, ["x", -1]), unspecified_dims=[1])
        w = jannotate(w, jsplit(2, JMESH, [-1, "y"]))
        return jannotate(x @ w, jsplit(2, JMESH, ["x", "y"]))

    (ins, _, _), _ = check_parity(f, g, (8, 8), (8, 8))
    assert ins[0][0] == ("x",)


def test_grad_of_annotation_is_annotated():
    """§3.6: the gradient of XlaSharding is a copy of itself — capture over
    ``torch.autograd.grad`` records the annotation in the backward too."""

    def f(w, x):
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = torch.tanh(x @ annotate(w, mesh_split(2, MESH, ["x", "y"]))).sum()
            return torch.autograd.grad(loss, w)[0]

    def g(w, x):
        w = jannotate(w, jsplit(2, JMESH, ["x", "y"]))
        return jnp.sum(jnp.tanh(x @ w))

    (ins, outs, anns), _ = port_shardings(f, (8, 8), (4, 8))
    want = ref_shardings(jax.grad(g), (8, 8), (4, 8))
    assert (ins, outs, anns) == want
    assert len(anns) == 2 and outs == [(("x",), ("y",))]


def test_fixed_point_idempotent():
    """Running propagation on an already-completed env changes nothing."""

    def f(x, w):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]))
        w = annotate(w, mesh_split(2, MESH, [-1, "y"]))
        return torch.relu(x @ w)

    def g(x, w):
        x = jannotate(x, jsplit(2, JMESH, ["x", -1]))
        w = jannotate(w, jsplit(2, JMESH, [-1, "y"]))
        return jax.nn.relu(x @ w)

    _, prop = check_parity(f, g, (4, 8), (8, 8))
    snapshot = {v: s.dims_mapping for v, s in prop.env.items()}
    prop.run(max_rounds=4)
    assert {v: s.dims_mapping for v, s in prop.env.items()} == snapshot


def test_transpose_reshape_reduce_chain():
    def f(x):
        x = annotate(x, mesh_split(3, MESH, ["x", -1, "y"]))
        y = x.permute(2, 0, 1)
        return y.reshape(y.shape[0], -1).sum(dim=1)

    def g(x):
        x = jannotate(x, jsplit(3, JMESH, ["x", -1, "y"]))
        y = jnp.transpose(x, (2, 0, 1))
        return y.reshape(y.shape[0], -1).sum(axis=1)

    (_, outs, _), _ = check_parity(f, g, (4, 3, 8))
    assert outs == [(("y",),)]


def test_quickstart_mlp_completion():
    def f(x, w1, w2):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]))
        w1 = annotate(w1, mesh_split(2, MESH, [-1, "y"]))
        return torch.relu(x @ w1) @ w2

    def g(x, w1, w2):
        x = jannotate(x, jsplit(2, JMESH, ["x", -1]))
        w1 = jannotate(w1, jsplit(2, JMESH, [-1, "y"]))
        return jax.nn.relu(x @ w1) @ w2

    (ins, outs, _), _ = check_parity(f, g, (16, 64), (64, 128), (128, 32))
    assert ins == [(("x",), ()), ((), ("y",)), ((), ())] and outs == [(("x",), ())]


def test_einsum_and_bias_chain_completion():
    """``einsum`` captures as permutes, views and bmm; a bias add broadcasts
    a lower-rank operand implicitly.  The boundary still completes as in the
    reference."""

    def f(e1, e2, b):
        e1 = annotate(e1, mesh_split(3, MESH, ["x", -1, "y"]))
        e2 = annotate(e2, mesh_split(3, MESH, ["x", "y", -1]))
        return torch.einsum("ebm,emh->ebh", e1, e2) + b

    def g(e1, e2, b):
        e1 = jannotate(e1, jsplit(3, JMESH, ["x", -1, "y"]))
        e2 = jannotate(e2, jsplit(3, JMESH, ["x", "y", -1]))
        return jnp.einsum("ebm,emh->ebh", e1, e2) + b

    check_parity(f, g, (2, 4, 8), (2, 8, 16), (16,))


def test_scan_node_waits_for_a9():
    """A scan captured by the port (``core/scan.py``: one ``repro_torch::scan``
    node) completes through its body as the reference's ``lax.scan`` does
    (tests/test_propagation.py::test_scan_carry_fixed_point): the carry's
    fixed point keeps x's ("x", -1) on the result, and the stacked weights
    take the body's annotation with their leading (scan) dim unsharded."""
    from repro_torch.core.scan import scan

    def f(x, ws):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]))

        def body(c, w):
            w = annotate(w, mesh_split(2, MESH, [-1, "y"]))
            return torch.tanh(c @ w), None

        return scan(body, x, ws)[0]

    def g(x, ws):
        x = jannotate(x, jsplit(2, JMESH, ["x", -1]))

        def body(c, w):
            w = jannotate(w, jsplit(2, JMESH, [-1, "y"]))
            return jnp.tanh(c @ w), ()

        return jax.lax.scan(body, x, ws)[0]

    (ins, outs, _), prop = check_parity(f, g, (8, 16), (3, 16, 16))
    assert ins[1] == ((), (), ("y",)) and outs[0][0] == ("x",)
    (node,) = [n for n in prop.graph.nodes if str(n.target) == "repro_torch.scan.default"]
    assert node in prop.sub  # the body's own completion, kept for the partitioner


def test_gspmd_jit_numeric():
    m1 = Mesh.create((1, 1), ("x", "y"))

    def f(a, b):
        a = annotate(a, mesh_split(2, m1, ["x", -1]))
        b = annotate(b, mesh_split(2, m1, [-1, "y"]))
        return torch.relu(a @ b)

    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16)).astype(np.float32)
    b = rng.standard_normal((16, 8)).astype(np.float32)
    run = gspmd_jit(f, m1, device="cpu")
    assert_close(run(torch.from_numpy(a), torch.from_numpy(b)), np.maximum(a @ b, 0), "f32")
    prop = run.propagation_for(torch.from_numpy(a), torch.from_numpy(b))
    assert prop.get(prop.outvars[0]).dims_mapping == (("x",), ("y",))
