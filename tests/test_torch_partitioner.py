"""The port's SPMD partitioner on a simulated (2,4) mesh against the JAX
package (paper §4): the partitioned program equals the unsharded one.

The cases of tests/multidev/test_partitioner_multidev.py run through
``spmd_partition(..., compile_plans=False, device="cpu")`` and are held
against the unsharded JAX function on the same numpy inputs (the reference
cannot run sharded in this one-device process).  Plans are held to the
reference device-free and exactly.
"""
import importlib.util
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import Mesh as JMesh
from repro.core import annotate as jannotate
from repro.core import einsum_rules as jer
from repro.core import mesh_split as jsplit
from repro.core import sharding as js
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core import einsum_rules as er
from repro_torch.core import mesh_runtime as mr
from repro_torch.core import sharding as ps
from repro_torch.core.compat import assert_close
from repro_torch.core.halo import sharded_conv_nd
from repro_torch.core.manual import manual
from repro_torch.core.partitioner import (clear_process_plan_cache, process_plan_cache_stats,
                                          spmd_partition)

MESH = Mesh.create((2, 4), ("x", "y"))
JMESH = JMesh.create((2, 4), ("x", "y"))
ROOT = pathlib.Path(__file__).resolve().parents[1]


def data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def run(f, *args):
    """The port's partitioned ``f`` on numpy inputs: (result, runner)."""
    runner = spmd_partition(f, MESH, compile_plans=False, device="cpu")
    out = runner(*(torch.from_numpy(a) for a in args))
    return out, runner


def test_dp_mp_matmul():
    def f(bd, df):
        bd = annotate(bd, mesh_split(2, MESH, ["x", -1]))
        df = annotate(df, mesh_split(2, MESH, [-1, "y"]))
        return torch.relu(torch.einsum("bd,df->bf", bd, df))

    def g(bd, df):
        bd = jannotate(bd, jsplit(2, JMESH, ["x", -1]))
        df = jannotate(df, jsplit(2, JMESH, [-1, "y"]))
        return jax.nn.relu(jnp.einsum("bd,df->bf", bd, df))

    a, b = data(0, (8, 16), (16, 32))
    got, runner = run(f, a, b)
    assert_close(got, g(a, b), "f32_dot")
    assert runner.fallbacks == [] and runner.collectives == {}


def test_contracting_allreduce():
    def f(x, w):
        x = annotate(x, mesh_split(2, MESH, ["x", "y"]))
        w = annotate(w, mesh_split(2, MESH, ["y", -1]))
        return torch.einsum("bd,df->bf", x, w)

    def g(x, w):
        x = jannotate(x, jsplit(2, JMESH, ["x", "y"]))
        w = jannotate(w, jsplit(2, JMESH, ["y", -1]))
        return jnp.einsum("bd,df->bf", x, w)

    x, w = data(1, (4, 8), (8, 6))
    got, runner = run(f, x, w)
    assert_close(got, g(x, w), "f32_chain")
    assert runner.fallbacks == [] and runner.collectives.get("all-reduce") == 1


def test_recursive_grouping_expert_dim():
    """§4.4 Figure 6: batch-dim grouping + inner partitioning."""

    def f(e1, e2):
        e1 = annotate(e1, mesh_split(3, MESH, ["x", -1, "y"]))
        e2 = annotate(e2, mesh_split(3, MESH, ["x", "y", -1]))
        return torch.einsum("ebm,emh->ebh", e1, e2)

    def g(e1, e2):
        e1 = jannotate(e1, jsplit(3, JMESH, ["x", -1, "y"]))
        e2 = jannotate(e2, jsplit(3, JMESH, ["x", "y", -1]))
        return jnp.einsum("ebm,emh->ebh", e1, e2)

    e1, e2 = data(2, (2, 4, 8), (2, 8, 16))
    got, runner = run(f, e1, e2)
    assert_close(got, g(e1, e2), "f32_chain")
    assert runner.fallbacks == [] and runner.collectives.get("all-reduce") == 1


def test_mlp_forward_and_reduction():
    def f(x, w1, w2):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]))
        w1 = annotate(w1, mesh_split(2, MESH, [-1, "y"]))
        w2 = annotate(w2, mesh_split(2, MESH, ["y", -1]))
        return torch.sum((torch.tanh(x @ w1) @ w2) ** 2)

    def g(x, w1, w2):
        x = jannotate(x, jsplit(2, JMESH, ["x", -1]))
        w1 = jannotate(w1, jsplit(2, JMESH, [-1, "y"]))
        w2 = jannotate(w2, jsplit(2, JMESH, ["y", -1]))
        return jnp.sum((jnp.tanh(x @ w1) @ w2) ** 2)

    x, w1, w2 = data(3, (4, 8), (8, 16), (16, 8))
    got, runner = run(f, x, w1, w2)
    assert got.shape == ()
    assert_close(got, g(x, w1, w2), "f32_chain")
    assert runner.fallbacks == []


@pytest.mark.parametrize("stride,pads", [(1, (2, 2)), (2, (1, 2)), (3, (0, 2))])
def test_halo_conv(stride, pads):
    """The reference's case, run the same way: ``sharded_conv_nd`` on local
    shards inside a manual region (``shard_map``)."""
    xg, wk = data(4, (2, 3, 48), (4, 3, 5))
    want = jax.lax.conv_general_dilated(xg, wk, (stride,), [pads])

    def conv_local(xl, wl):
        return sharded_conv_nd(xl, wl, mesh=MESH, sharded=[(2, "y")],
                               window_strides=(stride,), padding=[pads])

    f = mr.shard_map(conv_local, mesh=MESH, in_specs=((None, None, "y"), ()),
                     out_specs=(None, None, "y"))
    with mr.recording() as log:
        got = f(torch.from_numpy(xg), torch.from_numpy(wk))
    assert_close(got, want, "f32_chain")
    assert set(log) == {"collective-permute"}


def test_halo_conv_2d_spatial():
    """Two spatial dims sharded on different axes (§4.4 recursion), in a
    manual region and through the partitioner."""
    xg, wk = data(5, (1, 2, 16, 16), (4, 2, 3, 3))
    want = jax.lax.conv_general_dilated(xg, wk, (1, 1), [(1, 1), (1, 1)])

    def conv_local(xl, wl):
        return sharded_conv_nd(xl, wl, mesh=MESH, sharded=[(2, "x"), (3, "y")],
                               window_strides=(1, 1), padding=[(1, 1), (1, 1)])

    f = manual(conv_local, MESH, in_specs=((None, None, "x", "y"), ()),
               out_specs=(None, None, "x", "y"))
    assert_close(f(torch.from_numpy(xg), torch.from_numpy(wk)), want, "f32_chain")

    def g(x, w):
        x = annotate(x, mesh_split(4, MESH, [-1, -1, "x", "y"]))
        return F.conv2d(x, w, padding=1)

    got, runner = run(g, xg, wk)
    assert_close(got, want, "f32_chain")
    assert runner.fallbacks == [] and set(runner.collectives) == {"collective-permute"}


def test_halo_conv_through_the_partitioner_with_bias_and_stride():
    xg, wk, bias = data(6, (2, 3, 48), (4, 3, 5), (4,))
    want = np.asarray(jax.lax.conv_general_dilated(xg, wk, (2,), [(2, 2)])) + bias[:, None]

    def f(x, w, b):
        return F.conv1d(annotate(x, mesh_split(3, MESH, ["x", -1, "y"])), w, b,
                        stride=2, padding=2)

    got, runner = run(f, xg, wk, bias)
    assert_close(got, want, "f32_chain")
    assert runner.fallbacks == []


EINSUM_SPECS = ["bd,df->bf", "ebd,edf->ebf", "bd,bd->b", "bde,dfe->bfe"]
DIMS = {"b": 8, "d": 8, "f": 8, "e": 2}
AXIS_SIZE = {"x": 2, "y": 4}


def _uniq(ax, labels):
    seen, out = set(), []
    for a, c in zip(ax, labels):
        if a is None or a in seen or DIMS[c] % AXIS_SIZE[a]:
            out.append(-1)
        else:
            seen.add(a)
            out.append(a)
    return out


@pytest.mark.parametrize("case", range(12))
def test_einsum_partition_examples(case):
    """A handful of the reference's einsum-property examples (seeded)."""
    rng = np.random.default_rng(100 + case)
    spec = EINSUM_SPECS[case % 4]
    lhs, rhs = spec.split("->")[0].split(",")
    axes = list(rng.choice([None, "x", "y"], 6))
    la, ra = _uniq(axes[:len(lhs)], lhs), _uniq(axes[3:3 + len(rhs)], rhs)

    def f(x, y):
        x = annotate(x, mesh_split(len(lhs), MESH, la))
        y = annotate(y, mesh_split(len(rhs), MESH, ra))
        return torch.einsum(spec, x, y)

    x, y = data(200 + case, [DIMS[c] for c in lhs], [DIMS[c] for c in rhs])
    got, runner = run(f, x, y)
    assert_close(got, np.einsum(spec, x, y), "f32_chain")
    assert runner.fallbacks == []


def _spec_shardings(mesh, labels):
    per = [None, "x", "y"]
    for combo in itertools.product(per, repeat=len(labels)):
        used = [a for a in combo if a]
        if len(used) == len(set(used)) and all(
                a is None or DIMS[c] % AXIS_SIZE[a] == 0 for a, c in zip(combo, labels)):
            yield combo


@pytest.mark.parametrize("spec", EINSUM_SPECS)
def test_plan_einsum_matches_reference(spec):
    """Role classification and the compiled plan (reshard programs,
    ReduceScatter vs AllReduce, modeled bytes) equal the reference's."""
    lhs, rhs, out = spec.replace("->", ",").split(",")
    out_choices = [None] + [tuple(a if i == d else -1 for i in range(len(out)))
                            for a, d in (("x", 0), ("y", len(out) - 1))
                            if DIMS[out[d]] % AXIS_SIZE[a] == 0]
    n = 0
    for la in _spec_shardings(MESH, lhs):
        for ra in _spec_shardings(MESH, rhs):
            for oa in out_choices:
                pl, pr = ps.mesh_split(len(lhs), MESH, la), ps.mesh_split(len(rhs), MESH, ra)
                jl, jr = js.mesh_split(len(lhs), JMESH, la), js.mesh_split(len(rhs), JMESH, ra)
                po = None if oa is None else ps.mesh_split(len(out), MESH, oa)
                jo = None if oa is None else js.mesh_split(len(out), JMESH, oa)
                lshape = tuple(DIMS[c] // pl.num_shards(i) for i, c in enumerate(lhs))
                rshape = tuple(DIMS[c] // pr.num_shards(i) for i, c in enumerate(rhs))
                got = er.compile_einsum(spec, pl, pr, po, lshape, rshape)
                want = jer.compile_einsum(spec, jl, jr, jo, lshape, rshape)
                assert _plan_key(got) == _plan_key(want), (spec, la, ra, oa)
                assert got.collectives() == want.collectives()
                bare = er.plan_einsum(spec, pl, pr, po)
                assert bare.collectives() == jer.plan_einsum(spec, jl, jr, jo).collectives()
                n += 1
    assert n > 50


def _plan_key(p):
    prog = lambda r: None if r is None else [(s.op, s.axis, s.dim, s.dim2) for s in r.steps]
    return (p.lhs_local.dims_mapping, p.rhs_local.dims_mapping, p.out_sharding.dims_mapping,
            p.psum_axes, p.gather_lhs, p.gather_rhs, prog(p.lhs_program), prog(p.rhs_program),
            p.scatter, p.reduce_axes, prog(p.out_program), p.final_sharding.dims_mapping,
            p.cost_bytes)


def test_partitioned_einsum_reduce_scatter_path():
    """Contracting-matched einsum with an output that wants the psum axis:
    local einsum + psum_scatter (the reference's test_reshard case)."""
    x, w = data(7, (8, 8), (8, 8))
    lhs_sh = ps.mesh_split(2, MESH, [-1, "y"])
    rhs_sh = ps.mesh_split(2, MESH, ["y", -1])
    out_sh = ps.mesh_split(2, MESH, ["y", -1])
    plan = er.compile_einsum("bd,df->bf", lhs_sh, rhs_sh, out_sh, (8, 2), (2, 8))
    assert plan.scatter == (("y", 0),) and plan.reduce_axes == ()
    with mr.recording() as log:
        z, sh = er.partitioned_einsum("bd,df->bf", mr.shard(torch.from_numpy(x), lhs_sh),
                                      mr.shard(torch.from_numpy(w), rhs_sh),
                                      lhs_sh, rhs_sh, out_sh)
    assert sh.dims_mapping == out_sh.dims_mapping and dict(log) == {"reduce-scatter": 1}
    assert_close(mr.unshard(z, sh), x @ w, "f32_chain")


def test_fallback_keeps_batch_sharding_for_cat():
    """The partial fallback runs cat locally on the kept (sharded) batch dim,
    exactly, and counts it."""

    def f(a, b):
        a = annotate(a, mesh_split(2, MESH, ["y", -1]))
        b = annotate(b, mesh_split(2, MESH, ["y", -1]))
        return torch.cat([a, b], dim=1) * 2.0

    a, b = data(8, (8, 4), (8, 6))
    got, runner = run(f, a, b)
    assert_close(got, np.concatenate([a, b], axis=1) * 2.0, "exact")
    assert runner.fallbacks == ["aten.cat"] and runner.collectives == {}


def test_op_without_rule_gathers_and_is_counted():
    def f(x):
        x = annotate(x, mesh_split(2, MESH, ["x", "y"]))
        return torch.softmax(x, dim=-1)[1:3] + 1.0

    (x,) = data(9, (8, 16))
    got, runner = run(f, x)
    want = np.asarray(jax.nn.softmax(x, axis=-1))[1:3] + 1.0
    assert_close(got, want, "f32")
    assert runner.fallbacks[0] == "aten._softmax" and "all-gather" in runner.collectives


def test_bf16_partials_reduce_in_bf16():
    """bf16 operands: the local products and their psum stay bf16, as the
    reference's ``preferred_element_type`` keeps them."""

    def f(x, w):
        x = annotate(x, mesh_split(2, MESH, ["x", "y"]))
        w = annotate(w, mesh_split(2, MESH, ["y", -1]))
        return x @ w

    def g(x, w):
        x = jannotate(x, jsplit(2, JMESH, ["x", "y"]))
        w = jannotate(w, jsplit(2, JMESH, ["y", -1]))
        return x @ w

    x, w = data(10, (8, 64), (64, 16))
    runner = spmd_partition(f, MESH, compile_plans=False, device="cpu")
    got = runner(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    want = g(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert_close(got, np.asarray(want, np.float32), "bf16_chain")


def test_runner_and_process_caches():
    def f(x):
        return annotate(x, mesh_split(2, MESH, ["x", -1])).sum(0)

    clear_process_plan_cache()
    (x,) = data(11, (8, 4))
    r1 = spmd_partition(f, MESH, compile_plans=False, device="cpu")
    r2 = spmd_partition(f, MESH, compile_plans=False, device="cpu")
    for r in (r1, r1, r2):
        assert_close(r(torch.from_numpy(x)), x.sum(0), "f32")
    assert (r1.cache_stats.hits, r1.cache_stats.misses) == (1, 1)
    stats = process_plan_cache_stats()
    assert (stats.hits, stats.misses) == (1, 1)
    r3 = spmd_partition(f, MESH, compile_plans=False, process_cache=False, device="cpu")
    r3(torch.from_numpy(x))
    assert (stats.hits, stats.misses) == (1, 1)


@pytest.mark.parametrize("kw,item", [
    ({}, "A9"), ({"compile_plans": True, "optimize": False, "verify": True}, "A9"),
    ({"compile_plans": False, "autoshard": "AutoshardConfig"}, "A11"),
    ({"compile_plans": False, "guard": object()}, "A9"),
    ({"compile_plans": False, "trace": "TraceConfig"}, "A15"),
    ({"compile_plans": True, "profile": object()}, "A15"),
])
def test_unported_options_raise_naming_their_item(kw, item):
    """No option raises naming its item any more.  A9's options are
    ported: ``optimize=True`` (the default) prices the optimizer with the
    committed profile, ``guard=`` needs a compiled plan, and
    ``verify=True`` runs.  A15's are ported: ``trace=`` needs a compiled
    plan, and ``profile=`` takes a ``RooflineParams``, a ``MachineProfile``
    or a path (anything else is a TypeError at the first call).  A11's
    ``autoshard=`` searches the inputs' shardings, on the dynamic path
    too."""
    from repro_torch.autoshard import AutoshardConfig
    from repro_torch.obs import TraceConfig

    if kw.get("trace") == "TraceConfig":
        kw = dict(kw, trace=TraceConfig())
    if kw.get("autoshard") == "AutoshardConfig":
        kw = dict(kw, autoshard=AutoshardConfig(top_n=1, sa_steps=2, max_candidates=4))
    x = torch.arange(8.0)
    if "guard" in kw or "trace" in kw:
        with pytest.raises(ValueError, match="compile_plans=True"):
            spmd_partition(lambda x: x, MESH, device="cpu", **kw)
    elif "profile" in kw:
        with pytest.raises(TypeError, match="profile"):
            spmd_partition(lambda x: x, MESH, device="cpu", **kw)(x)
    else:
        assert_close(spmd_partition(lambda x: x * 2, MESH, device="cpu", **kw)(x), x * 2,
                     "exact")


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        spmd_partition(lambda x: x, MESH, compile_plans=False)


def test_manual_subgroups_wait_for_a10():
    with pytest.raises(NotImplementedError, match="A10"):
        manual(lambda x: x, MESH, ((),), (), auto_axes=("y",))


def test_quickstart_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  ROOT / "examples" / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "inferred shardings:" in out
    assert "partitioned == single-device oracle: OK" in out


def test_reshape_of_a_minor_sharded_dim_gathers_and_stays_exact():
    """A reshape that merges a dim sharded on its minor side cannot run on
    each shard: the port gathers first (exact).  The reference reshapes each
    shard as it is and returns another order (ROADMAP R7), so this case is
    held to numpy, not to the reference."""

    def f(x):
        x = annotate(x, mesh_split(2, MESH, [-1, "y"]))
        return annotate(x.reshape(32), mesh_split(1, MESH, ["y"]))

    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    got, runner = run(f, x)
    assert_close(got, x.reshape(32), "exact")
    assert runner.collectives == {"all-gather": 1} and runner.fallbacks == []


def test_in_place_ops_are_refused_at_capture():
    def f(x):
        y = annotate(x, mesh_split(2, MESH, ["x", -1])) * 2.0
        return y.add_(1.0)

    with pytest.raises(NotImplementedError, match="out of place"):
        run(f, *data(12, (8, 4)))


@pytest.mark.parametrize("kernel", range(2, 8))
def test_halo_conv_matches_global_over_window_configs(kernel):
    """tests/multidev/test_halo_property.py's grid, enumerated: the halo
    bounds equal the reference's, and the halo convolution on stacked shards
    equals the unsharded JAX convolution (non-constant halos included)."""
    from repro.core.halo import _halo_bounds as ref_bounds
    from repro_torch.core.halo import _halo_bounds

    n, glen = 4, 48
    x, w = data(300 + kernel, (1, 2, glen), (3, 2, kernel))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for stride, lo, hi in itertools.product(range(1, 4), range(5), range(5)):
        out_len = (glen + lo + hi - kernel) // stride + 1
        if out_len % n or out_len <= 0:
            continue
        args = (n, glen // n, out_len // n, stride, lo, kernel)
        assert _halo_bounds(*args) == ref_bounds(*args)
        want = jax.lax.conv_general_dilated(x, w, (stride,), [(lo, hi)])
        f = mr.shard_map(
            lambda xl, wl: sharded_conv_nd(xl, wl, mesh=MESH, sharded=[(2, "y")],
                                           window_strides=(stride,), padding=[(lo, hi)]),
            mesh=MESH, in_specs=((None, None, "y"), ()), out_specs=(None, None, "y"))
        assert_close(f(xt, wt), want, "f32_chain", err_msg=f"{stride} {lo} {hi}")


LAYOUTS_2D = [dm for dm in itertools.product([(), ("x",), ("y",), ("x", "y"), ("y", "x")],
                                             repeat=2)
              if len({a for axes in dm for a in axes}) == sum(map(len, dm))]


@pytest.mark.parametrize("op", ["sum", "mean", "amax", "amin", "prod"])
def test_reductions_over_every_layout(op):
    """Local reduce + psum (pmax, pmin; a gather for prod) equals the global
    reduction for every rank-2 layout, every dim set and keepdim."""
    (x,) = data(13, (8, 8))
    xt = torch.from_numpy(x)
    for dm in LAYOUTS_2D:
        for dims, keep in itertools.product([(0,), (1,), (0, 1)], [False, True]):
            def f(t):
                t = annotate(t, ps.Sharding(MESH, dm))
                return getattr(torch, op)(t, dim=dims if op != "prod" else dims[0],
                                          keepdim=keep)

            got, runner = run(f, x)
            want = f(xt)
            kind = "f32_chain" if op in ("sum", "mean") else "exact"
            assert_close(got, want, kind, err_msg=f"{dm} {dims} {keep}")
            assert runner.fallbacks == []


def test_transpose_reshape_and_broadcast_over_every_layout():
    """permute, a merging reshape, unsqueeze/expand and an implicitly
    broadcast add, for every rank-2 input layout: exact."""
    (x,) = data(14, (8, 8))
    (b,) = data(15, (8,))

    def f(t, bias):
        t = annotate(t, ps.Sharding(MESH, dm))
        u = t.t().reshape(64)[None, :].expand(2, 64)
        return u + 1.0, t + bias, t[:, None, :] * t[:, :, None]

    for dm in LAYOUTS_2D:
        got, runner = run(f, x, b)
        want = f(torch.from_numpy(x), torch.from_numpy(b))
        for g, w_ in zip(got, want):
            assert_close(g, w_, "exact", err_msg=str(dm))
        assert runner.fallbacks == []
