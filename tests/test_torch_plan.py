"""Compiled partition plans (plan once, run many) against the port's dynamic
path and the JAX package.

* reference parity: the programs of tests/test_plan.py and of the port's
  partitioner cases run through ``spmd_partition(..., optimize=False)``;
  the compiled plan's outputs equal the dynamic path's bit for bit and the
  unsharded JAX function's under the named class;
* cost parity: ``lower_plan`` on fake tensors equals the reference's
  ``lower_plan`` (``optimize=False``, one pinned ``RooflineParams``) in
  collective kinds and counts, wire bytes, launches, flops, peak bytes and
  the priced ``PlanCost`` fields;
* plan once: a steady-state call captures, propagates and builds nothing;
* the layer: qwen1.5-0.5b's ``decoder_layer`` at a reduced width,
  partitioned on a (2,4) ("data", "model") mesh under 2d_finalized, against
  the JAX package's ``decoder_layer`` on the same weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.analysis.roofline import RooflineParams as JRooflineParams
from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.core import Mesh as JMesh
from repro.core import annotate as jannotate
from repro.core import mesh_split as jsplit
from repro.core.plan import lower_plan as jax_lower_plan
from repro.core.plan import plan_cost as jax_plan_cost
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.analysis.graph_cost import count_flops
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.configs.base import (STRATEGY_2D_FINALIZED, filter_spec_by_shape,
                                      spec_sharding)
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core import partitioner as pt
from repro_torch.core import plan as plan_mod
from repro_torch.core.compat import assert_close, capture
from repro_torch.core.plan import PlanBuilder, lower_for_cost, lower_plan, plan_cost
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import transformer

MESH = Mesh.create((2, 4), ("x", "y"))
JMESH = JMesh.create((2, 4), ("x", "y"))
# one profile, pinned in both packages (not a device's constants)
PROFILE = dict(peak_flops=1e15, hbm_bw=3e12, ici_bw=4.5e11, collective_launch_s=2e-5,
               overlap_efficiency=0.9)


def data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def split(rank, dims):
    return mesh_split(rank, MESH, dims), jsplit(rank, JMESH, dims)


# ---------------------------------------------------------------------------------
# the programs, in both packages: (port fn, JAX fn, input shapes, class)
# ---------------------------------------------------------------------------------


def _dp_mp():
    (pa, ja), (pb, jb) = split(2, ["x", -1]), split(2, [-1, "y"])
    return (lambda a, b: torch.relu(annotate(a, pa) @ annotate(b, pb)),
            lambda a, b: jnp.maximum(jannotate(a, ja) @ jannotate(b, jb), 0.0),
            [(8, 16), (16, 32)], "f32_dot")


def _contracting():
    (px, jx), (pw, jw) = split(2, ["x", "y"]), split(2, ["y", -1])
    return (lambda x, w: annotate(x, px) @ annotate(w, pw),
            lambda x, w: jannotate(x, jx) @ jannotate(w, jw), [(8, 16), (16, 8)], "f32_chain")


def _expert():
    (p1, j1), (p2, j2) = split(3, ["x", -1, "y"]), split(3, ["x", "y", -1])
    return (lambda a, b: torch.einsum("ebm,emh->ebh", annotate(a, p1), annotate(b, p2)),
            lambda a, b: jnp.einsum("ebm,emh->ebh", jannotate(a, j1), jannotate(b, j2)),
            [(2, 4, 8), (2, 8, 16)], "f32_chain")


def _mlp_sum():
    (px, jx), (p1, j1), (p2, j2) = split(2, ["x", -1]), split(2, [-1, "y"]), split(2, ["y", -1])
    return (lambda x, w1, w2: torch.sum(
                (torch.tanh(annotate(x, px) @ annotate(w1, p1)) @ annotate(w2, p2)) ** 2),
            lambda x, w1, w2: jnp.sum(
                (jnp.tanh(jannotate(x, jx) @ jannotate(w1, j1)) @ jannotate(w2, j2)) ** 2),
            [(4, 8), (8, 16), (16, 8)], "f32_chain")


def _reduce_scatter():
    (pl, jl), (pr, jr) = split(2, [-1, "y"]), split(2, ["y", -1])
    return (lambda x, w: annotate(annotate(x, pl) @ annotate(w, pr), pr),
            lambda x, w: jannotate(jannotate(x, jl) @ jannotate(w, jr), jr),
            [(8, 8), (8, 8)], "f32_chain")


def _weight_reshard():
    (px, jx), (pw, jw) = split(2, ["x", -1]), split(2, ["y", -1])
    return (lambda x, w: torch.tanh(annotate(x, px) @ annotate(w, pw)),
            lambda x, w: jnp.tanh(jannotate(x, jx) @ jannotate(w, jw)),
            [(8, 16), (16, 8)], "f32_chain")


def _cat():
    p, j = split(2, ["y", -1])
    return (lambda a, b: torch.cat([annotate(a, p), annotate(b, p)], dim=1) * 2.0,
            lambda a, b: jnp.concatenate([jannotate(a, j), jannotate(b, j)], 1) * 2.0,
            [(8, 4), (8, 6)], "exact")


def _softmax_slice():
    p, j = split(2, ["x", "y"])
    return (lambda x: torch.softmax(annotate(x, p), dim=-1)[1:3] + 1.0,
            lambda x: jax.nn.softmax(jannotate(x, j), axis=-1)[1:3] + 1.0,
            [(8, 16)], "f32")


def _tuple_fallback():
    """An op with no rule and two results (read back by getitem nodes)."""
    p, j = split(2, ["x", "y"])

    def f(x):
        v, i = torch.max(annotate(x, p), dim=1)
        return v * 2.0, i

    return (f, lambda x: (jnp.max(jannotate(x, j), axis=1) * 2.0, jnp.argmax(x, axis=1)),
            [(8, 16)], "exact")


def _halo_conv():
    p, j = split(3, ["x", -1, "y"])
    return (lambda x, w, b: F.conv1d(annotate(x, p), w, b, stride=2, padding=2),
            lambda x, w, b: jax.lax.conv_general_dilated(jannotate(x, j), w, (2,), [(2, 2)])
            + b[:, None], [(2, 3, 48), (4, 3, 5), (4,)], "f32_chain")


def _halo_conv2d():
    p, j = split(4, [-1, -1, "x", "y"])
    return (lambda x, w: F.conv2d(annotate(x, p), w, padding=1),
            lambda x, w: jax.lax.conv_general_dilated(jannotate(x, j), w, (1, 1),
                                                      [(1, 1), (1, 1)]),
            [(1, 2, 16, 16), (4, 2, 3, 3)], "f32_chain")


def _layouts(dm):
    s, js_ = ps_sharding(dm)

    def f(t, bias):
        t = annotate(t, s)
        u = t.t().reshape(64)[None, :].expand(2, 64)
        return u + 1.0, torch.amax(t, dim=0) + bias, t.mean(1, keepdim=True)

    def g(t, bias):
        t = jannotate(t, js_)
        u = jnp.broadcast_to(t.T.reshape(64)[None, :], (2, 64))
        return u + 1.0, jnp.max(t, axis=0) + bias, jnp.mean(t, axis=1, keepdims=True)

    return f, g, [(8, 8), (8,)], "f32_chain"


def ps_sharding(dm):
    from repro.core.sharding import Sharding as JSharding
    from repro_torch.core.sharding import Sharding

    return Sharding(MESH, dm), JSharding(JMESH, dm)


PROGRAMS = {"dp_mp": _dp_mp, "contracting": _contracting, "expert": _expert,
            "mlp_sum": _mlp_sum, "reduce_scatter": _reduce_scatter,
            "weight_reshard": _weight_reshard, "cat": _cat, "softmax_slice": _softmax_slice,
            "tuple_fallback": _tuple_fallback,
            "halo_conv": _halo_conv, "halo_conv2d": _halo_conv2d,
            "layouts_x_y": lambda: _layouts((("x",), ("y",))),
            "layouts_yx_": lambda: _layouts((("y", "x"), ())),
            "layouts__y": lambda: _layouts(((), ("y",)))}


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_compiled_equals_dynamic_and_reference(name):
    f, g, shapes, kind = PROGRAMS[name]()
    args = data(sum(map(ord, name)), *shapes)
    targs = [torch.from_numpy(a) for a in args]
    compiled = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    dynamic = pt.spmd_partition(f, MESH, compile_plans=False, device="cpu")
    got, dyn = compiled(*targs), dynamic(*targs)
    want = g(*args)
    if isinstance(got, torch.Tensor):
        got, dyn, want = (got,), (dyn,), (want,)
    for a, b, w in zip(got, dyn, want):
        assert_close(a, b, "exact")
        assert_close(a, np.asarray(w), kind)
    assert compiled.fallbacks == dynamic.fallbacks
    assert compiled.fallback_gathers == dynamic.fallback_gathers
    assert compiled.collectives == dynamic.collectives
    (entry,) = compiled.plans.values()
    assert entry.plan is not None and entry.plan.stats.steps == len(entry.plan.steps)


def test_bf16_compiled_equals_dynamic_and_reference():
    f, g, _, _ = _contracting()
    x, w = data(10, (8, 64), (64, 16))
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = pt.spmd_partition(f, MESH, optimize=False, device="cpu")(xt, wt)
    assert got.dtype == torch.bfloat16
    assert_close(got, pt.spmd_partition(f, MESH, compile_plans=False, device="cpu")(xt, wt),
                 "exact")
    want = g(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    assert_close(got, np.asarray(want, np.float32), "bf16_chain")


def test_minor_sharded_reshape_gathers_on_both_paths():
    """R7: the port gathers first on both paths; held to numpy."""
    p = mesh_split(2, MESH, [-1, "y"])

    def f(x):
        return annotate(annotate(x, p).reshape(32), mesh_split(1, MESH, ["y"]))

    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    r = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    assert_close(r(torch.from_numpy(x)), x.reshape(32), "exact")
    assert r.collectives == {"all-gather": 1} and r.fallbacks == []


# ---------------------------------------------------------------------------------
# cost parity with the reference's lower_plan
# ---------------------------------------------------------------------------------

# programs whose aten graph holds the same ops as the jaxpr (einsum is
# permutes, views and bmm in aten: same costs, more steps; ROADMAP Queue C)
COST_PROGRAMS = ["dp_mp", "contracting", "expert", "mlp_sum", "reduce_scatter",
                 "weight_reshard", "cat"]
# jnp.sum of bf16 reduces (and psums) in float32, aten.sum in bf16: the
# scalar psum moves 2 bytes fewer in the port (ROADMAP Queue C)
COST_CASES = [(n, d) for n in COST_PROGRAMS for d in ("float32", "bfloat16")
              if (n, d) != ("mlp_sum", "bfloat16")]


@pytest.mark.parametrize("name,dtype", COST_CASES)
def test_lower_plan_costs_match_reference(name, dtype):
    f, g, shapes, _ = PROGRAMS[name]()
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    fake = [torch.empty(s, dtype=tdt, device="meta") for s in shapes]
    mine = lower_plan(capture(f, *fake), None, MESH, optimize=False,
                      profile=RooflineParams(**PROFILE))
    ref = jax_lower_plan(jax.make_jaxpr(g)(*[jax.ShapeDtypeStruct(s, jdt) for s in shapes]),
                         None, JMESH, optimize=False, profile=JRooflineParams(**PROFILE))
    assert mine.stats.collectives == ref.stats.collectives
    for k in ("reshard_bytes", "baseline_bytes", "legacy_bytes"):
        assert getattr(mine.stats, k) == getattr(ref.stats, k), k
    got, want = plan_cost(mine).as_dict(), jax_plan_cost(ref).as_dict()
    same_ops = name != "expert"
    for k in ("wire_bytes", "launches", "flops_per_device", "ideal_flops_per_device",
              "peak_bytes", "collective_s", "compute_s", "imbalance_s", "total_s"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    if same_ops:
        assert got["steps"] == want["steps"]
    else:
        assert got["steps"] > want["steps"]


def test_cost_only_lowering_prices_a_mesh_larger_than_the_host():
    """A full-width qwen MLP on a (16,16) mesh, captured from meta tensors:
    no device, no runnable step, and time only with a profile."""
    big = Mesh.create((16, 16), ("data", "model"))

    def mlp(x, wg, wu, wd):
        x = annotate(x, mesh_split(2, big, ["data", -1]))
        wg = annotate(wg, mesh_split(2, big, [-1, "model"]))
        wu = annotate(wu, mesh_split(2, big, [-1, "model"]))
        return (F.silu(x @ wg) * (x @ wu)) @ wd

    shapes = [(65536, 1024), (1024, 2816), (1024, 2816), (2816, 1024)]
    cap = capture(mlp, *[torch.empty(s, device="meta") for s in shapes])
    plan = lower_plan(cap, None, big, optimize=False)
    with pytest.raises(RuntimeError, match="cost-only"):
        plan.execute(*[torch.empty(0)] * 4)
    cost = plan_cost(plan)
    assert cost.ideal_flops_per_device == pytest.approx(
        (3 * 2 * 65536 * 1024 * 2816 + 65536 * 2816) / 256)
    assert cost.launches == 1 and cost.wire_bytes > 0
    with pytest.raises(ValueError, match="RooflineParams"):
        cost.total_s
    priced = lower_for_cost(cap, None, big, optimize=False, profile=RooflineParams(**PROFILE))
    assert priced.total_s > 0 and priced.wire_bytes == cost.wire_bytes


def test_roofline_params_match_reference_and_have_no_defaults():
    p, j = RooflineParams(**PROFILE), JRooflineParams(**PROFILE)
    assert p.as_dict() == j.as_dict() and p.digest() == j.digest()
    assert RooflineParams.from_dict(p.as_dict()) == p
    from repro.analysis import roofline as jr
    from repro_torch.analysis import roofline as pr

    assert pr.overlap_time_s(3.0, 1.0, p) == jr.overlap_time_s(3.0, 1.0, j)
    assert pr.collective_time_s("all-gather", 4, 1e6, p) == jr.collective_time_s(
        "all-gather", 4, 1e6, j)
    with pytest.raises(TypeError):
        RooflineParams()


def test_graph_flops_count_products_elementwise_and_flash():
    def f(x, w, q, k, v):
        h = torch.tanh(x @ w)
        return h.sum(), ops.attention_model_layout(q, k, v, causal=True, chunk=8)

    shapes = [(4, 8), (8, 16), (2, 16, 2, 2, 32), (2, 16, 2, 32), (2, 16, 2, 32)]
    cap = capture(f, *[torch.empty(s, device="meta") for s in shapes])
    assert count_flops(cap.graph) == 2 * 4 * 8 * 16 + 64 + 64 + 4 * 2 * 4 * 16 * 16 * 32 / 2


# ---------------------------------------------------------------------------------
# plan once, run many (tests/test_plan.py's cases)
# ---------------------------------------------------------------------------------


def test_steady_state_calls_capture_propagate_and_build_nothing(monkeypatch):
    calls = {"capture": 0, "propagate": 0, "build": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)

        return wrapped

    monkeypatch.setattr(pt, "capture", counting("capture", pt.capture))
    monkeypatch.setattr(pt, "propagate", counting("propagate", pt.propagate))
    monkeypatch.setattr(PlanBuilder, "build", counting("build", PlanBuilder.build))

    def f(a, b):
        return torch.tanh(annotate(a, mesh_split(2, MESH, ["x", -1])) @ b)

    runner = pt.spmd_partition(f, MESH, optimize=False, process_cache=False, device="cpu")
    x, y = (torch.ones(4, 4), torch.ones(4, 4))
    runner(x, y)
    assert calls == {"capture": 1, "propagate": 1, "build": 1}
    r2 = runner(x + 1, y)  # same signature: cache hit
    assert calls == {"capture": 1, "propagate": 1, "build": 1}
    assert (runner.cache_stats.hits, runner.cache_stats.misses) == (1, 1)
    assert_close(r2, torch.tanh((x + 1) @ y), "f32")
    runner(torch.ones(8, 4), y)  # a new signature compiles once more
    assert calls == {"capture": 2, "propagate": 2, "build": 2}


def test_process_cache_shares_the_plan_across_call_sites():
    def f(x):
        return annotate(x, mesh_split(2, MESH, ["x", -1])).sum(0)

    pt.clear_process_plan_cache()
    (x,) = data(11, (8, 4))
    r1 = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    r2 = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    for r in (r1, r1, r2):
        assert_close(r(torch.from_numpy(x)), x.sum(0), "f32")
    stats = pt.process_plan_cache_stats()
    assert (stats.hits, stats.misses) == (1, 1)
    assert next(iter(r1.plans.values())).plan is next(iter(r2.plans.values())).plan


def test_plan_records_collective_stats():
    def f(a, b):
        return annotate(a, mesh_split(2, MESH, ["x", "y"])) @ annotate(
            b, mesh_split(2, MESH, ["y", -1]))

    r = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    r(torch.ones(4, 8), torch.ones(8, 4))
    (entry,) = r.plans.values()
    stats = entry.plan.stats.as_dict()
    assert stats["eqns"] >= 3 and stats["steps"] >= 3
    assert stats["collectives"] == {"all-reduce": 1}
    kinds = [s.kind for s in entry.plan.steps]
    assert kinds.count("collective") == 1 and "reshard" not in kinds


def test_plan_drops_each_value_after_its_last_reader():
    """Between steps the plan's env holds only values a later step reads or
    an output names (``PartitionPlan.dead``), and dropping them leaves the
    result unchanged."""
    f, _, shapes, _ = _mlp_sum()
    targs = [torch.from_numpy(a) for a in data(12, *shapes)]
    r = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    want = r(*targs)
    (entry,) = r.plans.values()
    plan = entry.plan
    needed_from = [set(plan.out_keys) for _ in range(len(plan.steps) + 1)]
    for i in range(len(plan.steps) - 1, -1, -1):
        needed_from[i] = needed_from[i + 1] | set(plan.steps[i].reads)
    held = []
    for i, step in enumerate(plan.steps):
        def run(env, reads, writes, i=i, inner=step.run):
            held.append((i, set(env) - set(plan.consts)))
            inner(env, reads, writes)

        step.run = run
    assert_close(r(*targs), want, "exact")
    assert [i for i, _ in held] == list(range(len(plan.steps)))
    assert all(keys <= needed_from[i] for i, keys in held)
    assert sum(map(len, plan.dead)) > len(plan.invars)


def test_eager_attention_skips_the_operator_but_capture_keeps_it(monkeypatch):
    """Eager no-grad attention calls the kernel route directly (the
    operator's dispatch costs host time per call); a captured graph still
    holds the operator as one node."""
    from repro_torch.kernels.ref import chunked_attention_ref

    q, k, v = (torch.from_numpy(a) for a in data(31, (2, 16, 2, 2, 32), (2, 16, 2, 32),
                                                    (2, 16, 2, 32)))

    def f(q, k, v):
        return ops.attention_model_layout(q, k, v, causal=True, chunk=8)

    names = [str(n.target) for n in capture(f, q, k, v).graph.nodes]
    assert "repro_torch.flash_attention.default" in names

    def refuse(*a, **kw):
        raise AssertionError("eager call went through the operator")

    monkeypatch.setattr(ops, "flash_attention_op", refuse)
    assert_close(f(q, k, v), chunked_attention_ref(q, k, v, causal=True, chunk=8), "exact")


def test_fallback_keeps_unmodified_dims():
    def f(a, b):
        return torch.cat([a, b], 1)

    cap = capture(f, torch.ones(8, 4), torch.ones(8, 6))
    (node,) = [n for n in cap.graph.nodes if n.op == "call_function"]
    from repro_torch.core.rules import lower

    sh = mesh_split(2, MESH, ["y", "x"])
    kept = pt.fallback_keep_sharding(lower(node), [sh, sh], MESH)
    assert kept.dims_mapping == (("y",), ())


@pytest.mark.parametrize("kw", [{}, {"compile_plans": True, "optimize": True},
                                {"optimize": False, "verify": True}])
def test_compile_plan_refuses_the_optimizer_and_verifier(kw):
    """The optimizer refuses to run without a machine profile (the port has
    no default constants); the verifier runs, and with a profile so does
    the optimizer."""
    cap = capture(lambda x: x * 2, torch.ones(4))
    prop = pt.propagate(cap, MESH).result()
    kw.pop("compile_plans", None)
    if kw.get("optimize", True):
        with pytest.raises(ValueError, match="profile="):
            plan_mod.compile_plan(cap, prop, MESH, **kw)
        kw["profile"] = RooflineParams(**PROFILE)
    plan = plan_mod.compile_plan(cap, prop, MESH, **kw)
    assert (plan.opt_report is not None) == kw.get("optimize", True)


# ---------------------------------------------------------------------------------
# strategies on a mesh, and the partitioned decoder layer
# ---------------------------------------------------------------------------------


def test_filter_spec_drops_missing_non_dividing_and_reused_axes():
    mesh = make_test_mesh()
    st = STRATEGY_2D_FINALIZED
    assert st.a("batch", "seq", "embed") == (("pod", "data"), None, "model")
    assert filter_spec_by_shape(st.a("batch", "seq", "embed"), (4, 16, 64), mesh) == (
        "data", None, "model")
    assert filter_spec_by_shape(("model", "model"), (8, 8), mesh) == ("model",)
    assert filter_spec_by_shape(("data", "model"), (3, 6), mesh) == ()
    s = spec_sharding(st.w("embed", "heads", None), (64, 4, 16), mesh)
    assert s.dims_mapping == (("data",), ("model",), ())


def _layer_inputs(dtype):
    jcfg = jax_reduced_config(jax_get_config("qwen1.5-0.5b"), 8).with_(dtype=dtype)
    cfg = reduced_config(get_config("qwen1.5-0.5b"), 8).with_(dtype=dtype)
    jst = jax_get_strategy("2d_finalized")
    jlp = jax_layers.tree_init(jax_transformer.layer_param_tree(jcfg, jst),
                               jax.random.PRNGKey(3))
    np_tree = jax.tree_util.tree_map(np.array, jlp)
    rng = np.random.default_rng(7)
    for a in (np_tree["attn"]["bq"], np_tree["attn"]["bk"], np_tree["attn"]["bv"],
              np_tree["ln1"], np_tree["ln2"]):
        a += 0.1 * rng.standard_normal(a.shape)
    return jcfg, cfg, jst, np_tree


def test_partitioned_decoder_layer_matches_reference():
    """reduced_config(qwen, 8): d128, 4 heads of 32 (divide "model"), qkv
    bias, SwiGLU d_ff 352; B4 S32 on ("data" 2, "model" 4) in float32."""
    jcfg, cfg, jst, np_tree = _layer_inputs("float32")
    from repro_torch.models.layers import stored_dtype, tree_map_params

    def leaf(decl, path):
        node = np_tree
        for k in path:
            node = node[k]
        return torch.from_numpy(np.array(node, np.float32)).to(stored_dtype(decl, "float32"))

    lp = tree_map_params(leaf, transformer.layer_param_tree(cfg, STRATEGY_2D_FINALIZED))
    B, S = 4, 32
    (x,) = data(21, (B, S, cfg.d_model))
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    mesh = make_test_mesh()
    fn = transformer.partitionable_layer(cfg, STRATEGY_2D_FINALIZED, mesh)
    runner = pt.spmd_partition(fn, mesh, optimize=False, device="cpu")
    got, aux = runner(lp, torch.from_numpy(x), torch.from_numpy(positions.copy()))
    jlp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    want, _ = jax_transformer.decoder_layer(jcfg, jst, jlp, jnp.asarray(x),
                                            jnp.asarray(positions))
    assert_close(got, np.asarray(want), "f32_chain")
    assert float(aux) == 0.0
    assert runner.fallback_gathers == []
    assert set(runner.fallbacks) <= {"aten.slice", "aten.cat"}  # rope's halves, kept sharded
    (entry,) = runner.plans.values()
    flash = [s for s in entry.plan.steps if s.op == "repro_torch.flash_attention"]
    assert len(flash) == 1
    # the attention runs sharded on batch ("data") and kv heads ("model")
    node = next(n for n in entry.captured.graph.nodes if n.name == "flash_attention")
    assert entry.prop.get(node).dims_mapping == (("data",), (), ("model",), (), ())
    dyn = pt.spmd_partition(fn, mesh, compile_plans=False, device="cpu")
    assert_close(dyn(lp, torch.from_numpy(x), torch.from_numpy(positions.copy()))[0], got,
                 "exact")


@pytest.mark.parametrize("dm", [(("x",), (), ("y",), (), ()), ((), ("x",), (), (), ("y",)),
                                (("y",), (), ("x",), (), ())])
def test_flash_op_partitions_on_batch_and_kv_heads(dm):
    """The flash op under any q layout: S and D axes are gathered, batch and
    kv heads kept, and the result equals the plain version unsharded."""
    from repro_torch.core.sharding import Sharding
    from repro_torch.kernels.ref import chunked_attention_ref

    q, k, v = (torch.from_numpy(a) for a in data(30, (4, 16, 4, 2, 32), (4, 16, 4, 32),
                                                    (4, 16, 4, 32)))

    def f(q, k, v):
        return ops.attention_model_layout(annotate(q, Sharding(MESH, dm)), k, v, causal=True,
                                          chunk=8)

    r = pt.spmd_partition(f, MESH, optimize=False, device="cpu")
    assert_close(r(q, k, v), chunked_attention_ref(q, k, v, causal=True, chunk=8), "exact")
    assert r.fallbacks == []
    (entry,) = r.plans.values()
    (step,) = [s for s in entry.plan.steps if s.op == "repro_torch.flash_attention"]
    n = lambda axes: int(np.prod([MESH.axis_size(a) for a in axes]))
    B, KR = 4 // n(dm[0]), 4 // n(dm[2])  # S and D axes are gathered
    assert step.flops == 4 * B * (KR * 2) * 16 * 16 * 32 / 2
