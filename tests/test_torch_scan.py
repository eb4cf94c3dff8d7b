"""The port's scan node (``core/scan.py``, ROADMAP A9b) against the JAX
package's ``lax.scan`` path.

* the node itself: eager loop, the captured graph run directly, and the
  gradient of ``scan_fwd`` (a reverse scan over the residuals) equal to the
  unrolled loop, with ``reverse``, ``length`` without xs and ``unroll``;
* completion: the carry's fixed point and the body's input shardings
  equal to the reference's (tests/test_propagation.py::test_scan_carry_fixed_point);
* the optimizer's scan hoist on tests/test_plan_opt.py's two programs,
  ``OptReport`` and ``PlanStats`` equal to the reference's with one pinned
  ``RooflineParams`` in both;
* the verifier on tests/test_plan_verify.py's scan cases, and a seeded
  mutation inside a body plan caught with the body's path;
* ``PlanCost`` of a scanned program equal to its unrolled program's and to
  the reference's ``lower_plan`` of the same scan;
* the two-layer qwen and Mamba2 gradient programs with ``scan_layers=True``
  under the mesh: equal bit for bit to the unrolled program on
  unoptimized plans under each remat mode, with the same kernel operator
  steps at trip count, and against the reference with ``scan_layers=True``;
* ``grad_accum=2`` under the mesh against the reference's
  ``make_train_step(grad_accum=2)``;
* the sharded ``Engine`` with ``scan_layers=True`` against the reference's
  ``Engine``, tokens equal.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.analysis.roofline import RooflineParams as JRooflineParams
from repro.core import Mesh as JMesh
from repro.core import annotate as jannotate
from repro.core import mesh_split as jsplit
from repro.core import propagate as jpropagate
from repro.core.plan import lower_plan as jax_lower_plan
from repro.core.plan import plan_cost as jax_plan_cost
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core.compat import TOLERANCES, assert_close, capture, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.plan import compile_plan, plan_cost
from repro_torch.core.plan_opt import whole_wire_bytes
from repro_torch.core.plan_verify import verify_plan
from repro_torch.core.propagation import propagate
from repro_torch.core.scan import scan
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.train.loop import TrainConfig, make_train_step, sharded_value_and_grad
from repro_torch.train.optimizer import get_optimizer

import test_torch_sharded_serve as serve_t
import test_torch_sharded_ssm as ssm_t
import test_torch_sharded_train as train_t

MESH = Mesh.create((4, 8), ("x", "y"))
JMESH = JMesh.create((4, 8), ("x", "y"))
# one profile, pinned in both packages (not a device's constants)
PROFILE = dict(peak_flops=1e15, hbm_bw=3e12, ici_bw=4.5e11, collective_launch_s=2e-5,
               overlap_efficiency=0.9)
WSH, JWSH = mesh_split(2, MESH, ["y", -1]), jsplit(2, JMESH, ["y", -1])
REP, JREP = mesh_split(2, MESH, [-1, -1]), jsplit(2, JMESH, [-1, -1])
KERNELS = ("repro_torch.flash_attention_fwd", "repro_torch.flash_attention_bwd",
           "repro_torch.ssd_scan", "repro_torch.ssd_scan_bwd")


# ---------------------------------------------------------------------------------
# the node
# ---------------------------------------------------------------------------------


def _unrolled(body, init, xs, consts, reverse):
    carry, ys = init, [None] * xs.shape[0]
    for t in (reversed(range(xs.shape[0])) if reverse else range(xs.shape[0])):
        carry, ys[t] = body(carry, xs[t], *consts)
    return carry, torch.stack(ys)


@pytest.mark.parametrize("reverse,unroll", [(False, 1), (True, 1), (False, 2)])
def test_scan_node_equals_the_unrolled_loop_with_its_gradient(reverse, unroll):
    """Captured, a scan is one ``scan_fwd`` node (gradient recorded) whose
    registered gradient is one ``scan`` node; the graph run directly gives
    the loop's values and gradients (consts, carry and xs), exactly; eager,
    ``scan`` is the loop itself."""
    rng = np.random.default_rng(0)
    W, x0, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((4, 8, 8), (2, 8), (8,)))

    def body(carry, w, c):
        h = torch.tanh(carry @ w + c)
        return h, h.sum(-1)

    def prog(W, x0, c, scanned=True):
        W, x0, c = (t.detach().requires_grad_() for t in (W, x0, c))
        with torch.enable_grad():
            if scanned:
                h, ys = scan(body, x0, W, consts=(c,), reverse=reverse, unroll=unroll)
            else:
                h, ys = _unrolled(body, x0, W, (c,), reverse)
            loss = h.sum() + (ys * ys).sum()
            return (loss, ys) + torch.autograd.grad(loss, [W, x0, c])

    want = prog(W, x0, c, scanned=False)
    for a, b in zip(prog(W, x0, c), want):
        assert_close(a, b, "exact")
    cap = capture(lambda W, x0, c: prog(W, x0, c), W, x0, c)
    ops = collections.Counter(str(n.target) for n in cap.graph.nodes if n.op == "call_function")
    assert (ops["repro_torch.scan_fwd.default"], ops["repro_torch.scan.default"]) == (1, 1)
    for a, b in zip(cap.gm(W, x0, c), want):
        assert_close(a, b, "f32")


def test_scan_with_a_length_and_no_xs():
    """``length`` without xs, as ``lax.scan(body, init, None, length=3)``."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    want = torch.tanh(torch.tanh(torch.tanh(x)))
    got, ys = scan(lambda c, _: (torch.tanh(c), None), x, None, length=3)
    assert ys is None
    assert_close(got, want, "exact")
    cap = capture(lambda x: scan(lambda c, _: (torch.tanh(c), None), x, None, length=3)[0], x)
    assert_close(cap.gm(x), want, "exact")


# ---------------------------------------------------------------------------------
# completion
# ---------------------------------------------------------------------------------


def test_scan_carry_fixed_point_matches_reference():
    """tests/test_propagation.py::test_scan_carry_fixed_point in both
    packages: the result keeps x's ("x", -1), the stacked weights take
    ((), (), "y"), and the body's carry and weight inputs complete as the
    reference's body."""
    mesh, jmesh = Mesh.create((2, 4), ("x", "y")), JMesh.create((2, 4), ("x", "y"))

    def f(x, ws):
        x = annotate(x, mesh_split(2, mesh, ["x", -1]))

        def body(c, w):
            return torch.tanh(c @ annotate(w, mesh_split(2, mesh, [-1, "y"]))), None

        return scan(body, x, ws)[0]

    def g(x, ws):
        x = jannotate(x, jsplit(2, jmesh, ["x", -1]))

        def body(c, w):
            return jnp.tanh(c @ jannotate(w, jsplit(2, jmesh, [-1, "y"]))), ()

        return lax.scan(body, x, ws)[0]

    cap = capture(f, torch.ones(8, 16), torch.ones(3, 16, 16))
    prop = propagate(cap, mesh)
    closed = jax.make_jaxpr(g)(jnp.ones((8, 16)), jnp.ones((3, 16, 16)))
    jprop = jpropagate(closed, jmesh)
    dm = lambda s: None if s is None else s.dims_mapping  # noqa: E731
    assert [dm(prop.get(v)) for v in cap.invars] == [
        dm(jprop.get(v)) for v in closed.jaxpr.invars]
    assert [dm(prop.get(v)) for v in cap.outvars] == [
        dm(jprop.get(v)) for v in closed.jaxpr.outvars]
    assert dm(prop.get(cap.outvars[0]))[0] == ("x",)
    (inner,) = prop.sub.values()
    (jinner,) = jprop.sub.values()
    jbody = next(e for e in closed.jaxpr.eqns if e.primitive.name == "scan").params["jaxpr"]
    assert [dm(inner.get(v)) for v in inner.invars] == [
        dm(jinner.get(v)) for v in jbody.jaxpr.invars]


# ---------------------------------------------------------------------------------
# the optimizer's scan hoist and the verifier
# ---------------------------------------------------------------------------------


def _invariant_gather(direct_reader: bool, trips: int = 4):
    """tests/test_plan_opt.py's scan programs: the body gathers an
    invariant const; with ``direct_reader`` it also reads the const
    unresharded, which pins the gather in the body."""

    def f(xs, w, c0):
        w = annotate(w, WSH)

        def body(c, x, w):
            out = torch.tanh(c + x @ annotate(annotate(w, WSH), REP))
            return (out + w.sum() if direct_reader else out), None

        return scan(body, c0, xs, consts=(w,))[0]

    def g(xs, w, c0):
        w = jannotate(w, JWSH)

        def body(c, x):
            out = jnp.tanh(c + x @ jannotate(jannotate(w, JWSH), JREP))
            return (out + jnp.sum(w) if direct_reader else out), ()

        return lax.scan(body, c0, xs)[0]

    return f, g, [(trips, 64, 64), (64, 64), (64, 64)]


def _plan(f, shapes, optimize=True):
    cap = capture(f, *[torch.empty(s, device="meta") for s in shapes])
    return compile_plan(cap, propagate(cap, MESH).result(), MESH, optimize=optimize,
                        cost_only=True, verify=False, profile=RooflineParams(**PROFILE))


def _jax_plan(g, shapes, optimize=True):
    closed = jax.make_jaxpr(g)(*[jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes])
    return jax_lower_plan(closed, None, JMESH, optimize=optimize,
                          profile=JRooflineParams(**PROFILE))


def _scan_step(plan):
    (s,) = [s for s in plan.steps if s.op == "scan"]
    return s


@pytest.mark.parametrize("direct_reader", [False, True])
def test_scan_hoist_report_matches_reference(direct_reader):
    """tests/test_plan_opt.py's test_scan_hoist_lifts_invariant_reshard and
    test_scan_hoist_skips_const_with_direct_reader: the gather leaves the
    body and runs once before the scan (the scan reads its result) unless
    the body reads the const directly; launches, wire bytes before and
    after (the body at trip count) and the hoist's savings equal the
    reference's, and the planned collectives the reference's at trip
    count."""
    f, g, shapes = _invariant_gather(direct_reader)
    raw, opt = _plan(f, shapes, optimize=False), _plan(f, shapes)
    ref = _jax_plan(g, shapes)
    got, want = opt.opt_report.as_dict(), ref.opt_report.as_dict()
    for k in ("collectives_before", "collectives_after", "wire_bytes_before",
              "wire_bytes_after", "hoisted_reshards"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    (hoist,) = [p for p in got["passes"] if p["name"] == "scan-hoist"]
    (jhoist,) = [p for p in want["passes"] if p["name"] == "scan-hoist"]
    for k in ("hoisted_reshards", "wire_bytes_saved", "launch_s_saved"):
        assert hoist[k] == pytest.approx(jhoist[k], rel=1e-12), k
    # PlanStats counts a body at its trip count; the reference's, built with
    # one shared counter, counts it once: a gather left in the body reads 4x
    trips = 4 if direct_reader else 1
    assert opt.stats.collectives == {k: trips * v for k, v in ref.stats.collectives.items()}
    body_reshards = sum(1 for s in _scan_step(opt).inner.steps if s.kind == "reshard")
    if direct_reader:
        assert hoist["hoisted_reshards"] == 0 and body_reshards >= 1
        return
    assert hoist["hoisted_reshards"] == 1 and body_reshards == 0
    assert sum(1 for s in _scan_step(raw).inner.steps if s.kind == "reshard") == 1
    gathers = [s for s in opt.steps if s.kind == "reshard"
               and any(ps.op == "all_gather" for ps in s.program.steps)]
    assert len(gathers) == 1
    assert opt.steps.index(gathers[0]) < opt.steps.index(_scan_step(opt))
    assert any(r is gathers[0].writes[0] for r in _scan_step(opt).reads)
    assert whole_wire_bytes(opt) == pytest.approx(whole_wire_bytes(raw) / 4)
    assert _scan_step(opt).transient_bytes == _scan_step(opt).inner.peak_bytes


def test_scan_plans_verify_and_a_body_mutation_is_caught():
    """tests/test_plan_verify.py's scan cases: a clean scan plan (length 3,
    no xs) verifies with its body (two plans); the hoisted plan verifies
    clean, its body's report refreshed to the edited body; the twin whose
    gather stays in the body verifies clean, and a reshard step deleted
    from its body (a broken pass) is reported under the body's path."""
    def clean(x, w):
        x = annotate(x, mesh_split(2, MESH, ["x", -1]))
        w = annotate(w, mesh_split(2, MESH, [-1, "y"]))
        return scan(lambda c, _, w: (torch.tanh(c @ w), None), x, None, length=3,
                    consts=(w,))[0]

    rep = verify_plan(_plan(clean, [(32, 64), (64, 64)]))
    assert rep.ok and rep.plans >= 2
    f, _, shapes = _invariant_gather(direct_reader=False)
    plan = _plan(f, shapes)
    inner = _scan_step(plan).inner
    assert sum(1 for s in inner.steps if s.kind == "reshard") == 0
    rep = verify_plan(plan, strict=False)
    assert rep.ok, rep.violations
    assert inner.opt_report.steps_after == len(inner.steps)
    assert inner.opt_report.wire_bytes_after == pytest.approx(whole_wire_bytes(inner))
    f, _, shapes = _invariant_gather(direct_reader=True)
    plan = _plan(f, shapes)
    inner = _scan_step(plan).inner
    reshards = [i for i, s in enumerate(inner.steps) if s.kind == "reshard"]
    assert reshards and verify_plan(plan, strict=False).ok
    del inner.steps[reshards[0]]
    rep = verify_plan(plan, strict=False)
    assert not rep.ok
    assert any(".inner." in v for v in rep.violations), rep.violations


def test_scanned_plan_cost_equals_unrolled_and_reference():
    """The scan program's ``PlanCost`` (unoptimized: the gather runs every
    trip) equals the same body unrolled by a Python loop and the
    reference's ``lower_plan`` of its ``lax.scan``: wire bytes, collective
    launches, per-device and ideal FLOPs."""
    f, g, shapes = _invariant_gather(direct_reader=False)

    def unrolled(xs, w, c0):
        w = annotate(w, WSH)
        for t in range(xs.shape[0]):
            c0 = torch.tanh(c0 + xs[t] @ annotate(annotate(w, WSH), REP))
        return c0

    costs = [plan_cost(_plan(fn, shapes, optimize=False)) for fn in (f, unrolled)]
    want = jax_plan_cost(_jax_plan(g, shapes, optimize=False))
    for got in costs:
        assert got.wire_bytes == pytest.approx(want.wire_bytes, rel=1e-12)
        assert got.launches == want.launches
        assert got.flops_per_device == pytest.approx(want.flops_per_device, rel=1e-12)
        assert got.ideal_flops_per_device == pytest.approx(want.ideal_flops_per_device,
                                                           rel=1e-12)


# ---------------------------------------------------------------------------------
# the models under the mesh
# ---------------------------------------------------------------------------------


def _kernel_steps(plan):
    n = plan.op_counts()
    return {k: n[k] for k in KERNELS if n[k]}


def _gradient(cfg, st, params, batch):
    with set_mesh(train_t.MESH):
        runner = spmd_partition(sharded_value_and_grad(cfg, st, train_t.MESH), train_t.MESH,
                                optimize=False, device="cpu")
        loss, grads = runner(tree_map(torch.Tensor.detach, params), batch)
    assert runner.fallback_gathers == []
    (entry,) = runner.plans.values()
    return loss, grads, entry.plan


def _scanned_and_unrolled(cfg, st, params, batch, runs=None):
    """The gradient program scanned and unrolled, equal bit for bit, with the
    same kernel operator steps per execution; returns the scanned run (and
    keeps both in ``runs`` where given)."""
    scanned = _gradient(cfg.with_(scan_layers=True), st, params, batch)
    unrolled = _gradient(cfg.with_(scan_layers=False), st, params, batch)
    if runs is not None:
        runs.update(scanned=scanned, unrolled=unrolled)
    assert torch.equal(scanned[0], unrolled[0])
    for (path, a), b in zip(leaves_with_paths(scanned[1]), leaves(unrolled[1])):
        assert torch.equal(a, b), path
    assert _kernel_steps(scanned[2]) == _kernel_steps(unrolled[2])
    assert len(scanned[2].body_plans()) == 2  # the layer scan and its reverse scan
    return scanned


def _optimized_alike(runs):
    """Both plans optimized (the scanned one's passes run inside its body
    plans too): the same collective launches and wire bytes per execution
    at trip count.  Fusion buckets psums within a layer here, which a body
    plan holds whole; the scanned plan's buckets times the trips are the
    unrolled plan's."""
    from repro_torch.core.plan_opt import optimize_plan, whole_collective_launches

    got = {}
    for name, (_, _, plan) in runs.items():
        plan.params = RooflineParams(**PROFILE)
        optimize_plan(plan)
        buckets = plan.opt_report.fused_buckets + sum(
            s.call["trips"] * s.inner.opt_report.fused_buckets
            for s in plan.steps if s.inner is not None)
        got[name] = (buckets, whole_collective_launches(plan), whole_wire_bytes(plan))
        assert verify_plan(plan).ok
    assert got["scanned"][:2] == got["unrolled"][:2]
    assert got["scanned"][2] == pytest.approx(got["unrolled"][2], rel=1e-12)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_qwen_gradient_program_scanned_equals_unrolled_and_reference(remat):
    """The two-layer qwen gradient program (tests/test_torch_sharded_train.py's
    config, float32, 2d_finalized) with ``scan_layers=True``: equal bit for
    bit to the unrolled program, and within f32_chain (loss and every
    gradient element) of the reference's ``scan_layers=True`` gradient."""
    jcfg, cfg, jst, st, np_tree, params, batch = train_t._inputs(
        "2d_finalized", "float32", remat=remat, scan_layers=True)
    runs = {}
    loss, grads, plan = _scanned_and_unrolled(cfg, st, params, train_t._torch_batch(batch), runs)
    launches = 2 if remat == "none" else 4
    assert _kernel_steps(plan) == {KERNELS[0]: launches, KERNELS[1]: 2}
    if remat != "none":
        return  # remat moves no value: the reference is held once
    _optimized_alike(runs)
    jloss, jgrads = train_t._jax_value_and_grad(jcfg, jst, np_tree, batch)
    assert_close(loss, np.asarray(jloss), "f32_chain")
    for (path, g), w in zip(leaves_with_paths(grads), jax.tree_util.tree_leaves(jgrads)):
        assert_close(g, np.asarray(w), "f32_chain", err_msg=f"grad {path}")


@functools.lru_cache(maxsize=None)
def _mamba2_inputs():
    """The reference's Mamba2 weights at ``reduced_config(.., 8)`` with two
    layers and d_model 128 (4 heads divide "model"), the float32 leaves
    moved off their zeros and ones as tests/test_torch_sharded_ssm.py moves
    them, and batch 0 of the arithmetic pattern (8 x 32: ROADMAP R11)."""
    jcfg = ssm_t.jax_reduced_config(ssm_t.jax_get_config("mamba2-130m"), 8).with_(
        **MAMBA2_FIELDS)
    tree = jax.tree_util.tree_map(np.array, jax_layers.tree_init(
        jax_api.param_tree(jcfg, ssm_t.jax_get_strategy("2d_finalized")),
        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(12)
    mix = tree["layers"]["mixer"]
    for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.3), ("norm", 0.2)):
        mix[name] += scale * rng.standard_normal(mix[name].shape)
    for a in (tree["layers"]["ln"], tree["final_ln"]):
        a += 0.1 * rng.standard_normal(a.shape)
    batch = TokenPipeline(DataConfig(jcfg.vocab_size, 32, 8, seed=4,
                                     pattern="arithmetic")).batch_at(0)
    return tree, batch


MAMBA2_FIELDS = dict(dtype="float32", num_layers=2, d_model=128)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_mamba2_gradient_program_scanned_equals_unrolled_and_reference(remat):
    """The two-layer Mamba2 gradient program (float32, d_model 128,
    2d_finalized) with ``scan_layers=True``: equal bit for bit to the
    unrolled program under each remat, the SSD and its gradient at the
    unrolled program's counts, and, under "none", the loss and each
    gradient leaf within f32_chain in norm of the reference's
    ``scan_layers=True`` gradient (float32 Mamba2 holds f32_chain in norm
    per leaf, not per element: tests/test_torch_sharded_ssm.py)."""
    tree, batch = _mamba2_inputs()
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(remat=remat, **MAMBA2_FIELDS)
    st = get_strategy("2d_finalized")
    params = ssm_t.padded_params(tree, cfg, st, ssm_t.MESH)
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    loss, grads, plan = _scanned_and_unrolled(cfg, st, params, tb)
    ssd = 2 if remat == "none" else 4
    assert _kernel_steps(plan) == {KERNELS[2]: ssd, KERNELS[3]: 2}
    if remat != "none":
        return  # remat moves no value: the reference is held once
    jcfg = ssm_t.jax_reduced_config(ssm_t.jax_get_config("mamba2-130m"), 8).with_(
        remat=remat, scan_layers=True, **MAMBA2_FIELDS)
    jloss, jgrads = train_t._jax_value_and_grad(jcfg, ssm_t.jax_get_strategy("2d_finalized"),
                                                tree, batch)
    assert_close(loss, np.asarray(jloss), "f32_chain")
    V = tree["embed"]["embedding"].shape[0]
    for (path, g), w in zip(leaves_with_paths(grads), jax.tree_util.tree_leaves(jgrads)):
        g = g[:V] if path == ("embed", "embedding") else g
        rel = train_t._rel_norm(g, w)
        assert rel <= TOLERANCES["f32_chain"][0], f"grad {path}: {rel}"


def test_grad_accum_under_the_mesh_matches_reference():
    """``make_train_step`` under ``set_mesh`` with ``grad_accum=2`` and
    ``scan_layers=True``: the microbatch loop one scan whose body holds the
    layer stack's scan and its reverse scan (body plans nest), for one
    Adafactor step against the reference's ``make_train_step(grad_accum=2)``
    unsharded: loss, grad norm and params within f32_chain; no gathering
    fallback; one flash forward and backward per layer per microbatch."""
    jcfg, cfg, jst, st, np_tree, params, _ = train_t._inputs("2d_finalized", "float32", seed=3,
                                                            scan_layers=True)
    jopt, opt = jax_get_optimizer("adafactor", lr=0.05), get_optimizer("adafactor", lr=0.05)
    b = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=4,
                                 pattern="arithmetic")).batch_at(0)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jst, jopt, JaxTrainConfig(grad_accum=2)))(
        train_t._jax_state(jcfg, jst, jopt, np_tree), {k: jnp.asarray(v) for k, v in b.items()})
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    with set_mesh(train_t.MESH):
        step = make_train_step(cfg, st, opt, TrainConfig(grad_accum=2))
    state, m = step(state, {k: torch.from_numpy(v).long() for k, v in b.items()})
    assert step.runner.fallback_gathers == []
    (entry,) = step.runner.plans.values()
    plan = entry.plan
    (micro,) = [s for s in plan.steps if s.op == "scan"]
    assert micro.call["trips"] == 2
    assert [s.op for s in micro.inner.steps].count("scan") == 2  # the layers, forward and back
    assert _kernel_steps(plan) == {KERNELS[0]: 4, KERNELS[1]: 4}
    assert verify_plan(plan).ok
    assert_close(m["loss"], np.asarray(jm["loss"]), "f32_chain")
    assert_close(m["grad_norm"], np.asarray(jm["grad_norm"]), "f32_chain")
    for (path, p), w in zip(leaves_with_paths(state["params"]),
                            jax.tree_util.tree_leaves(jstate["params"])):
        assert_close(p, np.asarray(w), "f32_chain", err_msg=f"param {path}")


def test_scanned_engine_matches_reference():
    """``Engine`` under ``set_mesh`` (2d_attempt1) with ``scan_layers=True``:
    the decode step's layer loop one scan over (layer params, layer caches)
    whose ys are the new caches; against the reference's ``Engine``
    unsharded, float32: tokens equal and logits within coarse (ROADMAP
    R10), one plan for the run, no gathering fallback, one decode operator
    per layer per step, and no whole stacked cache copied by a plan step
    other than the scan's own ys."""
    orig = serve_t._configs
    try:
        serve_t._configs = lambda a, d: (orig(a, d)[0], orig(a, d)[1].with_(scan_layers=True))
        eng, reqs, seen = serve_t._port_engine("qwen1.5-0.5b", "float32", "2d_attempt1",
                                               serve_t.MESH)
    finally:
        serve_t._configs = orig
    jreqs, jseen, _ = serve_t._reference("qwen1.5-0.5b", "float32")
    assert len(eng.runner.plans) == 1 and eng.runner.fallback_gathers == []
    (entry,) = eng.runner.plans.values()
    plan = entry.plan
    assert plan.op_counts()["repro_torch.flash_decode"] == eng.cfg.num_layers
    assert not any(s.op == "aten.stack" for s in plan.steps)
    serve_t._check_float32(jreqs, reqs, jseen, seen, "coarse")


def test_compiled_scan_plan_lists_its_body_fallbacks():
    """A scan body's fallbacks are the plan's, as the dynamic path lists
    them: a softmax over a sharded dim inside the body gathers it."""
    mesh = Mesh.create((4,), ("x",))

    def f(xs):
        xs = annotate(xs, mesh_split(3, mesh, [-1, "x", -1]))

        def body(c, x):
            y = torch.softmax(x, dim=0)
            return c + y.sum(0), y

        return scan(body, torch.zeros(4), xs)

    xs = torch.tensor(np.random.default_rng(5).standard_normal((3, 8, 4)).astype(np.float32))
    compiled = spmd_partition(f, mesh, optimize=False, device="cpu")
    dynamic = spmd_partition(f, mesh, compile_plans=False, device="cpu")
    got, want = compiled(xs), dynamic(xs)
    for a, b in zip(got, want):
        assert_close(a, b, "exact")
    assert compiled.fallback_gathers == dynamic.fallback_gathers == ["aten._softmax"]
    assert compiled.fallbacks == dynamic.fallbacks
