"""The port's GSPMD §3.3 pipelining (ROADMAP A10) against the JAX package.

* ``core/shift.py``: ``stage_shift`` forward and reverse and its gradient
  (``jax.vjp`` of the reference's), the malformed calls it refuses, and
  ``take_stage_row``;
* ``pipeline/stages.py``: ``stage_stack_params`` and ``pipelined_apply`` at
  S in {1, 2, 4} with its gradients on the tanh stack of
  ``tests/test_pipeline_subsystem.py``, against the reference and against
  the port's own plain stack (the known divergence: torch's batched CPU
  matmul, which the vmapped stage body runs, rounds apart from a plain
  ``mm``);
* ``core/pipeline.py``: the four (L, R, M) cases of
  ``tests/test_pipeline.py``, remat gradients and the bubble ratios;
* the plan: one ppermute per tick (perm and axes), one add-psum,
  ``plan_ppermute_bytes`` and ``schedule_cost`` equal to the reference's
  under one pinned ``RooflineParams``, the bubble as FLOP inflation,
  same-perm fusion;
* the three cases of ``tests/multidev/test_pipeline_multidev.py`` on a
  simulated ("stage" 4, "model" 2) mesh;
* ``pipelined_loss_fn`` of qwen1.5-0.5b and mamba2-130m at reduced width
  against the reference's, and partitioned against unpartitioned;
* ``api.pipeline_boundary`` for every registered config, and the kernel
  operators' and the annotation's vmap rules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.roofline import RooflineParams as JRooflineParams
from repro.configs import registry as jax_registry
from repro.configs.base import get_strategy as jax_get_strategy
from repro.core import Mesh as JMesh
from repro.core import annotate as jannotate
from repro.core import mesh_split as jsplit
from repro.core.pipeline import circular_bubble_ratio as jax_circular
from repro.core.pipeline import gpipe_bubble_ratio as jax_gpipe
from repro.core.pipeline import pipeline as jax_pipeline
from repro.core.plan import compile_plan as jax_compile_plan
from repro.core.plan import plan_cost as jax_plan_cost
from repro.core.propagation import propagate as jax_propagate
from repro.core.shift import stage_shift as jax_stage_shift
from repro.core.shift import take_stage_row as jax_take_stage_row
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.pipeline import pipelined_apply as jax_pipelined_apply
from repro.pipeline import pipelined_loss_fn as jax_pipelined_loss_fn
from repro.pipeline import plan_ppermute_bytes as jax_plan_ppermute_bytes
from repro.pipeline import stage_stack_params as jax_stage_stack_params
from repro.pipeline.schedule import PipelineDecision as JPipelineDecision
from repro.pipeline.schedule import schedule_cost as jax_schedule_cost
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.configs import registry
from repro_torch.configs.base import get_strategy
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core.annotate import ANNOTATE_OP, decode
from repro_torch.core.compat import TOLERANCES, assert_close, capture, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.pipeline import circular_bubble_ratio, gpipe_bubble_ratio, pipeline
from repro_torch.core.plan import lower_plan, plan_cost
from repro_torch.core.plan_opt import fuse_collectives
from repro_torch.core.propagation import propagate
from repro_torch.core.scan import body_of
from repro_torch.core.shift import stage_shift, take_stage_row
from repro_torch.core.tree import leaves, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (chunked_attention_ref, flash_attention_bwd_ref,
                                     ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import padded_vocab, tree_map_params
from repro_torch.pipeline import (PipelineDecision, bubble_fraction, pipeline_ticks,
                                  pipelined_apply, pipelined_loss_fn, plan_ppermute_bytes,
                                  schedule_cost, stage_batch, stage_stack_params)

rng = np.random.default_rng(0)
L, D, M, MB = 4, 8, 4, 2
WS = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
XS = rng.standard_normal((M, MB, D)).astype(np.float32)
# one machine profile pinned in both packages: the reference's default
# constants, which the port does not carry
PROFILE = JRooflineParams().as_dict()
SCAN_OPS = (torch.ops.repro_torch.scan.default, torch.ops.repro_torch.scan_fwd.default)


def layer(lp, x, _):
    return torch.tanh(x @ lp)


def jax_layer(lp, x, _):
    return jnp.tanh(x @ lp)


def _t(a):
    return torch.tensor(np.asarray(a))


def plain_stack(ws, xs, vmapped=False):
    """Each microbatch through the layers in turn; ``vmapped`` runs each
    layer as the pipeline's stage body does, a vmap over a stage dim of 1."""
    fn = torch.func.vmap(lambda lp, h: layer(lp, h, None)) if vmapped else None
    out = []
    for m in range(xs.shape[0]):
        h = xs[m][None] if vmapped else xs[m]
        for i in range(ws.shape[0]):
            h = fn(ws[i][None], h) if vmapped else layer(ws[i], h, None)
        out.append(h[0] if vmapped else h)
    return torch.stack(out)


# ---------------------------------------------------------------------------------
# the stage shift
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True])
def test_stage_shift_and_its_gradient_match_reference(reverse):
    state = rng.standard_normal((4, 3, 5)).astype(np.float32)
    x = rng.standard_normal((3, 5)).astype(np.float32)
    ct = rng.standard_normal((4, 3, 5)).astype(np.float32)
    want, vjp = jax.vjp(lambda s, v: jax_stage_shift(s, v, reverse=reverse),
                        jnp.asarray(state), jnp.asarray(x))
    want_ds, want_dx = vjp(jnp.asarray(ct))
    s, v = _t(state).requires_grad_(), _t(x).requires_grad_()
    got = stage_shift(s, v, reverse=reverse)
    ds, dx = torch.autograd.grad(got, [s, v], _t(ct))
    for a, b in ((got, want), (ds, want_ds), (dx, want_dx)):
        assert_close(a.detach(), np.asarray(b), "exact")


@pytest.mark.parametrize("state,x,match", [
    (np.float32(1.0), np.float32(1.0), "leading stage dim"),
    (np.zeros((0, 3), np.float32), np.zeros((3,), np.float32), "empty stage dim"),
    (np.zeros((4, 3), np.float32), np.zeros((2,), np.float32), "one stage row"),
    (np.zeros((4, 3), np.float32), np.zeros((3,), np.int32), "dtype mismatch"),
])
def test_stage_shift_refuses_malformed_calls_as_the_reference(state, x, match):
    with pytest.raises(ValueError, match=match):  # the reference checks as it traces
        jax.make_jaxpr(jax_stage_shift)(jnp.asarray(state), jnp.asarray(x, dtype=x.dtype))
    with pytest.raises(ValueError, match=match):
        stage_shift(torch.tensor(state), torch.tensor(x))


def test_take_stage_row_and_stage_stack_params_match_reference():
    state = rng.standard_normal((4, 2, 3)).astype(np.float32)
    for row in range(4):
        assert_close(take_stage_row(_t(state), row),
                     np.asarray(jax_take_stage_row(jnp.asarray(state), row)), "exact")
    for S in (1, 2, 4):
        got = stage_stack_params({"w": _t(WS)}, S)["w"]
        assert tuple(got.shape) == (S, L // S, D, D)
        assert_close(got, np.asarray(jax_stage_stack_params(jnp.asarray(WS), S)), "exact")


# ---------------------------------------------------------------------------------
# pipelined_apply and the older wrapper
# ---------------------------------------------------------------------------------


def _jax_apply(S):
    return np.asarray(jax.jit(lambda w, x: jax_pipelined_apply(jax_layer, w, x, num_stages=S))(
        jax_stage_stack_params(jnp.asarray(WS), S), jnp.asarray(XS)))


@pytest.mark.parametrize("S", [1, 2, 4])
def test_pipelined_apply_matches_reference_and_the_plain_stack(S):
    got = pipelined_apply(layer, stage_stack_params(_t(WS), S), _t(XS), num_stages=S)
    assert_close(got, _jax_apply(S), "f32_dot")
    # bit for bit against the plain stack with the stage body's batched
    # products (test_batched_cpu_matmul_rounds_apart_from_mm)
    assert_close(got, plain_stack(_t(WS), _t(XS), vmapped=True), "exact")
    assert_close(got, plain_stack(_t(WS), _t(XS)), "f32_dot")


def test_pipelined_apply_gradients_match_reference():
    def jloss(w, x):
        return jnp.mean(jax_pipelined_apply(jax_layer, w, x, num_stages=2) ** 2)

    jw, jx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jax_stage_stack_params(jnp.asarray(WS), 2),
                                                      jnp.asarray(XS))
    w, x = stage_stack_params(_t(WS), 2).requires_grad_(), _t(XS).requires_grad_()
    gw, gx = torch.autograd.grad(
        (pipelined_apply(layer, w, x, num_stages=2) ** 2).mean(), [w, x])
    assert_close(gw, np.asarray(jw), "f32_dot")
    assert_close(gx, np.asarray(jx), "f32_dot")
    ws, xs = _t(WS).requires_grad_(), _t(XS).requires_grad_()
    rw, rx = torch.autograd.grad((plain_stack(ws, xs, vmapped=True) ** 2).mean(), [ws, xs])
    assert_close(gw.reshape(L, D, D), rw, "exact")
    assert_close(gx, rx, "exact")


def test_batched_cpu_matmul_rounds_apart_from_mm():
    """The known divergence: the reference's pipelined stack is bit-equal to
    its plain stack (XLA lowers the vmapped product and the plain one
    alike); torch's CPU ``bmm``, which the vmapped stage body runs, sums in
    another order than ``mm`` on the same rows, so the port's pipelined
    stack equals its plain stack only where the plain stack uses the same
    batched product (test_pipelined_apply_matches_reference_and_the_plain_stack)."""
    x, w = _t(XS[0]), _t(WS[0])
    batched = torch.func.vmap(torch.matmul)(x[None], w[None])[0]
    assert not torch.equal(batched, x @ w)
    assert torch.equal(batched, torch.bmm(x[None], w[None])[0])
    assert_close(batched, x @ w, "f32_dot")
    # a batch of stages rounds each stage as a batch of one does
    four = torch.func.vmap(torch.matmul)(x[None].expand(4, -1, -1), w[None].expand(4, -1, -1))
    assert all(torch.equal(four[s], batched) for s in range(4))


def _seq_ref(ws, xs, stages, rounds):
    out = []
    for m in range(xs.shape[0]):
        h = xs[m]
        for r in range(rounds):
            for s in range(stages):
                h = np.tanh(h @ ws[s, r])
        out.append(h)
    return np.stack(out)


@pytest.mark.parametrize("stages,rounds,micro", [(4, 1, 8), (4, 2, 8), (2, 3, 6), (8, 4, 16)])
def test_pipeline_matches_reference(stages, rounds, micro):
    ws = (rng.standard_normal((stages, rounds, 8, 8)) * 0.2).astype(np.float32)
    xs = rng.standard_normal((micro, 2, 8)).astype(np.float32)
    got = pipeline(lambda w, x: torch.tanh(x @ w), _t(ws), _t(xs), num_stages=stages,
                   num_rounds=rounds)
    want = jax_pipeline(lambda w, x: jnp.tanh(x @ w), jnp.asarray(ws), jnp.asarray(xs),
                        num_stages=stages, num_rounds=rounds)
    assert_close(got, np.asarray(want), "f32_chain")
    assert_close(got, _seq_ref(ws, xs, stages, rounds), "f32_chain")


def test_pipeline_remat_gradients_match_reference():
    ws = (rng.standard_normal((2, 2, 8, 8)) * 0.2).astype(np.float32)
    xs = rng.standard_normal((4, 2, 8)).astype(np.float32)

    def jloss(w):
        return jnp.sum(jax_pipeline(lambda p, x: jnp.tanh(x @ p), w, jnp.asarray(xs),
                                    num_stages=2, num_rounds=2, remat=True) ** 2)

    want = jax.grad(jloss)(jnp.asarray(ws))
    w = _t(ws).requires_grad_()
    out = pipeline(lambda p, x: torch.tanh(x @ p), w, _t(xs), num_stages=2, num_rounds=2,
                   remat=True)
    (got,) = torch.autograd.grad((out ** 2).sum(), [w])
    assert_close(got, np.asarray(want), "f32_chain")
    assert float(got.abs().sum()) > 0


def test_bubble_ratios_equal_reference():
    for S, Mi in ((8, 64), (8, 16), (4, 4), (2, 6)):
        assert gpipe_bubble_ratio(S, Mi) == jax_gpipe(S, Mi)
        for R in (1, 2, 4):
            assert circular_bubble_ratio(S, Mi, R) == jax_circular(S, Mi, R)
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7) and bubble_fraction(1, 8) == 0.0
    d = PipelineDecision("stage", 4, 4)
    assert d.ticks == pipeline_ticks(4, 4) == 7 and d.bubble == pytest.approx(3 / 7)
    assert d.as_dict() == JPipelineDecision("stage", 4, 4).as_dict()


# ---------------------------------------------------------------------------------
# plan structure: the per-tick ppermute is a first-class, priced step
# ---------------------------------------------------------------------------------


def _programs(S, micro, port_mesh, jax_mesh):
    def fn(wstk, xs):
        wstk = annotate(wstk, mesh_split(4, port_mesh, ["stage", -1, -1, -1]))
        ys = pipelined_apply(layer, wstk, xs, num_stages=S, mesh=port_mesh, stage_axis="stage")
        return (ys ** 2).mean()

    def jfn(wstk, xs):
        wstk = jannotate(wstk, jsplit(4, jax_mesh, ["stage", -1, -1, -1]))
        ys = jax_pipelined_apply(jax_layer, wstk, xs, num_stages=S, mesh=jax_mesh,
                                 stage_axis="stage")
        return jnp.mean(ys ** 2)

    meta = (torch.empty((S, L // S, D, D), device="meta"),
            torch.empty((micro, MB, D), device="meta"))
    closed = jax.make_jaxpr(jfn)(jax.ShapeDtypeStruct((S, L // S, D, D), jnp.float32),
                                 jax.ShapeDtypeStruct((micro, MB, D), jnp.float32))
    return capture(fn, *meta), closed


def _pipelined_plans(S=4, micro=4):
    mesh, jmesh = Mesh.create((S,), ("stage",)), JMesh.create((S,), ("stage",))
    captured, closed = _programs(S, micro, mesh, jmesh)
    plan = lower_plan(captured, None, mesh, optimize=True, profile=RooflineParams(**PROFILE))
    jplan = jax_compile_plan(closed, jax_propagate(closed, jmesh).result(), jmesh,
                             cost_only=True)
    return plan, jplan


def _scan_step(plan):
    (step,) = [s for s in plan.steps if s.op == "scan" and s.inner is not None]
    return step


def test_each_tick_issues_one_ppermute_and_one_psum_priced_as_the_reference():
    plan, jplan = _pipelined_plans(S=4, micro=4)
    scan = _scan_step(plan)
    assert scan.call["trips"] == pipeline_ticks(4, 4)
    (pp,) = [s for s in scan.inner.steps if s.kind == "collective" and s.op == "ppermute"]
    assert pp.axes == ("stage",)
    assert pp.call["perm"] == tuple((i, i + 1) for i in range(3))
    psums = [s for s in scan.inner.steps if s.kind == "collective" and s.op != "ppermute"]
    assert len(psums) == 1 and psums[0].reduce_op == "add"
    # the boundary row: one stage slot of the local state
    assert pp.in_bytes == MB * D * 4
    pbytes, launches = plan_ppermute_bytes(plan)
    assert (pbytes, launches) == jax_plan_ppermute_bytes(jplan)
    assert launches == scan.call["trips"] and pbytes == pytest.approx(launches * pp.in_bytes)
    cost = plan_cost(plan)
    assert cost.wire_bytes >= pbytes and cost.launches >= launches


def test_bubble_shows_up_as_compute_inflation():
    """Every stage computes every tick: modeled per-device FLOPs grow with
    the tick count, (M + S − 1) / M times the useful work.  The tick scan's
    FLOPs grow by 11/7; the whole plan's ratio reads 1.6031 against the
    reference's 1.5984, since the port's ``select`` of a layer's params is a
    view of no FLOPs where the reference's ``slice`` counts its elements
    (ROADMAP, the known divergences of pipelining), so it is held to the
    reference's ratio."""
    (p7, j7), (p11, j11) = _pipelined_plans(S=4, micro=4), _pipelined_plans(S=4, micro=8)
    assert _scan_step(p11).flops / _scan_step(p7).flops == pytest.approx(11 / 7, rel=0.02)
    ratio = plan_cost(p11).flops_per_device / plan_cost(p7).flops_per_device
    jratio = jax_plan_cost(j11).flops_per_device / jax_plan_cost(j7).flops_per_device
    assert jratio == pytest.approx(11 / 7, rel=0.02)
    assert ratio == pytest.approx(jratio, rel=0.02)


def test_same_perm_ppermutes_fuse():
    mesh = Mesh.create((4,), ("stage",))

    def fn(a, b, x, y):
        a = annotate(a, mesh_split(2, mesh, ["stage", -1]))
        b = annotate(b, mesh_split(2, mesh, ["stage", -1]))
        return stage_shift(a, x) + stage_shift(b, y)

    meta = [torch.empty(s, device="meta") for s in ((4, 3), (4, 3), (3,), (3,))]
    plan = lower_plan(capture(fn, *meta), None, mesh, optimize=False)
    plan.params = RooflineParams(**PROFILE)  # the fusion pass's bucket cap
    # the two shifts' boundary rows, then both hops, then their readers
    order = {"annotate": 0, "alias": 0, "shift-boundary": 1, "ppermute": 2}
    plan.steps.sort(key=lambda s: order.get(s.op, 3))
    plan.relive()
    rep = fuse_collectives(plan)
    assert rep.fused_buckets == 1 and rep.fused_members == 2
    (fused,) = [s for s in plan.steps if s.op == "fused-ppermute"]
    assert fused.call["perm"] == tuple((i, i + 1) for i in range(3))


def test_schedule_cost_matches_reference():
    S, micro = 4, 4
    mesh, jmesh = Mesh.create((S,), ("stage",)), JMesh.create((S,), ("stage",))
    captured, closed = _programs(S, micro, mesh, jmesh)
    got = schedule_cost(captured, [None, None], mesh, PipelineDecision("stage", S, micro),
                        profile=RooflineParams(**PROFILE),
                        state=torch.empty((S, MB, D), device="meta"))
    want = jax_schedule_cost(closed, [None, None], jmesh, JPipelineDecision("stage", S, micro),
                             state_shape=(S, MB, D))
    for field in ("bubble", "ppermute_bytes", "ppermute_launches",
                  "microbatch_activation_bytes"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.microbatch_activation_bytes == MB * D * 4 and got.total_s > 0
    assert got.as_dict()["bubble_fraction"] == want.as_dict()["bubble_fraction"]


# ---------------------------------------------------------------------------------
# tests/multidev/test_pipeline_multidev.py on the simulated mesh
# ---------------------------------------------------------------------------------

MD = Mesh.create((4, 2), ("stage", "model"))
MD_RNG = np.random.default_rng(3)
MD_WS = (MD_RNG.standard_normal((L, D, D)) * 0.3).astype(np.float32)
MD_XS = MD_RNG.standard_normal((M, MB, D)).astype(np.float32)


def _md_pipelined(spec):
    def loss(wstk, xs):
        wstk = annotate(wstk, mesh_split(4, MD, spec))
        ys = pipelined_apply(layer, wstk, xs, num_stages=4, mesh=MD, stage_axis="stage")
        return (ys ** 2).mean()

    return loss


def _md_ref(ws, xs):
    return (plain_stack(ws, xs) ** 2).mean()


def _value_and_grad(fn):
    def program(w, x):
        w = w.detach().requires_grad_()
        with torch.enable_grad():
            value = fn(w, x)
            return value, torch.autograd.grad(value, [w])[0]

    return program


def test_pipelined_loss_and_grads_match_unpipelined_on_the_mesh():
    wstk = stage_stack_params(_t(MD_WS), 4)
    vp, gp = spmd_partition(_value_and_grad(_md_pipelined(["stage", -1, -1, -1])), MD,
                            optimize=False, device="cpu")(wstk, _t(MD_XS))
    vr, gr = spmd_partition(_value_and_grad(_md_ref), MD, optimize=False,
                            device="cpu")(_t(MD_WS), _t(MD_XS))
    assert_close(vp, vr, "exact")
    assert_close(gp.reshape(L, D, D), gr, "ulp")


def test_pipelined_plan_runs_one_ppermute_per_tick():
    r = spmd_partition(_md_pipelined(["stage", -1, -1, -1]), MD, optimize=False, device="cpu",
                       process_cache=False)
    assert np.isfinite(float(r(stage_stack_params(_t(MD_WS), 4), _t(MD_XS))))
    (entry,) = r.plans.values()
    scan = _scan_step(entry.plan)
    assert scan.call["trips"] == pipeline_ticks(4, M)
    (pp,) = [s for s in scan.inner.steps if s.kind == "collective" and s.op == "ppermute"]
    assert pp.axes == ("stage",)
    assert r.collectives["collective-permute"] == pipeline_ticks(4, M)
    assert not r.fallback_gathers


def test_dynamic_path_gathers_the_shift_and_agrees():
    """The dynamic path (``compile_plans=False``) has no handler for the
    shift, as the reference's dynamic partitioner has none: it takes the
    fallback, which gathers the stage dim, and gives the compiled plan's
    values."""
    args = (stage_stack_params(_t(MD_WS), 4), _t(MD_XS))
    fn = _md_pipelined(["stage", -1, -1, -1])
    compiled = spmd_partition(fn, MD, optimize=False, device="cpu")(*args)
    dynamic = spmd_partition(fn, MD, compile_plans=False, device="cpu")
    assert_close(dynamic(*args), compiled, "exact")
    assert dynamic.fallback_gathers == ["repro_torch.stage_shift"]


def test_pipeline_plus_tensor_parallelism_matches_reference():
    """Stage dim over "stage", the layer's feature dim over "model": one
    partition plan, both kinds of parallelism."""
    got = spmd_partition(_md_pipelined(["stage", -1, -1, "model"]), MD, optimize=False,
                         device="cpu")(stage_stack_params(_t(MD_WS), 4), _t(MD_XS))

    def jref(ws, xs):
        def f(h):
            for i in range(ws.shape[0]):
                h = jnp.tanh(h @ ws[i])
            return h

        return jnp.mean(jnp.stack([f(xs[m]) for m in range(xs.shape[0])]) ** 2)

    assert_close(got, np.asarray(jref(jnp.asarray(MD_WS), jnp.asarray(MD_XS))), "f32_dot")


# ---------------------------------------------------------------------------------
# registry configs: pipelined_loss_fn
# ---------------------------------------------------------------------------------

MODEL_MESH = Mesh.create((2, 2), ("stage", "model"))
MODEL_FIELDS = {"qwen1.5-0.5b": dict(), "mamba2-130m": dict(d_model=128)}


def _model(arch):
    over = dict(num_layers=4, dtype="float32", remat="none", scan_layers=False,
                **MODEL_FIELDS[arch])
    jcfg = jax_reduced_config(jax_registry.get_config(arch), 8).with_(**over)
    cfg = registry.reduced_config(registry.get_config(arch), 8).with_(**over)
    jst, st = jax_get_strategy("2d_finalized"), get_strategy("2d_finalized")
    decls = jax_api.param_tree(jcfg, jst)
    jp = jax.jit(lambda key: jax_layers.tree_init(decls, key))(jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.array, jp)
    if cfg.family == "ssm":  # the float32 leaves away from their zeros and ones
        g = np.random.default_rng(11)
        mix = np_tree["layers"]["mixer"]
        for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.3), ("norm", 0.2)):
            mix[name] += scale * g.standard_normal(mix[name].shape).astype(np.float32)
        for a in (np_tree["layers"]["ln"], np_tree["final_ln"]):
            a += 0.1 * g.standard_normal(a.shape).astype(np.float32)
        jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 33))
    return jcfg, jst, jp, np_tree, cfg, st, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def _rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _hold_grad(got, want, cfg):
    """A gradient leaf within f32_chain: per element for qwen; in norm for
    Mamba2, whose random-weight gradient is ill-conditioned
    (tests/test_torch_ssm_train.py): a reordered sum moves its elements
    near 0 past the per-element class."""
    if cfg.family == "dense":
        assert_close(got, want, "f32_chain")
    else:
        assert _rel_norm(got, want) <= TOLERANCES["f32_chain"][0]


def _grads_of(fn, params, batch):
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        value = fn(live, batch)
        return value, torch.autograd.grad(value, leaves(live))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_pipelined_loss_fn_matches_reference_and_partitions(arch):
    jcfg, jst, jp, np_tree, cfg, st, tok = _model(arch)
    jbatch = {k: jnp.asarray(v) for k, v in tok.items()}
    batch = {k: torch.tensor(v) for k, v in tok.items()}
    jparams = {**jp, "layers": jax_stage_stack_params(jp["layers"], 2)}
    want, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_pipelined_loss_fn(
        jcfg, jst, p, jbatch, JPipelineDecision("stage", 2, 2))))(jparams)
    params = params_from_numpy(np_tree, cfg, "cpu")
    params = {**params, "layers": stage_stack_params(params["layers"], 2)}
    dec = PipelineDecision("stage", 2, 2)
    got, grads = _grads_of(lambda p, b: pipelined_loss_fn(cfg, st, p, b, dec), params, batch)
    assert_close(got, np.asarray(want), "f32_chain")
    for g, w in zip(grads, jax.tree_util.tree_leaves(jgrads)):
        _hold_grad(g, np.asarray(w), cfg)
    # the same program through the partitioner on the ("stage" 2, "model" 2)
    # mesh, against it run unpartitioned (the vocabulary padded to "model")
    emb = np_tree["embed"]["embedding"]
    with set_mesh(MODEL_MESH):
        V = padded_vocab(cfg, st)
        padded = params_from_numpy(
            {**np_tree, "embed": {"embedding": np.pad(emb, ((0, V - emb.shape[0]), (0, 0)))}},
            cfg, "cpu", st)
    padded = {**padded, "layers": stage_stack_params(padded["layers"], 2)}
    # the batch on "stage" outside the pipelined region, as on the card
    program = api.partitionable_pipelined_loss(cfg, st, MODEL_MESH, dec)

    def vg(p, b):
        return _grads_of(program, p, b)

    runner = spmd_partition(vg, MODEL_MESH, optimize=False, device="cpu")
    with set_mesh(MODEL_MESH):
        sharded = runner(padded, batch)
        whole = vg(padded, batch)
    assert not runner.fallback_gathers
    # over "stage" each tick body runs the hop and the row sum's psum, and no
    # reshard gathers the stage dim
    (entry,) = runner.plans.values()
    ticks = [s.inner for s in entry.plan.steps if s.op == "scan"
             and any(t.op == "ppermute" for t in s.inner.steps)]
    assert len(ticks) == 2
    for body in ticks:
        assert sorted(s.op for s in body.steps if "stage" in s.axes) == ["all-reduce", "ppermute"]
        assert not [c for s in body.steps if s.kind == "reshard" for c in s.program.steps
                    if c.axis == "stage" and c.op != "dynamic_slice"]
    assert_close(sharded[0], whole[0], "f32_chain")
    for a, b in zip(sharded[1], whole[1]):
        _hold_grad(a, b, cfg)


def test_a_stage_folded_batch_splits_back_without_a_gather():
    """A reshape that splits a stage-sharded batch back into (stage, batch)
    reshapes each shard and then slices what the target adds ("model" on
    the last dim), where it gathered the whole tensor and sliced it again."""

    def f(x):
        x = annotate(x, mesh_split(3, MODEL_MESH, ["stage", -1, -1]))
        y = x.reshape(2, 4, 6, 8)
        return annotate(y, mesh_split(4, MODEL_MESH, ["stage", -1, -1, "model"]))

    x = torch.tensor(rng.standard_normal((8, 6, 8)).astype(np.float32))
    runner = spmd_partition(f, MODEL_MESH, optimize=False, device="cpu")
    assert_close(runner(x), x.reshape(2, 4, 6, 8), "exact")
    assert runner.collectives == {}
    (entry,) = runner.plans.values()
    assert [s.op for s in entry.plan.steps if s.kind == "reshard"] == ["reshard"]
    (rs,) = [s for s in entry.plan.steps if s.kind == "reshard"]
    assert [c.op for c in rs.program.steps] == ["dynamic_slice"]


def test_stage_batch_puts_the_batch_on_the_stage_axis_outside_the_region():
    """The pipelined loss gives the prologue and epilogue ``stage_batch``'s
    strategy and the stage body the plain one: the embedding is annotated
    with its batch on "stage", and no activation inside the tick scan
    names "stage" but on its leading stage dim."""
    st = get_strategy("2d_finalized")
    with set_mesh(MODEL_MESH):
        assert stage_batch(st, "stage").a("batch", "seq", "embed") == ("stage", None, "model")
        assert st.a("batch", "seq", "embed") == (None, None, "model")
    assert st.act_rules["batch"] == ("pod", "data")
    cfg = registry.reduced_config(registry.get_config("qwen1.5-0.5b"), 8).with_(num_layers=2)
    dec = PipelineDecision("stage", 2, 2)
    with set_mesh(MODEL_MESH):
        decls = api.param_tree(cfg, st)
    params = tree_map_params(lambda p, _path: torch.empty(p["shape"], device="meta"), decls)
    params = {**params, "layers": stage_stack_params(params["layers"], 2)}
    batch = {k: torch.zeros((4, 16), dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    program = api.partitionable_pipelined_loss(cfg, st, MODEL_MESH, dec)
    graph = capture(program, params, batch).gm.graph

    def stage_dims(g):
        for n in g.nodes:
            if n.target is ANNOTATE_OP:
                sh, _ = decode(*n.args[1:])
                yield from (i for i, axes in enumerate(sh.dims_mapping) if "stage" in axes)

    assert 0 in set(stage_dims(graph))  # the embedding's batch
    bodies = [body_of(n.args[0]).captured.gm.graph for n in graph.nodes
              if n.op == "call_function" and n.target in SCAN_OPS]
    assert bodies and all(set(stage_dims(b)) <= {0} for b in bodies)


def test_pipeline_boundary_exists_where_the_reference_has_one():
    for name in jax_registry.arch_ids():
        jcfg, cfg = jax_registry.get_config(name), registry.get_config(name)
        jst = jax_get_strategy("2d_finalized")
        want = jax_api.pipeline_boundary(jcfg, jst) is None
        assert (api.pipeline_boundary(cfg, get_strategy("2d_finalized")) is None) == want, name


# ---------------------------------------------------------------------------------
# the vmap rules
# ---------------------------------------------------------------------------------


def _stage_inputs(n=3, B=2, S=32, KR=2, Gl=2, Dh=16):
    g = np.random.default_rng(5)
    q = _t(g.standard_normal((n, B, S, KR, Gl, Dh)).astype(np.float32))
    k = _t(g.standard_normal((n, B, S, KR, Dh)).astype(np.float32))
    v = _t(g.standard_normal((n, B, S, KR, Dh)).astype(np.float32))
    return q, k, v


def test_flash_operators_vmap_as_one_call_per_stage_batch():
    q, k, v = _stage_inputs()
    out = torch.func.vmap(lambda a, b, c: ops.flash_attention_op(a, b, c, True, 0, None, 16))(
        q, k, v)
    o2, lse = torch.func.vmap(lambda a, b, c: ops.flash_attention_fwd_op(a, b, c, True, 16))(
        q, k, v)
    dout = torch.randn_like(o2)
    grads = torch.func.vmap(lambda *t: ops.flash_attention_bwd_op(*t, True))(
        q, k, v, o2, lse, dout)
    for s in range(q.shape[0]):
        want = chunked_attention_ref(q[s], k[s], v[s], causal=True, chunk=16)
        assert_close(out[s], want, "f32_dot")
        assert_close(o2[s], want, "f32_dot")
        for g, w in zip(grads, flash_attention_bwd_ref(q[s], k[s], v[s], o2[s], lse[s],
                                                       dout[s], causal=True)):
            assert_close(g[s], w, "f32_dot")


@pytest.mark.parametrize("a_per_row", [False, True])
def test_ssd_operators_vmap_as_one_call_per_stage_batch(a_per_row):
    g = np.random.default_rng(6)
    n, B, S, H, hd, ds = 3, 2, 32, 4, 8, 16
    x = _t(g.standard_normal((n, B, S, H, hd)).astype(np.float32))
    dt = _t(np.abs(g.standard_normal((n, B, S, H))).astype(np.float32) * 0.1)
    Bm = _t(g.standard_normal((n, B, S, ds)).astype(np.float32))
    Cm = _t(g.standard_normal((n, B, S, ds)).astype(np.float32))
    A = _t(-np.abs(g.standard_normal((n, B, H) if a_per_row else (n, H))).astype(np.float32))
    dy = _t(g.standard_normal((n, B, S, H, hd)).astype(np.float32))
    y = torch.func.vmap(lambda *t: ops.ssd_scan_op(*t, 16))(x, dt, Bm, Cm, A)
    grads = torch.func.vmap(lambda *t: ops.ssd_scan_bwd_op(*t, 16))(x, dt, Bm, Cm, A, dy)
    assert tuple(grads[4].shape) == tuple(A.shape)
    for s in range(n):
        assert_close(y[s], ssd_scan_ref(x[s], dt[s], Bm[s], Cm[s], A[s], 16), "f32_dot")
        for got, want in zip(grads, ssd_scan_bwd_ref(x[s], dt[s], Bm[s], Cm[s], A[s], dy[s],
                                                     16)):
            assert_close(got[s], want, "f32_dot")


def test_vmapped_annotation_leaves_the_stage_dim_to_completion():
    mesh = Mesh.create((2, 2), ("stage", "model"))

    def fn(x):
        x = annotate(x, mesh_split(3, mesh, ["stage", -1, -1]))
        y = torch.func.vmap(lambda h: annotate(h * 2.0, mesh_split(2, mesh, [-1, "model"])))(x)
        return y + 1.0

    cap = capture(fn, torch.empty((4, 3, 8), device="meta"))
    (node,) = [n for n in cap.graph.nodes if n.op == "call_function"
               and n.target is torch.ops.repro_torch.annotate.default
               and n.args[4].startswith("3:|")]
    assert list(node.args[5]) == [0]  # the inserted dim, unspecified
    done = propagate(cap, mesh).result().get(node)
    assert done.dims_mapping == (("stage",), (), ("model",))
