"""The dense LM's training step partitioned by the port's own partitioner on a
simulated ("data" 2, "model" 4) mesh, against the JAX package unsharded.

* under ``set_mesh``, the loss and gradients of ``sharded_value_and_grad``
  (the step's program: params annotated by their specs, the batch on
  "data", the gradient taken inside the program, attention through the
  flash operator pair) run by ``spmd_partition(..., optimize=False)`` under
  2d_attempt1, 2d_attempt2 and 2d_finalized, in float32 and bf16, against
  ``jax.value_and_grad`` of the reference's ``api.loss_fn``;
* the padded-GQA layout (6 heads, 2 kv heads: G 3, r 2, Gp 4);
* one Adafactor step of ``TrainLoop`` under the mesh against the
  reference's ``make_train_step``;
* ``tree_specs``, the padded vocab and ``opt_state_specs`` under the mesh
  against the reference's under an ``AbstractMesh``;
* the flash operators' plain backward against autograd through the plain
  forward, and what stays as it was with no mesh.

The config is ``tests/multidev/test_numeric_parity.py``'s ``CFG`` with
remat "none" and the layer loop unrolled.  Weights come from the reference's
``tree_init`` through numpy.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_strategy as jax_get_strategy
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.train.loop import NumericFaultSpec as JaxNumericFaultSpec
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro.train.optimizer import opt_state_specs as jax_opt_state_specs
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.core.compat import TOLERANCES, assert_close, capture, get_abstract_mesh, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.ref import chunked_attention_ref
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api, layers
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.loop import (NumericFaultSpec, TrainConfig, TrainLoop, make_train_step,
                                    sharded_value_and_grad, value_and_grad)
from repro_torch.train.optimizer import get_optimizer, opt_state_specs

MESH = make_test_mesh()
STRATEGIES = ["2d_attempt1", "2d_attempt2", "2d_finalized"]
CFG_FIELDS = dict(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64, attn_chunk=16, remat="none",
                  qkv_bias=True, scan_layers=False)
PADDED = dict(num_heads=6, num_kv_heads=2, head_dim=8)  # G 3, r 2 -> Gp 4
# rope's halves: slice and cat along the head dim; where the heads do not
# divide "model", wq and wk shard that dim (attn_params' fallback), and the
# halves gather it, as the reference's layout does
ROPE = {"aten.slice", "aten.cat"}


def _cfgs(dtype, **over):
    return (JaxModelConfig(**CFG_FIELDS).with_(dtype=dtype, **over),
            ModelConfig(**CFG_FIELDS).with_(dtype=dtype, **over))


def _inputs(strategy, dtype, seed=0, **over):
    jcfg, cfg = _cfgs(dtype, **over)
    jst, st = jax_get_strategy(strategy), get_strategy(strategy)
    jparams = jax_layers.tree_init(jax_api.param_tree(jcfg, jst), jax.random.PRNGKey(seed))
    np_tree = jax.tree_util.tree_map(np.array, jparams)
    rng = np.random.default_rng(seed)
    for a in (np_tree["layers"]["attn"]["bq"], np_tree["layers"]["attn"]["bk"],
              np_tree["layers"]["attn"]["bv"], np_tree["layers"]["ln1"]):
        a += 0.1 * rng.standard_normal(a.shape).astype(np.float32)  # no zero bias or unit scale
    tok = rng.integers(0, cfg.vocab_size, (8, 17))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    params = params_from_numpy(np_tree, cfg, "cpu", st, dtype="float32")
    return jcfg, cfg, jst, st, np_tree, params, batch


def _torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _jax_value_and_grad(jcfg, jst, np_tree, batch):
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    return jax.value_and_grad(lambda p: jax_api.loss_fn(jcfg, jst, p, jb))(jparams)


def _partitioned(cfg, st, params, batch, **kw):
    with set_mesh(MESH):
        runner = spmd_partition(sharded_value_and_grad(cfg, st, MESH), MESH, optimize=False,
                                device="cpu", **kw)
        loss, grads = runner(tree_map(torch.Tensor.detach, params), _torch_batch(batch))
    return runner, loss, grads


def _rel_norm(got, want) -> float:
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flash_steps(runner):
    (entry,) = runner.plans.values()
    return collections.Counter(s.op for s in entry.plan.steps if s.op.startswith("repro_torch"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partitioned_loss_and_grads_match_reference(strategy, dtype):
    """The partitioned loss within f32_chain (bf16: bf16_chain) of the
    reference's unsharded loss; float32 gradients within f32_chain per
    element, bf16 gradients per leaf in norm within bf16_grad (measured: at
    most 3.4e-2, where the port's unsharded eager gradients are 2.0e-2 off
    the reference's); in float32 also against the port's own unsharded
    gradients, ULP-close (R4): per leaf in norm within ulp's rtol and per
    element within f32_dot.  No fallback gathers; each layer's attention is
    one flash forward and one backward step of the plan."""
    jcfg, cfg, jst, st, np_tree, params, batch = _inputs(strategy, dtype)
    runner, loss, grads = _partitioned(cfg, st, params, batch)
    assert runner.fallback_gathers == []
    assert set(runner.fallbacks) <= ROPE
    assert _flash_steps(runner) == {"repro_torch.flash_attention_fwd": 2,
                                    "repro_torch.flash_attention_bwd": 2}
    jloss, jgrads = _jax_value_and_grad(jcfg, jst, np_tree, batch)
    assert_close(loss, np.asarray(jloss), "f32_chain" if dtype == "float32" else "bf16_chain")
    for (path, g), w in zip(leaves_with_paths(grads), jax.tree_util.tree_leaves(jgrads)):
        assert g.dtype == torch.float32
        if dtype == "float32":
            assert_close(g, np.asarray(w), "f32_chain", err_msg=f"grad {path}")
        else:
            rel = _rel_norm(g, w)
            assert rel <= TOLERANCES["bf16_grad"][0], f"grad {path}: {rel}"
    if dtype == "float32":
        loss0, grads0 = value_and_grad(cfg, st, tree_map(lambda p: p.requires_grad_(), params),
                                       _torch_batch(batch))
        assert_close(loss, loss0, "f32_dot")
        for (path, g), g0 in zip(leaves_with_paths(grads), leaves(grads0)):
            assert _rel_norm(g, g0.detach().numpy()) <= TOLERANCES["ulp"][0], path
            assert_close(g, g0, "f32_dot", err_msg=f"grad {path}")


def test_a_dropped_psum_over_data_fails_the_bf16_limits():
    """Planted faults, one at a time: each standalone psum over "data" in the
    bf16 gradient program's plan (2d_finalized) replaced by the local
    value.  Every one puts the loss outside bf16_chain or a gradient leaf
    outside bf16_grad against the reference (the sound reading stays
    within both), so those limits would fail such a partitioning fault."""
    from repro_torch.core import plan as plan_mod

    jcfg, cfg, jst, st, np_tree, params, batch = _inputs("2d_finalized", "bfloat16")
    runner, loss, grads = _partitioned(cfg, st, params, batch)
    jloss, jgrads = _jax_value_and_grad(jcfg, jst, np_tree, batch)
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(jgrads)]
    (entry,) = runner.plans.values()

    def worst(loss, grads):
        rtol, atol = TOLERANCES["bf16_chain"]
        over = abs(loss.item() - float(jloss)) / (atol + rtol * abs(float(jloss)))
        return max(over, max(_rel_norm(g, w) for g, w in zip(leaves(grads), want))
                   / TOLERANCES["bf16_grad"][0])

    sound = worst(loss, grads)
    assert sound <= 1.0
    psums = [s for s in entry.plan.steps
             if s.kind == "collective" and "data" in s.axes and s.reduce_op == "add"]
    assert len(psums) > 10
    tb = _torch_batch(batch)
    faults = []
    for step in psums:
        run, step.run = step.run, plan_mod._alias_run
        try:
            faults.append(worst(*runner(tree_map(torch.Tensor.detach, params), tb)))
        finally:
            step.run = run
        assert faults[-1] > 1.0, f"dropping {step.reads} -> {step.writes} went unseen"
    print(f"sound {sound:.3f} x the limits; {len(faults)} dropped psums, the least seen at "
          f"{min(faults):.3f} x, the most at {max(faults):.3f} x")


def test_padded_gqa_matches_reference():
    """6 heads on 2 kv heads under 2d_finalized: "model" (4) outnumbers the kv
    heads, so each is broadcast twice and each group of 3 q heads padded to
    4; loss and gradients against the reference's unpadded layout."""
    jcfg, cfg, jst, st, np_tree, params, batch = _inputs("2d_finalized", "float32", seed=1,
                                                         **PADDED)
    with set_mesh(MESH):
        from repro_torch.models.attention import head_layout

        assert head_layout(cfg, st) == (2, 3, 2, 4, 4)
    runner, loss, grads = _partitioned(cfg, st, params, batch)
    assert set(runner.fallback_gathers) <= ROPE
    assert set(runner.fallbacks) <= ROPE | {"aten.constant_pad_nd"}  # the pad keeps its sharding
    jloss, jgrads = _jax_value_and_grad(jcfg, jst, np_tree, batch)
    assert_close(loss, np.asarray(jloss), "f32_chain")
    for (path, g), w in zip(leaves_with_paths(grads), jax.tree_util.tree_leaves(jgrads)):
        assert_close(g, np.asarray(w), "f32_chain", err_msg=f"grad {path}")


def test_compiled_step_equals_the_dynamic_path():
    """The same program by compiled plan and by the dynamic path, bit for
    bit, with the same collectives."""
    _, cfg, _, st, _, params, batch = _inputs("2d_attempt2", "float32", seed=2)
    compiled, loss, grads = _partitioned(cfg, st, params, batch)
    dynamic, loss_d, grads_d = _partitioned(cfg, st, params, batch, compile_plans=False)
    assert_close(loss, loss_d, "exact")
    for (path, g), gd in zip(leaves_with_paths(grads), leaves(grads_d)):
        assert_close(g, gd, "exact", err_msg=str(path))
    assert dynamic.collectives == compiled.collectives and dynamic.fallback_gathers == []


def _jax_state(jcfg, jst, jopt, np_tree):
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return {"params": jparams, "opt": jopt.init(jparams), "step": jnp.asarray(0, jnp.int32)}


def test_adafactor_step_under_the_mesh_matches_reference():
    """``TrainLoop`` under ``set_mesh`` (the partitioned step) for one step of
    the arithmetic pattern against the reference's ``make_train_step``
    unsharded: loss, grad norm, params and Adafactor state in float32."""
    jcfg, cfg, jst, st, np_tree, params, _ = _inputs("2d_finalized", "float32", seed=3)
    jopt, opt = jax_get_optimizer("adafactor", lr=0.05), get_optimizer("adafactor", lr=0.05)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=4, pattern="arithmetic"))
    jb = {k: jnp.asarray(v) for k, v in pipe.batch_at(0).items()}
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jst, jopt, JaxTrainConfig()))(
        _jax_state(jcfg, jst, jopt, np_tree), jb)
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    losses = []
    with set_mesh(MESH):
        loop = TrainLoop(cfg, st, opt, TrainConfig(steps=1), pipe, device="cpu",
                         hooks={"metrics": lambda step, loss: losses.append(loss)})
        state, got = loop.run(initial_state=state)
    assert loop.step_fn.runner.fallback_gathers == []
    assert_close(np.float32(got[0]), np.asarray(jm["loss"]), "f32_chain")
    assert state["step"] == 1
    for (path, p), w in zip(leaves_with_paths(state["params"]),
                            jax.tree_util.tree_leaves(jstate["params"])):
        assert_close(p, np.asarray(w), "f32_chain", err_msg=f"param {path}")
    for (path, s), w in zip(leaves_with_paths(state["opt"]),
                            jax.tree_util.tree_leaves(jstate["opt"])):
        assert_close(s, np.asarray(w), "f32_chain", err_msg=f"state {path}")


OPTIONS = {"compress_grads": ({"compress_grads": True}, {"compress_grads": True}),
           "numeric_fault": ({"numeric_fault": JaxNumericFaultSpec(nan_at_step=2,
                                                                    grad_spike_at_step=1)},
                             {"numeric_fault": NumericFaultSpec(nan_at_step=2,
                                                                grad_spike_at_step=1)})}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_step_options_under_the_mesh_match_reference(option):
    """Three Adafactor steps of the partitioned step with ``compress_grads``
    or the numeric-fault window (a gradient spike at step 1, NaN at step 2)
    against the reference's ``make_train_step`` unsharded, from the same
    weights and batches: losses and grad norms within f32_chain; with
    compression the params and error feedback within coarse (bf16 rounding
    is discontinuous, as in ``tests/test_torch_train.py``), under the fault
    window the params within f32_chain until NaN reaches both, and every
    param NaN after it."""
    jkw, kw = OPTIONS[option]
    jcfg, cfg, jst, st, np_tree, params, _ = _inputs("2d_finalized", "float32", seed=3)
    jopt, opt = jax_get_optimizer("adafactor", lr=0.05), get_optimizer("adafactor", lr=0.05)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=4, pattern="arithmetic"))
    jstep = jax.jit(jax_make_train_step(jcfg, jst, jopt, JaxTrainConfig(**jkw)))
    jstate = _jax_state(jcfg, jst, jopt, np_tree)
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    if option == "compress_grads":
        jstate["ef"] = jax.tree_util.tree_map(jnp.zeros_like, jstate["params"])
        state["ef"] = tree_map(torch.zeros_like, params)
    with set_mesh(MESH):
        step = make_train_step(cfg, st, opt, TrainConfig(**kw))
    for i in range(3):
        b = pipe.batch_at(i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, {k: torch.from_numpy(v).long() for k, v in b.items()})
        if option == "numeric_fault" and i == 2:
            assert bool(torch.isnan(m["loss"])) and bool(np.isnan(jm["loss"]))
            assert all(bool(torch.isnan(p).all()) for p in leaves(state["params"]))
            assert all(np.isnan(np.asarray(w)).all()
                       for w in jax.tree_util.tree_leaves(jstate["params"]))
            continue
        assert_close(m["loss"], np.asarray(jm["loss"]), "f32_chain", err_msg=f"step {i}")
        assert_close(m["grad_norm"], np.asarray(jm["grad_norm"]), "f32_chain",
                     err_msg=f"step {i}")
        kind = "coarse" if option == "compress_grads" else "f32_chain"
        parts = ("params", "ef") if option == "compress_grads" else ("params",)
        for part in parts:
            for (path, a), w in zip(leaves_with_paths(state[part]),
                                    jax.tree_util.tree_leaves(jstate[part])):
                assert_close(a, np.asarray(w), kind, err_msg=f"step {i} {part} {path}")
    stats = step.runner.cache_stats
    assert (stats.misses, stats.hits) == (1, 2) and step.runner.fallback_gathers == []


def test_train_loop_under_the_mesh_matches_the_unsharded_loop():
    """Three steps of ``TrainLoop`` in bf16 with float32 masters and
    Adafactor, under the mesh and without, from the same weights: the loss
    curves within loss_curve, and the step function's input signature keeps
    one plan (a hit on every call after the first)."""
    _, cfg, _, st, _, params, _ = _inputs("2d_attempt1", "bfloat16", seed=5)
    opt = get_optimizer("adafactor", lr=1e-2)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 8, seed=6, pattern="arithmetic"))
    curves, loops = [], []
    for mesh in (MESH, None):
        state = {"params": tree_map(lambda p: p.clone().requires_grad_(True), params),
                 "step": 0}
        state["opt"] = opt.init(state["params"])
        with set_mesh(mesh):
            loop = TrainLoop(cfg, st, opt, TrainConfig(steps=3), pipe, device="cpu")
            curves.append(loop.run(initial_state=state)[1])
        loops.append(loop)
    assert_close(np.array(curves[0]), np.array(curves[1]), "loss_curve")
    stats = loops[0].step_fn.runner.cache_stats
    assert (stats.misses, stats.hits) == (1, 2)


@pytest.mark.parametrize("kw,item", [({"remat": "dots"}, "remat"),
                                     ({"grad_accum": 2}, "grad_accum"),
                                     ({"compress_grads": True}, "compress_grads")])
def test_the_partitioned_step_refuses_what_it_does_not_cover(kw, item):
    """Every setting the partitioned step once refused now builds it: remat
    and compress_grads (tests/test_torch_sharded_options.py runs them) and,
    since the scan node, grad_accum > 1 (its microbatch loop a scan:
    tests/test_torch_scan.py runs it against the reference)."""
    cfg_kw = {k: v for k, v in kw.items() if k == "remat"}
    tc_kw = {k: v for k, v in kw.items() if k != "remat"}
    cfg = ModelConfig(**CFG_FIELDS).with_(**cfg_kw)
    make = lambda: make_train_step(cfg, get_strategy("2d_finalized"),
                                   get_optimizer("adafactor"), TrainConfig(**tc_kw))
    with set_mesh(MESH):
        assert make().runner is None, item  # built; it captures at its first call


def _trim(spec):
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("opt_name", ["adafactor", "adamw", "sgd"])
def test_specs_under_the_mesh_match_reference(opt_name):
    """``tree_specs``, the padded vocab, the head layout and
    ``opt_state_specs`` under the mesh against the reference's under a
    device-free ``AbstractMesh`` of the same axes, on the padded-GQA config
    with a vocab of 62 (padded to 64 on "model")."""
    from repro.models.attention import head_layout as jax_head_layout
    from repro_torch.models.attention import head_layout

    over = dict(PADDED, vocab_size=62)
    jcfg, cfg = _cfgs("float32", **over)
    jst, st = jax_get_strategy("2d_finalized"), get_strategy("2d_finalized")
    kw = {"momentum": 0.9} if opt_name == "sgd" else {}
    jopt, opt = jax_get_optimizer(opt_name, **kw), get_optimizer(opt_name, **kw)
    with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh((2, 4), ("data", "model"))):
        jtree = jax_api.param_tree(jcfg, jst)
        want = (jax_layers.padded_vocab(jcfg, jst), jax_head_layout(jcfg, jst),
                jax_layers.tree_specs(jtree),
                jax_opt_state_specs(jopt, jax_layers.tree_specs(jtree),
                                    jax_layers.tree_shapes(jtree)))
    with set_mesh(MESH):
        tree = api.param_tree(cfg, st)
        got = (layers.padded_vocab(cfg, st), head_layout(cfg, st), layers.tree_specs(tree),
               opt_state_specs(opt, layers.tree_specs(tree),
                               layers.tree_shapes(tree, cfg.param_dtype)))
    assert got[0] == want[0] == 64 and got[1] == tuple(want[1])
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
    for g, w in zip(got[2:], want[2:]):
        wl = jax.tree_util.tree_leaves_with_path(w, is_leaf=is_spec)
        gl = leaves_with_paths(g)
        assert [tuple(k.key for k in p) for p, _ in wl] == [p for p, _ in gl]
        assert [_trim(s) for _, s in wl] == [_trim(s) for _, s in gl]
    meta = leaves(layers.tree_shapes(tree, "float32"))
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in meta)


def test_flash_operator_backward_matches_autograd_through_the_plain_forward():
    """``flash_attention_fwd``'s registered gradient (the operator
    ``flash_attention_bwd``, plain on the CPU) against autograd through
    ``chunked_attention_ref``, GQA with causal and full masks."""
    rng = np.random.default_rng(8)
    for causal in (True, False):
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       for s in ((2, 24, 2, 3, 32), (2, 24, 2, 32), (2, 24, 2, 32),
                                 (2, 24, 2, 3, 32)))
        leaves_a = [t.clone().requires_grad_() for t in (q, k, v)]
        out, lse = ops.flash_attention_fwd_op(*leaves_a, causal, 8)
        got = torch.autograd.grad(out, leaves_a, do)
        leaves_b = [t.clone().requires_grad_() for t in (q, k, v)]
        want_out = chunked_attention_ref(*leaves_b, causal=causal, chunk=8)
        want = torch.autograd.grad(want_out, leaves_b, do)
        assert_close(out, want_out, "exact")
        assert lse.shape == (2, 2, 24 * 3) and lse.dtype == torch.float32
        for g, w in zip(got, want):
            assert_close(g, w, "f32_chain")


def test_no_mesh_leaves_strategy_attention_and_capture_as_they_were():
    """With no mesh: ``constrain`` returns its input, ``axis_size`` is 1,
    specs are unfiltered, the captured loss holds no annotation and its
    attention is the no-gradient operator; under the mesh the same capture
    is annotated (and broadcasts the 2 kv heads to the 4-wide "model"
    axis), and a differentiable attention is the operator pair."""
    _, cfg, _, st, _, params, batch = _inputs("2d_finalized", "float32", seed=9)
    assert get_abstract_mesh() is None
    x = torch.ones(4, 8, 32)
    assert st.constrain(x, "batch", "seq", "embed") is x
    assert st.axis_size("kv") == 1 and st.a("batch") == (("pod", "data"),)
    tb = _torch_batch(batch)
    flat = tree_map(torch.Tensor.detach, params)

    def ops_of(fn, *args):
        return collections.Counter(str(getattr(n.target, "_overloadpacket", n.target))
                                   for n in capture(fn, *args).graph.nodes
                                   if n.op == "call_function")

    loss = lambda p, b: api.loss_fn(cfg, st, p, b)
    plain = ops_of(loss, flat, tb)
    assert plain["repro_torch.annotate"] == 0 and plain["repro_torch.flash_attention"] == 2
    with set_mesh(MESH):
        assert st.axis_size("kv") == 4 and st.a("batch") == ("data",)
        assert st.constrain(x, "batch", "seq", "embed") is not x
        annotated = ops_of(loss, flat, tb)
        grads = ops_of(sharded_value_and_grad(cfg, st, MESH), flat, tb)
    assert annotated["repro_torch.annotate"] > 0
    assert grads["repro_torch.flash_attention_fwd"] == grads["repro_torch.flash_attention_bwd"] == 2
    assert grads["repro_torch.flash_attention"] == 0
    assert get_abstract_mesh() is None


def test_the_gradient_program_prices_on_meta_tensors():
    """Cost-only lowering of the step's gradient program on meta tensors
    (``tree_shapes``): no device; the flash operator pair is counted in the
    graph's flops (the backward at 2.5 times the forward) and in each plan
    step's, at the local shape (batch on "data", kv heads on "model")."""
    from repro_torch.analysis.graph_cost import count_flops, eqn_flops, flash_flops
    from repro_torch.core.plan import lower_plan, plan_cost
    from repro_torch.core.rules import lower

    _, cfg, _, st, _, _, _ = _inputs("2d_finalized", "float32")
    cfg = cfg.with_(num_kv_heads=4)
    with set_mesh(MESH):
        params = layers.tree_shapes(api.param_tree(cfg, st), "float32")
        batch = {k: torch.empty((8, 32), dtype=torch.long, device="meta")
                 for k in ("tokens", "labels")}
        cap = capture(sharded_value_and_grad(cfg, st, MESH), params, batch)
    plan = lower_plan(cap, None, MESH, optimize=False)
    fwd = flash_flops(8, 32, 4, 32, 8, True)
    flash = [eqn_flops(lower(n)) for n in cap.graph.nodes
             if n.op == "call_function" and "flash_attention" in str(n.target)]
    assert sorted(flash) == [fwd, fwd, 2.5 * fwd, 2.5 * fwd]
    assert count_flops(cap.graph) > sum(flash)
    steps = [s for s in plan.steps if s.op.startswith("repro_torch.flash_attention")]
    assert sorted(s.op for s in steps) == ["repro_torch.flash_attention_bwd"] * 2 + [
        "repro_torch.flash_attention_fwd"] * 2
    local = flash_flops(4, 32, 1, 32, 8, True)  # B 8 / 2 on "data", 4 kv heads / 4 on "model"
    assert sorted(s.flops for s in steps) == [local] * 2 + [2.5 * local] * 2
    assert plan_cost(plan).flops_per_device > 0 and plan.fallback_gathers == []


def _index_programs():
    from repro_torch.core import annotate, mesh_split

    def sp(rank, dims):
        return mesh_split(rank, MESH, dims)

    def embedding(table, idx, w):
        t = annotate(table, sp(2, ["model", -1]))
        return torch.nn.functional.embedding(annotate(idx, sp(2, ["data", -1])), t) * w

    def embedding_grad(table, idx, w):
        t = annotate(table, sp(2, ["model", -1])).detach().requires_grad_()
        with torch.enable_grad():
            out = torch.nn.functional.embedding(annotate(idx, sp(2, ["data", -1])), t)
            return torch.autograd.grad((out * w).sum(), t)[0]

    def gather_logsumexp(x, idx, w):
        x = annotate(x, sp(3, ["data", -1, "model"]))
        picked = x.gather(-1, idx)[..., 0]
        return torch.logsumexp(x, dim=-1) - picked

    def gather_grad(x, idx, w):
        x = annotate(x, sp(3, ["data", -1, "model"])).detach().requires_grad_()
        with torch.enable_grad():
            picked = x.gather(-1, idx)[..., 0]
            return torch.autograd.grad((torch.logsumexp(x, dim=-1) - picked).sum(), x)[0]

    def stack_unbind(x, idx, w):
        x = annotate(x, sp(3, ["data", -1, "model"]))
        return torch.stack([t * (i + 1) for i, t in enumerate(x.unbind(1))], dim=1)

    return {"embedding": embedding, "embedding_grad": embedding_grad,
            "gather_logsumexp": gather_logsumexp, "gather_grad": gather_grad,
            "stack_unbind": stack_unbind}


@pytest.mark.parametrize("name", sorted(_index_programs()))
def test_index_and_stacking_ops_partition_without_gathering(name):
    """The handlers the training step adds, alone: an embedding table split
    on its rows ("model") and its gradient, a pick and a log-sum-exp over a
    vocab split on "model" and their gradient, unbind and stack: equal to
    the program unsharded (exact, or f32_dot where a sum runs in another
    order), no fallback, and only psums (no gather of the table or input)."""
    rng = np.random.default_rng(10)
    f = _index_programs()[name]
    if name.startswith("embedding"):
        args = (rng.standard_normal((16, 8)), rng.integers(0, 16, (4, 6)),
                rng.standard_normal((4, 6, 8)))
    else:
        args = (rng.standard_normal((4, 6, 16)), rng.integers(0, 16, (4, 6, 1)), np.ones(1))
    args = [torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a)
            for a in args]
    runner = spmd_partition(f, MESH, optimize=False, device="cpu")
    got = runner(*args)
    kind = "f32_dot" if name in ("embedding_grad", "gather_logsumexp", "gather_grad") else "exact"
    assert_close(got, f(*args), kind)
    assert runner.fallbacks == []
    assert set(runner.collectives) <= {"all-reduce"}, runner.collectives
