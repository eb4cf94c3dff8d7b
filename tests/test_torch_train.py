"""The port's training side against the JAX package's: optimizers, the data
pipeline, the train step (gradient accumulation, gradient compression, the
numeric-fault window), the loop's loss curve, remat and the master weights.
Weights come from the reference's ``tree_init``, carried across through
numpy; batches from the pipelines; tolerances from the port's
``TOLERANCES``."""
import os
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.train.loop import NumericFaultSpec as JaxNumericFaultSpec
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import init_state as jax_init_state
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import TOLERANCES, assert_close
from repro_torch.core.plan import GuardConfig
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.loop import (
    NumericFaultSpec, TrainConfig, TrainLoop, make_train_step, value_and_grad,
)
from repro_torch.train import loop as train_loop
from repro_torch.train.optimizer import get_optimizer

ST = get_strategy("2d_finalized")
JST = jax_get_strategy("2d_finalized")
# tests/test_train_infra.py's TINY, in both packages
TINY_FIELDS = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4,
                   num_kv_heads=4, d_ff=64, vocab_size=128, attn_chunk=16, remat="none")


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _rel_norm(got, want):
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _assert_rel_norm(got, want, kind, msg):
    """Norm-relative error within the class's rtol: for bf16 gradients,
    whose small elements the classes' atol would not hold."""
    rel = _rel_norm(got, want)
    assert rel <= TOLERANCES[kind][0], f"{msg}: relative error {rel} over {kind}"


# ---------------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [("adafactor", {}), ("adafactor", {"weight_decay": 0.1}),
                                     ("adamw", {"weight_decay": 0.01}), ("sgd", {}),
                                     ("sgd", {"momentum": 0.9})])
def test_optimizer_updates_match_reference(name, kw):
    """Three updates of a factored (stacked 3-D and 2-D), a 1-D and a
    one-row leaf from the same numpy params and gradients: float32 math
    whose reductions sum in another order."""
    rng = np.random.default_rng(0)
    shapes = {"w": (2, 6, 8), "m": {"e": (5, 7), "b": (8,), "r": (1, 9)}}
    params = jax.tree_util.tree_map(lambda s: rng.standard_normal(s).astype(np.float32), shapes,
                                    is_leaf=lambda x: isinstance(x, tuple))
    jopt, opt = jax_get_optimizer(name, lr=0.1, **kw), get_optimizer(name, lr=0.1, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, jax.tree_util.tree_map(np.copy, params))
    js, ts = jopt.init(jp), opt.init(tp)
    for step in range(3):
        grads = jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                                       params)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads), js, jp, jnp.asarray(step))
        tp, ts = opt.update(tree_map(torch.from_numpy, grads), ts, tp, step)
        for (path, got), want in zip(leaves_with_paths(tp), jax.tree_util.tree_leaves(jp)):
            assert_close(got, want, "ulp", err_msg=f"step {step} {path}")
        for (path, got), want in zip(leaves_with_paths(ts), jax.tree_util.tree_leaves(js)):
            assert_close(got, want, "ulp", err_msg=f"state step {step} {path}")


# ---------------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------------


def test_data_patterns_match_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 500, 20000).astype(np.int32).tofile(path)
    for kw in ({"pattern": "arithmetic"}, {"path": str(path)}):
        for pi in (0, 1):
            want = JaxTokenPipeline(JaxDataConfig(500, 16, 4, seed=3, **kw), pi, 2)
            got = TokenPipeline(DataConfig(500, 16, 4, seed=3, **kw), pi, 2)
            for step in (0, 1, 7):
                for k in ("tokens", "labels"):
                    np.testing.assert_array_equal(got.batch_at(step)[k], want.batch_at(step)[k])
    # uniform: numpy's generator, not threefry (ROADMAP Queue C): the same
    # determinism and range, not the reference's tokens
    pipes = [TokenPipeline(DataConfig(500, 16, 4, seed=3), pi, 2) for pi in (0, 1)]
    a = pipes[0].batch_at(5)
    np.testing.assert_array_equal(a["tokens"], pipes[0].batch_at(5)["tokens"])
    np.testing.assert_array_equal(a["labels"][:, :-1], a["tokens"][:, 1:])
    assert a["tokens"].shape == (2, 16) and 0 <= a["tokens"].min() and a["tokens"].max() < 500
    assert not np.array_equal(a["tokens"], pipes[0].batch_at(6)["tokens"])
    assert not np.array_equal(a["tokens"], pipes[1].batch_at(5)["tokens"])


# ---------------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------------


def _tiny(dtype, **kw):
    return (JaxModelConfig(**TINY_FIELDS).with_(dtype=dtype, **kw),
            ModelConfig(**TINY_FIELDS).with_(dtype=dtype, **kw))


def _port_state(jstate, cfg, opt, tc):
    params = params_from_numpy(_np(jstate["params"]), cfg, "cpu", dtype=cfg.param_dtype)
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": int(jstate["step"])}
    if tc.compress_grads:
        state["ef"] = tree_map(torch.zeros_like, params)
    return state


def _batch(step, cfg, B=4, S=16):
    b = TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=7, pattern="arithmetic")).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


# f32: Adafactor, every leaf elementwise.  bf16: SGD, whose update is
# continuous in the gradient (Adafactor's first step is sign(g) on 1-D
# leaves, which bf16 rounding flips where g is near 0), compared in norm.
@pytest.mark.parametrize("dtype,opt_name", [("float32", "adafactor"), ("bfloat16", "sgd")])
def test_train_step_matches_reference(dtype, opt_name):
    jcfg, cfg = _tiny(dtype)
    jopt, opt = jax_get_optimizer(opt_name, lr=0.05), get_optimizer(opt_name, lr=0.05)
    jtc, tc = JaxTrainConfig(), TrainConfig()
    jstate = jax_init_state(jcfg, JST, jopt, jtc, jax.random.PRNGKey(0))
    state = _port_state(jstate, cfg, opt, tc)
    jb, tb = _batch(0, cfg)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_api.loss_fn(jcfg, JST, p, jb))(
        jstate["params"])
    loss, grads = value_and_grad(cfg, ST, state["params"], tb)
    for (path, g), w in zip(leaves_with_paths(grads), jax.tree_util.tree_leaves(jgrads)):
        assert g.dtype == torch.float32  # the master weights' gradients
        if dtype == "float32":
            assert_close(g, w, "f32_chain", err_msg=f"grad {path}")
        else:
            _assert_rel_norm(g, w, "bf16_chain", f"grad {path}")
    before = tree_map(lambda p: p.detach().clone(), state["params"])
    jstate, jm = jax.jit(jax_make_train_step(jcfg, JST, jopt, jtc))(jstate, jb)
    state, m = make_train_step(cfg, ST, opt, tc)(state, tb)
    kind = "f32_chain" if dtype == "float32" else "bf16_round"
    assert_close(m["loss"], jm["loss"], kind)
    assert_close(m["grad_norm"], jm["grad_norm"], kind)
    assert state["step"] == int(jstate["step"]) == 1
    for (path, p), p0, w in zip(leaves_with_paths(state["params"]), leaves(before),
                                jax.tree_util.tree_leaves(jstate["params"])):
        assert p.dtype == torch.float32
        if dtype == "float32":
            assert_close(p, w, "f32_chain", err_msg=f"param {path}")
        else:
            _assert_rel_norm(p.detach() - p0, np.asarray(w, np.float32) - p0.numpy(),
                             "bf16_chain", f"update {path}")


def _run_steps(jtc, tc, steps, seed, before=None):
    """``steps`` train steps of TINY in float32 in both packages from the same
    weights; yields (step, port state, port metrics, reference state and
    metrics[, what ``before(state, batch)`` gave before the port's step])
    after each."""
    jcfg, cfg = _tiny("float32")
    jopt, opt = jax_get_optimizer("adafactor", lr=0.05), get_optimizer("adafactor", lr=0.05)
    jstate = jax_init_state(jcfg, JST, jopt, jtc, jax.random.PRNGKey(seed))
    state = _port_state(jstate, cfg, opt, tc)
    jstep = jax.jit(jax_make_train_step(jcfg, JST, jopt, jtc))
    step = make_train_step(cfg, ST, opt, tc)
    for i in range(steps):
        jb, tb = _batch(i, cfg)
        jstate, jm = jstep(jstate, jb)
        seen = before and (before(state, tb),)
        state, m = step(state, tb)
        yield (i, state, m, jstate, jm) + (seen or ())


def test_train_step_accum_and_fault_window_match_reference():
    """grad_accum = 2 for three steps, NaN poisoned into step 1 by the fault
    window: loss, grad norm and params after every step."""
    runs = _run_steps(
        JaxTrainConfig(grad_accum=2, numeric_fault=JaxNumericFaultSpec(nan_at_step=1)),
        TrainConfig(grad_accum=2, numeric_fault=NumericFaultSpec(nan_at_step=1)), 3, seed=1)
    for i, state, m, jstate, jm in runs:
        poisoned = i >= 1  # NaN at step 1 lands in the params and stays
        assert bool(torch.isnan(m["loss"])) == poisoned == bool(np.isnan(jm["loss"]))
        if poisoned:
            assert all(bool(torch.isnan(p).all()) for p in leaves(state["params"]))
            assert all(np.isnan(np.asarray(p)).all()
                       for p in jax.tree_util.tree_leaves(jstate["params"]))
            continue
        assert_close(m["loss"], jm["loss"], "f32_chain")
        assert_close(m["grad_norm"], jm["grad_norm"], "f32_chain")
        for (path, p), w in zip(leaves_with_paths(state["params"]),
                                jax.tree_util.tree_leaves(jstate["params"])):
            assert_close(p, w, "f32_chain", err_msg=f"step {i} {path}")


def test_train_step_gradient_compression_matches_reference():
    """bf16 gradient exchange with float32 error feedback for three steps.
    Within the port, the error feedback is exactly what the bf16 rounding of
    the fed-back gradient left behind.  Against the reference: loss and
    grad norm within f32_chain; the params within coarse, because rounding
    to bf16 is discontinuous: where the two packages' float32 gradients
    straddle a bf16 rounding boundary (a few per leaf and step), the
    exchanged gradients are one bf16 ulp apart, the error feedback there
    flips sign, and the param moves by up to lr * rms(p) * 2^-8 more or
    less, which later steps spread through Adafactor's row and column
    statistics (1.8e-4 at most here)."""
    jcfg, cfg = _tiny("float32")
    runs = _run_steps(JaxTrainConfig(compress_grads=True), TrainConfig(compress_grads=True), 3,
                      seed=1, before=lambda state, tb: (
                          value_and_grad(cfg, ST, state["params"], tb)[1],
                          tree_map(torch.clone, state["ef"])))
    for i, state, m, jstate, jm, (grads, ef_prev) in runs:
        for (path, ef), g, e0 in zip(leaves_with_paths(state["ef"]), leaves(grads),
                                     leaves(ef_prev)):
            fed = g + e0
            assert_close(ef, fed - fed.bfloat16().float(), "exact", err_msg=f"ef {path}")
        assert_close(m["loss"], jm["loss"], "f32_chain")
        assert_close(m["grad_norm"], jm["grad_norm"], "f32_chain")
        for (path, p), w in zip(leaves_with_paths(state["params"]),
                                jax.tree_util.tree_leaves(jstate["params"])):
            assert_close(p, w, "coarse", err_msg=f"step {i} {path}")


def test_grad_accum_sums_microbatches():
    """Two microbatches' mean gradient equals the full batch's."""
    _, cfg = _tiny("float32")
    jstate = jax_init_state(_tiny("float32")[0], JST, jax_get_optimizer("sgd"), JaxTrainConfig(),
                            jax.random.PRNGKey(2))
    params = _port_state(jstate, cfg, get_optimizer("sgd"), TrainConfig())["params"]
    _, tb = _batch(0, cfg)
    l1, g1 = value_and_grad(cfg, ST, params, tb)
    l2, g2 = value_and_grad(cfg, ST, params, tb, grad_accum=2)
    assert_close(l2, l1, "f32_chain")
    for (path, a), b in zip(leaves_with_paths(g2), leaves(g1)):
        assert_close(a, b, "f32_chain", err_msg=str(path))


# ---------------------------------------------------------------------------------
# the loop at the launch defaults
# ---------------------------------------------------------------------------------


def test_train_loop_loss_curve_matches_reference():
    """Five steps of TrainLoop.run at launch/train.py's defaults (qwen1.5-0.5b
    at --reduce 16: 2 layers, d64, bf16 compute with float32 master weights,
    remat "dots", batch 8 x 256, Adafactor at lr 1e-2) on the arithmetic
    pattern, from the reference's initial weights."""
    jcfg = jax_reduced_config(jax_get_config("qwen1.5-0.5b"), 16)
    cfg = reduced_config(get_config("qwen1.5-0.5b"), 16)
    assert (cfg.dtype, cfg.param_dtype, cfg.remat) == ("bfloat16", "float32", "dots")
    jopt, opt = jax_get_optimizer("adafactor", lr=1e-2), get_optimizer("adafactor", lr=1e-2)
    jtc, tc = JaxTrainConfig(steps=5, log_every=1000), TrainConfig(steps=5, log_every=1000)
    dc = dict(seed=0, pattern="arithmetic")
    jloop = JaxTrainLoop(jcfg, JST, jopt, jtc,
                         JaxTokenPipeline(JaxDataConfig(jcfg.vocab_size, 256, 8, **dc)),
                         rng=jax.random.PRNGKey(0))
    jstate = jax_init_state(jcfg, JST, jopt, jtc, jax.random.PRNGKey(0))
    state = _port_state(jstate, cfg, opt, tc)
    _, want = jloop.run(initial_state=jstate, start_step=0)
    loop = TrainLoop(cfg, ST, opt, tc, TokenPipeline(DataConfig(cfg.vocab_size, 256, 8, **dc)),
                     device="cpu")
    _, got = loop.run(initial_state=state)
    assert len(got) == 5 and len(loop.step_times) == 5 and len(loop.tokens_per_s) == 5
    assert got[-1] < got[0]
    assert_close(np.array(got), np.array(want), "loss_curve")


# ---------------------------------------------------------------------------------
# remat, master weights, refusals
# ---------------------------------------------------------------------------------


def test_remat_modes_give_the_same_loss_and_gradients(monkeypatch):
    """"none", "full" and "dots" give bit-identical loss and gradients; under
    "full" and "dots" the backward runs each layer's attention again."""
    jcfg, cfg = _tiny("bfloat16")
    jstate = jax_init_state(jcfg, JST, jax_get_optimizer("sgd"), JaxTrainConfig(),
                            jax.random.PRNGKey(3))
    _, tb = _batch(0, cfg)
    calls = []
    attention = ops.attention_model_layout
    monkeypatch.setattr(ops, "attention_model_layout",
                        lambda *a, **k: calls.append(1) or attention(*a, **k))
    results = {}
    for remat in ("none", "full", "dots"):
        rcfg = cfg.with_(remat=remat)
        params = _port_state(jstate, rcfg, get_optimizer("sgd"), TrainConfig())["params"]
        calls.clear()
        results[remat] = value_and_grad(rcfg, ST, params, tb)
        assert len(calls) == cfg.num_layers * (1 if remat == "none" else 2), remat
    for remat in ("full", "dots"):
        assert_close(results[remat][0], results["none"][0], "exact")
        for (path, a), b in zip(leaves_with_paths(results[remat][1]), leaves(results["none"][1])):
            assert_close(a, b, "exact", err_msg=f"{remat} {path}")


def test_master_weights_leave_serving_outputs_unchanged():
    """Float32 master weights cast at use give the logits of weights stored in
    the compute dtype, bit for bit; params_from_numpy stores what it is told."""
    jcfg, cfg = _tiny("bfloat16")
    np_params = _np(jax_init_state(jcfg, JST, jax_get_optimizer("sgd"), JaxTrainConfig(),
                                   jax.random.PRNGKey(4))["params"])
    served = params_from_numpy(np_params, cfg, "cpu")
    master = params_from_numpy(np_params, cfg, "cpu", dtype="float32")
    assert served["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in leaves(master))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, 128, (2, 24)))
    with torch.inference_mode():
        assert_close(api.forward(cfg, ST, master, tokens), api.forward(cfg, ST, served, tokens),
                     "exact")


def test_unported_settings_raise_and_name_their_roadmap_items(tmp_path):
    _, cfg = _tiny("float32")
    opt = get_optimizer("sgd")
    # the numerics guards are ported (tests/test_torch_guard.py)
    assert callable(make_train_step(cfg, ST, opt, TrainConfig(guard=GuardConfig())))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 4))
    # checkpoints are ported (tests/test_torch_checkpoint.py): a loop and the
    # entry point with a checkpoint directory save into it
    ck = tmp_path / "ck"
    TrainLoop(cfg, ST, opt, TrainConfig(steps=1, ckpt_dir=str(ck / "loop")), pipe,
              device="cpu").run()
    assert sorted(os.listdir(ck / "loop")) == ["step_00000001"]
    launch_train.main(["--device", "cpu", "--reduce", "32", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(ck / "main")])
    assert sorted(os.listdir(ck / "main")) == ["step_00000001"]
    # Mamba2 trains (its SSD's gradient is the backward kernel on the card);
    # a family with no model yet still raises, naming its item
    assert callable(make_train_step(reduced_config(get_config("mamba2-130m"), 8), ST, opt,
                                    TrainConfig()))
    with pytest.raises(NotImplementedError, match="A12b"):
        make_train_step(reduced_config(get_config("jamba-1.5-large-398b"), 8), ST, opt,
                        TrainConfig())


def test_train_entry_point_asks_for_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        launch_train.main(["--steps", "1"])
    losses = launch_train.main(["--device", "cpu", "--reduce", "32", "--steps", "2",
                                "--batch", "2", "--seq", "32"])
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_loop_asks_for_cuda_by_default(monkeypatch):
    _, cfg = _tiny("float32")
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 8, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TrainLoop(cfg, ST, get_optimizer("sgd"), TrainConfig(steps=1), pipe)


def test_train_loop_fails_at_step_watches_stragglers_and_swaps_its_step(monkeypatch):
    _, cfg = _tiny("float32")
    opt = get_optimizer("sgd", lr=0.01)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 8, 2, seed=3, pattern="arithmetic"))
    with pytest.raises(RuntimeError, match="injected failure at step 2"):
        TrainLoop(cfg, ST, opt, TrainConfig(steps=5, fail_at_step=2), pipe, device="cpu").run()
    # The loop's clock runs 1000 s ahead from step 9's fault hook on: a stall
    # no machine's step time can hide, however slow or loaded the host
    stall = {"s": 0.0}
    monkeypatch.setattr(train_loop, "time", types.SimpleNamespace(
        perf_counter=lambda: time.perf_counter() + stall["s"]))
    events, seen = [], []
    hooks = {"straggler": lambda s, dt, med: events.append(s),
             "fault": lambda s: stall.update(s=1000.0) if s == 9 else None,
             "metrics": lambda s, loss: seen.append((s, loss))}
    loop = TrainLoop(cfg, ST, opt, TrainConfig(steps=10, straggler_factor=3.0), pipe, hooks=hooks,
                     device="cpu")
    state, losses = loop.run()
    assert 9 in events and [s for s, _ in seen] == list(range(10)) and state["step"] == 10
    step_fn = loop.step_fn
    calls = []
    loop.swap_plan(lambda st, b: calls.append(1) or step_fn(st, b))
    assert loop.step_times == []
    loop.tc.steps = 12
    _, more = loop.run(initial_state=state)
    assert len(calls) == len(more) == 2 and len(loop.step_times) == 2
