"""Mamba2 training in the port against the JAX package's: the SSD's backward
plain version (``kernels/ref.py::ssd_scan_bwd_ref``, the backward kernel's
formulas) against ``jax.vjp`` of the reference's oracle, the train step
against the reference's ``make_train_step``, five steps of the loop within
``loss_curve``, remat "none", "full" and "dots" alike, and the captured
gradient with one ``repro_torch::ssd_scan_bwd`` node per layer.

The model is mamba2-130m at ``reduced_config(.., 8)`` cut to two layers
(d96, 3 heads of 64, state 128), with the reference's ``tree_init``
weights carried across through numpy and its float32 leaves moved away
from their zeros and ones (as tests/test_torch_ssm.py does).  Random-weight
Mamba2 is ill-conditioned: a 1e-7 relative change of its weights moves a
three-layer float32 gradient leaf by up to 1.7e-4 in norm
(``tools/mamba2_conditioning.py --reduce 8 --layers 3 --seq 32``), so the
float32 classes hold at two layers, and bf16 is held in norm against the reference run op
by op, at one layer (ROADMAP R6).  The loop runs at 32 positions, where
the reference's own gradient is finite (ROADMAP R11).
tests/test_torch_sharded_ssm.py holds the partitioned step and the SSD's
gradient as a partitioned op; tests/test_torch_cuda.py the backward kernel.
"""
import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import TOLERANCES, assert_close, capture
from repro_torch.core.rules import lower
from repro_torch.analysis.graph_cost import eqn_flops, ssd_bwd_flops
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.loop import TrainConfig, TrainLoop, make_train_step, value_and_grad
from repro_torch.train.optimizer import get_optimizer

ST = get_strategy("2d_finalized")
JST = jax_get_strategy("2d_finalized")
SSD, SSD_BWD = "repro_torch.ssd_scan", "repro_torch.ssd_scan_bwd"


def _ssd_args(seed, B, S, H, hd, ds, a_shape):
    """x, dt, B, C, A and dy with tests/test_kernels.py's distributions."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, H, hd)),
        np.abs(rng.standard_normal((B, S, H))) * 0.5,
        rng.standard_normal((B, S, ds)) * 0.2,
        rng.standard_normal((B, S, ds)) * 0.2,
        -np.abs(rng.standard_normal(a_shape)),
        rng.standard_normal((B, S, H, hd)),
    )]


@functools.partial(jax.jit, static_argnames="chunk")
def _jit_vjp(x, dt, B, C, A, dy, chunk):
    return jax.vjp(lambda *a: jax_ssm.ssd_scan_ref(*a, chunk=chunk), x, dt, B, C, A)[1](dy)


def _reference_vjp(x, dt, B, C, A, dy, chunk):
    return [np.array(g) for g in _jit_vjp(*(jnp.asarray(t) for t in (x, dt, B, C, A, dy)),
                                          chunk=chunk)]


GRADS = ("dx", "ddt", "dB", "dC", "dA")


# (B, S, H, hd, ds, chunk): several chunks, one chunk (S = Q), and ragged
# widths with three chunks
BWD_SHAPES = [(2, 64, 3, 16, 8, 16), (1, 32, 2, 8, 4, 32), (2, 96, 2, 16, 8, 32)]


@pytest.mark.parametrize("B,S,H,hd,ds,chunk", BWD_SHAPES)
def test_ssd_scan_bwd_ref_matches_reference_vjp(B, S, H, hd, ds, chunk):
    """dx, ddt, dB, dC and dA (A shared by the rows) against XLA's autodiff
    of the reference's oracle: the same derivatives, their sums in another
    order (dl by rows and columns of dW * W and a reverse cumsum, where
    autodiff goes back through exp(l_t - l_s) and the cumsum)."""
    args = _ssd_args(B * S + H, B, S, H, hd, ds, (H,))
    got = ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in args), chunk)
    for name, g, w in zip(GRADS, got, _reference_vjp(*args, chunk)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        assert_close(g, w, "f32_chain", err_msg=name)


def test_ssd_scan_bwd_ref_with_a_per_row_matches_reference_per_device():
    """Eight devices' rows folded into one batch of 16 (2 rows each), each
    device with its own A (2 heads): the plain backward with A (16, 2)
    against ``jax.vjp`` of the reference's oracle on each device's rows
    and A; dA comes per row, and a device's two rows sum to its dA."""
    x, dt, B, C, A_dev, dy = _ssd_args(1, 16, 64, 2, 16, 16, (8, 2))
    A = np.repeat(A_dev, 2, axis=0)
    got = ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in (x, dt, B, C, A, dy)), 16)
    assert tuple(got[4].shape) == (16, 2)
    for d in range(8):
        rows = slice(2 * d, 2 * d + 2)
        want = _reference_vjp(x[rows], dt[rows], B[rows], C[rows], A_dev[d], dy[rows], 16)
        for name, g, w in zip(GRADS[:4], got, want):
            assert_close(g[rows], w, "f32_chain", err_msg=f"device {d} {name}")
        assert_close(got[4][rows].sum(0), want[4], "f32_chain", err_msg=f"device {d} dA")


def test_ssd_scan_bwd_ref_is_the_gradient_of_the_plain_forward():
    """In float64 the backward's formulas equal autograd through the plain
    forward; with dt large enough that exp(l_t - l_s) overflows above the
    diagonal, both stay finite (the exponent is masked before the exp)."""
    for scale in (1.0, 8.0):
        x, dt, B, C, A, dy = (torch.from_numpy(a).double()
                              for a in _ssd_args(5, 1, 128, 2, 32, 16, (2,)))
        dt = dt * scale + (scale - 1.0)
        leaves_ = [t.clone().requires_grad_() for t in (x, dt, B, C, A)]
        want = torch.autograd.grad(ssd_scan_ref(*leaves_, 128), leaves_, dy)
        got = ssd_scan_bwd_ref(x, dt, B, C, A, dy, 128)
        for name, g, w in zip(GRADS, got, want):
            assert bool(torch.isfinite(g).all()) and bool(torch.isfinite(w).all()), name
            assert_close(g, w, "f32", err_msg=f"dt x {scale}: {name}")


def test_reference_gradient_is_nan_where_exp_overflows_and_the_port_is_finite():
    """ROADMAP R11: where l_t - l_s passes float32's exp range above the
    diagonal (a 128-row chunk of large dt), the reference's oracle gives a
    finite output but NaN in ddt and dA, the gradients through l
    (``jnp.where``'s gradient is 0 there, times exp's inf); the port masks
    the exponent before the exp, and its gradient is finite and equals the
    float64 one in norm within f32_chain's rtol (per element, 2 of ddt's
    2,048 values, sums of terms up to about 30 that cancel, land 5e-5
    off)."""
    x, dt, B, C, A, dy = _ssd_args(5, 1, 128, 2, 32, 16, (2,))
    dt = dt * 8 + 7.0
    want = _reference_vjp(x, dt, B, C, A, dy, 128)
    assert [bool(np.isfinite(w).all()) for w in want] == [True, False, True, True, False]
    got = ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in (x, dt, B, C, A, dy)), 128)
    exact = ssd_scan_bwd_ref(*(torch.from_numpy(a).double() for a in (x, dt, B, C, A, dy)), 128)
    for name, g, w in zip(GRADS, got, exact):
        assert bool(torch.isfinite(g).all()), name
        assert _rel_norm(g, w.numpy()) <= TOLERANCES["f32_chain"][0], name


# ---------------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------------


def _cfgs(dtype, layers=2, **kw):
    jcfg = jax_reduced_config(jax_get_config("mamba2-130m"), 8).with_(
        dtype=dtype, scan_layers=False, num_layers=layers, **kw)
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(dtype=dtype, num_layers=layers, **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _weights(layers=2):
    """The reference's initial weights (numpy), the float32 leaves moved."""
    jcfg, _ = _cfgs("float32", layers)
    np_tree = jax.tree_util.tree_map(
        np.array, jax_layers.tree_init(jax_api.param_tree(jcfg, JST), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    mix = np_tree["layers"]["mixer"]
    for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.3), ("norm", 0.2)):
        mix[name] += scale * rng.standard_normal(mix[name].shape)
    for a in (np_tree["layers"]["ln"], np_tree["final_ln"]):
        a += 0.1 * rng.standard_normal(a.shape)
    return np_tree


def _port_params(cfg, layers=2):
    params = params_from_numpy(_weights(layers), cfg, "cpu", dtype="float32")
    return tree_map(lambda p: p.requires_grad_(True), params)


def _batch(cfg, step=0, B=4, S=32):
    b = TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=7, pattern="arithmetic")).batch_at(step)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v).long() for k, v in b.items()})


def _rel_norm(got, want):
    got, want = got.detach().double().numpy(), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# float32: Adafactor; the gradients (the reference's under jit) and the
# params after the step per element within f32_chain.  bf16: SGD (its
# update is continuous in the gradient) and one layer, against the
# reference's step run op by op: compiled as one program, the reference's
# bf16 Mamba2 rounds otherwise than op by op (R6; its jitted gradients are
# up to 5.1e-2 off its own op-by-op ones in norm, where the port's are at
# most 1.5e-2), so the loss and grad norm are held within bf16_round and
# the update (-lr times the gradient) per leaf in norm within bf16_chain,
# as the dense family's
@pytest.mark.parametrize("dtype,opt_name", [("float32", "adafactor"), ("bfloat16", "sgd")])
def test_mamba2_train_step_matches_reference(dtype, opt_name):
    layers = 2 if dtype == "float32" else 1
    jcfg, cfg = _cfgs(dtype, layers)
    jopt, opt = jax_get_optimizer(opt_name, lr=0.05), get_optimizer(opt_name, lr=0.05)
    jparams = jax.tree_util.tree_map(jnp.asarray, _weights(layers))
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.asarray(0, jnp.int32)}
    params = _port_params(cfg, layers)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    jb, tb = _batch(cfg)
    before = tree_map(lambda p: p.detach().clone(), params)
    jstep = jax_make_train_step(jcfg, JST, jopt, JaxTrainConfig())
    if dtype == "float32":
        _, jgrads = jax.jit(jax.value_and_grad(lambda p: jax_api.loss_fn(jcfg, JST, p, jb)))(
            jparams)
        _, grads = value_and_grad(cfg, ST, params, tb)
        for (path, g), w in zip(leaves_with_paths(grads), jax.tree_util.tree_leaves(jgrads)):
            assert g.dtype == torch.float32
            assert_close(g, w, "f32_chain", err_msg=f"grad {path}")
        jstate, jm = jax.jit(jstep)(jstate, jb)
    else:
        with jax.disable_jit():
            jstate, jm = jstep(jstate, jb)
    state, m = make_train_step(cfg, ST, opt, TrainConfig())(state, tb)
    kind = "f32_chain" if dtype == "float32" else "bf16_round"
    assert_close(m["loss"], jm["loss"], kind)
    assert_close(m["grad_norm"], jm["grad_norm"], kind)
    assert state["step"] == 1
    for (path, p), p0, w in zip(leaves_with_paths(state["params"]), leaves(before),
                                jax.tree_util.tree_leaves(jstate["params"])):
        assert p.dtype == torch.float32
        if dtype == "float32":
            assert_close(p, w, "f32_chain", err_msg=f"param {path}")
        else:
            rel = _rel_norm(p.detach() - p0, np.asarray(w, np.float32) - p0.numpy())
            assert rel <= TOLERANCES["bf16_chain"][0], f"update {path}: {rel}"


def test_mamba2_loss_curve_matches_reference():
    """Five steps of ``TrainLoop.run`` at launch/train.py's defaults for
    ``--arch mamba2-130m`` (bf16 compute with float32 master weights, remat
    "dots", Adafactor at lr 1e-2) at ``--reduce 8`` cut to two layers,
    batch 8 x 32 of the arithmetic pattern, from the reference's weights.
    At 64 positions the reference's own gradient is NaN from step 0 on
    these weights (ROADMAP R11: its chunk of 64 rows overflows exp(l_t -
    l_s) above the diagonal, and the select's gradient multiplies 0 by
    inf), so the curve is taken at 32, where both packages' gradients are
    finite."""
    jcfg, cfg = _cfgs("bfloat16")
    assert (cfg.param_dtype, cfg.remat) == ("float32", "dots")
    jopt, opt = jax_get_optimizer("adafactor", lr=1e-2), get_optimizer("adafactor", lr=1e-2)
    jtc, tc = JaxTrainConfig(steps=5, log_every=1000), TrainConfig(steps=5, log_every=1000)
    dc = dict(seed=0, pattern="arithmetic")
    jparams = jax.tree_util.tree_map(jnp.asarray, _weights())
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.asarray(0, jnp.int32)}
    jloop = JaxTrainLoop(jcfg, JST, jopt, jtc,
                         JaxTokenPipeline(JaxDataConfig(jcfg.vocab_size, 32, 8, **dc)),
                         rng=jax.random.PRNGKey(0))
    _, want = jloop.run(initial_state=jstate, start_step=0)
    params = _port_params(cfg)
    loop = TrainLoop(cfg, ST, opt, tc, TokenPipeline(DataConfig(cfg.vocab_size, 32, 8, **dc)),
                     device="cpu")
    _, got = loop.run(initial_state={"params": params, "opt": opt.init(params), "step": 0})
    assert len(got) == 5 and all(np.isfinite(got)) and got[-1] < got[0]
    assert_close(np.array(got), np.array(want), "loss_curve")


def test_remat_modes_give_the_same_loss_and_gradients(monkeypatch):
    """"none", "full" and "dots" give bit-identical loss and gradients; under
    "full" and "dots" the backward runs each layer's SSD forward again: 2L
    forward calls per step, where "none" makes L."""
    _, cfg = _cfgs("float32")
    _, tb = _batch(cfg)
    calls = []
    ssd = ops.ssd
    monkeypatch.setattr(ops, "ssd", lambda *a, **k: calls.append(1) or ssd(*a, **k))
    results = {}
    for remat in ("none", "full", "dots"):
        calls.clear()
        results[remat] = value_and_grad(cfg.with_(remat=remat), ST, _port_params(cfg), tb)
        assert len(calls) == cfg.num_layers * (1 if remat == "none" else 2), remat
    for remat in ("full", "dots"):
        assert_close(results[remat][0], results["none"][0], "exact")
        for (path, a), b in zip(leaves_with_paths(results[remat][1]), leaves(results["none"][1])):
            assert_close(a, b, "exact", err_msg=f"{remat} {path}")


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_captured_gradient_holds_one_ssd_bwd_node_per_layer(remat):
    """Under graph capture the SSD is the operator ``repro_torch::ssd_scan``
    and its gradient one ``repro_torch::ssd_scan_bwd`` node per layer (the
    operator's registered gradient); "dots" recomputes each layer's forward,
    so its graph holds two SSD forward nodes per layer.  The cost model
    prices each gradient node (``analysis/graph_cost.py::ssd_bwd_flops``)."""
    _, cfg = _cfgs("float32", remat=remat)
    cfg = cfg.with_(scan_layers=False)  # the layers unrolled: their nodes are counted in the graph
    _, tb = _batch(cfg)
    flat = tree_map(torch.Tensor.detach, _port_params(cfg))

    def program(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            return value_and_grad(cfg, ST, live, batch)

    graph = capture(program, flat, tb).graph
    count = collections.Counter(str(getattr(n.target, "_overloadpacket", n.target))
                                for n in graph.nodes if n.op == "call_function")
    L = cfg.num_layers
    assert count[SSD_BWD] == L
    assert count[SSD] == (L if remat == "none" else 2 * L)
    # the cost model prices each gradient node as ssd_bwd_flops
    B, S = tb["tokens"].shape
    H, hd = 2 * cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    priced = [eqn_flops(lower(n)) for n in graph.nodes if n.op == "call_function"
              and str(getattr(n.target, "_overloadpacket", "")) == SSD_BWD]
    assert priced == [ssd_bwd_flops(B, S, H, hd, cfg.ssm_state, 128)] * L
