"""The SSD scan as a partitioned operator and Mamba2's loss partitioned by the
port's own partitioner on a simulated ("data" 2, "model" 4) mesh, against the
JAX package unsharded.

* the SSD's plain version at a folded shape (eight devices' rows in one
  batch, each device with its own A) against the Pallas kernel in interpret
  mode and the reference's ``ssd_scan_ref`` on each device's slice;
* ``repro_torch::ssd_scan`` partitioned with batch and heads sharded and
  with B and C arriving sharded on the state dim (gathered), bit for bit
  against the unsharded plain version, and with the head dim sharded;
* ``api.partitionable_loss`` of mamba2-130m at ``reduced_config(.., 8)``
  (3 heads padded to 4, the head dim riding "model") and ``(.., 4)`` (6
  heads padded to 8) under 2d_attempt1, 2d_attempt2 and 2d_finalized, in
  float32 and bf16, against the reference's ``loss_fn`` run op by op
  (ROADMAP R6);
* the SSD's gradient (``repro_torch::ssd_scan_bwd``, the operator's
  registered gradient) partitioned on the three layouts above against the
  plain backward, and planted faults (dB's, dC's or dA's psum dropped)
  that each break it;
* Mamba2's train step under the mesh (``make_train_step`` under
  ``set_mesh``, two layers of 4 heads) under the three strategies against
  the reference's ``make_train_step`` unsharded, and with
  ``compress_grads`` and the numeric-fault window against the same steps
  unsharded;
* the partitioned step's gradient in float64 against the same unsharded,
  with planted dropped psums of dB and dC, and of dA, each breaking it.

Weights come from the reference's ``tree_init`` through numpy; under the
mesh the vocabulary is padded to the "model" axis with zero rows, which the
loss masks (§4.1).
"""
import collections
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import make_train_step as jax_make_train_step
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import TOLERANCES, assert_close, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_bwd_ref, ssd_scan_ref
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import annotate_spec, padded_vocab
from repro_torch.train.loop import NumericFaultSpec, TrainConfig, make_train_step
from repro_torch.train.optimizer import get_optimizer

MESH = make_test_mesh()
STRATEGIES = ["2d_attempt1", "2d_attempt2", "2d_finalized"]
SSD = "repro_torch.ssd_scan"


def _ssd_inputs(seed, B, S, H, hd, ds, a_shape):
    """The distributions of tests/test_kernels.py, float32."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((B, S, H, hd)),
        np.abs(rng.standard_normal((B, S, H))) * 0.5,
        rng.standard_normal((B, S, ds)) * 0.2,
        rng.standard_normal((B, S, ds)) * 0.2,
        -np.abs(rng.standard_normal(a_shape)),
    )]


def test_ssd_plain_version_with_a_per_row_matches_reference_per_device():
    """Eight devices' rows folded into one batch of 16 (2 rows each), every
    device with its own A (2 heads): the plain version with A (16, 2)
    against the Pallas kernel (interpret mode) and the reference's oracle on
    each device's two rows and its A."""
    x, dt, B, C, A_dev = _ssd_inputs(1, 16, 64, 2, 16, 16, (8, 2))
    A = A_dev.repeat_interleave(2, dim=0)
    got = ssd_scan_ref(x, dt, B, C, A, 16)
    assert got.shape == x.shape and got.dtype == torch.float32
    for d in range(8):
        rows = slice(2 * d, 2 * d + 2)
        j = [jnp.asarray(t[rows].numpy()) for t in (x, dt, B, C)] + [jnp.asarray(A_dev[d].numpy())]
        assert_close(got[rows], pallas_ssd_scan(*j, chunk=16), "f32_chain", err_msg=f"device {d}")
        assert_close(got[rows], jax_ssm.ssd_scan_ref(*j, chunk=16), "f32_chain",
                     err_msg=f"device {d}")
    # a shared A (H,) reads as the same A on every row
    shared = ssd_scan_ref(x, dt, B, C, A_dev[0], 16)
    assert_close(shared, ssd_scan_ref(x, dt, B, C, A_dev[0].expand(16, 2), 16), "exact")


# (x, dt, B/C, A) specs on ("data", "model"): batch and heads; the head dim
# (the heads replicated, as Mamba2's weights lay it out where the heads do
# not divide "model"); B and C arriving sharded on the state dim
SSD_LAYOUTS = {
    "batch_heads": (("data", None, "model", None), ("data", None, "model"),
                    ("data", None, None), ("model",)),
    "head_dim": (("data", None, None, "model"), ("data", None, None),
                 ("data", None, None), (None,)),
    "state_dim_gathered": (("data", None, "model", None), ("data", None, "model"),
                           ("data", None, "model"), ("model",)),
}


@pytest.mark.parametrize("layout", sorted(SSD_LAYOUTS))
def test_partitioned_ssd_operator_equals_the_unsharded_plain_version(layout):
    """One ``repro_torch::ssd_scan`` step in the compiled plan (one call for
    all eight devices, each device's A repeated over its rows) against the
    plain version on the whole inputs, bit for bit where batch and heads
    are sharded (they are batch dims of every product); no fallback; the
    state dim of B and C gathered where it arrives sharded.  With the head
    dim sharded, each device's products are narrower on it (the N side of
    ``W x``, ``C S^T`` and the state update), and the CPU's GEMMs sum a
    narrower product's terms in another order: within f32_dot there (one
    contraction reordered; measured 1.8e-7 at most).  The dynamic path
    gives the compiled plan's bits."""
    x_s, dt_s, bc_s, a_s = SSD_LAYOUTS[layout]
    args = _ssd_inputs(2, 4, 64, 8, 16, 16, (8,))

    def fn(x, dt, B, C, A):
        x, dt = annotate_spec(x, x_s, MESH), annotate_spec(dt, dt_s, MESH)
        B, C = annotate_spec(B, bc_s, MESH), annotate_spec(C, bc_s, MESH)
        return ops.ssd(x, dt, B, C, annotate_spec(A, a_s, MESH), chunk=16)

    want = ssd_scan_ref(*args, 16)
    runner = spmd_partition(fn, MESH, optimize=False, device="cpu")
    got = runner(*args)
    assert_close(got, want, "f32_dot" if layout == "head_dim" else "exact")
    assert runner.fallbacks == []
    (entry,) = runner.plans.values()
    assert [s.op for s in entry.plan.steps if s.op.startswith("repro_torch")] == [SSD]
    if layout == "state_dim_gathered":
        assert runner.collectives.get("all-gather", 0) >= 2
    dynamic = spmd_partition(fn, MESH, optimize=False, compile_plans=False, device="cpu")
    assert_close(dynamic(*args), got, "exact")


# -- Mamba2's loss under the mesh ----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(reduce):
    jcfg = jax_reduced_config(jax_get_config("mamba2-130m"), reduce).with_(scan_layers=False)
    jp = jax_layers.tree_init(jax_api.param_tree(jcfg, jax_get_strategy("2d_finalized")),
                              jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.array, jp)
    rng = np.random.default_rng(11)
    mix = np_tree["layers"]["mixer"]  # the float32 leaves, away from their zeros and ones
    for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.3), ("norm", 0.2)):
        mix[name] += scale * rng.standard_normal(mix[name].shape)
    for a in (np_tree["layers"]["ln"], np_tree["final_ln"]):
        a += 0.1 * rng.standard_normal(a.shape)
    tok = rng.integers(0, jcfg.vocab_size, (8, 257))
    return np_tree, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def padded_params(np_tree, cfg, st, mesh):
    """The reference's weights as the port's params under ``mesh``: the
    embedding padded with zero rows to the vocabulary the mesh pads to."""
    with set_mesh(mesh):
        V = padded_vocab(cfg, st)
        emb = np_tree["embed"]["embedding"]
        tree = {**np_tree, "embed": {"embedding": np.pad(emb, ((0, V - emb.shape[0]), (0, 0)))}}
        return params_from_numpy(tree, cfg, "cpu", st)


@functools.lru_cache(maxsize=None)
def _reference_loss(reduce, dtype):
    """The reference's loss unsharded, op by op (R6)."""
    np_tree, batch = _weights(reduce)
    jcfg = jax_reduced_config(jax_get_config("mamba2-130m"), reduce).with_(
        dtype=dtype, scan_layers=False)
    jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    with jax.disable_jit():
        return float(jax_api.loss_fn(jcfg, jax_get_strategy("2d_finalized"), jp,
                                     {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduce", [8, 4])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partitioned_mamba2_loss_matches_reference(strategy, reduce, dtype):
    """``api.partitionable_loss`` through ``spmd_partition(..., optimize=False)``
    against the reference's loss unsharded: float32 within f32_chain, bf16
    within bf16_chain.  Heads pad to the "model" axis (3 -> 4 at width 8,
    6 -> 8 at width 4) with their dt masked; where the heads do not divide
    it the head dim rides "model" and the gated norm's mean over it is a
    psum.  No fallback gathers a sharded dim, and the captured graph holds
    exactly one SSD operator per layer."""
    np_tree, batch = _weights(reduce)
    # the layer loop unrolled: the SSD operators are counted in the graph
    cfg = reduced_config(get_config("mamba2-130m"), reduce).with_(dtype=dtype, scan_layers=False)
    st = get_strategy(strategy)
    params = padded_params(np_tree, cfg, st, MESH)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
    runner = spmd_partition(api.partitionable_loss(cfg, st, MESH), MESH, optimize=False,
                            device="cpu")
    with torch.no_grad():
        loss = runner(params, tb)
    assert runner.fallback_gathers == []
    (entry,) = runner.plans.values()
    ops_in_graph = collections.Counter(str(getattr(n.target, "_overloadpacket", n.target))
                                       for n in entry.captured.graph.nodes
                                       if n.op == "call_function")
    assert ops_in_graph[SSD] == cfg.num_layers
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert_close(loss, _reference_loss(reduce, dtype),
                 "f32_chain" if dtype == "float32" else "bf16_chain")


# -- the SSD's gradient as a partitioned op -------------------------------------------


def _gradient_program(layout):
    """(x, dt, B, C, A, dy) -> the five gradients of the SSD, its operands
    annotated by ``SSD_LAYOUTS[layout]`` and dy as x, the gradient taken
    inside the captured program (``repro_torch::ssd_scan``'s registered
    gradient, ``repro_torch::ssd_scan_bwd``)."""
    x_s, dt_s, bc_s, a_s = SSD_LAYOUTS[layout]

    def fn(x, dt, B, C, A, dy):
        x, dt = annotate_spec(x, x_s, MESH), annotate_spec(dt, dt_s, MESH)
        B, C = annotate_spec(B, bc_s, MESH), annotate_spec(C, bc_s, MESH)
        live = [t.detach().requires_grad_() for t in (x, dt, B, C, annotate_spec(A, a_s, MESH))]
        with torch.enable_grad():
            y = ops.ssd(*live, chunk=16)
            return torch.autograd.grad(y, live, annotate_spec(dy, x_s, MESH))

    return fn


def _gradient_args(seed):
    args = _ssd_inputs(seed, 4, 64, 8, 16, 16, (8,))
    dy = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((4, 64, 8, 16))
                          .astype(np.float32))
    return args + [dy]


SSD_GRADS = ("dx", "ddt", "dB", "dC", "dA")


@pytest.mark.parametrize("layout", sorted(SSD_LAYOUTS))
def test_partitioned_ssd_gradient_equals_the_unsharded_plain_backward(layout):
    """The captured gradient of the SSD, partitioned: one
    ``repro_torch::ssd_scan_bwd`` step for all eight devices, no fallback,
    against ``ssd_scan_bwd_ref`` on the whole inputs.  Each device's dB and
    dC are sums over its heads (and head-dim slice), its dA (one per folded
    row) a sum over its rows: the op's psums complete them, so they are
    sums in another order (f32_chain); dx, and ddt where the head dim is
    whole, are each device's own rows, bit for bit."""
    args = _gradient_args(4)
    want = ssd_scan_bwd_ref(*args, 16)
    runner = spmd_partition(_gradient_program(layout), MESH, optimize=False, device="cpu")
    got = runner(*args)
    assert runner.fallbacks == []
    (entry,) = runner.plans.values()
    steps = collections.Counter(s.op for s in entry.plan.steps if s.op.startswith("repro_torch"))
    assert steps == {SSD: 1, "repro_torch.ssd_scan_bwd": 1}
    for name, g, w in zip(SSD_GRADS, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        exact = name == "dx" or (name == "ddt" and layout != "head_dim")
        assert_close(g, w, "exact" if exact else "f32_chain", err_msg=name)


def test_a_dropped_psum_of_the_ssd_gradient_fails():
    """Planted faults, one at a time: the partitioned gradient with its
    psum of dB (then of dC, then of dA) over "model" (dB, dC: the heads'
    axis; dA: the batch's is "data") left out.  Each puts that gradient
    outside f32_chain of the unsharded plain backward, where the sound
    program is within it (the readings print under -s)."""
    from repro_torch.core import mesh_runtime as mr
    from repro_torch.core import partitioner as part

    args = _gradient_args(5)
    want = ssd_scan_bwd_ref(*args, 16)
    rtol, atol = TOLERANCES["f32_chain"]

    def over(got, name):
        g, w = got[SSD_GRADS.index(name)], want[SSD_GRADS.index(name)]
        return ((g - w).abs() / (atol + rtol * w.abs())).max().item()

    runner = spmd_partition(_gradient_program("batch_heads"), MESH, optimize=False, device="cpu")
    sound = runner(*args)
    readings = {}
    for name, axis, shape in (("dB", "model", (8, 2, 64, 16)), ("dC", "model", (8, 2, 64, 16)),
                              ("dA", "data", (8, 2))):
        assert over(sound, name) <= 1.0

        def dropped(x, mesh, axes, shape=shape, axis=axis):
            if tuple(x.shape) == shape and axis in tuple(axes):
                return x
            return mr.psum(x, mesh, axes)

        part.mr = _MeshRuntime(dropped)
        try:
            readings[name] = over(runner(*args), name)
        finally:
            part.mr = mr
        assert readings[name] > 1.0, f"dropping {name}'s psum over {axis} went unseen"
    print(f"a dropped psum of the SSD gradient: err / f32_chain {readings}")


class _MeshRuntime:
    """``core/mesh_runtime.py`` with its psum replaced."""

    def __init__(self, psum):
        from repro_torch.core import mesh_runtime as mr

        self._mr, self.psum = mr, psum

    def __getattr__(self, name):
        return getattr(self._mr, name)


# -- Mamba2's train step under the mesh ------------------------------------------------


# mamba2-130m at reduced_config(.., 8) with d_model 128: two layers of 4
# heads of 64, which divide "model" (3 heads would pad to 4, and the
# gradient of that pad, a slice of the sharded head dim, gathers it)
TRAIN_FIELDS = dict(dtype="float32", num_layers=2, d_model=128)


@functools.lru_cache(maxsize=None)
def _reference_step():
    """The reference's initial weights (float32 leaves moved, as
    ``_weights``) and one Adafactor step of its ``make_train_step``
    unsharded on batch 0 of the arithmetic pattern (8 x 32)."""
    jcfg = jax_reduced_config(jax_get_config("mamba2-130m"), 8).with_(scan_layers=False,
                                                                       **TRAIN_FIELDS)
    jst = jax_get_strategy("2d_finalized")
    np_tree = jax.tree_util.tree_map(
        np.array, jax_layers.tree_init(jax_api.param_tree(jcfg, jst), jax.random.PRNGKey(1)))
    rng = np.random.default_rng(12)
    mix = np_tree["layers"]["mixer"]
    for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.3), ("norm", 0.2)):
        mix[name] += scale * rng.standard_normal(mix[name].shape)
    for a in (np_tree["layers"]["ln"], np_tree["final_ln"]):
        a += 0.1 * rng.standard_normal(a.shape)
    jopt = jax_get_optimizer("adafactor", lr=0.05)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_tree)
    jstate = {"params": jparams, "opt": jopt.init(jparams), "step": jnp.asarray(0, jnp.int32)}
    batch = JaxTokenPipeline(JaxDataConfig(jcfg.vocab_size, 32, 8, seed=4,
                                           pattern="arithmetic")).batch_at(0)
    jstate, jm = jax.jit(jax_make_train_step(jcfg, jst, jopt, JaxTrainConfig()))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return np_tree, batch, float(jm["loss"]), float(jm["grad_norm"]), jax.tree_util.tree_map(
        np.array, jstate["params"])


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partitioned_mamba2_train_step_matches_reference(strategy):
    """``make_train_step`` under ``set_mesh`` (the whole step one program
    through the partitioner, the SSD and its gradient as partitioned ops)
    for one Adafactor step in float32 against the reference's step
    unsharded: loss, grad norm and the params after the step within
    f32_chain (the embedding on its first 6,285 rows: the padded rows have
    no counterpart); no fallback gathers a sharded dim (the causal conv's
    pad and slice of the sequence take the fallback, which gathers
    nothing), and the plan holds per layer two SSD forward steps (remat
    "dots", the config's default, recomputes it) and one backward step."""
    np_tree, batch, jloss, jnorm, jparams = _reference_step()
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(scan_layers=False, **TRAIN_FIELDS)
    st = get_strategy(strategy)
    params = tree_map(lambda p: p.requires_grad_(True), padded_params(np_tree, cfg, st, MESH))
    opt = get_optimizer("adafactor", lr=0.05)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    with set_mesh(MESH):
        step = make_train_step(cfg, st, opt, TrainConfig())
    state, m = step(state, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert step.runner.fallback_gathers == []
    (entry,) = step.runner.plans.values()
    steps = collections.Counter(s.op for s in entry.plan.steps if s.op.startswith("repro_torch"))
    assert cfg.remat == "dots"  # the recompute runs each layer's SSD forward again
    assert (steps[SSD], steps["repro_torch.ssd_scan_bwd"]) == (2 * cfg.num_layers, cfg.num_layers)
    assert_close(m["loss"], jloss, "f32_chain")
    assert_close(m["grad_norm"], jnorm, "f32_chain")
    for (path, p), w in zip(leaves_with_paths(state["params"]), jax.tree_util.tree_leaves(jparams)):
        assert_close(p[:w.shape[0]], w, "f32_chain", err_msg=f"param {path}")


class _SSDBwdPsumDropped:
    """``core/mesh_runtime.py`` with the psums over ``axis`` that
    ``decide_ssd_bwd``'s op runs for the gradients whose shape ``which``
    accepts left out; every other psum as it was."""

    def __init__(self, which, axis):
        from repro_torch.core import mesh_runtime as mr

        self._mr, self._which, self._axis, self.dropped = mr, which, axis, 0

    def __getattr__(self, name):
        return getattr(self._mr, name)

    def psum(self, x, mesh, axes):
        caller = sys._getframe(1).f_code.co_qualname
        if caller.startswith("decide_ssd_bwd.") and self._axis in tuple(axes) and self._which(x):
            self.dropped += 1
            return x
        return self._mr.psum(x, mesh, axes)


def test_float64_partitioned_mamba2_gradient_parts_a_dropped_psum_from_rounding():
    """The float64 witness of ``chip_smoke.py``'s full-depth case, at two
    layers: the partitioned step's gradient program (2d_finalized) in
    float64 against ``value_and_grad`` unsharded in float64, loss and each
    leaf within f32_chain in norm (the two read about 1e-13 apart), and
    planted faults, dB's and dC's psums over "model" and dA's over "data"
    dropped in turn, each putting a leaf beyond that limit."""
    from repro_torch.core import partitioner as part
    from repro_torch.train.loop import sharded_value_and_grad, value_and_grad

    np_tree, batch, _, _, _ = _reference_step()
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(**{**TRAIN_FIELDS,
                                                                "dtype": "float64"})
    st = get_strategy("2d_finalized")
    params = tree_map(torch.Tensor.double, padded_params(np_tree, cfg, st, MESH))
    batch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with set_mesh(MESH):
        runner = spmd_partition(sharded_value_and_grad(cfg, st, MESH), MESH, optimize=False,
                                device="cpu")
    loss, grads = runner(params, batch)
    want_loss, want = value_and_grad(
        cfg, st, tree_map(lambda p: p.clone().requires_grad_(), params), batch)
    assert loss.dtype == torch.float64 and runner.fallback_gathers == []
    limit = TOLERANCES["f32_chain"][0]

    def worst(got):
        return max(((g - w).norm() / w.norm()).item() for g, w in zip(leaves(got), leaves(want)))

    assert abs(loss.item() - want_loss.item()) <= limit * abs(want_loss.item())
    assert worst(grads) <= limit
    readings = {}
    for name, which, axis, per_layer in (("dB, dC", lambda t: t.ndim == 4, "model", 2),
                                         ("dA", lambda t: t.ndim == 2, "data", 1)):
        planted = _SSDBwdPsumDropped(which, axis)
        part.mr = planted
        try:
            readings[name] = worst(runner(params, batch)[1]) / limit
        finally:
            part.mr = planted._mr
        assert planted.dropped == per_layer * cfg.num_layers, name
        assert readings[name] > 1.0, f"dropping {name}'s psum over {axis} went unseen"
    print(f"float64 partitioned gradient, a dropped psum: largest leaf error / f32_chain "
          f"{readings}")


@pytest.mark.parametrize("option", ["compress_grads", "numeric_fault"])
def test_partitioned_mamba2_step_options_match_the_unsharded_step(option):
    """Three Adafactor steps of Mamba2's partitioned step (2d_finalized)
    with ``compress_grads`` (the error feedback an input and an output of
    the program) or the numeric-fault window (a gradient spike at step 1,
    NaN at step 2: ``torch.where`` on the step tensor) against the same
    steps unsharded: losses and grad norms within f32_chain; with
    compression the params and error feedback after step 0 within coarse
    (bf16 rounding is discontinuous, as in ``tests/test_torch_train.py``),
    and the later losses and grad norms within coarse: the flipped ulps
    feed back through Adafactor and random-weight Mamba2 amplifies them
    (step 1's loss read 1.04e-4 relative, and 45 of 804,864 embedding
    values 3.7e-3 apart after step 2); under the window NaN in every param
    of both after step 2; one plan for the run."""
    np_tree, _, _, _, _ = _reference_step()
    cfg = reduced_config(get_config("mamba2-130m"), 8).with_(scan_layers=False, **TRAIN_FIELDS)
    st, opt = get_strategy("2d_finalized"), get_optimizer("adafactor", lr=0.05)
    tc = (TrainConfig(compress_grads=True) if option == "compress_grads" else
          TrainConfig(numeric_fault=NumericFaultSpec(nan_at_step=2, grad_spike_at_step=1)))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 32, 8, seed=4, pattern="arithmetic"))
    runs = []
    for mesh in (MESH, None):
        params = tree_map(lambda p: p.requires_grad_(True),
                          padded_params(np_tree, cfg, st, MESH))
        state = {"params": params, "opt": opt.init(params), "step": 0}
        if tc.compress_grads:
            state["ef"] = tree_map(torch.zeros_like, params)
        with set_mesh(mesh):
            step = make_train_step(cfg, st, opt, tc)
        ms, after0 = [], None
        for i in range(3):
            ms.append(step(state, {k: torch.from_numpy(v).long()
                                   for k, v in pipe.batch_at(i).items()})[1])
            after0 = after0 or {part: tree_map(torch.clone, state[part])
                                for part in ("params", "ef") if part in state}
        runs.append((state, ms, step, after0))
    (state, ms, step, after0), (ustate, ums, _, uafter0) = runs
    checked = 3 if option == "compress_grads" else 2
    for i, (m, um) in enumerate(zip(ms[:checked], ums[:checked])):
        # after a compressed step the params are coarse-close, so the losses too
        kind = "coarse" if option == "compress_grads" and i > 0 else "f32_chain"
        assert_close(m["loss"], um["loss"], kind, err_msg=f"step {i}")
        assert_close(m["grad_norm"], um["grad_norm"], kind, err_msg=f"step {i}")
    if option == "compress_grads":
        for part in ("params", "ef"):
            for (path, a), b in zip(leaves_with_paths(after0[part]), leaves(uafter0[part])):
                assert_close(a, b, "coarse", err_msg=f"{part} after step 0 {path}")
    else:
        assert float(ms[1]["grad_norm"]) > 1e11 * float(ms[0]["grad_norm"])
        for m, s in ((ms[2], state), (ums[2], ustate)):
            assert bool(torch.isnan(m["loss"]))
            assert all(bool(torch.isnan(p).all()) for p in leaves(s["params"]))
    stats = step.runner.cache_stats
    assert (stats.misses, stats.hits) == (1, 2) and step.runner.fallback_gathers == []
