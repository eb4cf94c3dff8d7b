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
  (ROADMAP R6).

Weights come from the reference's ``tree_init`` through numpy; under the
mesh the vocabulary is padded to the "model" axis with zero rows, which the
loss masks (§4.1).
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
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd_scan
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import assert_close, capture, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import annotate_spec, padded_vocab

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
    cfg = reduced_config(get_config("mamba2-130m"), reduce).with_(dtype=dtype)
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


def test_ssd_under_capture_refuses_a_gradient():
    """The SSD operator has no gradient until its backward kernel lands (A8):
    a capture that needs one raises, naming the item."""
    x, dt, B, C, A = _ssd_inputs(3, 2, 32, 2, 16, 16, (2,))
    x.requires_grad_()

    def fn(x, dt, B, C, A):
        with torch.enable_grad():
            return ops.ssd(x, dt, B, C, A, chunk=16)

    with pytest.raises(NotImplementedError, match="A8"):
        capture(fn, x, dt, B, C, A)
