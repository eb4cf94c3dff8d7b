"""The port's Mamba2 and the loss side of both families against the JAX
package's, on the same weights (the JAX package's ``tree_init`` carried
across with ``params_from_numpy``, with the float32 leaves perturbed away
from their zeros and ones) and the same inputs (numpy, seeded).

On the CPU the port's SSD runs its plain version (``kernels/ref.py``); it is
held against the JAX oracle, the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it) and the exact recurrence.
tests/test_torch_cuda.py holds the CUDA kernel against the plain version on
the card.
"""
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
from repro_torch.core.compat import assert_close
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.kernels.ref import ssd_recurrence, ssd_scan_ref
from repro_torch.models import api, layers, ssm
from repro_torch.models.convert import params_from_numpy

ST = get_strategy("2d_finalized")
JST = jax_get_strategy("2d_finalized")
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# Whole models, against the reference run op by op (not under jax.jit: see
# ROADMAP R6).  Compiled as one program, the reference's bfloat16 Mamba2
# rounds otherwise than op by op, and where a head's SSD output nearly
# cancels against D * x the gated RMS norm scales the difference up to order
# 1: at this size the jitted and op-by-op logits differ by up to 3.0 at
# logits of magnitude 5, more than either differs from the float32 model.
# bfloat16: one-ulp flips between XLA's and PyTorch's kernels grow through
# the layers (see the port's TOLERANCES).  float32: chains of contractions
# summed in another order; in Mamba2 the SSD's outputs reach about 1e2 as
# sums over 128-row chunks whose terms cancel, so a reassociated float32 sum
# moves them by a few 1e-6 relative (both packages alike against the
# float64 recurrence), and the gated norm and the layers carry that to about
# 1e-4 at logits of order 1: a deep chain, "coarse"
MODEL_TOL = {"ssm": {"float32": "coarse", "bfloat16": "bf16_chain"},
             "dense": {"float32": "f32_chain", "bfloat16": "bf16_chain"}}
# one layer: float32 reorders a few contractions; bfloat16 values may sit one
# rounding of the working dtype apart
LAYER_TOL = {"float32": "f32_chain", "bfloat16": "bf16_round"}
ARCHS = {"ssm": "mamba2-130m", "dense": "qwen1.5-0.5b"}
# reduced_config(mamba2-130m, 8): 3 layers, d96, 3 heads of 64, ds 128;
# reduced_config(qwen1.5-0.5b, 32): 2 layers, d64, 2 q heads on 1 kv head
REDUCE = {"ssm": 8, "dense": 32}


def _cfgs(family, dtype, **kw):
    arch, k = ARCHS[family], REDUCE[family]
    jcfg = jax_reduced_config(jax_get_config(arch), k).with_(dtype=dtype, scan_layers=False, **kw)
    return jcfg, reduced_config(get_config(arch), k).with_(dtype=dtype, **kw)


def _params(family, dtype, **kw):
    jcfg, cfg = _cfgs(family, dtype, **kw)
    jp = jax_layers.tree_init(jax_api.param_tree(jcfg, JST), jax.random.PRNGKey(0))
    np_tree = jax.tree_util.tree_map(np.array, jp)
    rng = np.random.default_rng(11)
    lay = np_tree["layers"]
    if family == "ssm":  # the float32 leaves, away from their zeros and ones
        mix = lay["mixer"]
        for name, scale in (("A_log", 0.5), ("dt_bias", 0.5), ("D", 0.3), ("norm", 0.2)):
            mix[name] += scale * rng.standard_normal(mix[name].shape)
        norms = [lay["ln"], np_tree["final_ln"]]
    else:
        norms = [lay["ln1"], lay["ln2"], np_tree["final_ln"]]
    for a in norms:
        a += 0.1 * rng.standard_normal(a.shape)
    jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return jcfg, cfg, jp, params_from_numpy(np_tree, cfg, "cpu"), np_tree


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(TORCH_DTYPE[dtype])


def _ssd_inputs(seed, B, S, H, hd, ds):
    """The distributions of tests/test_kernels.py, float32."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((B, S, H, hd)),
        np.abs(rng.standard_normal((B, S, H))) * 0.5,
        rng.standard_normal((B, S, ds)) * 0.2,
        rng.standard_normal((B, S, ds)) * 0.2,
        -np.abs(rng.standard_normal((H,))),
    )]


# tests/test_kernels.py's sweep and recurrence shapes, plus S < chunk (Q = S)
SSD_SHAPES = [
    (1, 128, 2, 64, 64, 64),
    (2, 256, 3, 64, 128, 128),
    (1, 256, 1, 32, 16, 128),
    (1, 64, 2, 16, 8, 32),
    (2, 64, 3, 64, 128, 128),
]


@pytest.mark.parametrize("B,S,H,hd,ds,chunk", SSD_SHAPES)
def test_ssd_scan_ref_matches_reference(B, S, H, hd, ds, chunk):
    arrs = _ssd_inputs(B * S + hd, B, S, H, hd, ds)
    j = [jnp.asarray(a) for a in arrs]
    got = ssd_scan_ref(*(torch.from_numpy(a) for a in arrs), chunk)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, hd)
    # the same steps as the JAX oracle: contractions summed in another order
    assert_close(got, jax_ssm.ssd_scan_ref(*j, chunk=chunk), "f32_chain")
    # the Pallas kernel carries the state chunk to chunk where the oracle
    # scans chunk states: the same sums reassociated in float32
    assert_close(got, pallas_ssd_scan(*j, chunk=chunk), "f32_chain")
    # the exact recurrence in float64: the chunked form reassociates its
    # float32 sums and rounds exp(l) once per chunk row
    assert_close(got, ssd_recurrence(*(torch.from_numpy(a) for a in arrs)), "f32_chain")


def test_ssd_dispatch_takes_the_plain_version_on_cpu():
    arrs = [torch.from_numpy(a) for a in _ssd_inputs(3, 2, 256, 3, 64, 128)]
    ssd_kernel.launches = 0
    got = ops.ssd(*arrs, chunk=128)
    assert ssd_kernel.launches == 0
    assert torch.equal(got, ssd_scan_ref(*arrs, 128))
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd(*(a[:, :200] if a.ndim > 1 else a for a in arrs), chunk=128)


def test_ssd_masks_before_exp():
    """Long chunks with large dt: exp(l_t - l_s) overflows above the
    diagonal, and the select keeps it out of the product."""
    x, dt, B, C, A = (torch.from_numpy(a) for a in _ssd_inputs(4, 1, 128, 2, 32, 16))
    dt = dt * 8 + 1.0  # l_t - l_s up to several hundred above the diagonal
    y = ssd_scan_ref(x, dt, B, C, A, 128)
    assert bool(torch.isfinite(y).all())
    assert_close(y, ssd_recurrence(x, dt, B, C, A), "f32_chain")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_layer_forward_and_decode_match_reference(dtype):
    jcfg, cfg, jp, p, _ = _params("ssm", dtype)
    rng = np.random.default_rng(12)
    x = jnp.asarray(rng.standard_normal((2, 256, cfg.d_model)), JAX_DTYPE[dtype])
    jlp = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["mixer"])
    lp = layers.layer_slice(p["layers"], 1)["mixer"]
    want = jax_ssm.ssm_forward(jcfg, JST, jlp, x)  # two chunks of 128
    got = ssm.ssm_forward(cfg, ST, lp, _to_torch(x, dtype))
    assert got.dtype == TORCH_DTYPE[dtype]
    assert_close(got, want, LAYER_TOL[dtype])

    shapes = ssm.ssm_state_shapes(cfg, ST, 2)
    assert shapes == jax_ssm.ssm_state_shapes(jcfg, JST, 2)
    jstate = {"s": jnp.zeros(shapes["s"], jnp.float32), "conv": jnp.zeros(shapes["conv"], jnp.bfloat16)}
    state = {"s": torch.zeros(shapes["s"]), "conv": torch.zeros(shapes["conv"], dtype=torch.bfloat16)}
    for t in range(6):
        xt = x[:, t:t + 1]
        want, jstate = jax_ssm.ssm_decode(jcfg, JST, jlp, xt, jstate)
        got, state = ssm.ssm_decode(cfg, ST, lp, _to_torch(xt, dtype), state)
        assert_close(got, want, LAYER_TOL[dtype], err_msg=f"output at step {t}")
        for name in ("s", "conv"):  # the reference's dtypes: concatenate promotes conv
            assert state[name].dtype == TORCH_DTYPE[str(jstate[name].dtype)]
            assert_close(state[name], jstate[name], LAYER_TOL[dtype], err_msg=f"{name} at {t}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,xent_chunk", [("ssm", 0), ("dense", 0), ("dense", 16)])
def test_forward_and_loss_match_reference(family, xent_chunk, dtype):
    jcfg, cfg, jp, p, _ = _params(family, dtype, xent_chunk=xent_chunk)
    rng = np.random.default_rng(13)
    tokens, labels = rng.integers(0, cfg.vocab_size, (2, 2, 64))
    want = jax_api.loss_fn(jcfg, JST, jp, {"tokens": jnp.asarray(tokens, jnp.int32),
                                           "labels": jnp.asarray(labels, jnp.int32)})
    batch = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels)}
    got = api.loss_fn(cfg, ST, p, batch)
    assert got.dtype == torch.float32 and got.shape == ()
    # a mean of log-sum-exps over the model's logits
    assert_close(got, want, "f32_chain" if dtype == "float32" else "coarse")
    if xent_chunk:  # the streamed loss equals the whole-logits loss
        whole = api.loss_fn(cfg.with_(xent_chunk=0), ST, p, batch)
        assert_close(got, whole, "f32_dot" if dtype == "float32" else "coarse")
        return
    want = jax_api.family_module(jcfg).forward(jcfg, JST, jp, jnp.asarray(tokens, jnp.int32))
    want = want[0] if family == "dense" else want
    got = api.forward(cfg, ST, p, torch.from_numpy(tokens))
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (2, 64, cfg.vocab_size)
    assert_close(got, want, MODEL_TOL[family][dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_decode_steps_match_reference(dtype):
    jcfg, cfg, jp, p, _ = _params("ssm", dtype)
    tokens = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 5))
    shapes = api.cache_shapes(cfg, ST, 2, 16)
    assert shapes == jax_api.cache_shapes(jcfg, JST, 2, 16)
    assert set(shapes) == {"s", "conv"}
    jcache = {k: jnp.zeros(v, jnp.float32 if k == "s" else jnp.bfloat16) for k, v in shapes.items()}
    cache = {k: torch.zeros(v, dtype=torch.float32 if k == "s" else torch.bfloat16)
             for k, v in shapes.items()}
    for pos in range(5):
        tok = tokens[:, pos:pos + 1]
        want, jcache = jax_api.decode_step(jcfg, JST, jp, jnp.asarray(tok, jnp.int32), jcache, pos)
        got, cache = api.decode_step(cfg, ST, p, torch.from_numpy(tok), cache, pos)
        assert_close(got, want, MODEL_TOL["ssm"][dtype], err_msg=f"logits at pos {pos}")
        for name in ("s", "conv"):
            assert cache[name].dtype == TORCH_DTYPE[str(jcache[name].dtype)]
            assert_close(cache[name], jcache[name], MODEL_TOL["ssm"][dtype],
                         err_msg=f"{name} at {pos}")


def test_ssm_forward_equals_decode_loop():
    """The chunked SSD in the forward and the exact recurrence in decode give
    the same logits (the reference's kernel-vs-recurrence check at model
    scale), two chunks of 128 in float32."""
    _, cfg, _, p, _ = _params("ssm", "float32")
    tokens = torch.from_numpy(np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 256)))
    fwd = api.forward(cfg, ST, p, tokens)
    cache = {k: torch.zeros(v, dtype=torch.float32 if k == "s" else torch.bfloat16)
             for k, v in api.cache_shapes(cfg, ST, 2, 256).items()}
    dec = []
    for pos in range(256):
        logits, cache = api.decode_step(cfg, ST, p, tokens[:, pos:pos + 1], cache, pos)
        dec.append(logits)
    # float32 both ways: the chunked sums reassociate through 3 layers
    assert_close(torch.cat(dec, dim=1), fwd, MODEL_TOL["ssm"]["float32"])


def test_params_from_numpy_mamba2_keeps_float32_leaves():
    _, cfg, _, _, np_tree = _params("ssm", "float32")
    bf = params_from_numpy(np_tree, cfg.with_(dtype="bfloat16"), "cpu")
    mixer, want = bf["layers"]["mixer"], np_tree["layers"]["mixer"]
    for name in ("A_log", "dt_bias", "D", "norm"):  # perturbed: not bf16-exact
        assert mixer[name].dtype == torch.float32, name
        np.testing.assert_array_equal(mixer[name].numpy(), want[name])
    assert bf["layers"]["ln"].dtype == bf["final_ln"].dtype == torch.float32
    for name in ("wz", "wx", "wB", "wC", "wdt", "conv_w", "wo"):
        assert mixer[name].dtype == torch.bfloat16, name
    assert bf["embed"]["embedding"].dtype == torch.bfloat16
