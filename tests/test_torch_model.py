"""The port's configs, layers and dense LM against the JAX package's, on the
same weights (the JAX package's ``tree_init`` carried across with
``params_from_numpy``) and the same inputs (numpy, seeded)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import arch_ids as jax_arch_ids
from repro.configs.registry import get_config as jax_get_config
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models import attention as jax_attention
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import arch_ids, get_config, reduced_config
from repro_torch.core.compat import assert_close
from repro_torch.models import api, attention, layers, transformer
from repro_torch.models.convert import params_from_numpy

ST = get_strategy("2d_finalized")
JST = jax_get_strategy("2d_finalized")
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
# float32: a chain of contractions whose order differs per layer.  bfloat16:
# XLA compiles the layer stack as one program and rounds some intermediates
# differently from PyTorch's op-by-op kernels; see the port's TOLERANCES.
MODEL_TOL = {"float32": "f32_chain", "bfloat16": "bf16_chain"}
# single elementwise ops: float32 differs in libm ulps, bf16 by one rounding
OP_TOL = {"float32": "f32", "bfloat16": "bf16_round"}


def _cfgs(dtype):
    """reduced_config(qwen1.5-0.5b, 32): 2 layers, d64, 2 q heads on 1 kv head.
    The JAX side runs its layers unrolled, as the port does."""
    jcfg = jax_reduced_config(jax_get_config("qwen1.5-0.5b"), 32)
    cfg = reduced_config(get_config("qwen1.5-0.5b"), 32)
    return jcfg.with_(dtype=dtype, scan_layers=False), cfg.with_(dtype=dtype)


def _params(dtype):
    jcfg, cfg = _cfgs(dtype)
    jp = jax_layers.tree_init(jax_api.param_tree(jcfg, JST), jax.random.PRNGKey(0))
    # non-zero biases and norm scales, so that they are exercised
    np_tree = jax.tree_util.tree_map(np.array, jp)
    rng = np.random.default_rng(5)
    attn = np_tree["layers"]["attn"]
    for a in (attn["bq"], attn["bk"], attn["bv"], np_tree["layers"]["ln1"],
              np_tree["layers"]["ln2"], np_tree["final_ln"]):
        a += 0.1 * rng.standard_normal(a.shape)
    jp = jax.tree_util.tree_map(jnp.asarray, np_tree)
    return jcfg, cfg, jp, params_from_numpy(np_tree, cfg, "cpu")


def _to_torch(x, dtype):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(TORCH_DTYPE[dtype])


def test_configs_match_reference_field_for_field():
    assert arch_ids() == jax_arch_ids()
    for arch in arch_ids():
        for k in (1, 8, 16, 32):
            want = dataclasses.asdict(jax_reduced_config(jax_get_config(arch), k))
            assert dataclasses.asdict(reduced_config(get_config(arch), k)) == want, (arch, k)


def test_param_tree_matches_reference_shapes():
    jcfg, cfg = _cfgs("bfloat16")
    jshapes = jax.tree_util.tree_map(
        lambda p: p["shape"], jax_api.param_tree(jcfg, JST), is_leaf=jax_layers.is_param)
    shapes = layers.tree_map_params(lambda p, _: p["shape"], api.param_tree(cfg, ST))
    assert shapes == jshapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_rope_mlp_match_reference(dtype):
    jcfg, cfg, jp, p = _params(dtype)
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 24, 64)), JAX_DTYPE[dtype])
    xt = _to_torch(x, dtype)
    lp = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    lpt = layers.layer_slice(p["layers"], 0)
    assert_close(layers.rms_norm(xt, lpt["ln1"]), jax_layers.rms_norm(x, lp["ln1"]), OP_TOL[dtype])
    q = jnp.asarray(rng.standard_normal((2, 24, 2, 32)), JAX_DTYPE[dtype])
    pos = np.stack([np.arange(24), np.arange(7, 31)])
    assert_close(layers.rope(_to_torch(q, dtype), torch.from_numpy(pos), 32),
                 jax_layers.rope(q, jnp.asarray(pos), 32), OP_TOL[dtype])
    assert_close(layers.mlp_forward(cfg, ST, lpt["mlp"], xt),
                 jax_layers.mlp_forward(jcfg, JST, lp["mlp"], x),
                 "f32_chain" if dtype == "float32" else "bf16_round")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_attention_matches_reference(dtype):
    jcfg, cfg, jp, p = _params(dtype)
    x = jnp.asarray(np.random.default_rng(9).standard_normal((2, 24, 64)), JAX_DTYPE[dtype])
    pos = np.broadcast_to(np.arange(24), (2, 24))
    lp = jax.tree_util.tree_map(lambda a: a[1], jp["layers"]["attn"])
    want = jax_attention.prefill_attention(jcfg, JST, lp, x, jnp.asarray(pos))
    got = attention.prefill_attention(cfg, ST, layers.layer_slice(p["layers"]["attn"], 1),
                                      _to_torch(x, dtype), torch.from_numpy(pos))
    for g, w in zip(got, want):  # output, k, v: a few contractions deep
        assert_close(g, w, "f32_chain" if dtype == "float32" else "bf16_round")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype):
    jcfg, cfg, jp, p = _params(dtype)
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 40))
    want, _ = jax.jit(lambda p, t: jax_transformer.forward(jcfg, JST, p, t))(
        jp, jnp.asarray(tokens, jnp.int32))
    got, aux = transformer.forward(cfg, ST, p, torch.from_numpy(tokens))
    assert got.dtype == TORCH_DTYPE[dtype] and float(aux) == 0.0
    assert_close(got, want, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_reference(dtype):
    jcfg, cfg, jp, p = _params(dtype)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 5))
    shapes = api.cache_shapes(cfg, ST, 2, 16)
    assert shapes == jax_api.cache_shapes(jcfg, JST, 2, 16)
    jcache = {k: jnp.zeros(v, jnp.bfloat16) for k, v in shapes.items()}
    cache = {k: torch.zeros(v, dtype=torch.bfloat16) for k, v in shapes.items()}
    step = jax.jit(lambda p, t, c, pos: jax_api.decode_step(jcfg, JST, p, t, c, pos))
    for pos in range(5):
        tok = tokens[:, pos:pos + 1]
        want, jcache = step(jp, jnp.asarray(tok, jnp.int32), jcache, pos)
        got, cache = api.decode_step(cfg, ST, p, torch.from_numpy(tok), cache, pos)
        assert_close(got, want, MODEL_TOL[dtype], err_msg=f"logits at pos {pos}")
        for name in ("k", "v"):  # the cache is bf16 for every model dtype
            assert cache[name].dtype == torch.bfloat16
            assert_close(cache[name], jcache[name], "bf16_round", err_msg=f"cache {name} at {pos}")


def test_params_from_numpy_checks_names_and_shapes():
    jcfg, cfg = _cfgs("float32")
    np_tree = jax.tree_util.tree_map(
        np.asarray, jax_layers.tree_init(jax_api.param_tree(jcfg, JST), jax.random.PRNGKey(1)))
    p = params_from_numpy(np_tree, cfg, "cpu")
    assert p["layers"]["attn"]["wq"].dtype == torch.float32
    np.testing.assert_array_equal(p["layers"]["mlp"]["wo"].numpy(), np_tree["layers"]["mlp"]["wo"])
    bf = params_from_numpy(np_tree, cfg.with_(dtype="bfloat16"), "cpu")
    assert bf["embed"]["embedding"].dtype == torch.bfloat16
    assert bf["final_ln"].dtype == torch.float32  # norm scales stay float32
    np_tree["layers"]["attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy(np_tree, cfg, "cpu")
    del np_tree["layers"]["attn"]["extra"]
    np_tree["final_ln"] = np_tree["final_ln"][:-1]
    with pytest.raises(ValueError, match="final_ln"):
        params_from_numpy(np_tree, cfg, "cpu")


@pytest.mark.parametrize("arch,item", [("granite-moe-1b-a400m", "A12"), ("whisper-base", "A12")])
def test_unported_families_raise(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        api.param_tree(get_config(arch), ST)
