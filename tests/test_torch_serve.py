"""The port's serving path against the JAX package's, and the port's ground
rules: no JAX in it, no kernel launches on the CPU, no silent CPU fallback."""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.launch.train import reduced_config as jax_reduced_config
from repro.models import api as jax_api
from repro.models.layers import tree_init as jax_tree_init
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs.base import get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import TOLERANCES, assert_close
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve.engine import Engine, Request

ROOT = pathlib.Path(__file__).resolve().parents[1]
_TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _recorded(engine):
    """Record the logits each decode step hands to the sampler."""
    seen, sample = [], engine._sample

    def record(logits, temperature):
        if isinstance(logits, torch.Tensor):
            seen.append(logits.float().numpy())
        else:
            seen.append(np.asarray(logits.astype(jnp.float32)))
        return sample(logits, temperature)

    engine._sample = record
    return seen


def _serve_both(dtype, arch="qwen1.5-0.5b", reduce=32):
    """test_system's serve setting: 2 slots, max_len 32, 3 requests of 4 new
    tokens, prompts as launch/serve.py makes them.  Mamba2's reference
    engine runs its decode step op by op: compiled as one program its
    bfloat16 stack rounds otherwise (ROADMAP R6, tests/test_torch_ssm.py)."""
    jcfg = jax_reduced_config(jax_get_config(arch), reduce).with_(dtype=dtype)
    cfg = reduced_config(get_config(arch), reduce).with_(dtype=dtype)
    jst, st = jax_get_strategy("2d_finalized"), get_strategy("2d_finalized")
    jp = jax_tree_init(jax_api.param_tree(jcfg, jst), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(4)] for i in range(3)]
    jeng = JaxEngine(jcfg, jst, jp, batch_slots=2, max_len=32)
    if cfg.family == "ssm":
        jeng._decode = lambda p, t, c, pos: jax_api.decode_step(jcfg, jst, p, t, c, pos)
    eng = Engine(cfg, st, params, batch_slots=2, max_len=32)
    jseen, seen = _recorded(jeng), _recorded(eng)
    jreqs = jeng.generate([JaxRequest(prompt=p, max_new_tokens=4) for p in prompts])
    reqs = eng.generate([Request(prompt=p, max_new_tokens=4) for p in prompts])
    assert eng.pos == jeng.pos and len(seen) == len(jseen)
    for name, c in eng.cache.items():  # the reference's cache dtypes, finite
        assert c.dtype == _TORCH_DTYPE[str(jeng.cache[name].dtype)], name
        assert bool(torch.isfinite(c).all()), name
    return jreqs, reqs, jseen, seen


def _check_float32(jreqs, reqs, jseen, seen, tol):
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert all(len(r.out) == 4 and r.done for r in reqs)
    for step, (got, want) in enumerate(zip(seen, jseen)):
        assert_close(got, want, tol, err_msg=f"step {step}")


def _check_bfloat16(jreqs, reqs, jseen, seen):
    """Greedy tokens agree wherever the reference's top-2 margin is wider
    than the logits' tolerance; after a near-tie the streams may part."""
    rtol, atol = TOLERANCES["bf16_chain"]
    for step, (got, want) in enumerate(zip(seen, jseen)):
        assert_close(got, want, "bf16_chain", err_msg=f"step {step}")
        top2 = np.sort(want[:, -1], axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        differs = got[:, -1].argmax(-1) != want[:, -1].argmax(-1)
        assert not np.any(differs & (margin > 2 * (atol + rtol * np.abs(top2[:, 1])))), step
        if differs.any():
            return
    assert [r.out for r in reqs] == [r.out for r in jreqs]


def test_engine_matches_reference_float32():
    _check_float32(*_serve_both("float32"), "f32_chain")


def test_engine_matches_reference_bfloat16():
    _check_bfloat16(*_serve_both("bfloat16"))


def test_engine_matches_reference_mamba2_float32():
    """reduced_config(mamba2-130m, 8); the state {"s": f32, "conv": bf16}
    becomes {"s": f32, "conv": f32} after the first step, as in the
    reference.  Logits: the float32 Mamba2 class of tests/test_torch_ssm.py."""
    _check_float32(*_serve_both("float32", "mamba2-130m", 8), "coarse")


def test_engine_matches_reference_mamba2_bfloat16():
    _check_bfloat16(*_serve_both("bfloat16", "mamba2-130m", 8))


def test_serve_main_on_cpu_launches_no_kernel():
    fa.launches = 0
    reqs = serve_main(["--arch", "qwen1.5-0.5b", "--reduce", "32", "--slots", "2",
                       "--max-len", "32", "--new-tokens", "4", "--requests", "3",
                       "--device", "cpu"])
    assert all(len(r.out) == 4 for r in reqs)
    assert fa.launches == 0


def test_serve_main_mamba2_on_cpu_launches_no_kernel():
    ssd_kernel.launches = 0
    reqs = serve_main(["--arch", "mamba2-130m", "--reduce", "8", "--slots", "2",
                       "--max-len", "32", "--new-tokens", "4", "--requests", "3",
                       "--device", "cpu"])
    assert all(len(r.out) == 4 for r in reqs)
    assert ssd_kernel.launches == 0


def test_serve_main_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        serve_main(["--reduce", "32", "--device", "cuda"])


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path.relative_to(ROOT)} imports {mod}"


def test_temperature_sampling_is_seeded_and_in_vocab():
    """Gumbel-max sampling draws from the engine's torch.Generator: the same
    seed gives the same tokens (jax.random's bits are not reproduced)."""
    cfg = reduced_config(get_config("qwen1.5-0.5b"), 32).with_(dtype="float32")
    st = get_strategy("2d_finalized")
    jp = jax_tree_init(jax_api.param_tree(
        jax_reduced_config(jax_get_config("qwen1.5-0.5b"), 32), jax_get_strategy("2d_finalized")),
        jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")

    def run(seed):
        eng = Engine(cfg, st, params, batch_slots=2, max_len=16,
                     rng=torch.Generator().manual_seed(seed))
        reqs = [Request(prompt=[1, 2, 3], max_new_tokens=5, temperature=1.0) for _ in range(2)]
        return [r.out for r in eng.generate(reqs)]

    outs = run(3)
    assert outs == run(3)
    assert all(len(o) == 5 and all(0 <= t < cfg.vocab_size for t in o) for o in outs)
