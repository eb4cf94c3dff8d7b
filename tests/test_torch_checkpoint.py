"""Checkpoints of the port against the JAX package's: the cases of
tests/test_checkpoint.py (and the checkpoint cases of test_train_infra.py and
test_guard.py) on the port, where the reference's runtime mesh becomes a
simulated ("data" 2, "model" 4) mesh; the on-disk format byte for byte in
both directions; ``compile_state_reshard`` and ``verify_state_reshard``
against the reference's on the reduced qwen state's specs; the train loop's
crash and restart (exact in the port, from a checkpoint either package
wrote); a partitioned save restored onto another mesh and trained on; and
``launch.train.main`` with ``--ckpt-dir``.

The reference cannot read back a bfloat16 leaf it wrote (ROADMAP R12): its
``np.load`` gives 2-byte voids that its restore cannot cast and its verify
calls a dtype mismatch.  The port writes the same bytes and reads them by
the manifest's dtype; the bfloat16 parity is held on the files and through
the port."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.roofline import RooflineParams as JRooflineParams
from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_strategy as jax_get_strategy
from repro.configs.registry import get_config as jax_get_config
from repro.core.sharding import Mesh as JMesh
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.launch.elastic import specs_by_key as jax_specs_by_key
from repro.launch.elastic import state_partition_specs as jax_state_partition_specs
from repro.launch.train import reduced_config as jax_reduced_config
from repro.train import checkpoint as jck
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.compat import assert_close, set_mesh
from repro_torch.core.plan import compile_state_reshard
from repro_torch.core.plan_verify import PlanVerifyError, verify_state_reshard
from repro_torch.core.sharding import Mesh, mesh_split, project_dims_mapping, replicated
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import elastic
from repro_torch.launch import train as launch_train
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import TrainConfig, TrainLoop
from repro_torch.train.optimizer import get_optimizer

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ST, JST = get_strategy("2d_finalized"), jax_get_strategy("2d_finalized")
MESH = Mesh.create((2, 4), ("data", "model"))
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
            d_ff=64, vocab_size=128, attn_chunk=16, remat="none", dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The file's tiny models train fastest on one thread, and stay so when
    the suite's workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state():
    """The reference tests' STATE in the port's form: tensors and an int
    step."""
    return {"params": {"w": torch.arange(32.0).reshape(4, 8), "b": torch.ones(8)}, "step": 3}


def _equal(a, b):
    assert [k for k, _ in leaves_with_paths(a)] == [k for k, _ in leaves_with_paths(b)]
    for (path, x), y in zip(leaves_with_paths(a), leaves(b)):
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor) and x.dtype == y.dtype, path
            assert torch.equal(x, y), path
        else:
            assert x == y and type(x) is type(y), path


def _corrupt_leaf(d, step, fname="params__w.npy"):
    path = os.path.join(d, f"step_{step:08d}", fname)
    arr = np.load(path)
    arr.flat[0] += 1.0
    np.save(path, arr)


# ---------------------------------------------------------------------------------
# tests/test_checkpoint.py's cases on the port
# ---------------------------------------------------------------------------------


def test_roundtrip_and_manifest_contents(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 3, _state(), extra={"data_cursor": 3})
    restored, manifest = ckpt.restore(d, _state())
    _equal(restored, _state())
    assert manifest["format"] == ckpt.FORMAT == jck.FORMAT
    assert manifest["extra"]["data_cursor"] == 3
    by_key = {l["key"]: l for l in manifest["leaves"]}
    assert set(by_key) == {"params/w", "params/b", "step"}
    assert by_key["step"]["dtype"] == "int32" and by_key["step"]["shape"] == []
    for l in manifest["leaves"]:
        assert l["checksum"].startswith("crc32:")
    assert manifest["restore_report"]["missing"] == []


def test_manifest_records_partition_specs(tmp_path):
    specs = {"params/w": mesh_split(2, MESH, ["data", "model"])}
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state(), specs=specs)
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        man = json.load(f)
    by_key = {l["key"]: l for l in man["leaves"]}
    assert by_key["params/w"]["spec"] == [["data"], ["model"]]
    assert by_key["params/b"]["spec"] is None
    assert man["mesh"] == {"shape": [2, 4], "axes": ["data", "model"]}


def test_atomic_save_crash_leaves_latest_intact(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())

    def boom(i, key):
        if i >= 1:
            raise OSError("injected crash mid-save")

    ckpt.set_save_fault(boom)
    try:
        with pytest.raises(OSError, match="injected crash"):
            ckpt.save(d, 2, _state())
    finally:
        ckpt.set_save_fault(None)
    assert ckpt.latest_step(d) == 1
    assert any(x.startswith(".tmp-") for x in os.listdir(d))
    _, manifest = ckpt.restore(d, _state())
    assert manifest["step"] == 1
    ckpt.cleanup(d, keep=3, remove_tmp=True)
    assert not any(x.startswith(".tmp-") for x in os.listdir(d))
    assert ckpt.latest_step(d) == 1


def test_cleanup_keeps_newest_n(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4, 5):
        ckpt.save(d, s, _state())
    ckpt.cleanup(d, keep=2)
    assert ckpt.intact_steps(d) == [4, 5]


def test_corruption_raises_typed_error(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    _corrupt_leaf(d, 1)
    with pytest.raises(ckpt.CheckpointCorruptError, match="params/w") as ei:
        ckpt.restore(d, _state(), step=1)
    assert ei.value.step == 1 and ei.value.key == "params/w"
    restored, _ = ckpt.restore(d, _state(), step=1, verify=False)
    assert float(restored["params"]["w"].flatten()[0]) == 1.0


def test_corruption_falls_back_to_previous_intact_step(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    ckpt.save(d, 2, _state())
    _corrupt_leaf(d, 2)
    _, manifest = ckpt.restore(d, _state())
    assert manifest["step"] == 1
    assert manifest["restore_report"]["fell_back_from"] == [2]
    with open(os.path.join(d, "step_00000002", "manifest.json"), "w") as f:
        f.write("{not json")
    _, manifest = ckpt.restore(d, _state())
    assert manifest["step"] == 1


def test_missing_leaf_keyerror_context_and_strict_false(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    target = _state()
    target["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError) as ei:
        ckpt.restore(d, target, step=1)
    msg = str(ei.value)
    assert "params/extra" in msg and "step 1" in msg and "params/w" in msg
    restored, manifest = ckpt.restore(d, target, step=1, strict=False)
    assert manifest["restore_report"]["missing"] == ["params/extra"]
    assert torch.equal(restored["params"]["extra"], torch.zeros(2))
    # a meta (abstract) target's missing leaf materializes as zeros
    meta = _state()
    meta["params"]["extra"] = torch.empty(2, device="meta")
    restored, _ = ckpt.restore(d, meta, step=1, strict=False)
    assert torch.equal(restored["params"]["extra"], torch.zeros(2))
    _, manifest = ckpt.restore(d, {"step": 3}, step=1, strict=False)
    assert sorted(manifest["restore_report"]["unused"]) == ["params/b", "params/w"]


def test_transient_io_errors_are_retried(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    monkeypatch.setattr(ckpt, "_IO_BACKOFF_S", 0.001)
    real_load = np.load
    fails = {"n": 2}

    def flaky(path, *a, **kw):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")
        return real_load(path, *a, **kw)

    monkeypatch.setattr(np, "load", flaky)
    _, manifest = ckpt.restore(d, _state(), step=1)
    assert manifest["step"] == 1 and fails["n"] == 0


def test_state_reshard_plan_pure_planning():
    """Planning a mesh-shrink restore needs no tensors: (2,4) specs project
    onto (2,2) and the plan is priced against gather-all.  ``reshard_s`` is
    priced only under an explicit profile (the port has no default
    constants: ROADMAP, known divergences)."""
    new = Mesh.create((2, 2), ("data", "model"))
    shape = (16, 32)
    src = project_dims_mapping(new, (("data",), ("model",)), shape)
    dst = mesh_split(2, new, [-1, "model"])
    items = [("w", src, dst, shape, "float32"),
             ("b", replicated(new, 1), replicated(new, 1), (32,), "float32")]
    rep = compile_state_reshard(items, new).report()
    assert rep["leaves"] == 2 and rep["resharded_leaves"] == 1
    assert rep["wire_bytes"] > 0 and rep["reshard_s"] is None
    assert rep["ratio_vs_gather_all"] <= 1.0 + 1e-9
    profile = RooflineParams(**dataclasses.asdict(JRooflineParams()))
    priced = compile_state_reshard(items, new, profile=profile).report()
    assert priced["reshard_s"] > 0 and priced["wire_bytes"] == rep["wire_bytes"]


def test_restore_resharded_onto_a_simulated_mesh(tmp_path):
    """restore_resharded on the (2,4) mesh: values identical to the plain
    restore, the step back as an int, the report populated."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state(), specs={"params/w": mesh_split(2, MESH, ["data", "model"])})
    restored, manifest, report = ckpt.restore_resharded(
        d, _state(), MESH, target_specs={"params/w": (("model",), ("data",))})
    _equal(restored, _state())
    assert report["leaves"] == 3 and report["step"] == 1 and report["resharded_leaves"] == 1
    assert manifest["restore_report"] is report


def test_restore_resharded_fallback_and_strict(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    ckpt.save(d, 2, _state())
    _corrupt_leaf(d, 2)
    _, _, report = ckpt.restore_resharded(d, _state(), MESH)
    assert report["step"] == 1 and report["fell_back_from"] == [2]
    target = _state()
    target["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        ckpt.restore_resharded(d, target, MESH, step=1)
    _, _, report = ckpt.restore_resharded(d, target, MESH, step=1, strict=False)
    assert report["missing"] == ["params/extra"]


def test_read_npy_slice_matches_numpy(tmp_path):
    for arr in (np.arange(4 * 6 * 8, dtype=np.float32).reshape(4, 6, 8),
                np.arange(12, dtype=np.int32).reshape(3, 4),
                np.arange(7, dtype=np.float64),
                np.asarray(5.0, np.float32)):
        p = str(tmp_path / "a.npy")
        np.save(p, arr)
        idx = tuple(slice(0, max(n // 2, 1)) for n in arr.shape)
        stats = {}
        got = ckpt.read_npy_slice(p, idx, stats=stats)
        np.testing.assert_array_equal(got, arr[idx] if arr.ndim else arr)
        np.testing.assert_array_equal(got, jck.read_npy_slice(p, idx))
        if arr.ndim:
            assert stats["bytes_read"] == got.nbytes
            assert stats["bytes_read"] < arr.nbytes or got.nbytes == arr.nbytes


def test_transposed_leaf_saves_in_c_order_for_sliced_reads(tmp_path):
    """A leaf whose tensor is a transpose (Adafactor's factored moments can
    be) is written in C order, as the reference writes every leaf, so that
    a sliced read takes it: saved in Fortran order it made a restore with
    sliced reads fall back past every step that held it."""
    d = str(tmp_path / "ck")
    w = torch.arange(12.0).reshape(3, 4).t()
    ckpt.save(d, 1, {"w": w})
    path = os.path.join(d, "step_00000001", "w.npy")
    assert not ckpt._npy_header(path)[2]  # fortran_order
    np.testing.assert_array_equal(ckpt.read_npy_slice(path, (slice(1, 3), slice(0, 3))),
                                  w[1:3, 0:3].numpy())
    mesh = Mesh.create((1, 2), ("data", "model"))
    tree, _, rep = ckpt.restore_resharded(d, {"w": torch.empty(4, 3, device="meta")}, mesh,
                                          {"w": (None, "model")}, sharded_io=True, device="cpu")
    assert rep["fell_back_from"] == [] and torch.equal(tree["w"], w)


def test_read_npy_slice_detects_torn_write_and_header_mismatch(tmp_path):
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    p = str(tmp_path / "a.npy")
    np.save(p, arr)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 8)
    with pytest.raises(ValueError, match="torn write"):
        ckpt.read_npy_slice(p, (slice(0, 2), slice(0, 6)))
    np.save(p, arr)
    with pytest.raises(ValueError, match="shape"):
        ckpt.read_npy_slice(p, (slice(0, 2), slice(0, 6)),
                            expected={"shape": [8, 6], "dtype": "float32"})
    with pytest.raises(ValueError, match="dtype"):
        ckpt.read_npy_slice(p, (slice(0, 2), slice(0, 6)),
                            expected={"shape": [4, 6], "dtype": "bfloat16"})


def test_restore_resharded_sharded_io_bit_identical(tmp_path):
    """sharded_io restores what the full read restores; every simulated
    device's tile is a byte-range read and each distinct tile is read once,
    so the bytes read equal the checkpoint's."""
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state(), specs={"params/w": mesh_split(2, MESH, ["data", "model"])})
    full, _, _ = ckpt.restore_resharded(d, _state(), MESH)
    shard, _, report = ckpt.restore_resharded(d, _state(), MESH, sharded_io=True)
    _equal(shard, full)
    _equal(shard, _state())
    assert report["sharded_io"] is True
    io = report["io"]
    assert io["leaves"] == 3 and io["reads"] >= 3
    assert io["bytes_read"] == io["full_bytes"]
    assert io["unique_slices"] == 8 + 1 + 1  # w's eight tiles, b and step once


def test_sharded_io_corruption_falls_back_like_full_read(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    ckpt.save(d, 2, _state())
    _corrupt_leaf(d, 2)
    _, _, report = ckpt.restore_resharded(d, _state(), MESH, sharded_io=True)
    assert report["step"] == 1 and report["fell_back_from"] == [2]
    assert report["sharded_io"] is True


def test_sharded_io_transient_errors_retried(tmp_path, monkeypatch):
    arr = np.arange(24, dtype=np.float32).reshape(4, 6)
    p = str(tmp_path / "a.npy")
    np.save(p, arr)
    monkeypatch.setattr(ckpt, "_IO_BACKOFF_S", 0.001)
    import builtins

    real_open = builtins.open
    fails = {"n": 2}

    def flaky(path, mode="r", *a, **kw):
        if str(path) == p and "b" in mode and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient")
        return real_open(path, mode, *a, **kw)

    monkeypatch.setattr(builtins, "open", flaky)
    got = ckpt.read_npy_slice(p, (slice(0, 2), slice(0, 6)))
    np.testing.assert_array_equal(got, arr[:2])
    assert fails["n"] == 0


def test_fuzz_truncated_leaf_is_typed_and_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    ckpt.save(d, 2, _state())
    p = os.path.join(d, "step_00000002", "params__w.npy")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(d, _state(), step=2)
    _, manifest = ckpt.restore(d, _state())
    assert manifest["step"] == 1
    _, _, report = ckpt.restore_resharded(d, _state(), MESH, sharded_io=True)
    assert report["step"] == 1 and report["fell_back_from"] == [2]


def test_fuzz_manifest_self_checksum_catches_stale_edit(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    ckpt.save(d, 2, _state())
    p = os.path.join(d, "step_00000002", "manifest.json")
    with open(p, "r+b") as f:
        data = bytearray(f.read())
        data[len(data) // 2] ^= 0xFF
        f.seek(0)
        f.write(bytes(data))
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(d, _state(), step=2)
    _, manifest = ckpt.restore(d, _state())
    assert manifest["step"] == 1
    assert not ckpt.verify_step(d, 2)["ok"]
    assert ckpt.verify_step(d, 1)["ok"]


def test_fuzz_torn_tmp_rename_is_invisible(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, _state())
    tmp = os.path.join(d, ".tmp-step_00000002-zzz")
    os.makedirs(tmp)
    with open(os.path.join(tmp, "params__w.npy"), "wb") as f:
        f.write(b"\x93NUMPY garbage")
    assert ckpt.intact_steps(d) == [1]
    _, manifest = ckpt.restore(d, _state())
    assert manifest["step"] == 1
    ckpt.cleanup(d, keep=3, remove_tmp=True)
    assert not os.path.exists(tmp)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.train.checkpoint", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT)


def test_verify_cli_exit_codes(tmp_path):
    """The CLI imports no torch (it runs on a storage host)."""
    d = str(tmp_path / "ck")
    assert _cli().returncode == 2                  # usage
    assert _cli("verify", d).returncode == 1       # empty dir
    ckpt.save(d, 1, _state())
    r = _cli("verify", d)
    assert r.returncode == 0 and "step 1: ok (3 leaves)" in r.stdout
    _corrupt_leaf(d, 1)
    assert _cli("verify", d).returncode == 1       # corrupt
    assert _cli("verify", d, "--step", "1").returncode == 1
    code = ("import sys, repro_torch.train.checkpoint as c; "
            "sys.exit(c._cli(sys.argv[1:]) + 10 * ('torch' in sys.modules))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    assert subprocess.run([sys.executable, "-c", code, "verify", d], env=env,
                          capture_output=True).returncode == 1


def test_cleanup_never_drops_newest_verified_step(tmp_path):
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, _state())
    _corrupt_leaf(d, 3)
    _corrupt_leaf(d, 4)
    ckpt.cleanup(d, keep=2)
    assert ckpt.intact_steps(d) == [2, 3, 4]
    assert ckpt.verify_step(d, 2)["ok"]
    for s in (5, 6):
        ckpt.save(d, s, _state())
    _corrupt_leaf(d, 5)
    _corrupt_leaf(d, 6)
    ckpt.cleanup(d, keep=2, protect_verified=False)
    assert ckpt.intact_steps(d) == [5, 6]


# -- test_train_infra.py:62 and test_guard.py:225-277 ---------------------------------


def _two_steps(d):
    state = {"a": torch.arange(6.0).reshape(2, 3), "n": {"b": torch.ones(4, dtype=torch.int32)}}
    ckpt.save(d, 5, state, extra={"data_cursor": 6})
    ckpt.save(d, 7, state)
    return state


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    state = _two_steps(d)
    restored, manifest = ckpt.restore(d, state, step=5)
    _equal(restored, state)
    assert manifest["step"] == 5 and ckpt.latest_step(d) == 7
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    ckpt.cleanup(d, keep=1)
    assert ckpt.latest_step(d) == 7
    assert len([f for f in os.listdir(d) if f.startswith("step_")]) == 1


def test_manifest_self_checksum_detects_edit_and_verify_api(tmp_path):
    d = str(tmp_path / "ck")
    state = _two_steps(d)
    rep = ckpt.verify_dir(d)
    assert rep["ok"] and [r["step"] for r in rep["steps"]] == [5, 7]
    assert all(r["leaves"] == 2 for r in rep["steps"])
    mp = os.path.join(d, "step_00000007", "manifest.json")
    m = json.load(open(mp))
    m["step"] = 999
    json.dump(m, open(mp, "w"))
    with pytest.raises(ckpt.CheckpointCorruptError, match="self-checksum"):
        ckpt._load_manifest(d, 7)
    _, manifest = ckpt.restore(d, state)
    assert manifest["step"] == 5 and manifest["restore_report"]["fell_back_from"] == [7]
    p = os.path.join(d, "step_00000005", "a.npy")
    arr = np.load(p)
    arr[0, 0] += 1
    np.save(p, arr)
    r = _cli("verify", d)
    assert r.returncode == 1 and "CORRUPT" in r.stdout and "leaf 'a'" in r.stdout


# ---------------------------------------------------------------------------------
# the format, byte for byte, in both directions
# ---------------------------------------------------------------------------------


def _format_states(bf16=True):
    """One state in both packages' forms: float32, int32, a 0-d step and a
    bfloat16 leaf (bf16-representable values), from numpy with a seed."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    idx = rng.integers(0, 100, (3, 5)).astype(np.int32)
    h = np.array(jnp.asarray(rng.standard_normal((6, 4)).astype(np.float32),
                             jnp.bfloat16).astype(jnp.float32))
    jstate = {"params": {"w": jnp.asarray(w)}, "idx": jnp.asarray(idx),
              "step": jnp.asarray(3, jnp.int32)}
    state = {"params": {"w": torch.from_numpy(w)}, "idx": torch.from_numpy(idx), "step": 3}
    if bf16:
        jstate["params"]["h"] = jnp.asarray(h, jnp.bfloat16)
        state["params"]["h"] = torch.from_numpy(h).bfloat16()
    return jstate, state


def test_both_packages_write_the_same_bytes(tmp_path):
    """With time.time pinned, the reference's and the port's step
    directories are equal file for file, manifest and checksum included,
    bfloat16 leaf (header '<V2') included."""
    jstate, state = _format_states()
    jd, d = str(tmp_path / "jax"), str(tmp_path / "port")
    jspecs = {"params/w": ("data", "model")}
    with unittest.mock.patch("time.time", lambda: 1234.5):
        jck.save(jd, 3, jstate, extra={"data_cursor": 3}, specs=jspecs)
        ckpt.save(d, 3, state, extra={"data_cursor": 3}, specs=jspecs)
    a, b = os.path.join(jd, "step_00000003"), os.path.join(d, "step_00000003")
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        with open(os.path.join(a, f), "rb") as fa, open(os.path.join(b, f), "rb") as fb:
            assert fa.read() == fb.read(), f
    with open(os.path.join(b, "params__h.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    assert json.load(open(os.path.join(b, "manifest.json"))) == jck._load_manifest(jd, 3)


def test_reference_checkpoint_restores_bit_identically_in_the_port(tmp_path):
    """A reference-written step (bfloat16 leaf included) through the port's
    restore, restore_resharded (full and sliced reads) and verify CLI."""
    jstate, state = _format_states()
    d = str(tmp_path / "jax")
    jck.save(d, 3, jstate, specs={"params/w": ("data", "model")})
    got, _ = ckpt.restore(d, state)
    _equal(got, state)
    for sharded_io in (False, True):
        got, _, report = ckpt.restore_resharded(d, state, MESH, sharded_io=sharded_io,
                                                target_specs={"params/w": ("model", "data")})
        _equal(got, state)
        assert report["resharded_leaves"] == 1
    r = _cli("verify", d)
    assert r.returncode == 0, r.stdout


def test_port_checkpoint_restores_bit_identically_in_the_reference(tmp_path):
    """A port-written step through the reference's restore and verify_dir;
    the bfloat16 leaf fails in the reference exactly as the reference's own
    does (R12), on files equal to its own."""
    jstate, state = _format_states(bf16=False)
    d = str(tmp_path / "port")
    ckpt.save(d, 3, state)
    got, _ = jck.restore(d, jstate)
    for (k, a), b in zip(jck._flatten_with_paths(got)[0], jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b)), k
    assert jck.verify_dir(d)["ok"]
    jb, b = _format_states()
    ckpt.save(str(tmp_path / "p16"), 3, b)
    jck.save(str(tmp_path / "j16"), 3, jb)
    for dd in (str(tmp_path / "p16"), str(tmp_path / "j16")):
        errors = jck.verify_dir(dd)["steps"][0]["errors"]
        assert errors == ["leaf 'params/h': dtype |V2 != recorded bfloat16"]
        with pytest.raises(ValueError, match="No cast function"):
            jck.restore(dd, jb)
    assert ckpt.verify_dir(str(tmp_path / "j16"))["ok"]


# ---------------------------------------------------------------------------------
# the state-reshard plan against the reference's
# ---------------------------------------------------------------------------------


def _reduced_qwen():
    return (jax_reduced_config(jax_get_config("qwen1.5-0.5b"), 16),
            reduced_config(get_config("qwen1.5-0.5b"), 16))


def _saved_manifest(cfg, opt, tc, mesh):
    """The manifest's leaf table of a state saved under ``mesh``, from
    shapes alone (meta tensors): each leaf's spec as the loop records it."""
    from repro_torch.models import api
    from repro_torch.models.layers import tree_shapes
    from repro_torch.train.loop import checkpoint_specs

    shapes = tree_shapes(api.param_tree(cfg, ST), cfg.param_dtype)
    state = {"params": shapes, "opt": opt.init(shapes), "step": 0}
    specs = checkpoint_specs(cfg, ST, opt, tc, state, mesh)
    return {"leaves": [
        {"key": k, "shape": list(getattr(v, "shape", ())),
         "dtype": "int32" if isinstance(v, int) else str(v.dtype).replace("torch.", ""),
         "spec": [list(a) for a in specs[k].dims_mapping]}
        for k, v in ckpt._flatten_with_paths(state)]}


def _program(prog):
    return [(s.op, s.axis, s.dim, s.dim2) for s in prog.steps], prog.cost_bytes


def test_state_partition_specs_match_reference():
    jcfg, cfg = _reduced_qwen()
    for name, compress in (("adafactor", False), ("adamw", True), ("sgd", False)):
        want = jax_specs_by_key(jax_state_partition_specs(
            jcfg, JST, jax_get_optimizer(name), JaxTrainConfig(compress_grads=compress)))
        got = elastic.specs_by_key(elastic.state_partition_specs(
            cfg, ST, get_optimizer(name), TrainConfig(compress_grads=compress)))
        assert set(got) == set(want), name
        for k in want:
            assert ckpt._dims_mapping(got[k], 4) == ckpt._dims_mapping(tuple(want[k]), 4), k
    assert elastic.derive_mesh(4, 4).shape == (1, 4)
    assert elastic.derive_mesh(8, 3).shape == (4, 2)
    assert elastic.derive_mesh(6).shape == (1, 6)


@pytest.mark.parametrize("new_shape", [(4, 2), (1, 4), (2, 2)])
def test_compile_state_reshard_matches_reference(new_shape):
    """The reduced qwen state saved on (2,4), planned onto another mesh by
    both packages from the same manifest, onto the state's own specs and
    onto a replicated target: the same program per leaf, the same report
    under one pinned RooflineParams, both verified.  Named axes keep their
    meaning on the new mesh, so the state's own specs move only leaves whose
    axis (2,4) had dropped; the replicated target gathers every sharded
    leaf."""
    jcfg, cfg = _reduced_qwen()
    opt = get_optimizer("adafactor")
    manifest = _saved_manifest(cfg, opt, TrainConfig(), MESH)
    mesh, jmesh = Mesh.create(new_shape, ("data", "model")), JMesh.create(new_shape,
                                                                          ("data", "model"))
    specs = elastic.specs_by_key(elastic.state_partition_specs(cfg, ST, opt, TrainConfig()))
    jspecs = jax_specs_by_key(jax_state_partition_specs(jcfg, JST, jax_get_optimizer("adafactor"),
                                                        JaxTrainConfig()))
    keys = [(l["key"], None) for l in manifest["leaves"]]
    profile = RooflineParams(**dataclasses.asdict(JRooflineParams()))
    for own in (True, False):
        plan = ckpt.plan_restore_reshard(manifest, keys, mesh, specs if own else None,
                                         profile=profile)
        jplan = jck.plan_restore_reshard(manifest, keys, jmesh, jspecs if own else None)
        assert [l.key for l in plan.leaves] == [l.key for l in jplan.leaves]
        for a, b in zip(plan.leaves, jplan.leaves):
            assert a.src.dims_mapping == b.src.dims_mapping
            assert a.dst.dims_mapping == b.dst.dims_mapping
            assert _program(a.program) == _program(b.program), a.key
        assert plan.report() == jplan.report()
        assert plan.report()["ratio_vs_gather_all"] <= 1.0
        assert verify_state_reshard(plan).ok and verify_state_reshard(plan).steps == len(keys)
        if not own:
            assert plan.resharded_leaves == sum(1 for l in manifest["leaves"] if any(l["spec"]))


def test_verify_state_reshard_rejects_seeded_mutations():
    _, cfg = _reduced_qwen()
    opt = get_optimizer("adafactor")
    manifest = _saved_manifest(cfg, opt, TrainConfig(), MESH)
    mesh = Mesh.create((4, 2), ("data", "model"))
    specs = elastic.specs_by_key(elastic.state_partition_specs(cfg, ST, opt, TrainConfig()))
    keys = [(l["key"], None) for l in manifest["leaves"]]
    rng = np.random.default_rng(3)
    moved = [i for i, l in enumerate(ckpt.plan_restore_reshard(manifest, keys, mesh, specs).leaves)
             if not l.is_identity]
    for mutation in ("drop_step", "cost", "dst"):
        plan = ckpt.plan_restore_reshard(manifest, keys, mesh, specs)
        leaf = plan.leaves[moved[int(rng.integers(len(moved)))]]
        prog = leaf.program
        if mutation == "drop_step":
            leaf.program = dataclasses.replace(prog, steps=prog.steps[:-1])
        elif mutation == "cost":
            leaf.program = dataclasses.replace(prog, cost_bytes=prog.cost_bytes * 2 + 8)
        else:
            leaf.dst = replicated(mesh, len(leaf.global_shape))
        with pytest.raises(PlanVerifyError, match=leaf.key):
            verify_state_reshard(plan)
    # shardings on axes the plan's mesh lacks
    with pytest.raises(PlanVerifyError, match="not in mesh"):
        compile_state_reshard([("w", mesh_split(1, MESH, ["data"]), replicated(MESH, 1), (8,),
                                "float32")], Mesh.create((8,), ("x",)))


# ---------------------------------------------------------------------------------
# the train loop: crash and restart
# ---------------------------------------------------------------------------------


def _loop(cfg, d, steps, fail_at=-1, opt="adafactor", mesh=None, **tc_kw):
    """A TrainLoop saving every second step into ``d`` (None: no saves)."""
    tc = TrainConfig(steps=steps, ckpt_dir=None if d is None else str(d), ckpt_every=2,
                     fail_at_step=fail_at, log_every=1000, **tc_kw)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 16, 2, seed=7, pattern="arithmetic"))
    o = get_optimizer(opt, lr=0.05)
    if mesh is None:
        return TrainLoop(cfg, ST, o, tc, pipe, device="cpu")
    with set_mesh(mesh):
        return TrainLoop(cfg, ST, o, tc, pipe, device="cpu")


def _mamba():
    return reduced_config(get_config("mamba2-130m"), 8).with_(num_layers=2, dtype="float32")


@pytest.mark.parametrize("case", ["qwen", "mamba2", "compress_grads", "adamw"])
def test_checkpoint_restart_bitwise_resume(tmp_path, case):
    """test_train_infra.py's contract in the port: 8 steps, a crash at 5,
    a restart from the step-4 checkpoint: the resumed losses and the final
    state equal the uninterrupted run's bit for bit (the CPU's plain
    versions are deterministic).  Reduced qwen (2 layers, bf16 compute,
    remat "dots") and Mamba2; the error feedback and AdamW on the tiny
    float32 model."""
    cfg = {"qwen": reduced_config(get_config("qwen1.5-0.5b"), 16), "mamba2": _mamba()}.get(
        case, ModelConfig(**TINY))
    kw = {"compress_grads": True} if case == "compress_grads" else {}
    opt = "adamw" if case == "adamw" else "adafactor"
    ref_state, ref_losses = _loop(cfg, tmp_path / "ref", 8, opt=opt, **kw).run()
    with pytest.raises(RuntimeError, match="injected failure"):
        _loop(cfg, tmp_path / "ft", 8, fail_at=5, opt=opt, **kw).run()
    assert ckpt.intact_steps(str(tmp_path / "ft")) == [2, 4]
    logs = []
    resumed = _loop(cfg, tmp_path / "ft", 8, opt=opt, **kw)
    resumed.hooks["log"] = logs.append
    state, losses = resumed.run()
    assert logs[0] == "restored checkpoint step=4 cursor=4"
    assert losses == ref_losses[4:]
    _equal(state, ref_state)
    assert all(p.requires_grad for p in leaves(state["params"]))
    assert ("ef" in state) == (case == "compress_grads")
    final, manifest = ckpt.restore(str(tmp_path / "ft"), ref_state, step=8)
    _equal(final, ref_state)
    assert manifest["extra"] == {"data_cursor": 8}


def test_port_resumes_a_reference_checkpoint_as_the_reference_does(tmp_path):
    """The reference's TrainLoop writes steps 2 and 4; the port and the
    reference each restart from a copy of that directory and run steps 4-5:
    their losses within loss_curve, the checkpoints they write within
    f32_chain."""
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    data = dict(seed=7, pattern="arithmetic")
    jtc = lambda d, steps: JaxTrainConfig(steps=steps, ckpt_dir=str(d), ckpt_every=2,
                                          log_every=1000)
    jpipe = JaxTokenPipeline(JaxDataConfig(jcfg.vocab_size, 16, 4, **data))
    jloop = JaxTrainLoop(jcfg, JST, jax_get_optimizer("adafactor", lr=0.05),
                         jtc(tmp_path / "j", 4), jpipe, rng=jax.random.PRNGKey(0))
    jloop.run()
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    jloop.tc = jtc(tmp_path / "j", 6)  # the same jitted step restarts from step 4
    _, want = jloop.run()
    loop = TrainLoop(cfg, ST, get_optimizer("adafactor", lr=0.05),
                     TrainConfig(steps=6, ckpt_dir=str(tmp_path / "p"), ckpt_every=2,
                                 log_every=1000),
                     TokenPipeline(DataConfig(cfg.vocab_size, 16, 4, **data)), device="cpu")
    state, got = loop.run()
    assert len(got) == len(want) == 2
    assert_close(np.array(got), np.array(want), "loss_curve")
    jfinal = {l["key"]: np.load(os.path.join(tmp_path, "j", "step_00000006", l["file"]))
              for l in jck._load_manifest(str(tmp_path / "j"), 6)["leaves"]}
    for key, leaf in ckpt._flatten_with_paths(state):
        if isinstance(leaf, torch.Tensor):
            assert_close(leaf.detach(), jfinal[key], "f32_chain", err_msg=key)
    assert ckpt._load_manifest(str(tmp_path / "p"), 6)["extra"] == {"data_cursor": 6}


def test_guard_counters_ride_in_the_manifest(tmp_path):
    """test_guard.py:116's loop with a checkpoint directory: the NaN batch at
    step 4 is skipped, the skipped step's save happens, and the counters in
    the manifest come back into a restarted loop."""
    from repro_torch.core.plan import GuardConfig
    from repro_torch.train.loop import NumericFaultSpec

    cfg = ModelConfig(**TINY)
    kw = dict(guard=GuardConfig(rewind_after=3), numeric_fault=NumericFaultSpec(nan_at_step=3))
    loop = _loop(cfg, tmp_path / "ck", 6, **kw)
    state, losses = loop.run()
    assert len(losses) == 5 and np.all(np.isfinite(losses)) and loop.skipped_steps == [3]
    assert loop.guard_counters == {"faults": 1, "skips": 1, "rewinds": 0}
    for step in (4, 6):  # step 4 saved after the skipped step 3
        m = ckpt._load_manifest(str(tmp_path / "ck"), step)
        assert m["extra"] == {"data_cursor": step, "guard": {"faults": 1, "skips": 1,
                                                             "rewinds": 0}}
    for leaf in leaves(state["params"]):
        assert bool(torch.isfinite(leaf).all())
    again = _loop(cfg, tmp_path / "ck", 8, guard=GuardConfig(rewind_after=3))
    again.hooks["ckpt_extra"] = lambda: {"note": "resumed"}
    again.run()
    assert again.guard_counters == {"faults": 1, "skips": 1, "rewinds": 0}
    assert ckpt._load_manifest(str(tmp_path / "ck"), 8)["extra"]["note"] == "resumed"


# ---------------------------------------------------------------------------------
# partitioned: save on (2,4), restore onto (4,2), train on
# ---------------------------------------------------------------------------------


def test_partitioned_save_restores_onto_another_mesh_and_trains_on(tmp_path):
    """TrainLoop under set_mesh of (2,4) saves its state with each leaf's
    spec (the reference's state_partition_specs projected onto the mesh);
    restore_resharded onto (4,2) gives the saved state bit for bit, full and
    sliced reads; one more step under the (4,2) mesh equals the unsharded
    step from the same state within f32_chain."""
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    saved_loop = _loop(cfg, tmp_path / "ck", 2, mesh=MESH)
    with set_mesh(MESH):
        saved, _ = saved_loop.run()
    manifest = ckpt._load_manifest(str(tmp_path / "ck"), 2)
    assert manifest["mesh"] == {"shape": [2, 4], "axes": ["data", "model"]}
    jspecs = jax_specs_by_key(jax_state_partition_specs(
        jcfg, JST, jax_get_optimizer("adafactor"), JaxTrainConfig()))
    for leaf in manifest["leaves"]:
        want = project_dims_mapping(MESH, [tuple(a) for a in ckpt._dims_mapping(
            tuple(jspecs[leaf["key"]]), len(leaf["shape"]))], leaf["shape"])
        assert leaf["spec"] == [list(a) for a in want.dims_mapping], leaf["key"]
    new = Mesh.create((4, 2), ("data", "model"))
    opt = get_optimizer("adafactor", lr=0.05)
    specs = elastic.specs_by_key(elastic.state_partition_specs(cfg, ST, opt, TrainConfig()))
    target = tree_map(lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t, saved)
    keys = [(l["key"], None) for l in manifest["leaves"]]
    for target_specs in (specs, None):  # the state's own layout; all replicated
        predicted = ckpt.plan_restore_reshard(manifest, keys, new, target_specs).report()
        for sharded_io in (True, False):
            restored, _, report = ckpt.restore_resharded(str(tmp_path / "ck"), target, new,
                                                         target_specs, step=2,
                                                         sharded_io=sharded_io)
            _equal(restored, target)
            assert {k: report[k] for k in predicted} == predicted
            assert report["ratio_vs_gather_all"] <= 1.0
            assert not any(p.requires_grad for p in leaves(restored["params"]))
    # named axes keep their meaning on the new mesh: the state's own specs
    # need moves only where (2,4) had dropped an axis (4 heads on "model");
    # a replicated target gathers every sharded leaf
    assert predicted["resharded_leaves"] == sum(1 for l in manifest["leaves"]
                                                if any(l["spec"]))
    plain, _ = ckpt.restore(str(tmp_path / "ck"), target, step=2)
    for p in leaves(plain["params"]):
        p.requires_grad_(True)
    on_new = _loop(cfg, None, 3, mesh=new)
    with set_mesh(new):
        sharded, (loss,) = on_new.run(initial_state=restored, start_step=2)
    unsharded = _loop(cfg, None, 3)
    want_state, (want,) = unsharded.run(initial_state=plain, start_step=2)
    assert on_new.step_fn.runner is not None and on_new.step_fn.runner.fallback_gathers == []
    assert_close(np.float32(loss), np.float32(want), "f32_chain")
    for (path, a), b in zip(leaves_with_paths(sharded["params"]), leaves(want_state["params"])):
        assert_close(a.detach(), b.detach(), "f32_chain", err_msg=str(path))


# ---------------------------------------------------------------------------------
# the entry point and the old refusal
# ---------------------------------------------------------------------------------


def test_launch_train_crashes_and_restarts_from_its_checkpoint(tmp_path, capsys):
    d = str(tmp_path / "ck")
    argv = ["--device", "cpu", "--reduce", "32", "--steps", "4", "--batch", "2", "--seq", "16",
            "--data-pattern", "arithmetic", "--ckpt-every", "2"]
    want = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        launch_train.main(argv + ["--ckpt-dir", d, "--fail-at-step", "3"])
    assert ckpt.intact_steps(d) == [2] and not [f for f in os.listdir(d) if f.startswith(".tmp")]
    got = launch_train.main(argv + ["--ckpt-dir", d])
    assert "restored checkpoint step=2 cursor=2" in capsys.readouterr().out
    assert got == want[2:]
    assert ckpt.intact_steps(d) == [2, 4] and _cli("verify", d).returncode == 0
