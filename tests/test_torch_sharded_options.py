"""The options of the partitioned train step and the sequence-sharded decode,
on a simulated ("data" 2, "model" 4) mesh.

* remat "full" and "dots" under the partitioned step: the recompute lands in
  the captured graph (a second flash forward per layer, the annotations
  again, completed to the forward's shardings), the step equals its "none"
  run bit for bit, and the plan's modeled peak falls;
* ``compress_grads`` (the error feedback an input and an output of the
  program) and the numeric-fault window (``torch.where`` on the step
  tensor, one plan per run) against the port's unsharded step, in the
  classes of ``tests/test_torch_train.py``;
* the decode over a cache sharded on its sequence: the plain partial decode
  (``kernels/ref.py::flash_decode_partial_ref``) at per-row positions, and
  the partitioned decode op (one partial per shard, combined by log-sum-exp
  with a pmax and two psums over "data") against the whole-cache plain
  decode, on both sides of a shard boundary and with a shard that sees no
  key.

The config is ``tests/test_torch_sharded_train.py``'s (two layers, d32, four
heads on two kv heads, qkv bias), with float32 weights from a seeded numpy
generator.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.core import mesh_runtime as mr
from repro_torch.core.annotate import ANNOTATE_OP
from repro_torch.core.compat import assert_close, set_mesh
from repro_torch.core.partitioner import combine_decode, spmd_partition
from repro_torch.core.rules import FLASH_FWD
from repro_torch.core.sharding import Sharding
from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
from repro_torch.kernels import ops
from repro_torch.kernels.ref import NEG_INF, chunked_attention_ref, flash_decode_partial_ref
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.models.layers import annotate_spec, tree_init
from repro_torch.train.loop import NumericFaultSpec, TrainConfig, make_train_step
from repro_torch.train.optimizer import get_optimizer

MESH = make_test_mesh()
CFG = ModelConfig(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
                  num_kv_heads=2, d_ff=64, vocab_size=64, attn_chunk=16, remat="none",
                  qkv_bias=True, scan_layers=False, dtype="float32")


def _state(cfg, st, seed=0, compress=False):
    """Float32 params from a seeded generator, Adafactor's state, step 0."""
    with set_mesh(MESH):
        tree = api.param_tree(cfg, st)
    params = tree_init(tree, torch.Generator().manual_seed(seed), dtype="float32", device="cpu")
    opt = get_optimizer("adafactor", lr=1e-2)
    state = {"params": tree_map(lambda p: p.requires_grad_(True), params), "step": 0,
             "opt": opt.init(params)}
    if compress:
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape), params)
    return state, opt


def _batch(step, seed=7):
    tok = np.random.default_rng(seed + step).integers(0, CFG.vocab_size, (8, 17))
    return {"tokens": torch.from_numpy(tok[:, :-1]).contiguous(),
            "labels": torch.from_numpy(tok[:, 1:]).contiguous()}


def _steps(cfg, st, tc, mesh, n, compress=False):
    """``n`` steps of the train step (partitioned under ``mesh``) from the
    seeded state; returns the state, each step's metrics and the step."""
    state, opt = _state(cfg, st, compress=compress)
    with set_mesh(mesh):
        step = make_train_step(cfg, st, opt, tc)
    metrics = []
    for i in range(n):
        state, m = step(state, _batch(i))
        metrics.append(m)
    return state, metrics, step


@functools.lru_cache(maxsize=None)
def _remat_run(strategy, remat):
    state, (m,), step = _steps(CFG.with_(remat=remat), get_strategy(strategy), TrainConfig(),
                               MESH, 1)
    (entry,) = step.runner.plans.values()
    return state, m, entry


def _completed(entry, target):
    """The completed shardings at each node of ``target``, in graph order:
    its operands' and its result's (a tuple result: its getitem nodes')."""
    out = []
    for n in entry.captured.graph.nodes:
        if n.op == "call_function" and str(n.target).startswith(str(target)):
            args = [entry.prop.get(a) for a in n.args if isinstance(a, torch.fx.Node)]
            tup = isinstance(n.meta.get("val"), (tuple, list))
            res = [entry.prop.get(u) for u in n.users] if tup else [entry.prop.get(n)]
            out.append(tuple(str(s) for s in args + res))
    return out


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("strategy", ["2d_finalized", "2d_attempt1"])
def test_remat_under_the_partitioned_step_equals_none(strategy, remat):
    """One partitioned Adafactor step under remat "full" / "dots" against
    "none" on the same state: loss, grad norm, params and optimizer state
    bit for bit; the graph runs each layer's flash forward twice (the
    recompute) and completes every copy, and every recomputed annotation,
    to the shardings "none" gives the forward; the modeled peak falls."""
    base_state, base_m, base = _remat_run(strategy, "none")
    state, m, entry = _remat_run(strategy, remat)
    assert_close(m["loss"], base_m["loss"], "exact")
    assert_close(m["grad_norm"], base_m["grad_norm"], "exact")
    for part in ("params", "opt"):
        for (path, a), b in zip(leaves_with_paths(state[part]), leaves(base_state[part])):
            assert_close(a, b, "exact", err_msg=f"{remat} {part} {path}")
    fwd, base_fwd = _completed(entry, FLASH_FWD), _completed(base, FLASH_FWD)
    assert len(base_fwd) == CFG.num_layers and len(fwd) == 2 * CFG.num_layers
    assert set(fwd) == set(base_fwd)
    ann, base_ann = _completed(entry, ANNOTATE_OP), _completed(base, ANNOTATE_OP)
    assert len(ann) > len(base_ann) and set(ann) == set(base_ann)
    assert entry.plan.peak_bytes < base.plan.peak_bytes, (entry.plan.peak_bytes,
                                                          base.plan.peak_bytes)
    assert entry.plan.fallback_gathers == base.plan.fallback_gathers


def test_compressed_partitioned_step_matches_the_unsharded_step():
    """Four steps with ``compress_grads``: the error feedback is an input and
    an output of the partitioned program; losses and grad norms within
    f32_chain of the unsharded step, params and error feedback within
    coarse (bf16 rounding is discontinuous, as against the reference in
    ``tests/test_torch_train.py``), one plan for the run."""
    st, tc = get_strategy("2d_finalized"), TrainConfig(compress_grads=True)
    state, ms, step = _steps(CFG, st, tc, MESH, 4, compress=True)
    ustate, ums, _ = _steps(CFG, st, tc, None, 4, compress=True)
    for i, (m, um) in enumerate(zip(ms, ums)):
        assert_close(m["loss"], um["loss"], "f32_chain", err_msg=f"step {i}")
        assert_close(m["grad_norm"], um["grad_norm"], "f32_chain", err_msg=f"step {i}")
    for part in ("params", "ef"):
        for (path, a), b in zip(leaves_with_paths(state[part]), leaves(ustate[part])):
            assert_close(a, b, "coarse", err_msg=f"{part} {path}")
    assert any(bool(e.abs().max() > 0) for e in leaves(state["ef"]))
    stats = step.runner.cache_stats
    assert (stats.misses, stats.hits) == (1, 3) and step.runner.fallback_gathers == []


def test_fault_window_in_the_partitioned_step_matches_the_unsharded_step():
    """Four steps with a gradient spike at step 1 and NaN at step 3: the
    window is ``torch.where`` on the step tensor, so one plan serves every
    step; steps 0-2 (the spike among them) within f32_chain of the
    unsharded step, step 3's loss, grad norm and every param NaN in both."""
    st = get_strategy("2d_finalized")
    tc = TrainConfig(numeric_fault=NumericFaultSpec(nan_at_step=3, grad_spike_at_step=1))
    state, ms, step = _steps(CFG, st, tc, MESH, 4)
    ustate, ums, _ = _steps(CFG, st, tc, None, 4)
    for i, (m, um) in enumerate(zip(ms[:3], ums[:3])):
        assert_close(m["loss"], um["loss"], "f32_chain", err_msg=f"step {i}")
        assert_close(m["grad_norm"], um["grad_norm"], "f32_chain", err_msg=f"step {i}")
    assert float(ms[1]["grad_norm"]) > 1e11 * float(ms[0]["grad_norm"])
    for m in (ms[3], ums[3]):
        assert bool(torch.isnan(m["loss"])) and bool(torch.isnan(m["grad_norm"]))
    for s in (state, ustate):
        assert all(bool(torch.isnan(p).all()) for p in leaves(s["params"]))
    stats = step.runner.cache_stats
    assert (stats.misses, stats.hits) == (1, 3) and step.runner.fallback_gathers == []


def _decode_inputs(kv_dtype, seed=0, B=4, T=16, KR=4, Gl=2, D=32):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, KR, Gl, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, T, KR, D)).astype(np.float32)).to(kv_dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_partial_decode_at_per_row_positions_matches_the_plain_decode(kv_dtype):
    """``flash_decode_partial_ref`` at one position per row equals
    ``chunked_attention_ref`` at that row's position bit for bit; a row at a
    negative position sees no key: output 0, log-sum-exp -1e9, no NaN; its
    log-sum-exp is the scores' over the visible keys."""
    q, k, v = _decode_inputs(kv_dtype)
    pos = torch.tensor([0, 7, 15, -3], dtype=torch.int32)
    out, lse = flash_decode_partial_ref(q, k, v, pos, 16)
    for b, p in enumerate(pos.tolist()[:3]):
        want = chunked_attention_ref(q[b:b + 1], k[b:b + 1], v[b:b + 1], causal=False, chunk=16,
                                     q_offset=p, kv_len=p + 1)
        assert_close(out[b:b + 1], want, "exact", err_msg=f"row {b}")
        s = torch.einsum("sngd,tnd->nsgt", (q[b] * torch.tensor(32 ** -0.5)).float(),
                         k[b, :p + 1].float())
        assert_close(lse[b], torch.logsumexp(s, -1).reshape(4, 2), "f32")
    assert bool((out[3] == 0).all()) and bool((lse[3] == NEG_INF).all())
    assert bool(torch.isfinite(out).all())


def _decode_program(T_axes):
    def fn(q, k, v, pos):
        spec = (None, T_axes, "model", None)
        k, v = annotate_spec(k, spec, MESH), annotate_spec(v, spec, MESH)
        return ops.flash_decode(q, k, v, pos, k.shape[1])

    return fn


@pytest.mark.parametrize("kv_dtype,kind", [(torch.float32, "f32_chain"),
                                           (torch.bfloat16, "bf16_round")])
def test_sequence_sharded_decode_combines_to_the_whole_cache_decode(kv_dtype, kind,
                                                                    monkeypatch):
    """The decode op over k/v sharded on their sequence over "data" (two
    shards of 8 keys), compiled and dynamic: the cache stays sharded (one
    partial decode per shard, each row at its shard-relative position),
    the shards combine by a pmax and two psums over "data", and the result
    equals the whole-cache plain decode at positions 3 (the second shard
    sees no key), 7, 8 and 9 (either side of the boundary) and 15.  With a
    float32 cache within f32_chain; with a bf16 cache p is rounded to bf16
    relative to each shard's own max, not the whole row's, so within
    bf16_round (ROADMAP Queue C)."""
    q, k, v = _decode_inputs(kv_dtype)
    reduced = []
    real = mr._reduce
    monkeypatch.setattr(mr, "_reduce", lambda x, mesh, axes, op: reduced.append(
        (op, tuple(axes))) or real(x, mesh, axes, op))
    for compile_plans in (True, False):
        runner = spmd_partition(_decode_program("data"), MESH, optimize=False, device="cpu",
                                compile_plans=compile_plans)
        for p in (3, 7, 8, 9, 15):
            reduced.clear()
            got = runner(q, k, v, torch.tensor(p, dtype=torch.int32))
            want = chunked_attention_ref(q, k, v, causal=False, chunk=16, q_offset=p,
                                         kv_len=p + 1)
            assert_close(got, want, kind, err_msg=f"pos {p}")
            assert sorted(reduced) == [("max", ("data",)), ("sum", ("data",)),
                                       ("sum", ("data",))], reduced
            assert runner.collectives == {"all-reduce": 3}, runner.collectives
        assert runner.fallbacks == []
    runner = spmd_partition(_decode_program("data"), MESH, optimize=False, device="cpu")
    runner(q, k, v, torch.tensor(3, dtype=torch.int32))
    (entry,) = runner.plans.values()
    seq = Sharding(MESH, ((), ("data",), ("model",), ()))
    assert entry.plan.in_shardings[1] == seq and entry.plan.in_shardings[2] == seq


def test_combine_weighs_an_empty_shard_by_zero():
    """``combine_decode`` with one shard that saw no key (output 0,
    log-sum-exp -1e9) returns the other shard's output, exactly."""
    rng = np.random.default_rng(1)
    out = torch.from_numpy(rng.standard_normal((8, 2, 1, 1, 2, 8)).astype(np.float32))
    lse = torch.from_numpy(rng.standard_normal((8, 2, 1, 2)).astype(np.float32))
    empty = torch.from_numpy(mr.axis_index(MESH, "data") == 1)
    out[empty], lse[empty] = 0.0, NEG_INF
    got = combine_decode(out, lse, MESH, ("data",))
    assert_close(got[~empty], out[~empty], "exact")
    assert_close(got[empty], out[~empty], "exact")


def test_partial_decode_captures_as_one_operator():
    """Under graph capture the partial decode is one
    ``repro_torch::flash_decode_partial`` node whose fake results have the
    output's and the log-sum-exp's shapes and dtypes; run eagerly it calls
    the plain version directly."""
    from repro_torch.core.compat import capture

    q, k, v = _decode_inputs(torch.bfloat16)
    q = q.bfloat16()
    pos = torch.tensor([0, 7, 15, -3], dtype=torch.int32)
    cap = capture(lambda *a: ops.flash_decode_partial(*a, 16), q, k, v, pos)
    nodes = [n for n in cap.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("repro_torch.flash_decode_partial")]
    assert len(nodes) == 1
    out, lse = nodes[0].meta["val"]
    assert (tuple(out.shape), out.dtype) == (tuple(q.shape), torch.bfloat16)
    assert (tuple(lse.shape), lse.dtype) == ((4, 4, 2), torch.float32)
    got, got_lse = cap.gm(q, k, v, pos)
    want, want_lse = flash_decode_partial_ref(q, k, v, pos, 16)
    assert_close(got, want, "exact")
    assert_close(got_lse, want_lse, "exact")
