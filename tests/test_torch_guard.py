"""Numerics guards: the plan's guard epilogue, the runner's NumericsFault and
the train loop's skip and escalation, against the JAX package's
(tests/test_guard.py's cases; those with a checkpoint directory are in
tests/test_torch_checkpoint.py, and the rewind to a checkpoint is the
elastic coordinator's, ROADMAP A14b).

* ``guard_faults`` decodes as the reference's does, and
  ``append_guard_steps`` adds the same leaves, stat steps and one pmax over
  every mesh axis to the same program's plan;
* ``spmd_partition(guard=)`` strips the guard vector from a clean call and
  raises ``NumericsFault`` naming a non-finite leaf on a NaN input, and
  refuses ``compile_plans=False``;
* ``TrainLoop`` with a guard skips a NaN batch, keeping the params bit for
  bit, and escalates after K consecutive faults (``consecutive == 3`` at
  step 6); a gradient spike trips ``max_abs``; ``guard_leaf_names`` is in
  the metrics' order and equal to the reference's;
* the guarded loop's losses are within ``loss_curve`` of the reference's
  ``TrainLoop`` with the same ``TrainConfig``, unsharded and partitioned
  (two layers, 2d_finalized on the simulated ("data" 2, "model" 4) mesh).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.configs.base import get_strategy as jax_get_strategy
from repro.core import Mesh as JMesh
from repro.core.plan import GuardConfig as JGuardConfig
from repro.core.plan import guard_faults as jax_guard_faults
from repro.core.plan import lower_plan as jax_lower_plan
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import TokenPipeline as JaxTokenPipeline
from repro.train.loop import NumericFaultSpec as JaxNumericFaultSpec
from repro.train.loop import TrainConfig as JaxTrainConfig
from repro.train.loop import TrainLoop as JaxTrainLoop
from repro.train.loop import guard_leaf_names as jax_guard_leaf_names
from repro.train.loop import init_state as jax_init_state
from repro.train.optimizer import get_optimizer as jax_get_optimizer
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core.compat import assert_close, capture, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.plan import GuardConfig, NumericsFault, guard_faults, lower_plan
from repro_torch.core.tree import leaves, tree_map
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.loop import (NumericFaultSpec, TrainConfig, TrainLoop, guard_leaf_names)
from repro_torch.train.optimizer import get_optimizer

TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4, num_kv_heads=4,
            d_ff=64, vocab_size=128, attn_chunk=16, remat="none", dtype="float32",
            scan_layers=False)
ST, JST = get_strategy("2d_finalized"), jax_get_strategy("2d_finalized")
DATA = dict(vocab_size=128, seq_len=8, global_batch=4, seed=1, pattern="arithmetic")


# ---------------------------------------------------------------------------------
# guard_faults and the plan's guard epilogue
# ---------------------------------------------------------------------------------


def test_guard_faults_decode_matches_reference():
    stats = np.array([[0.0, 1.0], [3.0, np.nan], [0.0, 99.0], [0.0, np.inf]])
    leaves_ = ("a", "b", "c", "d")
    got = guard_faults(GuardConfig(max_abs=10.0), stats, leaves_)
    want = jax_guard_faults(JGuardConfig(max_abs=10.0), stats, leaves_)
    assert got == want
    assert {f["leaf"]: f["kind"] for f in got} == {"b": "nonfinite", "c": "absmax",
                                                   "d": "nonfinite"}
    assert guard_faults(GuardConfig(max_abs=10.0), np.array([[0.0, 1.0]]), ("a",)) == []


def test_append_guard_steps_structure_matches_reference():
    mesh, jmesh = Mesh.create((2, 4), ("x", "y")), JMesh.create((2, 4), ("x", "y"))

    def f(a, b):
        return torch.tanh(a @ b), a + 1.0

    def g(a, b):
        return jnp.tanh(a @ b), a + 1.0

    cap = capture(f, torch.empty(8, 8, device="meta"), torch.empty(8, 8, device="meta"))
    plan = lower_plan(cap, None, mesh, optimize=False, guard=GuardConfig())
    ref = jax_lower_plan(jax.make_jaxpr(g)(*[jax.ShapeDtypeStruct((8, 8), jnp.float32)] * 2),
                         None, jmesh, optimize=False, guard=JGuardConfig())
    gi, jgi = plan.guard, ref.guard
    assert gi.leaves == jgi.leaves == ("out[0]", "out[1]")
    assert gi.out_index == jgi.out_index == 2
    assert len(plan.out_keys) == len(plan.out_shardings) == 3
    stats = [s for s in plan.steps if s.op == "guard-stat"]
    jstats = [s for s in ref.steps if s.op == "guard-stat"]
    assert [s.flops for s in stats] == [s.flops for s in jstats] and all(s.flops > 0 for s in stats)
    (pmax,) = [s for s in plan.steps if s.kind == "collective" and s.reduce_op == "max"]
    (jpmax,) = [s for s in ref.steps if s.kind == "collective" and s.reduce_op == "max"]
    assert pmax.axes == jpmax.axes == ("x", "y") and pmax.lshape == jpmax.lshape
    assert plan.stats.collectives == ref.stats.collectives


def _guarded_runner(**kw):
    mesh = make_test_mesh()

    def f(a, b):
        a = annotate(a, mesh_split(2, mesh, ["data", -1]))
        c = torch.tanh(a @ b)
        return c.sum(), c

    return spmd_partition(f, mesh, optimize=False, device="cpu", **kw)


def test_spmd_partition_guard_strips_the_vector_and_raises_on_nan():
    r = _guarded_runner(guard=GuardConfig(names=("loss", "c")))
    a, b = torch.ones(8, 4), torch.ones(4, 8)
    loss, c = r(a, b)  # a clean call: the guard vector stripped, the outputs whole
    assert torch.isfinite(loss) and c.shape == (8, 8)
    assert_close(loss, torch.tanh(a @ b).sum(), "f32")
    a[0, 0] = float("nan")
    with pytest.raises(NumericsFault) as ei:
        r(a, b)
    assert ei.value.step == 1
    assert {f["leaf"] for f in ei.value.faults if f["kind"] == "nonfinite"} == {"loss", "c"}


def test_guard_requires_compiled_plans():
    with pytest.raises(ValueError, match="compile_plans=True"):
        spmd_partition(lambda a: a, make_test_mesh(), compile_plans=False, guard=GuardConfig(),
                       device="cpu")


# ---------------------------------------------------------------------------------
# the train loop: skip, escalation, a spike, leaf names, against the reference
# ---------------------------------------------------------------------------------


def _loops(tc_kw, jtc_kw=None, hooks=None, partitioned=False):
    """The port's and the reference's TrainLoop with the same TrainConfig,
    from the reference's initial weights; returns (loop, state, jloop, jstate)."""
    jcfg, cfg = JaxModelConfig(**TINY), ModelConfig(**TINY)
    jopt, opt = jax_get_optimizer("adafactor", lr=0.05), get_optimizer("adafactor", lr=0.05)
    jtc = JaxTrainConfig(**(jtc_kw or tc_kw))
    jstate = jax_init_state(jcfg, JST, jopt, jtc, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.array, jstate["params"]), cfg, "cpu",
                               dtype="float32")
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    jloop = JaxTrainLoop(jcfg, JST, jopt, jtc, JaxTokenPipeline(JaxDataConfig(**DATA)))
    if partitioned:
        with set_mesh(make_test_mesh()):
            loop = TrainLoop(cfg, ST, opt, TrainConfig(**tc_kw), TokenPipeline(DataConfig(**DATA)),
                             hooks=hooks, device="cpu")
    else:
        loop = TrainLoop(cfg, ST, opt, TrainConfig(**tc_kw), TokenPipeline(DataConfig(**DATA)),
                         hooks=hooks, device="cpu")
    return loop, state, jloop, jstate


@pytest.mark.parametrize("partitioned", [False, True])
def test_train_loop_skips_nan_batch_and_matches_reference(partitioned):
    """Ten steps with NaN poisoning step 4: the loop skips it (the params
    after step 4 equal those before it bit for bit), counts one fault and
    one skip, calls the hook once, and its nine losses are within
    loss_curve of the reference's guarded TrainLoop."""
    events = []
    kw = dict(steps=4, guard=GuardConfig(rewind_after=3),
              numeric_fault=NumericFaultSpec(nan_at_step=4))
    jkw = dict(steps=10, guard=JGuardConfig(rewind_after=3),
               numeric_fault=JaxNumericFaultSpec(nan_at_step=4))
    loop, state, jloop, jstate = _loops(kw, jkw, partitioned=partitioned,
                                        hooks={"numerics_fault":
                                               lambda s, f, c: events.append((s, c))})
    _, want = jloop.run(initial_state=jstate, start_step=0)
    state, first = loop.run(initial_state=state)
    before = tree_map(torch.Tensor.clone, state["params"])
    loop.tc.steps = 5
    state, poisoned = loop.run(initial_state=state)
    assert poisoned == [] and loop.skipped_steps == [4]
    assert all(torch.equal(a, b) for a, b in zip(leaves(state["params"]), leaves(before)))
    loop.tc.steps = 10
    state, rest = loop.run(initial_state=state)
    got = first + rest
    assert len(got) == len(want) == 9 and np.all(np.isfinite(got))
    assert loop.guard_counters == {"faults": 1, "skips": 1, "rewinds": 0}
    assert events == [(4, 1)]
    assert_close(np.array(got), np.array(want), "loss_curve")
    if partitioned:
        assert loop.step_fn.runner is not None and loop.step_fn.runner.fallback_gathers == []


def test_train_loop_escalates_after_k_consecutive():
    loop, state, _, _ = _loops(dict(steps=10, guard=GuardConfig(rewind_after=3),
                                    numeric_fault=NumericFaultSpec(nan_at_step=4, steps=5)),
                               dict(steps=10))
    with pytest.raises(NumericsFault) as ei:
        loop.run(initial_state=state)
    assert ei.value.consecutive == 3 and ei.value.step == 6
    assert loop.guard_counters["faults"] == 3 and loop.guard_counters["skips"] == 2
    assert loop.skipped_steps == [4, 5]


def test_grad_spike_caught_by_max_abs():
    events = []
    loop, state, _, _ = _loops(dict(steps=6, guard=GuardConfig(max_abs=1e6, rewind_after=99),
                                    numeric_fault=NumericFaultSpec(grad_spike_at_step=3,
                                                                   spike_factor=1e12)),
                               dict(steps=6),
                               hooks={"numerics_fault": lambda s, f, c: events.append((s, f))})
    _, losses = loop.run(initial_state=state)
    assert len(losses) == 5 and np.all(np.isfinite(losses))
    ((step, faults),) = events
    assert step == 3 and any(f["kind"] == "absmax" for f in faults)


def test_guard_leaf_names_match_metrics_order_and_reference():
    gc = GuardConfig(moments=True)
    loop, state, _, jstate = _loops(dict(steps=1, guard=gc), dict(steps=1, guard=JGuardConfig(
        moments=True)))
    names = guard_leaf_names(gc, state)
    assert names == jax_guard_leaf_names(JGuardConfig(moments=True), jstate)
    assert names[0] == "loss" and any(n.startswith("grads/") for n in names)
    assert any(n.startswith("opt/") for n in names)
    batch = {k: torch.from_numpy(v).long()
             for k, v in TokenPipeline(DataConfig(**DATA)).batch_at(0).items()}
    _, metrics = loop.step_fn(state, batch)
    assert metrics["guard"].shape == (2 * len(names),) and not bool(metrics["fault"])
