"""The autoshard search (``repro_torch/autoshard``) against the JAX package's
``repro.autoshard`` on the CPU, cost-only on meta tensors.

The two packages lower the same program to plans that differ where their
partitioners differ (ROADMAP "Known divergences"), so parity is held in
three parts:

* the search itself: the port's ``search`` driven by the reference's own
  scores (an adapter that prices each port assignment with the reference's
  ``Evaluator``) gives the reference's assignment, evals, searched inputs
  and history exactly, cold and warm-started;
* the cost surface: on the MLP program, where the two packages' plans agree,
  the port's ``Evaluator`` terms equal the reference's on every point the
  reference's search visited, and the whole solve picks the same
  assignment; on the registry loss the wire-byte gap is attributed to the
  plan steps that make it;
* the golden contract of ``tests/test_autoshard.py`` in the port's own
  terms (its budget from the port's own peaks, its committed profile).

Both packages price with one pinned ``RooflineParams`` where scores are
compared (the reference's defaults, passed explicitly: not a device's
constants).
"""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import autoshard as jas
from repro.analysis.roofline import RooflineParams as JRooflineParams
from repro.core import Mesh as JMesh
from repro.core.sharding import Sharding as JSharding
from repro_torch import autoshard
from repro_torch.analysis.roofline import RooflineParams
from repro_torch.autoshard import api as as_api
from repro_torch.core import Mesh
from repro_torch.core.compat import assert_close, capture
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.rules import aval
from repro_torch.core.sharding import Sharding
from repro_torch.obs import metrics as obs_metrics
from repro_torch.pipeline import PipelineConfig, bubble_fraction, pipeline_ticks

MESH2D, JMESH2D = Mesh.create((2, 4), ("data", "model")), JMesh.create((2, 4), ("data", "model"))
MESH1D, JMESH1D = Mesh.create((4,), ("model",)), JMesh.create((4,), ("model",))
# the reference's default constants, pinned in both packages where scores meet
_J = JRooflineParams()
PINNED = RooflineParams(**{k: getattr(_J, k) for k in (
    "peak_flops", "hbm_bw", "ici_bw", "collective_launch_s", "overlap_efficiency")})
CHEAP = dict(top_n=2, sa_steps=2, max_candidates=6)  # tests/test_elastic.py's knobs
GOLD = dict(top_n=3, sa_steps=4, max_candidates=8)  # tests/test_autoshard.py's knobs
MLP_SHAPES = [(64, 128), (128, 256), (256, 64)]


def _jmlp(a, w1, w2):
    return jnp.tanh(a @ w1) @ w2


def _mlp(a, w1, w2):
    return torch.tanh(a @ w1) @ w2


def _jmlp_jaxpr():
    return jax.make_jaxpr(_jmlp)(*[jax.ShapeDtypeStruct(s, jnp.float32) for s in MLP_SHAPES])


def _mlp_captured():
    return capture(_mlp, *[torch.empty(s, device="meta") for s in MLP_SHAPES])


def _dms(assignment):
    return [None if s is None else s.dims_mapping for s in assignment]


def _port(assignment, mesh):
    return [None if s is None else Sharding(mesh, s.dims_mapping) for s in assignment]


def _jax(assignment, jmesh):
    return [None if s is None else JSharding(jmesh, s.dims_mapping) for s in assignment]


@functools.lru_cache(maxsize=None)
def _jregistry(arch, shape, names):
    return jas.registry_problem(arch, JMesh.create(shape, names))


class ReferenceScored:
    """The port's search's evaluator interface (``__call__``, ``lowerings``,
    ``budget_bytes``, the inputs' shapes and dtypes read off the port's
    capture), scoring each port assignment with the reference's
    ``Evaluation``s: those a finished reference search memoized, else a
    reference ``Evaluator`` call.  ``lowerings`` counts the distinct
    assignments this adapter priced, as the reference's evaluator counts
    its own."""

    def __init__(self, jevaluator, jmesh, captured):
        self.jev, self.jmesh, self.captured = jevaluator, jmesh, captured
        self.budget_bytes = jevaluator.budget_bytes
        self.seen = set()

    @property
    def lowerings(self):
        return len(self.seen)

    def __call__(self, assignment):
        ref = _jax(assignment, self.jmesh)
        self.seen.add(self.jev.key(ref))
        return self.jev(ref)

    def invar_shapes(self):
        return [aval(v).shape for v in self.captured.invars]

    def invar_dtype_bytes(self):
        return [aval(v).dtype.itemsize for v in self.captured.invars]


# ---------------------------------------------------------------------------------
# (a) the candidate space and the pipeline decisions
# ---------------------------------------------------------------------------------

SPACE_SHAPES = [(6, 128), (64, 64), (8, 16), (64, 128), (128, 256), (256, 64), (9496, 64),
                (2, 64, 2, 32), (64,), ()]


@pytest.mark.parametrize("mesh,jmesh", [(MESH2D, JMESH2D), (MESH1D, JMESH1D)], ids=["2d", "1d"])
def test_candidate_shardings_match_reference_in_order(mesh, jmesh):
    for shape in SPACE_SHAPES:
        for kw in ({}, {"max_candidates": 8}, {"dtype_bytes": 4, "budget_bytes": 4096.0},
                   {"dtype_bytes": 2, "budget_bytes": 1024.0, "max_candidates": 5}):
            got = autoshard.candidate_shardings(shape, mesh, **kw)
            want = jas.candidate_shardings(shape, jmesh, **kw)
            assert _dms(got) == _dms(want), (shape, kw)
            assert [repr(s) for s in got] == [repr(s) for s in want]
    s = Sharding(MESH2D, (("data",), ("model",)))
    js = JSharding(JMESH2D, (("data",), ("model",)))
    assert autoshard.local_bytes((8, 16), 4, s) == jas.local_bytes((8, 16), 4, js)
    assert autoshard.assignment_bytes([(8, 16), (8, 16)], [4, 2], [s, None]) == \
        jas.assignment_bytes([(8, 16), (8, 16)], [4, 2], [js, None])
    assert not autoshard.fits_budget([(8, 16)], [4], [None], 100.0)
    assert autoshard.fits_budget([(8, 16)], [4], [s], 100.0)


def test_pipeline_decisions_match_reference():
    from repro.pipeline import PipelineConfig as JPipelineConfig

    for layers, batch, kw in ((4, 8, dict(max_stages=4)), (6, 8, dict(max_stages=4)),
                              (4, 6, dict(max_stages=2)),
                              (8, 8, dict(max_stages=8, num_microbatches=4)),
                              (4, 8, dict(max_stages=4, stage_axes=("model",)))):
        got = autoshard.pipeline_decisions(MESH2D, layers, batch, PipelineConfig(**kw))
        want = jas.pipeline_decisions(JMESH2D, layers, batch, JPipelineConfig(**kw))
        assert [d.as_dict() for d in got] == [d.as_dict() for d in want], (layers, batch, kw)


# ---------------------------------------------------------------------------------
# (b) the search, driven by the reference's scores
# ---------------------------------------------------------------------------------


def _search_parity(captured, closed, mesh, jmesh, knobs, warm_of=None):
    """Run the reference's search, then the port's with the reference's
    scores, on the same knobs; return both results."""
    jev = jas.Evaluator(closed, jmesh)
    jwarm = None if warm_of is None else warm_of[1]
    want = jas.search(jev, jmesh, init_assignment=jwarm, **knobs)
    adapter = ReferenceScored(jev, jmesh, captured)
    got = autoshard.search(adapter, mesh, init_assignment=None if warm_of is None
                           else warm_of[0], **knobs)
    assert _dms(got.assignment) == _dms(want.assignment)
    assert got.evals == want.evals
    assert got.searched_invars == want.searched_invars
    assert got.history == want.history
    assert got.warm_used == want.warm_used
    assert got.evaluation.score == want.evaluation.score
    return got, want


@pytest.mark.parametrize("program", ["mlp", "qwen1.5-0.5b"])
def test_search_with_reference_scores_matches_reference_cold_and_warm(program):
    if program == "mlp":
        captured, closed = _mlp_captured(), _jmlp_jaxpr()
        mesh, jmesh, knobs = MESH2D, JMESH2D, dict(top_n=3, sa_steps=6, seed=7)
    else:
        closed, jbase = _jregistry(program, (4,), ("model",))
        captured, base = autoshard.registry_problem(program, MESH1D)
        mesh, jmesh, knobs = MESH1D, JMESH1D, CHEAP
    cold, _ = _search_parity(captured, closed, mesh, jmesh, knobs)
    assert not cold.warm_used
    # the warm start: the cold result (the MLP) or the Table-1 baseline
    warm_of = ((cold.assignment, _jax(cold.assignment, jmesh)) if program == "mlp"
               else (base, jbase))
    warm, _ = _search_parity(captured, closed, mesh, jmesh, knobs, warm_of=warm_of)
    assert warm.warm_used and warm.evals < cold.evals


# ---------------------------------------------------------------------------------
# (c) the cost surface on the MLP program, and the registry loss's gap
# ---------------------------------------------------------------------------------

TERMS = ("wire_bytes", "launches", "flops_per_device", "peak_bytes")


def test_mlp_cost_surface_equals_reference_on_every_point_visited():
    closed, captured = _jmlp_jaxpr(), _mlp_captured()
    knobs = dict(top_n=3, sa_steps=6, seed=7)
    jev = jas.Evaluator(closed, JMESH2D)
    jas.search(jev, JMESH2D, **knobs)
    ev = autoshard.Evaluator(captured, MESH2D, profile=PINNED)
    assert len(jev.cache) > 20
    for key, want in jev.cache.items():
        got = ev([None if k is None else Sharding(MESH2D, k) for k in key])
        assert got.feasible == want.feasible, key
        for t in TERMS:
            assert getattr(got.cost, t) == getattr(want.cost, t), (key, t)
        assert got.score == pytest.approx(want.score, rel=1e-12), key
    cfg = dict(budget_bytes=None, **knobs)
    got = autoshard.solve_problem(captured, MESH2D, autoshard.AutoshardConfig(profile=PINNED,
                                                                              **cfg))
    want = jas.solve_problem(closed, JMESH2D, jas.AutoshardConfig(**cfg))
    assert _dms(got.assignment) == _dms(want.assignment)
    assert got.evals == want.evals
    assert got.evaluation.score == pytest.approx(want.evaluation.score, rel=1e-12)


def _wire_rows(plan, trips=1, depth=0):
    """(in a scan body, step kind, bytes) of every step of ``plan`` that moves
    wire bytes, scan bodies at trip count (as ``whole_wire_bytes`` sums)."""
    from repro.core.plan_opt import _collective_step_wire_bytes as jax_wire
    from repro_torch.core.plan_opt import _collective_step_wire_bytes as port_wire

    rows = []
    for s in plan.steps:
        b = 0.0
        if s.kind == "reshard" and s.program is not None:
            b = s.program.cost_bytes
        elif s.kind == "collective":
            wire = port_wire if isinstance(plan.mesh, Mesh) else jax_wire
            b = wire(plan.mesh, s)
        if b:
            rows.append((depth > 0, s.kind, b * trips))
        if s.inner is not None:
            rows += _wire_rows(s.inner, trips * s.call.get("trips", 1), depth + 1)
    return rows


def test_registry_cost_gap_is_the_reference_index_fallbacks_and_product_routes():
    """The reduced qwen loss under its Table-1 baseline on ("data" 2, "model"
    4), lowered unoptimized by both packages under one pinned profile: the
    reference's 11.12 MB of wire bytes against the port's 0.34 MB.  Every
    step the two plans share moves the same bytes; the gap is exactly

    * the reference's index ops taking the gathering fallback (ROADMAP's
      known divergences, the index ops): the embedding table all-gathered
      for the lookup (2,127,104 B) and the logits all-gathered along the
      vocab, with the labels, for the label pick (7,292,928 + 512 B), where
      the port runs a masked lookup and a masked gather, each completed by
      a psum inside the step;
    * the reference's logsumexp: a pmax and a psum over the vocab's shards
      as plan steps (2 x 1,536 B), inside the port's logsumexp step;
    * the unembedding: the reference all-reduces the (8, 32, 2374) logits
      over "data" (1,215,488 B) where the port's product reduce-scatters
      into a vocab split over both axes, which neither package prices (R9);
      the reference's product therefore computes twice the port's FLOPs;
    * in the scan body, the reference all-gathers the MLP's hidden over
      "model" before the down projection (2 trips, 135,168 B); the port
      contracts it sharded;
    * the port's extra 4 B: the loss mean's psum of one scalar.
    """
    from repro.core.plan import lower_plan as jax_lower_plan
    from repro.core.plan import plan_cost as jax_plan_cost
    from repro_torch.core.plan import lower_plan, plan_cost

    closed, jbase = _jregistry("qwen1.5-0.5b", (2, 4), ("data", "model"))
    captured, base = autoshard.registry_problem("qwen1.5-0.5b", MESH2D)
    want = jax_lower_plan(closed, jbase, JMESH2D, optimize=False, profile=_J)
    got = lower_plan(captured, base, MESH2D, optimize=False, profile=PINNED)
    wc, gc = jax_plan_cost(want), plan_cost(got)
    assert (wc.wire_bytes, gc.wire_bytes) == (11115776.0, 341508.0)
    ref_rows, port_rows = _wire_rows(want), _wire_rows(got)
    shared = []
    for r in list(port_rows):
        if r in ref_rows:
            ref_rows.remove(r)
            port_rows.remove(r)
            shared.append(r)
    assert sum(r[2] for r in shared) == 341504.0
    assert sorted(ref_rows) == sorted([
        (False, "reshard", 2127104.0),    # the embedding table, for the lookup
        (False, "reshard", 7292928.0),    # the logits along the vocab, for the label pick
        (False, "reshard", 512.0),        # the labels, for the label pick
        (False, "collective", 1536.0),    # logsumexp's pmax
        (False, "collective", 1536.0),    # logsumexp's psum
        (False, "collective", 1215488.0),  # the unembedding's all-reduce over "data"
        (True, "reshard", 135168.0),      # the MLP hidden over "model", 2 trips
    ])
    assert port_rows == [(False, "collective", 4.0)]
    # the unembedding: the reference's product (8, 32, 2374) over a local
    # contraction of 32, the port's (256, 1187): half the FLOPs
    jdot = max((s for s in want.steps if s.op == "dot_general"), key=lambda s: s.flops)
    pmm = max((s for s in got.steps if s.op == "aten.mm"), key=lambda s: s.flops)
    assert (jdot.flops, pmm.flops) == (2 * 8 * 32 * 2374 * 32, 2 * 256 * 1187 * 32)


# ---------------------------------------------------------------------------------
# (d) the golden contract, in the port's own terms
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
@pytest.mark.parametrize("mesh", [MESH2D, MESH1D], ids=["2d", "1d"])
def test_golden_contract_in_the_port_terms(arch, mesh):
    """tests/test_autoshard.py's golden cases: the budget between the port's
    own replicated and Table-1 peaks (under the committed profile), so that
    replication does not fit and the baseline does; the result feasible, no
    worse than the baseline, within the budget, and the same JSON under the
    same seed (the Mamba2 1D case solves twice)."""
    captured, baseline = autoshard.registry_problem(arch, mesh)
    free = autoshard.Evaluator(captured, mesh)
    repl_peak = free([None] * len(baseline)).cost.peak_bytes
    base_peak = free(baseline).cost.peak_bytes
    budget = (repl_peak + base_peak) / 2.0
    assert base_peak < budget < repl_peak
    cfg = autoshard.AutoshardConfig(budget_bytes=budget, **GOLD)
    res = autoshard.solve(arch, mesh, config=cfg)
    assert res.evaluation.feasible, f"{arch}: no feasible assignment found"
    assert res.baseline.feasible, f"{arch}: baseline over its own budget"
    assert res.evaluation.score <= res.baseline.score * (1 + 1e-9)
    assert res.cost.peak_bytes <= budget
    assert res.arch == arch and res.evals > len(res.searched_invars)
    if mesh is MESH1D and arch == "mamba2-130m":
        again = autoshard.solve_problem(captured, mesh, cfg, baseline=baseline, arch=arch)
        assert json.dumps(again.to_json()) == json.dumps(res.to_json())


# ---------------------------------------------------------------------------------
# (e) dumps across the packages, and the elastic helpers
# ---------------------------------------------------------------------------------


def test_dumps_load_across_packages_onto_the_same_leaf_paths(tmp_path):
    from repro.autoshard.api import AutoshardResult as JAutoshardResult
    from repro.configs.base import get_strategy as jget_strategy
    from repro.launch.train import reduced_config as jreduced_config
    from repro.configs.registry import get_config as jget_config
    from repro.models import api as jmodel_api
    from repro.models.layers import is_param as jis_param
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.models import api as model_api
    from repro_torch.models.layers import tree_shapes

    arch = "qwen1.5-0.5b"
    closed, jbase = _jregistry(arch, (4,), ("model",))
    captured, base = autoshard.registry_problem(arch, MESH1D)
    # the inputs' leaf paths: the reference's jax.tree_util order, the port's
    # placeholders (params by sorted keys, then labels, tokens)
    jcfg = jreduced_config(jget_config(arch), 16)
    jtree = jmodel_api.param_tree(jcfg, jget_strategy("2d_finalized"))
    jpaths = [tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p)
              for p, _ in jax.tree_util.tree_flatten_with_path(
                  (jtree, {"tokens": 0, "labels": 0}), is_leaf=jis_param)[0]]
    cfg, st = as_api._registry_config(arch, 16)
    paths = [("params",) + p for p, _ in leaves_with_paths(
        tree_shapes(model_api.param_tree(cfg, st), cfg.param_dtype))]
    paths += [("batch", "labels"), ("batch", "tokens")]
    assert [p[1:] for p in paths] == [p[1:] for p in jpaths]
    assert len(paths) == len(captured.invars)
    # a reference dump (the baseline as its assignment) loads onto them
    jev = jas.Evaluator(closed, JMESH1D)(jbase)
    jres = JAutoshardResult(mesh=JMESH1D, assignment=list(jbase), evaluation=jev,
                            config=jas.AutoshardConfig(**CHEAP), arch=arch)
    mesh, got = autoshard.load(jres.dump(str(tmp_path / "ref.json")))
    assert mesh.shape == MESH1D.shape and mesh.axis_names == MESH1D.axis_names
    assert _dms(got) == _dms(base)
    # and a port dump (the baseline as its assignment, one leaf left to
    # propagation) in the reference
    assignment = [None] + list(base[1:])
    res = autoshard.AutoshardResult(
        mesh=MESH1D, assignment=assignment,
        evaluation=autoshard.Evaluator(captured, MESH1D)(assignment),
        config=autoshard.AutoshardConfig(**CHEAP), arch=arch)
    rec = json.load(open(res.dump(str(tmp_path / "port.json"))))
    assert rec["version"] == 1 and rec["config"]["top_n"] == CHEAP["top_n"]
    jmesh, jgot = jas.load(str(tmp_path / "port.json"))
    assert jmesh.shape == MESH1D.shape and jmesh.axis_names == MESH1D.axis_names
    assert _dms(jgot) == _dms(res.assignment)
    assert _dms(autoshard.assignment_from_json(rec)[1]) == _dms(res.assignment)


def test_remap_restrict_expand_match_reference():
    """tests/test_elastic.py:230-245: a data-parallel (2, 1) assignment lifted
    onto (2, 4), on the reference's tiny config's inputs."""
    from repro.configs.base import get_strategy as jget_strategy
    from repro.configs.base import ModelConfig as JModelConfig
    from repro.launch.elastic import sharding_problem

    tiny = JModelConfig(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=4,
                        num_kv_heads=4, d_ff=64, vocab_size=128, attn_chunk=16, remat="none")
    st = jget_strategy("2d_finalized")
    small, jsmall = Mesh.create((2, 1), ("data", "model")), JMesh.create((2, 1),
                                                                         ("data", "model"))
    closed_s, jbase_s = sharding_problem(tiny, st, jsmall, 4, 16)
    shapes_s = [tuple(v.aval.shape) for v in closed_s.jaxpr.invars]
    closed_b, jbase_b = sharding_problem(tiny, st, JMESH2D, 4, 16)
    shapes = [tuple(v.aval.shape) for v in closed_b.jaxpr.invars]
    base_s = _port(jbase_s, small)
    jprior = jas.restrict_assignment(jbase_s, jsmall, shapes_s)
    prior = autoshard.restrict_assignment(base_s, small, shapes_s)
    assert _dms(prior) == _dms(jprior)
    for got, want in ((autoshard.remap_assignment(prior, MESH2D, shapes),
                       jas.remap_assignment(jprior, JMESH2D, shapes)),
                      (autoshard.expand_assignment(prior, MESH2D, shapes),
                       jas.expand_assignment(jprior, JMESH2D, shapes)),
                      (autoshard.restrict_assignment(_port(jbase_b, MESH2D), MESH2D, shapes,
                                                     keep_axes=("model",)),
                       jas.restrict_assignment(jbase_b, JMESH2D, shapes,
                                               keep_axes=("model",)))):
        assert _dms(got) == _dms(want)
    assert _dms(autoshard.expand_assignment(prior, MESH2D, shapes)) != \
        _dms(autoshard.remap_assignment(prior, MESH2D, shapes))
    for spec, shape in (((("data", "model"), None), (8, 16)), (("pod", "model"), (8, 16)),
                        (("model", "model"), (8, 16)), (("data",), (3, 4)), (None, (4,))):
        from jax.sharding import PartitionSpec as P

        jspec = None if spec is None else P(*spec)
        assert autoshard.sharding_from_spec(MESH2D, spec, shape).dims_mapping == \
            jas.sharding_from_spec(JMESH2D, jspec, shape).dims_mapping


# ---------------------------------------------------------------------------------
# (f) spmd_partition(autoshard=) on the CPU
# ---------------------------------------------------------------------------------


def test_spmd_partition_autoshard_runs_the_searched_plan_and_caches_it():
    """The MLP on a simulated (2, 4) mesh with no annotation, under a budget
    that replication does not meet: the searched plan shards, equals the
    unpartitioned program, and a second call site reuses the assignment; an
    unmeetable budget raises, and another config searches anew."""
    captured = _mlp_captured()
    repl = autoshard.Evaluator(captured, MESH2D)([None] * 3).cost.peak_bytes
    cfg = autoshard.AutoshardConfig(budget_bytes=0.6 * repl, top_n=3, sa_steps=4)
    autoshard.clear_assignment_cache()
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in MLP_SHAPES]
    runner = spmd_partition(_mlp, MESH2D, autoshard=cfg, process_cache=False, device="cpu")
    assert_close(runner(*args), _mlp(*args), "f32_chain")
    plan = next(iter(runner.plans.values())).plan
    assert any(not s.is_fully_replicated() for s in plan.in_shardings)
    assert plan.peak_bytes <= cfg.budget_bytes
    assert len(as_api._ASSIGNMENT_CACHE) == 1
    evals = obs_metrics.registry().counter("autoshard.evals").value
    runner2 = spmd_partition(_mlp, MESH2D, autoshard=cfg, process_cache=False, device="cpu")
    assert_close(runner2(*args), _mlp(*args), "f32_chain")
    assert len(as_api._ASSIGNMENT_CACHE) == 1
    assert obs_metrics.registry().counter("autoshard.evals").value == evals
    with pytest.raises(ValueError, match="autoshard: no feasible assignment found"):
        spmd_partition(_mlp, MESH2D, autoshard=autoshard.AutoshardConfig(budget_bytes=1.0),
                       process_cache=False, device="cpu")(*args)
    other = spmd_partition(_mlp, MESH2D, autoshard=autoshard.AutoshardConfig(top_n=2,
                                                                             sa_steps=2),
                           process_cache=False, device="cpu")
    assert_close(other(*args), _mlp(*args), "f32_chain")
    assert len(as_api._ASSIGNMENT_CACHE) == 3  # the refused config's search is cached too


# ---------------------------------------------------------------------------------
# (g) the pipeline search
# ---------------------------------------------------------------------------------


def test_solve_with_pipeline_returns_mixed_assignment():
    """tests/test_pipeline_subsystem.py's case on the port, its budget from
    the port's own peaks: midway between the pipelined baseline's and the
    lowest of the pure-tensor layouts' (replicated and Table-1), so that the
    §3.3 rewrite fits where the pure-tensor search finds nothing.
    ``solve`` keeps the pure-tensor result unless a pipelined point scores
    no worse, so a chosen decision is at or below the best pure-tensor
    assignment."""
    from repro_torch.pipeline import PipelineDecision

    kw = dict(batch=4, seq=32, reduce_k=6)
    knobs = dict(top_n=2, sa_steps=2, beam_width=2, max_candidates=6)
    captured, base = autoshard.registry_problem("qwen1.5-0.5b", MESH2D, **kw)
    ev = autoshard.Evaluator(captured, MESH2D)
    pure_floor = min(ev(base).cost.peak_bytes, ev([None] * len(base)).cost.peak_bytes)
    dec = PipelineDecision("model", 4, 2)
    captured_p, base_p, _ = autoshard.registry_pipeline_problem("qwen1.5-0.5b", MESH2D, dec,
                                                                **kw)
    pipe_peak = autoshard.Evaluator(captured_p, MESH2D)(base_p).cost.peak_bytes
    assert pipe_peak < pure_floor
    cfg = autoshard.AutoshardConfig(budget_bytes=(pipe_peak + pure_floor) / 2, **knobs)
    res = autoshard.solve("qwen1.5-0.5b", MESH2D, cfg, **kw, pipeline=PipelineConfig(
        max_stages=4, num_microbatches=2, stage_axes=("model",)))
    assert res.pipeline is not None, "no pipeline decision chosen"
    assert res.evaluation.feasible and res.cost.peak_bytes <= cfg.budget_bytes
    assert res.pipeline["stage_axis"] == "model" and res.pipeline["num_stages"] == 4
    assert res.pipeline["bubble_fraction"] == pytest.approx(bubble_fraction(4, 2))
    assert res.pipeline["ppermute_launches"] == pipeline_ticks(4, 2)
    assert any(s is not None and any(a != "model" for dm in s.dims_mapping for a in dm)
               for s in res.assignment)
    assert res.to_json()["pipeline"]["num_microbatches"] == 2


def test_mem_term_breaks_pipeline_search_tie():
    """The soft-memory objective term: a pipelined step that threads a
    prefetch buffer through untouched has a roofline tie (sharding it moves
    no wire byte and no FLOP), so with the term off the greedy sweep keeps
    the propagation default; with it on, the lower-peak assignment wins."""
    from repro_torch.pipeline import pipelined_apply

    S, M_, L, D, MB = 4, 4, 4, 8, 2
    mesh = Mesh.create((S,), ("stage",))

    def fn(wstk, xs, prefetch):
        ys = pipelined_apply(lambda lp, x, _: torch.tanh(x @ lp), wstk, xs, num_stages=S,
                             mesh=mesh, stage_axis="stage")
        return (ys ** 2).mean()

    captured = capture(fn, torch.empty((S, L // S, D, D), device="meta"),
                       torch.empty((M_, MB, D), device="meta"),
                       torch.empty((64, MB, D), device="meta"))  # the largest input
    cfg = dict(top_n=1, sa_steps=0, max_candidates=8)
    off = autoshard.solve_problem(captured, mesh, autoshard.AutoshardConfig(**cfg))
    on = autoshard.solve_problem(captured, mesh, autoshard.AutoshardConfig(
        mem_weight=1.0, soft_budget_bytes=0.0, **cfg))
    assert off.evaluation.cost.mem_s == 0.0
    assert on.evaluation.cost.mem_s > 0.0
    assert on.cost.wire_bytes == off.cost.wire_bytes
    assert on.cost.flops_per_device == off.cost.flops_per_device
    assert on.cost.peak_bytes < off.cost.peak_bytes
    assert off.assignment[2] is None and on.assignment[2] is not None
    assert on.cost.as_dict()["mem_s"] == on.evaluation.cost.mem_s
    # weight 0 leaves every cost as it was; mem_s needs a profile, as total_s
    bare = dataclasses.replace(off.cost, params=None)
    with pytest.raises(ValueError, match="machine profile"):
        bare.mem_s  # noqa: B018
    assert "mem_s" not in bare.as_dict()


# ---------------------------------------------------------------------------------
# (h) the evaluator's reasons, its faults, and the metrics
# ---------------------------------------------------------------------------------


def test_evaluator_reasons_faults_and_metrics(monkeypatch):
    from repro_torch.autoshard import evaluate as ev_mod
    from repro_torch.core.collective_planner import PlanError
    from repro_torch.core.plan_verify import PlanVerifyError

    captured = _mlp_captured()
    before = obs_metrics.snapshot(include_sources=False)
    ev = autoshard.Evaluator(captured, MESH2D)
    ok = ev([None] * 3)
    assert ok.feasible and math.isfinite(ok.score) and ev.lowerings == 1
    ev([None] * 3)
    assert ev.lowerings == 1  # memoized
    assert ok.cost.wire_bytes == 0.0 and ok.cost.flops_per_device > ok.cost.ideal_flops_per_device
    assert ev.invar_shapes() == MLP_SHAPES and ev.invar_dtype_bytes() == [4, 4, 4]
    tight = autoshard.Evaluator(captured, MESH2D, budget_bytes=1.0)([None] * 3)
    assert not tight.feasible and tight.score == math.inf and tight.cost is not None
    assert tight.reason == "over memory budget"

    def raising(exc):
        def lower(*a, **k):
            raise exc
        return lower

    s = Sharding(MESH2D, (("data",), ()))
    for exc, prefix in ((PlanVerifyError("a fused step's accounting"), "verify: "),
                        (PlanError("an inexpressible reshard"), "plan: ")):
        monkeypatch.setattr(ev_mod, "lower_for_cost", raising(exc))
        got = autoshard.Evaluator(captured, MESH2D)([s, None, None])
        assert not got.feasible and got.cost is None and got.reason.startswith(prefix), got
    monkeypatch.setattr(ev_mod, "lower_for_cost", raising(KeyError("a port fault")))
    with pytest.raises(KeyError, match="a port fault"):
        autoshard.Evaluator(captured, MESH2D)([s, None, None])
    monkeypatch.undo()
    autoshard.solve_jaxpr(captured, MESH2D, autoshard.AutoshardConfig(top_n=1, sa_steps=1,
                                                                      max_candidates=2))
    after = obs_metrics.snapshot(include_sources=False)

    def count(snap, kind, name):
        v = snap[kind].get(name)
        return 0 if v is None else (v if kind == "counters" else v["count"])

    for kind, name in (("counters", "autoshard.evals"), ("counters", "autoshard.solves"),
                       ("histograms", "autoshard.eval_ms"),
                       ("histograms", "autoshard.search_ms")):
        assert count(after, kind, name) > count(before, kind, name), name
