"""Autoshard entry points: annotation-free sharding for captured programs
and registry configs (a port of the JAX package's ``autoshard/api.py``).

Two front doors:

* ``spmd_partition(fn, mesh, autoshard=AutoshardConfig(...))``
  (``core/partitioner.py``): the captured program's input shardings are
  searched instead of read from ``annotate`` seeds; the assignment is
  cached process-wide by the program's digest, the mesh, the config and
  the pricing profile.
* :func:`solve`: search a model-registry config.  It captures the family's
  ``loss_fn`` on a reduced config with no ``Strategy.constrain``
  annotation (no ambient mesh while capturing, so every constraint is a
  no-op), searches the input/parameter assignment, and compares it with
  the hand-annotated baseline (the config's default Table-1 ``Strategy``
  applied to the same inputs).

An assignment holds one entry per input of the captured program, in its
placeholder order.  The registry problems capture their inputs in the JAX
package's leaf order (params by sorted keys, then ``labels``, ``tokens``),
so that an assignment, its ``searched_invars`` and its JSON dump mean the
same inputs in both packages.

Assignments serialize to JSON (:meth:`AutoshardResult.to_json` /
:func:`assignment_from_json`, the reference's version 1): the dump pins the
mesh shape and axis names, the per-input dims_mapping (or null: left to
propagation), the search config, and both modeled costs.

The port has no default machine constants: a config with ``profile=None``
prices with ``obs.profile.resolve_profile(None)`` (the environment's
profile, else the committed H100 one), and the resolved profile's digest
keys the assignment cache.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.roofline import RooflineParams
from ..core.sharding import Mesh, Sharding, project_dims_mapping, replicated
from ..obs import metrics as obs_metrics
from .evaluate import Evaluation, Evaluator
from .search import search
from .space import MaybeSharding


@dataclasses.dataclass(frozen=True)
class AutoshardConfig:
    """Search knobs (all deterministic under ``seed``).

    ``budget_bytes`` is the per-device live-memory budget (params and peak
    activations under the plan-level memory model); ``None`` switches the
    constraint off.  ``top_n`` bounds how many (largest) inputs are
    searched; the rest are left to propagation.  ``mem_weight`` /
    ``soft_budget_bytes`` price overshoot above a soft budget into the
    objective (``PlanCost.mem_s``), off at weight 0.  ``profile`` (a
    ``RooflineParams``) prices every cost-only lowering of the search;
    ``None`` resolves as ``obs.profile.resolve_profile(None)`` does.
    """

    budget_bytes: Optional[float] = None
    top_n: int = 6
    beam_width: int = 4
    sa_steps: int = 16
    seed: int = 0
    max_candidates: int = 16
    optimize: bool = True  # run the plan_opt passes inside cost-only scoring
    mem_weight: float = 0.0
    soft_budget_bytes: Optional[float] = None
    profile: Optional[RooflineParams] = None

    def cache_key(self) -> tuple:
        return dataclasses.astuple(self)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AutoshardResult:
    """A searched assignment with its modeled cost context."""

    mesh: Mesh
    assignment: List[MaybeSharding]  # one per input; None = inferred
    evaluation: Evaluation
    config: AutoshardConfig
    evals: int = 0
    searched_invars: Tuple[int, ...] = ()
    baseline: Optional[Evaluation] = None
    arch: str = ""
    # the pipeline search's outcome: None for a pure-tensor assignment, else
    # the chosen decision and its schedule terms (ScheduleCost.as_dict)
    pipeline: Optional[Dict] = None
    # warm-started from a prior assignment whose point was feasible
    warm_started: bool = False

    @property
    def cost(self):
        return self.evaluation.cost

    @property
    def baseline_cost(self):
        return self.baseline.cost if self.baseline is not None else None

    @property
    def ratio_vs_baseline(self) -> float:
        """Searched over hand-annotated modeled seconds (at most 1.0 when
        the baseline was scored as a search point)."""
        if self.baseline is None or not self.baseline.feasible:
            return 0.0
        base = self.baseline.score
        return self.evaluation.score / base if base else 1.0

    def to_json(self) -> Dict:
        return {
            "version": 1,
            "arch": self.arch,
            "mesh": {"shape": list(self.mesh.shape), "axes": list(self.mesh.axis_names)},
            "assignment": [None if s is None else [list(axes) for axes in s.dims_mapping]
                           for s in self.assignment],
            "config": self.config.as_dict(),
            "evals": self.evals,
            "searched_invars": list(self.searched_invars),
            "cost": self.cost.as_dict() if self.cost is not None else None,
            "baseline_cost": (self.baseline_cost.as_dict()
                              if self.baseline_cost is not None else None),
            "pipeline": dict(self.pipeline) if self.pipeline else None,
            "warm_started": self.warm_started,
        }

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)
        return path


def assignment_from_json(rec: Dict) -> Tuple[Mesh, List[MaybeSharding]]:
    """Rebuild (mesh, assignment) from an :meth:`AutoshardResult.to_json`
    record (the JAX package's dumps too).  The mesh is rebuilt in row-major
    device order (``Mesh.create``)."""
    m = rec["mesh"]
    mesh = Mesh.create(tuple(m["shape"]), tuple(m["axes"]))
    return mesh, [None if ent is None else Sharding(mesh, tuple(tuple(a) for a in ent))
                  for ent in rec["assignment"]]


def load(path: str) -> Tuple[Mesh, List[MaybeSharding]]:
    with open(path) as f:
        return assignment_from_json(json.load(f))


def remap_assignment(assignment: Sequence[MaybeSharding], mesh: Mesh,
                     shapes: Sequence[Sequence[int]]) -> List[MaybeSharding]:
    """Re-express a (possibly foreign-mesh) assignment on ``mesh`` by name:
    axes absent from the new mesh, reused, or no longer dividing the dim are
    dropped (propagation handles them).  This is how a prior solve's dump
    becomes a warm start after an elastic mesh shrink or regrow."""
    out: List[MaybeSharding] = [
        None if s is None else project_dims_mapping(mesh, s.dims_mapping, tuple(shape))
        for s, shape in zip(assignment, shapes)]
    return out + [None] * (len(shapes) - len(out))


def restrict_assignment(assignment: Sequence[MaybeSharding], mesh: Mesh,
                        shapes: Sequence[Sequence[int]],
                        keep_axes: Sequence[str] = ("data",)) -> List[MaybeSharding]:
    """Degrade an assignment to ``keep_axes`` only (default: data-parallel
    only), the fallback layout when a warm re-solve is infeasible under a
    shrunk mesh's memory budget."""
    keep = set(keep_axes)
    out: List[MaybeSharding] = []
    for s, shape in zip(assignment, shapes):
        if s is None:
            out.append(None)
            continue
        dm = tuple(tuple(a for a in axes if a in keep) for axes in s.dims_mapping)
        out.append(project_dims_mapping(mesh, dm, tuple(shape)))
    return out + [None] * (len(shapes) - len(out))


def expand_assignment(assignment: Sequence[MaybeSharding], mesh: Mesh,
                      shapes: Sequence[Sequence[int]]) -> List[MaybeSharding]:
    """Lift a smaller-mesh assignment onto a grown ``mesh``, the regrow
    counterpart of :func:`restrict_assignment`: after
    :func:`remap_assignment`, each mesh axis of size > 1 that a tensor no
    longer uses is appended to its largest dim where divisibility holds, so
    that a warm start after a regrow proposes model parallelism again."""
    out = remap_assignment(assignment, mesh, shapes)
    for i, (s, shape) in enumerate(zip(out, shapes)):
        if s is None:
            continue
        shape = tuple(shape)
        used = set(s.sharded_axes)
        free = [a for a in mesh.axis_names if a not in used and mesh.axis_size(a) > 1]
        if not free:
            continue
        dm = [list(axes) for axes in s.dims_mapping]
        for a in free:
            best = None
            for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
                n = int(np.prod([mesh.axis_size(x) for x in dm[d]] or [1]))
                if shape[d] % (n * mesh.axis_size(a)) == 0:
                    best = d
                    break
            if best is not None:
                dm[best].append(a)
        out[i] = Sharding(mesh, tuple(tuple(x) for x in dm))
    return out


# ---------------------------------------------------------------------------------
# solving one captured program, and the process-level assignment cache
# ---------------------------------------------------------------------------------


def solve_problem(captured, mesh: Mesh, config: AutoshardConfig = AutoshardConfig(),
                  baseline: Optional[Sequence[MaybeSharding]] = None, arch: str = "",
                  warm_start: Optional[Sequence[MaybeSharding]] = None) -> AutoshardResult:
    """Search one captured program (``compat.Captured``), optionally against
    a hand-annotated ``baseline`` assignment scored as an extra search
    point: the result never costs more than the baseline.

    ``warm_start`` (an assignment on ``mesh``, typically a prior result's
    dump remapped by :func:`remap_assignment`) seeds the search: when the
    warm point is feasible the greedy sweep is skipped, so a warm solve
    performs strictly fewer cost lowerings than a cold one."""
    ev = Evaluator(captured, mesh, budget_bytes=config.budget_bytes, optimize=config.optimize,
                   mem_weight=config.mem_weight, soft_budget_bytes=config.soft_budget_bytes,
                   profile=config.profile)
    t0 = time.perf_counter()
    base_ev = ev(list(baseline)) if baseline is not None else None
    res = search(ev, mesh, top_n=config.top_n, beam_width=config.beam_width,
                 sa_steps=config.sa_steps, seed=config.seed,
                 max_candidates=config.max_candidates, init_assignment=warm_start)
    obs_metrics.inc("autoshard.solves")
    obs_metrics.observe("autoshard.search_ms", (time.perf_counter() - t0) * 1e3)
    assignment, final = res.assignment, res.evaluation
    if base_ev is not None and base_ev.score < final.score:
        assignment, final = list(baseline), base_ev
    return AutoshardResult(mesh=mesh, assignment=assignment, evaluation=final, config=config,
                           evals=ev.lowerings, searched_invars=res.searched_invars,
                           baseline=base_ev, arch=arch, warm_started=res.warm_used)


def solve_jaxpr(captured, mesh: Mesh,
                config: AutoshardConfig = AutoshardConfig()) -> AutoshardResult:
    """Search the input-sharding assignment of one captured program (the
    reference's name; the port's programs are ``compat.Captured`` graphs)."""
    return solve_problem(captured, mesh, config)


_ASSIGNMENT_CACHE: Dict[tuple, AutoshardResult] = {}
_ASSIGNMENT_LOCK = threading.Lock()


def solve_jaxpr_cached(captured, mesh: Mesh, config: AutoshardConfig) -> AutoshardResult:
    """Process-level cache in front of :func:`solve_jaxpr`, keyed like the
    plan cache (the program's content digest, the mesh, the config and the
    digest of the profile that prices the search), so that repeated
    ``spmd_partition`` call sites pay for the search once."""
    from ..obs.profile import resolve_profile

    key = (captured.digest(), mesh.structural_key(), config.cache_key(),
           resolve_profile(config.profile).digest())
    with _ASSIGNMENT_LOCK:
        hit = _ASSIGNMENT_CACHE.get(key)
    if hit is not None:
        return hit
    res = solve_jaxpr(captured, mesh, config)
    with _ASSIGNMENT_LOCK:
        _ASSIGNMENT_CACHE[key] = res
    return res


def clear_assignment_cache() -> None:
    with _ASSIGNMENT_LOCK:
        _ASSIGNMENT_CACHE.clear()


# ---------------------------------------------------------------------------------
# registry-level solve (annotation-free model sharding)
# ---------------------------------------------------------------------------------


def sharding_from_spec(mesh: Mesh, spec, shape: Sequence[int]) -> Sharding:
    """A partition spec (a tuple of None / axis / tuple of axes) as a
    ``Sharding`` on ``mesh``, dropping axes absent from the mesh, axes
    already used, and axes that do not divide the dim (§4.1 fallback)."""
    shape = tuple(int(s) for s in shape)
    if spec is None:
        return replicated(mesh, len(shape))
    entries = list(spec) + [None] * (len(shape) - len(spec))
    dm: List[Tuple[str, ...]] = []
    used: set = set()
    for i, e in enumerate(entries[:len(shape)]):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        kept: List[str] = []
        n = 1
        for a in axes:
            if a in mesh.axis_names and a not in used \
                    and shape[i] % (n * mesh.axis_size(a)) == 0:
                kept.append(a)
                used.add(a)
                n *= mesh.axis_size(a)
        dm.append(tuple(kept))
    return Sharding(mesh, tuple(dm))


def _registry_config(arch: str, reduce_k: int):
    from ..configs.base import get_strategy
    from ..configs.registry import default_strategy, get_config, reduced_config

    cfg = reduced_config(get_config(arch), reduce_k).with_(attn_chunk=16, remat="none")
    return cfg, get_strategy(default_strategy(arch))


def _meta_batch(batch: int, seq: int):
    """The registry batch as meta tensors, keys in the reference's leaf order,
    int32 as the reference's."""
    import torch

    return {k: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for k in ("labels", "tokens")}


def _capture_with_baseline(fn, tree, cfg, mesh: Mesh, batch_in):
    """Capture ``fn(params, batch)`` on meta tensors with the inputs in the
    reference's leaf order, and the baseline: each param's declared spec and
    the batch on ("data",), as ``Sharding``s on the same inputs."""
    from ..core.compat import capture
    from ..core.rules import aval
    from ..core.tree import leaves_with_paths, tree_from_paths
    from ..models.layers import tree_shapes, tree_specs

    params = tree_from_paths(leaves_with_paths(tree_shapes(tree, cfg.param_dtype)))
    captured = capture(fn, params, batch_in)
    spec_leaves = [s for _, s in leaves_with_paths(tree_specs(tree))]
    spec_leaves += [("data",)] * len(batch_in)
    if len(spec_leaves) != len(captured.invars):
        raise AssertionError((len(spec_leaves), len(captured.invars)))
    baseline = [sharding_from_spec(mesh, s, aval(v).shape)
                for s, v in zip(spec_leaves, captured.invars)]
    return captured, baseline


def registry_problem(arch: str, mesh: Mesh, batch: int = 8, seq: int = 32, reduce_k: int = 16):
    """Capture one registry config's loss annotation-free and derive the
    hand-annotated baseline assignment from its default Strategy.

    Returns ``(captured, baseline_assignment)``.  The model is reduced
    (``configs.registry.reduced_config``) so that each cost-only lowering
    stays in the tens of milliseconds; the program's structure (the scanned
    layer body) is the full config's."""
    from ..models import api as model_api

    cfg, st = _registry_config(arch, reduce_k)
    tree = model_api.param_tree(cfg, st)
    return _capture_with_baseline(lambda p, b: model_api.loss_fn(cfg, st, p, b), tree, cfg,
                                  mesh, _meta_batch(batch, seq))


def registry_pipeline_problem(arch: str, mesh: Mesh, decision, batch: int = 8, seq: int = 32,
                              reduce_k: int = 16):
    """Capture one registry config's loss in §3.3 stage-stacked pipelined
    form (``pipeline.stages.pipelined_loss_fn`` under ``decision``) and
    derive the pipelined baseline: stacked-layer leaves get the stage axis
    on their leading dim, then the Table-1 spec on the body dims (axes the
    stage dim already uses are dropped); every other input keeps its
    unpipelined Table-1 spec.

    Returns ``(captured, baseline_assignment, state)``; ``state`` is the
    global shifting buffer as a float32 meta tensor, which sizes the
    schedule cost model's activation-memory term."""
    import torch

    from ..models import api as model_api
    from ..models.layers import tree_map_params
    from ..pipeline.stages import pipelined_loss_fn

    cfg, st = _registry_config(arch, reduce_k)
    if cfg.num_layers % decision.num_stages:
        raise ValueError(f"{arch}: {cfg.num_layers} layers not divisible into "
                         f"{decision.num_stages} stages")
    if model_api.pipeline_boundary(cfg, st) is None:
        raise ValueError(f"{arch}: no stackable-layer boundary")
    tree = model_api.param_tree(cfg, st)
    S = decision.num_stages

    def stage_stack_decl(p, _path):
        # (L, ...) declaration -> (S, L/S, ...); the spec gains the stage axis
        # on dim 0 (the leading None came from models.layers.stacked)
        entries = tuple(p["spec"]) if p["spec"] is not None else (None,)
        return {**p, "shape": (S, p["shape"][0] // S) + tuple(p["shape"][1:]),
                "spec": (decision.stage_axis,) + entries}

    tree["layers"] = tree_map_params(stage_stack_decl, tree["layers"])
    captured, baseline = _capture_with_baseline(
        lambda p, b: pipelined_loss_fn(cfg, st, p, b, decision, mesh), tree, cfg, mesh,
        _meta_batch(batch, seq))
    mb = batch // decision.num_microbatches
    state = torch.empty((S, mb, seq, cfg.d_model), dtype=torch.float32, device="meta")
    return captured, baseline, state


def solve(arch: str, mesh: Optional[Mesh] = None, config: AutoshardConfig = AutoshardConfig(),
          batch: int = 8, seq: int = 32, reduce_k: int = 16, pipeline=None,
          warm_start=None) -> AutoshardResult:
    """Annotation-free sharding for a registry config on ``mesh`` (default
    ("data" 2, "model" 4)).

    Searches the input/parameter assignment of the (reduced) config's loss,
    scores the hand-annotated Table-1 baseline as an extra search point,
    and returns the winner: its modeled cost never exceeds the baseline's.

    With ``pipeline`` (a ``pipeline.PipelineConfig``) the decision space
    widens to §3.3 stage-stacked pipelining: every (stage axis, stage count,
    microbatch count) point is rewritten by ``pipelined_loss_fn`` and
    searched jointly with tensor sharding; the cheapest feasible point,
    pipelined or pure-tensor, wins (a pipelined point also wins exact ties).
    The chosen decision and its schedule terms land in ``result.pipeline``.
    ``warm_start`` (a prior assignment, on any mesh) is remapped onto
    ``mesh`` by name and seeds the search.
    """
    from ..core.rules import aval

    mesh = mesh if mesh is not None else Mesh.create((2, 4), ("data", "model"))
    captured, baseline = registry_problem(arch, mesh, batch, seq, reduce_k)
    if warm_start is not None:
        shapes = [aval(v).shape for v in captured.invars]
        warm_start = remap_assignment(warm_start, mesh, shapes)
    best = solve_problem(captured, mesh, config, baseline=baseline, arch=arch,
                         warm_start=warm_start)
    if pipeline is None:
        return best
    from ..obs.profile import resolve_profile
    from ..pipeline.schedule import schedule_cost
    from .space import pipeline_decisions

    cfg, _ = _registry_config(arch, reduce_k)
    for dec in pipeline_decisions(mesh, cfg.num_layers, batch, pipeline):
        try:
            captured_p, baseline_p, state = registry_pipeline_problem(arch, mesh, dec, batch, seq,
                                                                      reduce_k)
        except ValueError:
            continue
        res = solve_problem(captured_p, mesh, config, baseline=baseline_p, arch=arch)
        if not res.evaluation.feasible:
            continue
        if res.evaluation.score <= best.evaluation.score:
            sched = schedule_cost(captured_p, res.assignment, mesh, dec,
                                  profile=resolve_profile(config.profile), state=state)
            res.pipeline = sched.as_dict()
            best = res
    return best
