"""Sharding-strategy search over input assignments (Automap-style moves).

A port of the JAX package's ``autoshard/search.py``; every random draw is
made in the reference's order, so that Python's ``random.Random(seed)``
walks the same moves in both packages.

The searched object is an *assignment*: one ``Optional[Sharding]`` per
input of the captured program, where ``None`` leaves the tensor to
propagation.  The search only touches the ``top_n`` largest inputs (by
global bytes): a few seed annotations suffice and the partitioner infers
the rest, so the search space is the seed set, not every tensor of the
program.

Phases (all deterministic under ``seed``):

0. **warm start**: a given assignment is scored first and, when feasible,
   takes the place of phase 1.
1. **greedy incumbent**: from the propagation default (all ``None``),
   sweep the searched tensors largest first, fixing for each the candidate
   that minimizes the whole-program cost with the others held.
2. **beam and annealing refinement**: keep the ``beam_width`` best
   assignments seen; each round mutates a beam member with one of the
   neighborhood moves (reshard one tensor, swap two mesh axes everywhere,
   flip two dims of one tensor) and accepts worse neighbors into the beam
   with a decaying temperature, so the search can cross cost ridges the
   greedy sweep cannot.

Every candidate is priced by cost-only lowering (``evaluate.Evaluator``),
and infeasible candidates score ``inf``.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.sharding import Mesh, Sharding
from . import space as space_mod
from .evaluate import Evaluation, Evaluator
from .space import MaybeSharding


@dataclasses.dataclass
class SearchResult:
    assignment: List[MaybeSharding]
    evaluation: Evaluation
    evals: int  # cost lowerings actually performed
    searched_invars: Tuple[int, ...]  # input indices the search touched
    history: List[float]  # best score after each accepted improvement
    warm_used: bool = False  # init_assignment was feasible and seeded phase 2


def _global_bytes(shape, db) -> float:
    return float(db) * float(np.prod(shape or (1,)))


def search(
    evaluator: Evaluator,
    mesh: Mesh,
    top_n: int = 6,
    beam_width: int = 4,
    sa_steps: int = 16,
    seed: int = 0,
    max_candidates: int = 16,
    init_assignment: Optional[Sequence[MaybeSharding]] = None,
) -> SearchResult:
    """Find the cheapest feasible input-sharding assignment.

    Never returns something worse than the best point it scored; with no
    feasible point the propagation default (all ``None``) is returned with
    an infeasible evaluation, so that callers can tell.

    ``init_assignment`` warm-starts the search: the point is scored first
    and, when feasible, replaces the phase-1 greedy sweep (refinement
    starts from it), so a warm solve performs strictly fewer cost lowerings
    than a cold one.  An infeasible warm point falls back to the cold path.
    """
    rng = random.Random(seed)
    shapes = evaluator.invar_shapes()
    dbytes = evaluator.invar_dtype_bytes()
    n = len(shapes)
    order = sorted(range(n), key=lambda i: -_global_bytes(shapes[i], dbytes[i]))
    searched = tuple(i for i in order[:top_n] if np.prod(shapes[i] or (1,)) > 1)
    spaces = {
        i: [None] + candidate_list(shapes[i], mesh, max_candidates, dbytes[i],
                                   evaluator.budget_bytes)
        for i in searched
    }

    # -- phase 0: warm start (skips the greedy sweep when feasible) ---------
    if init_assignment is not None:
        warm = list(init_assignment)[:n] + [None] * max(0, n - len(init_assignment))
        warm = [
            s if s is None or (s.mesh is mesh or s.mesh.shape == mesh.shape)
            and _divisible_assignment(shapes[i], s) else None
            for i, s in enumerate(warm)
        ]
        warm_ev = evaluator(warm)
        if math.isfinite(warm_ev.score):
            res = _refine(evaluator, mesh, rng, shapes, searched, spaces, beam_width, sa_steps,
                          warm, warm_ev, [warm_ev.score])
            res.warm_used = True
            return res

    best: List[MaybeSharding] = [None] * n
    best_ev = evaluator(best)
    history: List[float] = [best_ev.score]

    # -- phase 1: greedy sweep, largest tensor first ------------------------
    for i in searched:
        cur_best = spaces[i][0]
        cur_score = best_ev.score
        for cand in spaces[i][1:]:
            trial = list(best)
            trial[i] = cand
            ev = evaluator(trial)
            if ev.score < cur_score:
                cur_best, cur_score, best_ev = cand, ev.score, ev
        best[i] = cur_best
        history.append(best_ev.score)

    return _refine(evaluator, mesh, rng, shapes, searched, spaces, beam_width, sa_steps,
                   best, best_ev, history)


def _refine(evaluator, mesh, rng, shapes, searched, spaces, beam_width, sa_steps,
            best, best_ev, history) -> SearchResult:
    # -- phase 2: beam and annealing over neighborhood moves ----------------
    beam: List[Tuple[float, List[MaybeSharding]]] = [(best_ev.score, list(best))]

    def try_insert(score: float, assignment: List[MaybeSharding]) -> None:
        nonlocal best, best_ev
        if any(a == assignment for _, a in beam):
            return
        beam.append((score, assignment))
        beam.sort(key=lambda t: t[0])
        del beam[beam_width:]
        if score < best_ev.score:
            best, best_ev = list(assignment), evaluator(assignment)
            history.append(score)

    t0 = max(best_ev.score, 1e-9)
    for step in range(sa_steps):
        base = rng.choice(beam)[1] if beam else list(best)
        trial = list(base)
        move = rng.random()
        if move < 0.5 and searched:
            # reshard one tensor
            i = rng.choice(searched)
            trial[i] = rng.choice(spaces[i])
        elif move < 0.8 and len(mesh.axis_names) >= 2:
            # swap two mesh axes across the whole assignment
            a, b = rng.sample(list(mesh.axis_names), 2)
            trial = [space_mod.swap_axes(s, a, b) for s in trial]
            trial = [s if s is None or _divisible_assignment(shapes[i], s) else None
                     for i, s in enumerate(trial)]
        elif searched:
            # flip two dims of one tensor (batch against model)
            cands = [i for i in searched if trial[i] is not None and trial[i].rank >= 2]
            if not cands:
                continue
            i = rng.choice(cands)
            d1, d2 = rng.sample(range(trial[i].rank), 2)
            flipped = space_mod.flip_dims(trial[i], d1, d2)
            if not _divisible_assignment(shapes[i], flipped):
                continue
            trial[i] = flipped
        else:
            continue
        ev = evaluator(trial)
        if not math.isfinite(ev.score):
            continue
        # annealing acceptance into the beam: always when better than the
        # beam's worst, else with a decaying probability (seeded rng)
        worst = beam[-1][0] if beam else math.inf
        temp = t0 * (1.0 - step / max(sa_steps, 1)) + 1e-12
        if ev.score < worst or rng.random() < math.exp(min((worst - ev.score) / temp, 0.0)):
            try_insert(ev.score, trial)

    return SearchResult(assignment=best, evaluation=best_ev, evals=evaluator.lowerings,
                        searched_invars=searched, history=history)


def candidate_list(shape, mesh, max_candidates, dtype_bytes, budget):
    return space_mod.candidate_shardings(shape, mesh, max_candidates=max_candidates,
                                         dtype_bytes=dtype_bytes, budget_bytes=budget)


def _divisible_assignment(shape, s: Sharding) -> bool:
    return space_mod._divisible(tuple(shape), s.dims_mapping, s.mesh)
