"""The whole-program plan optimizer (``core/plan_opt.py``) against the JAX
package's (``tests/test_plan_opt.py``'s programs and cases).

* report parity: each program of tests/test_plan_opt.py that needs no pjit
  and no scan, lowered in both packages (``lower_plan``, cost-only, one
  pinned ``RooflineParams`` in both), gives equal ``OptReport``s in
  collective launches and wire bytes before and after, in the reshards CSE
  and DCE remove, and in the fused buckets' members and wire bytes.  Step
  counts are not compared: the aten lowering has more steps by design
  (ROADMAP Queue C, the aten lowering against the jaxpr lowering);
* the cases: CSE of a shared operand and of a duplicate feeding an output,
  dead reshards, fusion buckets (hoisted and sunk members, a dependency
  chain, the bucket cap), write-before-read under every pass, the
  schedule's determinism and the report's schema;
* execution: every program optimized equals it unoptimized bit for bit on
  the simulated (4,8) mesh; and the two-layer partitioned gradient programs
  of qwen (2d_finalized) and Mamba2 (float32) optimized equal them
  unoptimized bit for bit, with the same kernel operator steps.

The reference's two inline tests stay out (R1: its pjit pass does not fire
on jax 0.9.0); its scan-hoist tests are in tests/test_torch_scan.py.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.analysis.roofline import RooflineParams as JRooflineParams
from repro.core import Mesh as JMesh
from repro.core import annotate as jannotate
from repro.core import mesh_split as jsplit
from repro.core.plan import lower_plan as jax_lower_plan
from repro_torch.analysis.roofline import RooflineParams, fusion_bucket_bytes
from repro_torch.configs.base import ModelConfig, get_strategy
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core import Mesh, annotate, mesh_split
from repro_torch.core.compat import capture, set_mesh
from repro_torch.core.partitioner import spmd_partition
from repro_torch.core.plan import compile_plan, lower_plan
from repro_torch.core.plan_opt import optimize_plan
from repro_torch.core.propagation import propagate
from repro_torch.core.tree import leaves, tree_map
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import api
from repro_torch.models.layers import tree_init
from repro_torch.train.loop import sharded_value_and_grad

MESH = Mesh.create((4, 8), ("x", "y"))
JMESH = JMesh.create((4, 8), ("x", "y"))
# one profile, pinned in both packages (not a device's constants)
PROFILE = dict(peak_flops=1e15, hbm_bw=3e12, ici_bw=4.5e11, collective_launch_s=2e-5,
               overlap_efficiency=0.9)


def split(dims, rank=2):
    return mesh_split(rank, MESH, dims), jsplit(rank, JMESH, dims)


Y, JY = split(["y", -1])
R, JR = split([-1, -1])


# ---------------------------------------------------------------------------------
# tests/test_plan_opt.py's programs, in both packages: (port fn, JAX fn, shapes)
# ---------------------------------------------------------------------------------


def _shared():
    def f(a, w1, w2):
        a, w1, w2 = annotate(a, Y), annotate(w1, Y), annotate(w2, Y)
        return (a @ w1) + (a @ w2)

    def g(a, w1, w2):
        a, w1, w2 = jannotate(a, JY), jannotate(w1, JY), jannotate(w2, JY)
        return (a @ w1) + (a @ w2)

    return f, g, [(64, 64)] * 3


def _fanout_psum(k=4):
    def f(a, *ws):
        a = annotate(a, Y)
        return tuple(annotate(a @ annotate(w, Y), R) for w in ws)

    def g(a, *ws):
        a = jannotate(a, JY)
        return tuple(jannotate(a @ jannotate(w, JY), JR) for w in ws)

    return f, g, [(64, 64)] * (k + 1)


def _duplicate_output():
    (px, jx), (pt, jt) = split(["x", -1]), split([-1, "y"])
    return (lambda a: (annotate(annotate(a, px), pt), annotate(annotate(a, px), pt)),
            lambda a: (jannotate(jannotate(a, jx), jt), jannotate(jannotate(a, jx), jt)),
            [(64, 64)])


def _dead_reshard():
    (px, jx), (pt, jt) = split(["x", -1]), split([-1, "y"])

    def f(a):
        a1 = annotate(a, px)
        annotate(a1, pt)
        return torch.tanh(a1)

    def g(a):
        a1 = jannotate(a, jx)
        jannotate(a1, jt)
        return jnp.tanh(a1)

    return f, g, [(64, 64)]


def _noop():
    px, jx = split(["x", -1])
    return (lambda a: annotate(annotate(a, px), px), lambda a: jannotate(jannotate(a, jx), jx),
            [(64, 64)])


def _gather_hoist():
    px, jx = split(["x", -1])

    def f(a, b):
        a, b = annotate(a, px), annotate(b, px)
        return torch.flip(a, (0,)) + torch.flip(b, (0,))

    def g(a, b):
        a, b = jannotate(a, jx), jannotate(b, jx)
        return lax.rev(a, (0,)) + lax.rev(b, (0,))

    return f, g, [(64, 32)] * 2


def _chain():
    def f(a, w1, w2):
        h1 = annotate(annotate(a, Y) @ annotate(w1, Y), R)
        return annotate(annotate(h1, Y) @ annotate(w2, Y), R)

    def g(a, w1, w2):
        h1 = jannotate(jannotate(a, JY) @ jannotate(w1, JY), JR)
        return jannotate(jannotate(h1, JY) @ jannotate(w2, JY), JR)

    return f, g, [(64, 64)] * 3


def _sunk_producer():
    (ps, js_), (px, jx) = split([("x", "y"), -1]), split(["x", -1])

    def f(u, a, v):
        u1 = annotate(annotate(u, ps), px)       # gather-y (bucket Y member 1)
        r1 = torch.flip(annotate(a, px), (0,))   # gather-x of a (bucket X member 1)
        v1 = annotate(annotate(v, ps), px)       # gather-y joins Y: sinks to here
        r2 = torch.flip(u1, (0,))                # gather-x of u1: must not hoist into X
        return r1, v1, r2

    def g(u, a, v):
        u1 = jannotate(jannotate(u, js_), jx)
        r1 = lax.rev(jannotate(a, jx), (0,))
        v1 = jannotate(jannotate(v, js_), jx)
        r2 = lax.rev(u1, (0,))
        return r1, v1, r2

    return f, g, [(64, 16)] * 3


def _overlap():
    px, jx = split(["x", -1])

    def f(a, w1, w2, p):
        h = torch.tanh(annotate(a, px) @ w1) @ w2  # a compute chain, no collective
        return h + annotate(annotate(p, Y), R)     # an independent gather

    def g(a, w1, w2, p):
        h = jnp.tanh(jannotate(a, jx) @ w1) @ w2
        return h + jannotate(jannotate(p, JY), JR)

    return f, g, [(256, 256)] * 4


PROGRAMS = {"shared": _shared, "fanout_psum": _fanout_psum,
            "duplicate_output": _duplicate_output, "dead_reshard": _dead_reshard,
            "noop": _noop, "gather_hoist": _gather_hoist, "chain": _chain,
            "sunk_producer": _sunk_producer, "overlap": _overlap}


def _lower(name, optimize=True):
    f, g, shapes = PROGRAMS[name]()
    mine = lower_plan(capture(f, *[torch.empty(s, device="meta") for s in shapes]), None, MESH,
                      optimize=optimize, profile=RooflineParams(**PROFILE))
    ref = jax_lower_plan(jax.make_jaxpr(g)(*[jax.ShapeDtypeStruct(s, jnp.float32)
                                            for s in shapes]),
                         None, JMESH, optimize=optimize, profile=JRooflineParams(**PROFILE))
    return mine, ref


def _plans(name):
    """The port's program captured once, its plan compiled raw and optimized."""
    f, _, shapes = PROGRAMS[name]()
    cap = capture(f, *[torch.empty(s, device="meta") for s in shapes])
    prop = propagate(cap, MESH).result()
    raw = compile_plan(cap, prop, MESH, optimize=False, cost_only=True,
                       profile=RooflineParams(**PROFILE))
    opt = compile_plan(cap, prop, MESH, optimize=True, cost_only=True,
                       profile=RooflineParams(**PROFILE))
    return raw, opt, cap, prop


def _pass(plan, name):
    (rep,) = [p for p in plan.opt_report.passes if p.name == name]
    return rep


def _reshards(plan):
    return [s for s in plan.steps if s.kind == "reshard"]


def _fused(plan):
    return [s for s in plan.steps if s.kind == "fused"]


def _check_write_before_read(plan):
    avail = {id(v) for v in plan.invars} | {id(v) for v in plan.consts}
    for i, s in enumerate(plan.steps):
        for r in s.reads:
            assert id(r) in avail, f"step {i} ({s.kind}/{s.op}) reads a value produced later"
        avail.update(id(w) for w in s.writes)
    for k in plan.out_keys:
        if isinstance(k, torch.fx.Node) or type(k).__name__ == "ProxyVar":
            assert id(k) in avail


# ---------------------------------------------------------------------------------
# report parity with the reference
# ---------------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_opt_report_matches_reference(name):
    mine, ref = _lower(name)
    got, want = mine.opt_report.as_dict(), ref.opt_report.as_dict()
    for k in ("collectives_before", "collectives_after", "wire_bytes_before", "wire_bytes_after",
              "fused_buckets"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    by_name = {p["name"]: p for p in want["passes"]}
    for p in got["passes"]:
        if p["name"] in ("reshard-cse", "dead-reshard-elim", "collective-fusion"):
            for k in ("removed_steps", "wire_bytes_saved", "fused_buckets", "fused_members",
                      "launch_s_saved"):
                assert p[k] == pytest.approx(by_name[p["name"]][k], rel=1e-12), (p["name"], k)
    assert [(s.op, len(s.reads), s.wire_bytes) for s in _fused(mine)] == [
        (s.op, len(s.reads), getattr(s, "_wire_bytes", 0.0)) for s in ref.steps
        if s.kind == "fused"]
    assert mine.stats.collectives == ref.stats.collectives
    _check_write_before_read(mine)


def test_optimize_needs_a_profile_and_takes_a_bucket_cap():
    f, _, shapes = _fanout_psum()
    cap = capture(f, *[torch.empty(s, device="meta") for s in shapes])
    with pytest.raises(ValueError, match="profile="):
        lower_plan(cap, None, MESH, optimize=True)
    with pytest.raises(ValueError, match="profile="):
        optimize_plan(lower_plan(cap, None, MESH, optimize=False))
    with pytest.raises(ValueError, match="RooflineParams"):
        fusion_bucket_bytes(None)
    p = RooflineParams(**PROFILE)
    assert fusion_bucket_bytes(p) == PROFILE["collective_launch_s"] * PROFILE["hbm_bw"] / 2


# ---------------------------------------------------------------------------------
# the passes' cases (tests/test_plan_opt.py)
# ---------------------------------------------------------------------------------


def test_cse_shared_operand_reshards_once():
    raw, opt, _, _ = _plans("shared")
    assert len(_reshards(raw)) == 2 and len(_reshards(opt)) == 1
    cse = _pass(opt, "reshard-cse")
    assert cse.removed_steps == 1 and cse.wire_bytes_saved > 0
    rep = opt.opt_report
    assert rep.wire_bytes_after < rep.wire_bytes_before
    assert rep.collectives_after < rep.collectives_before


def test_cse_duplicate_feeding_output_becomes_alias():
    raw, opt, _, _ = _plans("duplicate_output")
    assert len(_reshards(raw)) == 2 and len(_reshards(opt)) == 1
    assert len([s for s in opt.steps if s.kind == "compute" and s.op == "alias"]) == 1
    writes = {id(w) for s in opt.steps for w in s.writes}
    assert all(id(k) in writes for k in opt.out_keys)


def test_dead_reshard_eliminated_and_noop_never_emitted():
    raw, opt, _, _ = _plans("dead_reshard")
    dead = [s for s in _reshards(raw) if s.writes[0] not in raw.out_keys]
    assert len(dead) == 1 and dead[0].program.cost_bytes > 0
    assert [s for s in _reshards(opt) if s.writes[0] not in opt.out_keys] == []
    dce = _pass(opt, "dead-reshard-elim")
    assert dce.removed_steps == 1 and dce.wire_bytes_saved > 0
    raw, _, _, _ = _plans("noop")
    assert _reshards(raw) == []


def test_fused_allreduce_bucket():
    raw, opt, _, _ = _plans("fanout_psum")
    assert sum(1 for s in raw.steps if s.kind == "collective") == 4
    (fused,) = _fused(opt)
    assert fused.op == "fused-all-reduce" and len(fused.reads) == 4
    assert opt.opt_report.fused_buckets == 1
    assert opt.opt_report.collectives_after < opt.opt_report.collectives_before
    assert opt.stats.collectives.get("fused-all-reduce") == 1


def test_fused_gather_hoists_independent_members():
    _, opt, _, _ = _plans("gather_hoist")
    (fused,) = _fused(opt)
    assert fused.op == "fused-all-gather"
    idx = {id(s): i for i, s in enumerate(opt.steps)}
    flips = [s for s in opt.steps if s.op == "aten.flip"]
    assert flips and all(idx[id(fused)] < idx[id(r)] for r in flips)


def test_fusion_respects_dependency_chain():
    _, opt, _, _ = _plans("chain")
    assert _fused(opt) == []
    assert sum(1 for s in opt.steps if s.kind == "collective") == 2


def test_fusion_never_hoists_above_sunk_producer():
    raw, opt, _, _ = _plans("sunk_producer")
    _check_write_before_read(raw)
    _check_write_before_read(opt)
    assert any(s.op == "fused-all-gather" and s.axes == ("y",) for s in _fused(opt))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_all_passes_preserve_write_before_read(name):
    raw, opt, _, _ = _plans(name)
    _check_write_before_read(raw)
    _check_write_before_read(opt)


def test_bucket_cap_limits_fusion():
    raw, _, cap, prop = _plans("fanout_psum")
    member = max(s.in_bytes for s in raw.steps if s.kind == "collective")
    capped = optimize_plan(compile_plan(cap, prop, MESH, optimize=False, cost_only=True,
                                        profile=RooflineParams(**PROFILE)),
                           bucket_bytes=member / 2)
    assert _fused(capped) == []
    full = optimize_plan(compile_plan(cap, prop, MESH, optimize=False, cost_only=True,
                                      profile=RooflineParams(**PROFILE)))
    assert [len(s.reads) for s in _fused(full)] == [4]


def test_schedule_overlap_issues_collective_early_and_is_deterministic():
    _, opt, _, _ = _plans("overlap")
    _check_write_before_read(opt)
    ov = opt.opt_report.overlap
    assert 0.0 < ov["ratio"] < 1.0
    assert ov["overlapped_s"] <= ov["serial_s"]
    assert ov["overlapped_s"] >= max(ov["compute_s"], ov["comm_s"]) - 1e-12
    gather = min(i for i, s in enumerate(opt.steps) if s.kind == "reshard"
                 and any(ps.op == "all_gather" for ps in s.program.steps))
    dots = [i for i, s in enumerate(opt.steps) if s.op == "aten.mm"]
    assert gather < dots[-1]
    _, again, _, _ = _plans("overlap")
    assert [(s.kind, s.op) for s in opt.steps] == [(s.kind, s.op) for s in again.steps]


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_one_lane_profile_keeps_the_order_and_the_unoptimized_peak(name):
    """Under a profile with no overlap (the committed card profile's kind)
    the schedule keeps the plan's order and models it serially, and the
    optimized plan's modeled peak is at most the unoptimized plan's: CSE
    and fusion are undone where they would raise it.  The overlapping
    profile's plan is the reference's (test_opt_report_matches_reference):
    its fusion raises the peak of fanout_psum (92,160 to 141,312 bytes)
    and gather_hoist (22,528 to 28,672), and there the one-lane plan undoes
    it."""
    f, _, shapes = PROGRAMS[name]()
    cap = capture(f, *[torch.empty(s, device="meta") for s in shapes])
    prop = propagate(cap, MESH).result()
    one = RooflineParams(**dict(PROFILE, overlap_efficiency=0.0))
    raw = compile_plan(cap, prop, MESH, optimize=False, cost_only=True, profile=one)
    opt = compile_plan(cap, prop, MESH, optimize=True, cost_only=True, profile=one)
    _check_write_before_read(opt)
    sched = _pass(opt, "overlap-schedule")
    ov = opt.opt_report.overlap
    assert sched.moved_steps == 0 and ov["overlapped_s"] == ov["serial_s"]
    assert opt.peak_bytes <= raw.peak_bytes
    undone = {p.name for p in opt.opt_report.passes if p.detail.get("undone") == "peak"}
    assert undone == ({"collective-fusion"} if name in ("fanout_psum", "gather_hoist") else set())


def test_opt_report_as_dict_schema():
    _, opt, _, _ = _plans("fanout_psum")
    d = opt.opt_report.as_dict()
    for k in ("passes", "steps_before", "steps_after", "collectives_before",
              "collectives_after", "wire_bytes_before", "wire_bytes_after", "fused_buckets",
              "launch_s_saved"):
        assert k in d, k
    assert d["steps_after"] <= d["steps_before"]
    assert d["collectives_after"] <= d["collectives_before"]
    assert d["wire_bytes_after"] <= d["wire_bytes_before"]
    assert [p["name"] for p in d["passes"]] == [
        "inline-pjit", "scan-hoist", "reshard-cse", "dead-reshard-elim", "alias-sink",
        "collective-fusion", "overlap-schedule"]
    assert 0.0 < d["overlap"]["ratio"] <= 1.0 + 1e-9
    for k in ("compute_s", "comm_s", "serial_s", "overlapped_s"):
        assert k in d["overlap"], k


# ---------------------------------------------------------------------------------
# execution: optimized equals unoptimized bit for bit
# ---------------------------------------------------------------------------------


def _equal(a, b) -> bool:
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", list(PROGRAMS))
def test_optimized_program_equals_unoptimized_bit_for_bit(name):
    f, _, shapes = PROGRAMS[name]()
    rng = np.random.default_rng(sum(map(ord, name)))
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes]
    raw = spmd_partition(f, MESH, optimize=False, device="cpu")
    opt = spmd_partition(f, MESH, optimize=True, profile=RooflineParams(**PROFILE),
                         device="cpu")
    assert _equal(raw(*args), opt(*args))
    (entry,) = opt.plans.values()
    assert entry.plan.opt_report is not None


def _kernel_steps(plan):
    return collections.Counter(s.op for s in plan.steps if s.op.startswith("repro_torch"))


def _gradient_program_both_ways(cfg, st, dtype):
    """The partitioned step's gradient program on make_test_mesh(), captured
    and completed once, its plan compiled unoptimized and optimized, each
    run on the same inputs."""
    mesh = make_test_mesh()
    gen = torch.Generator().manual_seed(3)
    with set_mesh(mesh):
        params = tree_init(api.param_tree(cfg, st), gen, dtype=dtype, device="cpu")
        runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh, optimize=False,
                                device="cpu")
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (8, 17))
    batch = {"tokens": torch.from_numpy(tok[:, :-1].copy()),
             "labels": torch.from_numpy(tok[:, 1:].copy())}
    params = tree_map(torch.Tensor.detach, params)
    want = runner(params, batch)
    (entry,) = runner.plans.values()
    with set_mesh(mesh):
        entry.plan = compile_plan(entry.captured, entry.prop, mesh, optimize=True,
                                  profile=RooflineParams(**PROFILE))
    got = runner(params, batch)
    with set_mesh(mesh):
        raw = compile_plan(entry.captured, entry.prop, mesh, optimize=False)
    return want, got, entry.plan, raw


@pytest.mark.parametrize("arch", ["qwen", "mamba2"])
def test_two_layer_gradient_programs_optimized_equal_unoptimized(arch):
    if arch == "qwen":
        cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=32, num_heads=4,
                          num_kv_heads=2, d_ff=64, vocab_size=64, attn_chunk=16, remat="none",
                          qkv_bias=True, scan_layers=False)
    else:
        cfg = reduced_config(get_config("mamba2-130m"), 8).with_(
            dtype="float32", num_layers=2, d_model=128, scan_layers=False)
    st = get_strategy("2d_finalized")
    (loss, grads), (oloss, ograds), plan, raw = _gradient_program_both_ways(cfg, st, "float32")
    assert torch.equal(loss, oloss)
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads), leaves(ograds)))
    assert _kernel_steps(plan) == _kernel_steps(raw) and _kernel_steps(raw)
    rep = plan.opt_report
    assert rep.steps_after < rep.steps_before
    assert rep.collectives_after <= rep.collectives_before
