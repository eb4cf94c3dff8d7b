"""The port's sharding representation, simulated-mesh collectives and reshard
planner against the JAX package (paper §3.1, §3.5, §4.2, §4.5).

Everything here is device-free and exact: the sharding cases of
tests/test_sharding.py run against both packages, each collective is held
against a per-device numpy definition, and ``plan_reshard`` must return the
reference's program (steps, modeled bytes, strategy) — then executing that
program on stacked shards must give the target layout bit for bit.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import collective_planner as jcp
from repro.core import sharding as js
from repro_torch.core import collective_planner as cp
from repro_torch.core import mesh_runtime as mr
from repro_torch.core import sharding as ps
from repro_torch.core.reshard import reshard_local
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

MESH = ps.Mesh.create((2, 4), ("x", "y"))
JMESH = js.Mesh.create((2, 4), ("x", "y"))


def both(fn):
    """``fn`` run on each package's (mesh, module) pair."""
    return fn(MESH, ps), fn(JMESH, js)


def test_three_types():
    for dm in ([-1, -1], ["x", "y"], ["x", -1]):
        got, want = both(lambda m, mod: mod.mesh_split(2, m, dm).type.value)
        assert got == want


def test_device_assignment_figure1():
    def case(mod):
        m = mod.Mesh(np.array([[0, 2], [1, 3]]), ("a", "b"))
        s2 = mod.mesh_split(2, mod.Mesh.create((2, 2), ("a", "b")), [-1, "a"])
        return mod.mesh_split(2, m, ["a", "b"]).device_assignment(), s2.device_assignment()

    got, want = case(ps), case(js)
    assert got[0].tolist() == want[0].tolist() == [[0, 2], [1, 3]]
    assert got[1].tolist() == want[1].tolist() and got[1].shape == (1, 2, 2)


def test_offsets():
    got, want = both(lambda m, mod: [mod.mesh_split(2, m, ["x", "y"]).offset(d, i, n)
                                     for d, i, n in ((0, 0, 8), (7, 0, 8), (7, 1, 16))])
    assert got == want == [0, 4, 12]


@pytest.mark.parametrize("a,b", [
    (["x", -1], [-1, "y"]), (["x", -1], ["y", "x"]), (["x", -1], [-1, "x"]),
    (["x", -1], ["x", "y"]), ([("x", "y"), -1], ["x", -1])])
def test_merge_and_refinement_match(a, b):
    def case(m, mod):
        sa, sb = mod.mesh_split(2, m, a), mod.mesh_split(2, m, b)
        merged = mod.merge_shardings(sa, sb)
        return (None if merged is None else merged.dims_mapping,
                mod.is_refinement(sb, sa), mod.is_refinement(sa, sb))

    got, want = both(case)
    assert got == want


def test_partition_spec_bridge():
    got = ps.to_partition_spec(ps.mesh_split(3, MESH, ["x", -1, "y"]))
    want = tuple(js.to_partition_spec(js.mesh_split(3, JMESH, ["x", -1, "y"])))
    assert got == want == ("x", None, "y")
    for spec in [("x", None, "y"), (("x", "y"),), (None, "y")]:
        assert (ps.from_partition_spec(MESH, 3, spec).dims_mapping
                == js.from_partition_spec(JMESH, 3, spec).dims_mapping)
        assert ps.to_partition_spec(ps.from_partition_spec(MESH, 3, spec)) == spec


def test_padding_and_projection():
    for size, parts in ((24, 16), (32, 16), (7, 4)):
        assert ps.pad_to_multiple(size, parts) == js.pad_to_multiple(size, parts)
        assert ps.padded_waste(size, parts) == js.padded_waste(size, parts)
    small_p, small_j = ps.Mesh.create((2, 2), ("x", "y")), js.Mesh.create((2, 2), ("x", "y"))
    for dm, shape in ((((("x", "y"), ("z",))), (8, 4)), ((("y",), ("x",)), (6, 3)),
                      ((("x",), ("x",)), (4, 4))):
        assert (ps.project_dims_mapping(small_p, dm, shape).dims_mapping
                == js.project_dims_mapping(small_j, dm, shape).dims_mapping)


def test_meshes():
    m = make_production_mesh()
    assert (m.shape, m.axis_names) == ((16, 16), ("data", "model"))
    m = make_production_mesh(multi_pod=True)
    assert (m.shape, m.axis_names) == ((2, 16, 16), ("pod", "data", "model"))
    m = make_test_mesh()
    assert (m.shape, m.axis_names, m.size) == ((2, 4), ("data", "model"), 8)


OPTS = [(), ("x",), ("y",), ("x", "y"), ("y", "x")]


def _valid(dm):
    used = [a for axes in dm for a in axes]
    return len(used) == len(set(used))


def test_sharding_properties_match_on_every_mapping():
    """The property cases of tests/test_sharding.py, enumerated: merge is
    idempotent and a refinement of both sides, and the device assignment is
    a permutation — with both packages agreeing on every pair."""
    for rank in (1, 2, 3):
        dms = [dm for dm in itertools.product(OPTS, repeat=rank) if _valid(dm)]
        for dm in dms:
            s, j = ps.Sharding(MESH, dm), js.Sharding(JMESH, dm)
            assert ps.merge_shardings(s, s).dims_mapping == dm
            da = s.device_assignment()
            assert np.array_equal(da, j.device_assignment())
            assert sorted(da.reshape(-1).tolist()) == list(range(8))
            assert s.type.value == j.type.value
        for d1, d2 in itertools.product(dms, repeat=2):
            a, b = ps.Sharding(MESH, d1), ps.Sharding(MESH, d2)
            m = ps.merge_shardings(a, b)
            jm = js.merge_shardings(js.Sharding(JMESH, d1), js.Sharding(JMESH, d2))
            assert (m is None) == (jm is None)
            if m is not None:
                assert m.dims_mapping == jm.dims_mapping
                assert ps.is_refinement(m, a) and ps.is_refinement(m, b)


# ---------------------------------------------------------------------------------
# the simulated mesh's collectives against per-device numpy definitions
# ---------------------------------------------------------------------------------

MESHES = [((8,), ("a",)), ((2, 4), ("x", "y")), ((2, 2, 2), ("p", "q", "r"))]


def _coords(shape):
    return [np.unravel_index(p, shape) for p in range(int(np.prod(shape)))]


def _group(shape, p, ks):
    """Positions sharing p's coordinates off the axes ``ks``, in axis order."""
    cs = _coords(shape)
    return [q for q in range(len(cs))
            if all(cs[q][i] == cs[p][i] for i in range(len(shape)) if i not in ks)]


def _data(shape, local, seed):
    # small integers: every sum is exact in float32
    g = np.random.default_rng(seed).integers(-8, 8, (int(np.prod(shape)),) + local)
    return g.astype(np.float32)


@pytest.mark.parametrize("shape,names", MESHES)
def test_collectives_match_numpy(shape, names):
    mesh = ps.Mesh.create(shape, names)
    x = _data(shape, (4, 8, 6), 0)
    t = torch.from_numpy(x)
    for k, axis in enumerate(names):
        n = shape[k]
        idx = mr.axis_index(mesh, axis)
        assert idx.tolist() == [c[k] for c in _coords(shape)]
        groups = [_group(shape, p, {k}) for p in range(len(x))]
        for dim in range(3):
            want = np.stack([np.concatenate([x[q] for q in groups[p]], axis=dim)
                             for p in range(len(x))])
            assert np.array_equal(mr.all_gather(t, mesh, axis, dim).numpy(), want)
            if x.shape[1 + dim] % n == 0:
                want = np.stack([np.split(x[p], n, axis=dim)[idx[p]] for p in range(len(x))])
                got = mr.dynamic_slice_by_axis_index(t, mesh, axis, dim).numpy()
                assert np.array_equal(got, want)
                total = [sum(x[q] for q in groups[p]) for p in range(len(x))]
                want = np.stack([np.split(total[p], n, axis=dim)[idx[p]]
                                 for p in range(len(x))])
                assert np.array_equal(mr.psum_scatter(t, mesh, axis, dim).numpy(), want)
            for cdim in range(3):
                if cdim == dim or x.shape[1 + dim] % n:
                    continue
                want = np.stack([np.concatenate(
                    [np.split(x[q], n, axis=dim)[idx[p]] for q in groups[p]], axis=cdim)
                    for p in range(len(x))])
                got = mr.all_to_all(t, mesh, axis, split_dim=dim, concat_dim=cdim).numpy()
                assert np.array_equal(got, want)
        perm = [(j, (j + 1) % n) for j in range(n - 1)]
        want = np.zeros_like(x)
        for p in range(len(x)):
            src = [s for s, d in perm if d == idx[p]]
            if src:
                want[p] = x[groups[p][src[0]]]
        assert np.array_equal(mr.ppermute(t, mesh, axis, perm).numpy(), want)
    for ks in itertools.chain.from_iterable(
            itertools.combinations(range(len(shape)), r) for r in range(1, len(shape) + 1)):
        axes = [names[k] for k in ks]
        groups = [_group(shape, p, set(ks)) for p in range(len(x))]
        for fn, red in ((mr.psum, sum), (mr.pmax, lambda v: np.max(np.stack(v), 0)),
                        (mr.pmin, lambda v: np.min(np.stack(v), 0))):
            want = np.stack([red([x[q] for q in groups[p]]) for p in range(len(x))])
            assert np.array_equal(fn(t, mesh, axes).numpy(), want)


def test_collectives_are_recorded_by_kind():
    t = torch.zeros(8, 4, 4)
    with mr.recording() as log:
        mr.all_gather(t, MESH, "y", 0)
        mr.psum(t, MESH, ("x", "y"))
        mr.psum_scatter(t, MESH, "y", 1)
        mr.all_to_all(t, MESH, "x", 0, 1)
        mr.ppermute(t, MESH, "x", [(0, 1)])
        mr.dynamic_slice_by_axis_index(t, MESH, "y", 0)
    assert dict(log) == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
                         "all-to-all": 1, "collective-permute": 1}


@pytest.mark.parametrize("devices", [np.arange(8).reshape(2, 4),
                                     np.array([[3, 0, 6, 1], [7, 2, 5, 4]])])
def test_shard_places_what_offset_says_and_unshard_inverts(devices):
    """§3.1: the stacked position p holds device ``devices.flat[p]``, whose
    shard starts where ``Sharding.offset`` says."""
    mesh = ps.Mesh(devices, ("x", "y"))
    x = torch.arange(8 * 16 * 4, dtype=torch.float32).reshape(8, 16, 4)
    for dm in itertools.product(OPTS, OPTS, [()]):
        if not _valid(dm):
            continue
        s = ps.Sharding(mesh, dm)
        st = mr.shard(x, s)
        for p, dev in enumerate(devices.flat):
            sl = tuple(slice(s.offset(int(dev), d, x.shape[d]),
                             s.offset(int(dev), d, x.shape[d]) + x.shape[d] // s.num_shards(d))
                       for d in range(3))
            assert torch.equal(st[p], x[sl])
        assert torch.equal(mr.unshard(st, s), x)


def test_shard_map_runs_on_local_shards():
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    f = mr.shard_map(lambda xl: mr.psum(xl, MESH, "y"), mesh=MESH,
                     in_specs=(("x", "y"),), out_specs=("x",))
    # each x-row block summed over its four y-column blocks
    want = x.reshape(8, 4, 2).sum(1)
    assert torch.equal(f(x), want)


# ---------------------------------------------------------------------------------
# reshard planning: the reference's programs, exactly; then executed
# ---------------------------------------------------------------------------------


def _all_shardings(names, rank):
    per_dim = [()] + [p for r in range(1, len(names) + 1)
                      for p in itertools.permutations(names, r)]
    return [dm for dm in itertools.product(per_dim, repeat=rank) if _valid(dm)]


def _plan_both(pm, jm, src, dst, local, dtype_bytes=4):
    got = cp.plan_reshard(ps.Sharding(pm, src), ps.Sharding(pm, dst), local, dtype_bytes)
    want = jcp.plan_reshard(js.Sharding(jm, src), js.Sharding(jm, dst), local, dtype_bytes)
    key = lambda prog: ([(s.op, s.axis, s.dim, s.dim2) for s in prog.steps],
                        prog.cost_bytes, prog.strategy)
    assert key(got) == key(want), (src, dst, local)
    return got


def _local(shape, s_dm, sizes):
    return tuple(d // int(np.prod([sizes[a] for a in axes] or [1]))
                 for d, axes in zip(shape, s_dm))


@pytest.mark.parametrize("src,dst,local", [
    ((("y",), ()), ((), ("y",)), (2, 16)),
    ((("x",), ()), ((), ("y",)), (4, 16)),
    ((("x", "y"), ()), ((), ()), (1, 8)),
    ((("x", "y"), ()), (("x",), ("y",)), (1, 8)),
    ((("x",), ("y",)), (("x",), ("y",)), (4, 2)),
])
def test_plan_reshard_matches_reference_layouts(src, dst, local):
    """The layouts of tests/test_plan.py and tests/multidev/test_reshard.py."""
    _plan_both(MESH, JMESH, src, dst, local)


@pytest.mark.parametrize("shape,names,tshape", [
    ((2, 4), ("x", "y"), (8, 8)),
    ((2, 2, 2), ("p", "q", "r"), (8, 8)),
])
def test_plan_reshard_exhaustive_pairs_match_and_execute(shape, names, tshape):
    """Every (src, dst) pair of rank-2 layouts: the reference's program,
    exactly, and its execution on stacked shards is the target layout."""
    pm, jm = ps.Mesh.create(shape, names), js.Mesh.create(shape, names)
    sizes = dict(zip(names, shape))
    x = torch.from_numpy(_data((1,), tshape, 3)[0])
    layouts = _all_shardings(names, 2)
    stacked = {dm: mr.shard(x, ps.Sharding(pm, dm)) for dm in layouts}
    before = cp.search_telemetry()["searches"]
    jbefore = jcp.search_telemetry()["searches"]
    for src, dst in itertools.product(layouts, layouts):
        prog = _plan_both(pm, jm, src, dst, _local(tshape, src, sizes))
        got = cp.execute_program(stacked[src], prog)
        assert torch.equal(got, stacked[dst]), (src, dst, prog.collectives())
    assert (cp.search_telemetry()["searches"] - before
            == jcp.search_telemetry()["searches"] - jbefore)


def test_reshard_local_takes_stacked_shards():
    x = torch.from_numpy(_data((1,), (8, 16), 4)[0])
    src, dst = ps.mesh_split(2, MESH, ["y", -1]), ps.mesh_split(2, MESH, [-1, "y"])
    with mr.recording() as log:
        got = reshard_local(mr.shard(x, src), src, dst)
    assert dict(log) == {"all-to-all": 1}
    assert torch.equal(mr.unshard(got, dst), x)
