"""Partitioned Einsum/Dot (paper §3.2, §4.4) with recursive grouping.

A port of the JAX package's ``core/einsum_rules.py``: planning is the same
pure Python and must give the same plans; execution runs on the stacked
shards of the simulated mesh (``core/mesh_runtime.py``).

Given operand shardings, classify every mesh axis by the *role* of the dimension
it shards (Figure 6):

* batch-consistent      — axis shards the same batch dim in both operands (and the
                          output): handled by *grouping* — the recursive-partitioning
                          trick: treat each group as a logical partition and recurse
                          on the remaining dims.  Locally a plain einsum.
* contracting-matched   — axis shards the same contracting dim of both operands:
                          local einsum produces a partial sum → AllReduce (or
                          ReduceScatter when the requested output wants that axis).
* lhs/rhs non-contracting — result stays sharded on that axis; no comm.
* mismatched            — axis shards a dim inconsistently: reshard (AllGather) the
                          smaller operand first (§4.5).

``plan_einsum`` is the pure role-classification procedure; ``compile_einsum``
extends its output with cost-model-chosen reshard programs and the
ReduceScatter-vs-AllReduce decision; ``execute_einsum`` replays a compiled
plan on stacked local shards; ``partitioned_einsum`` is compile+execute in
one call for the dynamic partitioner.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..analysis.roofline import collective_wire_bytes
from . import mesh_runtime as mr
from .collective_planner import ReshardProgram, execute_program, plan_reshard
from .sharding import Sharding

# ---------------------------------------------------------------------------------


def parse_spec(spec: str):
    lhs_rhs, out = spec.replace(" ", "").split("->")
    lhs, rhs = lhs_rhs.split(",")
    batch = [c for c in lhs if c in rhs and c in out]
    contract = [c for c in lhs if c in rhs and c not in out]
    lhs_only = [c for c in lhs if c not in rhs]
    rhs_only = [c for c in rhs if c not in lhs]
    return lhs, rhs, out, batch, contract, lhs_only, rhs_only


@dataclasses.dataclass
class EinsumPlan:
    spec: str
    lhs_local: Sharding  # sharding the lhs must be in before the local einsum
    rhs_local: Sharding
    out_sharding: Sharding  # sharding of the local result
    psum_axes: Tuple[str, ...]  # partial-sum axes after the local einsum
    gather_lhs: bool = False  # operands needed resharding (mismatched case)
    gather_rhs: bool = False
    # --- filled by compile_einsum (planner-routed executable form) -------------
    lhs_program: Optional[ReshardProgram] = None
    rhs_program: Optional[ReshardProgram] = None
    scatter: Tuple[Tuple[str, int], ...] = ()  # psum_scatter (axis, out dim)
    reduce_axes: Tuple[str, ...] = ()  # remaining AllReduce axes
    out_program: Optional[ReshardProgram] = None
    final_sharding: Optional[Sharding] = None
    cost_bytes: float = 0.0  # modeled wire bytes of all planned collectives

    @property
    def compiled(self) -> bool:
        return self.final_sharding is not None

    def collectives(self) -> List[str]:
        """Planned collectives.  For a compiled plan this reports the concrete
        AllToAll / DynamicSlice / ReduceScatter choices the cost model made;
        for a bare ``plan_einsum`` result it reports the coarse roles only."""
        if not self.compiled:
            out = []
            if self.gather_lhs:
                out.append("all-gather(lhs)")
            if self.gather_rhs:
                out.append("all-gather(rhs)")
            if self.psum_axes:
                out.append(f"all-reduce({','.join(self.psum_axes)})")
            return out
        out = []
        if self.lhs_program is not None:
            out += [f"lhs:{c}" for c in self.lhs_program.collectives()]
        if self.rhs_program is not None:
            out += [f"rhs:{c}" for c in self.rhs_program.collectives()]
        for a, d in self.scatter:
            out.append(f"reduce-scatter({a}:d{d})")
        if self.reduce_axes:
            out.append(f"all-reduce({','.join(self.reduce_axes)})")
        if self.out_program is not None:
            out += [f"out:{c}" for c in self.out_program.collectives()]
        return out


def plan_einsum(
    spec: str,
    lhs_sh: Sharding,
    rhs_sh: Sharding,
    out_sh: Optional[Sharding] = None,
) -> EinsumPlan:
    lhs, rhs, out, batch, contract, lhs_only, rhs_only = parse_spec(spec)
    mesh = lhs_sh.mesh

    def axes_of(s: Sharding, labels: str):
        return {c: s.dims_mapping[i] for i, c in enumerate(labels)}

    l_ax, r_ax = axes_of(lhs_sh, lhs), axes_of(rhs_sh, rhs)

    l_target: Dict[str, Tuple[str, ...]] = {}
    r_target: Dict[str, Tuple[str, ...]] = {}
    psum: List[str] = []
    gather_lhs = gather_rhs = False
    used: set = set()

    # batch dims: grouping (recursive partitioning).  Keep the merge of both.
    # One-sided shardings need no gather: the unsharded operand is *sliced* to
    # match (the reshard planner emits a zero-wire-byte DynamicSlice); only the
    # mismatched sharded-both case forces the rhs through a real reshard.
    for c in batch:
        la, ra = l_ax.get(c, ()), r_ax.get(c, ())
        if la == ra or (la and not ra):
            tgt = la
        elif ra and not la:
            tgt = ra
        else:  # mismatched sharded-both: keep lhs, reshard rhs
            tgt = la
            gather_rhs = True
        tgt = tuple(a for a in tgt if a not in used)
        used.update(tgt)
        l_target[c] = tgt
        r_target[c] = tgt

    # contracting dims: matched -> partial sum; mismatched -> gather the rhs
    for c in contract:
        la, ra = l_ax.get(c, ()), r_ax.get(c, ())
        if la == ra and la:
            tgt = tuple(a for a in la if a not in used)
            if tgt == la:
                l_target[c] = tgt
                r_target[c] = tgt
                used.update(tgt)
                psum.extend(tgt)
                continue
        if la and ra and la != ra:
            # keep lhs sharding, reshard rhs to match
            tgt = tuple(a for a in la if a not in used)
            l_target[c] = tgt
            r_target[c] = tgt
            used.update(tgt)
            psum.extend(tgt)
            gather_rhs = True
            continue
        if la and not ra:
            tgt = tuple(a for a in la if a not in used)
            l_target[c] = tgt
            r_target[c] = tgt
            used.update(tgt)
            psum.extend(tgt)
            gather_rhs = gather_rhs or bool(tgt)
            continue
        if ra and not la:
            tgt = tuple(a for a in ra if a not in used)
            l_target[c] = tgt
            r_target[c] = tgt
            used.update(tgt)
            psum.extend(tgt)
            gather_lhs = gather_lhs or bool(tgt)
            continue
        l_target[c] = ()
        r_target[c] = ()

    # non-contracting dims: keep own sharding (no comm)
    for c in lhs_only:
        tgt = tuple(a for a in l_ax.get(c, ()) if a not in used)
        used.update(tgt)
        l_target[c] = tgt
    for c in rhs_only:
        tgt = tuple(a for a in r_ax.get(c, ()) if a not in used)
        used.update(tgt)
        r_target[c] = tgt

    lhs_local = Sharding(mesh, tuple(l_target[c] for c in lhs))
    rhs_local = Sharding(mesh, tuple(r_target[c] for c in rhs))
    out_map = tuple(
        l_target.get(c, r_target.get(c, ())) for c in out
    )
    out_sharding = Sharding(mesh, out_map)
    gather_lhs = gather_lhs or (lhs_local.dims_mapping != lhs_sh.dims_mapping)
    gather_rhs = gather_rhs or (rhs_local.dims_mapping != rhs_sh.dims_mapping)
    return EinsumPlan(
        spec, lhs_local, rhs_local, out_sharding, tuple(psum), gather_lhs, gather_rhs
    )


def _local_result_shape(
    spec: str, lhs_shape, rhs_shape, lhs_sh: Sharding, rhs_sh: Sharding,
    lhs_local: Sharding, rhs_local: Sharding, out_sharding: Sharding,
):
    """Shapes for costing: global dim sizes from the operands' current local
    shapes + shard counts, then each piece re-localized under the plan's
    shardings.  Returns (lhs_local_shape, rhs_local_shape, z_local_shape)."""
    lhs, rhs, out, *_ = parse_spec(spec)
    size = {}
    for i, c in enumerate(lhs):
        size[c] = lhs_shape[i] * lhs_sh.num_shards(i)
    for j, c in enumerate(rhs):
        size.setdefault(c, rhs_shape[j] * rhs_sh.num_shards(j))
    lhs_l = tuple(size[c] // lhs_local.num_shards(i) for i, c in enumerate(lhs))
    rhs_l = tuple(size[c] // rhs_local.num_shards(j) for j, c in enumerate(rhs))
    z_l = tuple(size[c] // out_sharding.num_shards(k) for k, c in enumerate(out))
    return lhs_l, rhs_l, z_l


def compile_einsum(
    spec: str,
    lhs_sh: Sharding,
    rhs_sh: Sharding,
    out_sh: Optional[Sharding],
    lhs_local_shape: Tuple[int, ...],
    rhs_local_shape: Tuple[int, ...],
    dtype_bytes: int = 4,
) -> EinsumPlan:
    """Extend :func:`plan_einsum` into an executable plan.

    Operand resharding is routed through the cost-model planner
    (AllToAll / slice-before-gather instead of blanket AllGather), and each
    pending partial sum chooses ReduceScatter vs AllReduce(+reshard) by the
    roofline byte model (§4.2: ReduceScatter is half the AllReduce wire cost,
    so it wins whenever the requested output shards a psum axis).  All
    decisions are recorded on the returned plan for reporting.
    """
    plan = plan_einsum(spec, lhs_sh, rhs_sh, out_sh)
    mesh = lhs_sh.mesh
    cost = 0.0
    lhs_prog = rhs_prog = None
    if plan.lhs_local.dims_mapping != lhs_sh.dims_mapping:
        lhs_prog = plan_reshard(lhs_sh, plan.lhs_local, lhs_local_shape, dtype_bytes)
        cost += lhs_prog.cost_bytes
    if plan.rhs_local.dims_mapping != rhs_sh.dims_mapping:
        rhs_prog = plan_reshard(rhs_sh, plan.rhs_local, rhs_local_shape, dtype_bytes)
        cost += rhs_prog.cost_bytes
    _, _, z_shape = _local_result_shape(
        spec, lhs_local_shape, rhs_local_shape, lhs_sh, rhs_sh,
        plan.lhs_local, plan.rhs_local, plan.out_sharding,
    )
    res_sh = plan.out_sharding
    z_shape = list(z_shape)
    scatter: List[Tuple[str, int]] = []
    remaining = list(plan.psum_axes)
    if remaining and out_sh is not None:
        # ReduceScatter vs AllReduce, decided per axis by the wire-byte model.
        z_bytes = float(dtype_bytes)
        for s in z_shape:
            z_bytes *= s
        for d, axes in enumerate(out_sh.dims_mapping):
            for a in axes:
                if a not in remaining or res_sh.dims_mapping[d]:
                    continue
                n = mesh.axis_size(a)
                if z_shape[d] % n:
                    continue  # tiled scatter needs divisibility; fall back to AR
                rs = collective_wire_bytes("reduce-scatter", n, z_bytes)
                ar = collective_wire_bytes("all-reduce", n, z_bytes)
                if rs <= ar:  # always true in the ring model; kept explicit
                    scatter.append((a, d))
                    res_sh = res_sh.with_dim(d, res_sh.dims_mapping[d] + (a,))
                    z_shape[d] //= n
                    z_bytes /= n
                    remaining.remove(a)
                    cost += rs
    z_bytes = float(dtype_bytes)
    for s in z_shape:
        z_bytes *= s
    for a in remaining:
        cost += collective_wire_bytes("all-reduce", mesh.axis_size(a), z_bytes)
    out_prog = None
    final = res_sh
    if out_sh is not None and res_sh.dims_mapping != out_sh.dims_mapping:
        out_prog = plan_reshard(res_sh, out_sh, tuple(z_shape), dtype_bytes)
        cost += out_prog.cost_bytes
        final = out_sh
    return dataclasses.replace(
        plan,
        lhs_program=lhs_prog,
        rhs_program=rhs_prog,
        scatter=tuple(scatter),
        reduce_axes=tuple(remaining),
        out_program=out_prog,
        final_sharding=final,
        cost_bytes=cost,
    )


def _batched_spec(spec: str) -> str:
    """``spec`` with a device letter leading every operand: one einsum over
    all devices' shards."""
    lhs_rhs, out = spec.replace(" ", "").split("->")
    z = next(c for c in "ZYXWVUTSRQPONMLKJIHGFEDCBA" if c not in spec)
    lhs, rhs = lhs_rhs.split(",")
    return f"{z}{lhs},{z}{rhs}->{z}{out}"


def execute_einsum(plan: EinsumPlan, x, y, preferred_element_type=None):
    """Replay a compiled einsum plan on stacked local shards.

    ``preferred_element_type`` (a torch dtype) computes the local product in
    that type, as the reference's ``jnp.einsum`` does; partial sums are
    then reduced in it.
    """
    if not plan.compiled:
        raise ValueError("execute_einsum needs a compile_einsum plan")
    mesh = plan.lhs_local.mesh
    if plan.lhs_program is not None:
        x = execute_program(x, plan.lhs_program)
    if plan.rhs_program is not None:
        y = execute_program(y, plan.rhs_program)
    if preferred_element_type is not None:
        x, y = x.to(preferred_element_type), y.to(preferred_element_type)
    z = torch.einsum(_batched_spec(plan.spec), x, y)
    for a, d in plan.scatter:
        z = mr.psum_scatter(z, mesh, a, d)
    if plan.reduce_axes:
        z = mr.psum(z, mesh, plan.reduce_axes)
    if plan.out_program is not None:
        z = execute_program(z, plan.out_program)
    return z, plan.final_sharding


def partitioned_einsum(
    spec: str,
    x,
    y,
    lhs_sh: Sharding,
    rhs_sh: Sharding,
    out_sh: Optional[Sharding] = None,
    preferred_element_type=None,
):
    """Execute a partitioned einsum on stacked local shards.

    Returns (local_result, result_sharding).  If ``out_sh`` is given, the result
    is resharded to it; a pending partial sum combined with a requested sharding
    on a psum axis becomes a ReduceScatter (§4.2: "half the cost of AllReduce").
    """
    plan = compile_einsum(
        spec, lhs_sh, rhs_sh, out_sh, tuple(x.shape[1:]), tuple(y.shape[1:]),
        dtype_bytes=x.element_size(),
    )
    return execute_einsum(plan, x, y, preferred_element_type)
