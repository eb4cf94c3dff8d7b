"""CLI for the observability layer (port of the JAX package's
``python -m repro.obs``).

``python -m repro_torch.obs summarize <metrics.json>``
    Print the top counters, the gauges and the histogram percentiles of a
    metrics snapshot (``REPRO_TORCH_METRICS_DUMP`` output or
    ``MetricsRegistry.dump``).

``python -m repro_torch.obs trace <out.json> [--arch A --mesh RxC ...]``
    Write the *modeled* timeline of a registry arch's loss on a simulated
    mesh as Chrome trace-event JSON: a cost-only lowering on meta tensors,
    no device and no execution.  Load the file in Perfetto or
    ``chrome://tracing``.

``python -m repro_torch.obs profile <out.json> [--device cpu --dims ...]``
    Fit a machine profile on this machine, the card unless ``--device
    cpu``: the JAX package's matmul chain ``x = tanh(x @ w)``, annotated so
    that every layer's product ends in a psum over the mesh's second axis,
    runs on the simulated mesh (default (2, 4)) at each of ``--dims`` under tight-timed
    tracing (one untimed run, then the least of ``--repeats`` runs timed
    with CUDA events); the spans of all sizes are fitted together into
    ``peak_flops``, ``ici_bw`` and ``collective_launch_s``.  The base the
    unfitted fields come from is measured by the command: ``hbm_bw`` an HBM
    copy timed with CUDA events, ``overlap_efficiency`` 0 (one stream runs
    the simulated collectives and the products in series); the starting
    values of the fitted fields (a GEMM's rate, the copy rate, one small
    psum's host time) price the plan the spans are taken on.  The
    :class:`~repro_torch.obs.profile.MachineProfile` JSON records the
    device's name and power limit.  Apply it with
    ``REPRO_TORCH_MACHINE_PROFILE=<out.json>`` or ``spmd_partition(profile=
    ...)``; ``src/repro_torch/obs/h100_profile.json`` is this command's
    output on an H100, the port's default.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _cmd_summarize(args: argparse.Namespace) -> int:
    with open(args.path) as f:
        snap = json.load(f)
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})
    histograms = snap.get("histograms", {})
    sources = snap.get("sources", {})

    print(f"# metrics summary: {args.path}")
    if counters:
        print(f"\n## counters (top {args.top})")
        ranked = sorted(counters.items(), key=lambda kv: -kv[1])[:args.top]
        width = max(len(k) for k, _ in ranked)
        for k, v in ranked:
            print(f"  {k:<{width}}  {v:g}")
    if gauges:
        print("\n## gauges")
        width = max(len(k) for k in gauges)
        for k, v in sorted(gauges.items()):
            print(f"  {k:<{width}}  {v:g}")
    if histograms:
        print("\n## histograms")
        print("  name | count | mean | p50 | p90 | p99 | max")
        for k, h in sorted(histograms.items()):
            def fmt(key):
                v = h.get(key)
                return f"{v:.4g}" if isinstance(v, (int, float)) else "—"
            print(f"  {k} | {h.get('count', 0)} | {fmt('mean')} | "
                  f"{fmt('p50')} | {fmt('p90')} | {fmt('p99')} | "
                  f"{fmt('max')}")
    if sources:
        print("\n## sources")
        for name, src in sorted(sources.items()):
            body = ", ".join(f"{k}={v}" for k, v in sorted(src.items())) \
                if isinstance(src, dict) else str(src)
            print(f"  {name}: {body}")
    return 0


def _parse_mesh(spec: str, axes: str):
    from ..core.sharding import Mesh

    shape = tuple(int(d) for d in spec.lower().split("x"))
    names = tuple(axes.split(","))
    if len(names) != len(shape):
        raise SystemExit(f"--axes gives {len(names)} names for a {len(shape)}-d mesh")
    return Mesh.create(shape, names)


def _cmd_trace(args: argparse.Namespace) -> int:
    import torch

    from ..configs.base import get_strategy
    from ..configs.registry import default_strategy, get_config, reduced_config
    from ..core.compat import capture, set_mesh
    from ..core.plan import lower_plan
    from ..core.plan_opt import modeled_timeline
    from ..models import api
    from ..models.layers import tree_shapes
    from .profile import resolve_profile
    from .trace import TraceConfig, Tracer

    mesh = _parse_mesh(args.mesh, args.axes)
    cfg = reduced_config(get_config(args.arch), args.reduce_k).with_(remat="none")
    st = get_strategy(default_strategy(args.arch))
    with set_mesh(mesh):
        params = tree_shapes(api.param_tree(cfg, st), cfg.param_dtype)
    batch = {k: torch.empty((args.batch, args.seq), dtype=torch.long, device="meta")
             for k in ("tokens", "labels")}
    cap = capture(api.partitionable_loss(cfg, st, mesh), params, batch)
    plan = lower_plan(cap, None, mesh, profile=resolve_profile(args.profile))

    tracer = Tracer(TraceConfig(measured=False))
    tracer.on_plan(plan)
    out = tracer.write(args.out, include_control=False)

    rows = modeled_timeline(plan)
    makespan = max((r["start_s"] + r["dur_s"] for r in rows), default=0.0)
    classes = sorted({r["cls"] for r in rows})
    print(f"wrote {out}")
    print(f"  arch={args.arch} mesh={args.mesh} ({args.axes}) "
          f"batch={args.batch} seq={args.seq}")
    print(f"  steps={len(rows)} makespan={makespan * 1e3:.3f} ms "
          f"classes={','.join(classes)}")
    return 0


def _time_ms(fn, cuda: bool, repeats: int) -> float:
    """The least of ``repeats`` timed calls of ``fn`` after one untimed call:
    CUDA events on the card, ``perf_counter`` on the CPU."""
    import torch

    fn()
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            best = min(best, e0.elapsed_time(e1))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def measure_base(mesh, device: str, dtype, gemm_n: int, copy_elems: int, repeats: int):
    """The base of a fit, measured here: ``hbm_bw`` from a float32 copy of
    ``copy_elems`` elements (read and written once), ``overlap_efficiency``
    0, and as starting values of the fitted fields a ``gemm_n``-cubed GEMM's
    rate in ``dtype``, the copy rate for the link and one small psum's host
    seconds on the simulated mesh.  Returns (params, the measurements)."""
    import torch

    from ..analysis.roofline import RooflineParams
    from ..core import mesh_runtime as mr

    cuda = device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    a = torch.randn(gemm_n, gemm_n, device=device).to(dtype)
    b = torch.randn(gemm_n, gemm_n, device=device).to(dtype)
    gemm_ms = _time_ms(lambda: a @ b, cuda, repeats)
    del a, b
    x = torch.empty(copy_elems, device=device)
    y = torch.empty_like(x)
    copy_ms = _time_ms(lambda: y.copy_(x), cuda, repeats)
    del x, y
    z = torch.randn(mesh.size, 256, device=device)
    axis = (mesh.axis_names[-1],)
    for _ in range(10):
        mr.psum(z, mesh, axis)
    sync()
    t0 = time.perf_counter()
    for _ in range(100):
        mr.psum(z, mesh, axis)
    sync()
    psum_s = (time.perf_counter() - t0) / 100
    rec = {"gemm_tflops": 2 * gemm_n ** 3 / gemm_ms / 1e9, "gemm_n": gemm_n,
           "gemm_dtype": str(dtype).replace("torch.", ""),
           "hbm_copy_gbs": 2 * 4 * copy_elems / copy_ms / 1e6, "copy_bytes": 4 * copy_elems,
           "small_psum_s": psum_s, "timing": "CUDA events" if cuda else "perf_counter"}
    params = RooflineParams(peak_flops=rec["gemm_tflops"] * 1e12,
                            hbm_bw=rec["hbm_copy_gbs"] * 1e9, ici_bw=rec["hbm_copy_gbs"] * 1e9,
                            collective_launch_s=psum_s, overlap_efficiency=0.0)
    return params, rec


def chain_program(mesh, layers: int):
    """The JAX package's profiling chain ``x = tanh(x @ w)``, annotated on
    ``mesh`` (axes A, B): x split (A, B) and w on its rows over B, so that
    each product leaves a partial sum over B, the product is annotated whole
    along B (a psum step completes it before the tanh), and each layer's
    result is split back on B (a local slice)."""
    import torch

    from ..core.annotate import annotate
    from ..core.sharding import mesh_split

    a0, a1 = mesh.axis_names[:2]

    def fn(a, w):
        x = annotate(a, mesh_split(2, mesh, [a0, a1]))
        w = annotate(w, mesh_split(2, mesh, [a1, -1]))
        for _ in range(layers):
            x = torch.tanh(annotate(x @ w, mesh_split(2, mesh, [a0, -1])))
            x = annotate(x, mesh_split(2, mesh, [a0, a1]))
        return x

    return fn


def _cmd_profile(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from ..core.partitioner import spmd_partition
    from ..core.plan_opt import step_class
    from .calibrate import attach_profile, calibration_report
    from .profile import (collect_samples, device_memory_stats, device_name, fit_profile,
                          memory_report, rescore_report)
    from .trace import TraceConfig

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("profile: no CUDA device (pass --device cpu to fit on the CPU)")
    mesh = _parse_mesh(args.mesh, args.axes)
    args.dtype = args.dtype or ("bfloat16" if cuda else "float32")
    dtype = getattr(torch, args.dtype)
    dims = [int(d) for d in (args.dims or ("8192,2048,512,128" if cuda else "256,64")).split(",")]
    base, rec = measure_base(mesh, args.device, dtype, gemm_n=8192 if cuda else 256,
                             copy_elems=2 ** 28 if cuda else 2 ** 22, repeats=args.repeats)
    trace = TraceConfig(timing="tight", repeats=args.repeats)
    rng = np.random.default_rng(args.seed)
    samples, events, mem = [], [], None
    for n in dims:
        a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32)).to(args.device, dtype)
        w = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32) / np.sqrt(n)).to(
            args.device, dtype)
        runner = spmd_partition(chain_program(mesh, args.layers), mesh, trace=trace,
                                profile=base, device=args.device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        mem0 = device_memory_stats()
        with torch.no_grad():
            runner(a, w)
        mem1 = device_memory_stats()
        entry = next(iter(runner.plans.values()))
        spans = runner.tracer.measured_events()
        samples += collect_samples(entry.plan, spans)
        events += runner.tracer.chrome_trace(include_control=False)["traceEvents"]
        if n == max(dims):
            mem = memory_report(entry.plan, mem0, mem1)
            classes = sorted({step_class(s) for s in entry.plan.steps})
        del a, w, runner
    card = device_name(args.device)
    prof = fit_profile(
        samples, base,
        source=(f"python -m repro_torch.obs profile: matmul chain tanh(x @ w), dims "
                f"{','.join(map(str, dims))}, {args.layers} layers, {args.dtype}, mesh "
                f"{args.mesh} ({args.axes}), tight timing, {args.repeats} repeats"),
        device=card)
    prof.measurements = dict(rec)
    out = prof.dump(args.out)
    res = rescore_report(samples, prof.params, base)
    report = attach_profile(calibration_report(events), prof)

    print(f"wrote {out} (digest {prof.digest()})")
    print(f"  device: {card}")
    print(f"  samples={prof.n_samples} dropped={prof.dropped} "
          f"fitted={','.join(prof.fitted) or '—'} classes={','.join(classes)}")
    print(f"  measured here: {rec['gemm_dtype']} GEMM {rec['gemm_tflops']:.1f} TFLOP/s "
          f"({rec['gemm_n']}^3), HBM copy {rec['hbm_copy_gbs']:.1f} GB/s "
          f"({rec['copy_bytes'] / 2**30:.3g} GiB), small psum {rec['small_psum_s'] * 1e6:.1f} us "
          f"({rec['timing']})")
    for k, v in sorted(prof.params.as_dict().items()):
        mark = " (fitted)" if k in prof.fitted else ""
        print(f"  {k:<20} {v:.6g}  (base {base.as_dict()[k]:.6g}){mark}")
    for cls, ratio in sorted(prof.residuals.items()):
        flag = " (flagged)" if cls in prof.flagged else ""
        print(f"  residual {cls:<12} measured/modeled = {ratio:.3g}{flag}")
    print(f"  rescore: in_band_classes={res['in_band_classes']} "
          f"improved_all={res['improved_all']}")
    print("  calibration against the base (per traced call, all sizes):")
    print("  " + report.table().replace("\n", "\n  "))
    if mem["measured"]:
        print(f"  memory at dim {max(dims)}: modeled peak {mem['modeled_peak_bytes']:.4g} B a "
              f"device x {mem['devices']} = {mem['modeled_peak_bytes_all_devices']:.4g} B, "
              f"allocator peak {mem['measured_peak_bytes']:.4g} B")
    else:
        print(f"  memory at dim {max(dims)}: modeled peak {mem['modeled_peak_bytes']:.4g} B a "
              "device (no allocator to read)")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summarize", help="summarize a metrics snapshot JSON")
    p.add_argument("path", help="metrics snapshot (REPRO_TORCH_METRICS_DUMP output)")
    p.add_argument("--top", type=int, default=20, help="counters to show")
    p.set_defaults(fn=_cmd_summarize)

    p = sub.add_parser("trace", help="write a registry arch's modeled timeline (no execution)")
    p.add_argument("out", help="output Chrome trace JSON path")
    p.add_argument("--arch", default="qwen1.5-0.5b", help="registry arch (default qwen1.5-0.5b)")
    p.add_argument("--mesh", default="2x4", help="mesh shape, e.g. 2x4")
    p.add_argument("--axes", default="data,model", help="comma-separated mesh axis names")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=64)
    p.add_argument("--reduce-k", type=int, default=8)
    p.add_argument("--profile", default=None,
                   help="MachineProfile JSON to price with (default: resolve_profile())")
    p.set_defaults(fn=_cmd_trace)

    p = sub.add_parser("profile", help="fit a machine profile from tight-timed spans")
    p.add_argument("out", help="output MachineProfile JSON path")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mesh", default="2x4", help="simulated mesh shape, e.g. 2x4")
    p.add_argument("--axes", default="data,model", help="comma-separated mesh axis names")
    p.add_argument("--dims", default=None,
                   help="comma-separated chain widths (default 8192,2048,512,128 on the card, "
                        "256,64 on the CPU)")
    p.add_argument("--layers", type=int, default=4, help="products in the chain")
    p.add_argument("--dtype", default=None,
                   help="the chain's dtype (default bfloat16 on the card, float32 on the CPU)")
    p.add_argument("--repeats", type=int, default=5, help="timed repetitions per step")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=_cmd_profile)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
