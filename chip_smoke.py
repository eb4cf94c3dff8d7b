#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the builds of the three kernel sources from ``src/repro_torch`` (one
   nvcc each, started together), with ptxas's registers and spills per
   variant and the HGMMA and HMMA counts of each instantiation's SASS (no
   spill, HGMMA in every instantiation of the bf16 prefill and of the bf16
   backward's bwd_main, and HMMA in every instantiation of the SSD's two
   product passes, or the phase fails);
2. flash_attention: the CUDA kernel against its plain PyTorch version on the
   card at the shapes of the Pallas kernel's contract, the qwen loss's own
   prefill, GQA, D = 32, a ragged prefill, prefill continuation and the
   serve path's decode, each case with the variant and split count the
   wrapper's plan() chose, with times (CUDA events) for the kernel, the
   plain version and ``scaled_dot_product_attention`` (a yardstick only: the
   port never calls it) beside the card's bound;
2b. flash_attention_bwd: the backward kernel (bf16: bwd_prep, bwd_main,
   bwd_dq_out; float32: two launches) against its plain version on the
   forward kernel's output and log-sum-exp, at the qwen training call (B4
   S2048 H16 D64), GQA at D = 128, D = 32, a ragged S = 1000, non-causal
   and float32, with times for the kernel (and each launch, from the
   trace), the plain version and SDPA's backward (a yardstick only) beside
   the bound;
3. ssd_scan: the CUDA kernel (three passes per call) against its plain
   version (and, at a small size, the exact recurrence) at the Mamba2
   loss's shape and smaller ones, ragged chunks and a short head group,
   with kernel, device (and, at the loss shapes, per-pass) and plain times
   beside the bound (no PyTorch call computes the SSD); and, on signed
   inputs scaled by 10^3, its error against float64 beside the plain
   float32 version's;
4. qwen1.5-0.5b at full width (random weights from the seed): serve 16
   greedy requests behind ``Engine(slots=8, max_len=1024)``, every decode
   step launching the attention kernel once per layer; the forward against
   the decode loop; ``loss_fn`` of one batch; training through
   ``launch.train.main`` (B4 S2048, ten Adafactor steps: every loss finite,
   step 0's loss equal to ``loss_fn`` without autograd, per step 48 forward
   launches with remat and 24 backward calls; ms per step, device busy
   and the backward's share of it, tokens/s, peak memory); and two full-width layers' gradients on the card
   against the CPU's plain path, per leaf, in float32 and bf16;
5. mamba2-130m at full width: ``loss_fn`` of a batch of 8 x 2048 under
   inference mode (24 SSD launches, one per layer); serve 16 greedy
   requests (the recurrent decode: no SSD launch); and the forward (the
   kernel) against 256 decode steps (the exact recurrence), with a planted
   fault that the phase's limits must reject.

Every path runs with the kernels' launch counts set to 0 just before it and
read just after.  The last two lines of output are the kernels' JSON record
and ``{"ok": true, "device": {...}}``.
"""
import argparse
import concurrent.futures
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense tensor-core bf16
PEAK_TF32_FLOPS = 495e12   # H100 SXM dense tensor-core TF32
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
L2_BYTES = 50 * 2**20


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def device_ms(fn, copies, calls=10, by_name=False):
    """Device time of one call: the kernels' own durations in a torch.profiler
    trace of ``calls`` calls, without the host's time between launches (None
    when no trace holds every call's device events); with ``by_name``, a
    dict by kernel name of its time and its launches per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for _ in range(3):  # a trace now and then comes back without some device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(i % copies)
            torch.cuda.synchronize()
        per_name, count = {}, {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
                count[e.name] = count.get(e.name, 0) + 1
        if count and all(n % calls == 0 for n in count.values()):  # every call's kernels
            if not by_name:
                return sum(per_name.values())
            return {n: {"ms": ms, "launches": count[n] // calls} for n, ms in per_name.items()}
    return None


def time_ms(fn, copies):
    """Median device time of one call, from CUDA events around runs of ten
    calls that rotate over ``copies`` input sets (so that the inputs are
    not all sitting in L2 when the caller would find them cold)."""
    for i in range(3):
        fn(i % copies)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(10):
            fn(i % copies)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 10)
    return statistics.median(times)


# ---------------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------------


def kernel_case(name, *, B, S, T, KR, Gl, D, dtype, causal, q_offset=0, kv_len=None,
                chunk, layout, gen, kv_dtype=None):
    """Build inputs, hold the kernel against the plain version, time the
    kernel, the plain version and SDPA, and compute the bound."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import chunked_attention_ref

    dev = torch.device("cuda")
    kv_dtype = kv_dtype or dtype
    kv_end = min(kv_len if kv_len is not None else T, T)
    esz, kv_esz = (torch.finfo(t).bits // 8 for t in (dtype, kv_dtype))
    q_bytes = B * S * KR * Gl * D * esz
    kv_bytes = 2 * B * kv_end * KR * D * kv_esz  # the visible prefix only
    nbytes = 2 * q_bytes + kv_bytes              # q and o once, k and v once
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / (nbytes + 2 * B * T * KR * D * kv_esz))))

    def model_inputs():
        q = torch.randn(B, S, KR, Gl, D, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, T, KR, D, generator=gen, device=dev).to(kv_dtype)
        v = torch.randn(B, T, KR, D, generator=gen, device=dev).to(kv_dtype)
        return q, k, v

    sets = [model_inputs() for _ in range(copies)]
    if layout == "reference":  # (B,Hq,S,D), (B,Hkv,T,D): the Pallas kernel's layout
        ref_sets = [(q.permute(0, 2, 3, 1, 4).reshape(B, KR * Gl, S, D).contiguous(),
                     k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
                    for q, k, v in sets]

        def run_kernel(i):
            return ops.attention(*ref_sets[i], causal=causal)

        def as_model(out):
            return out.reshape(B, KR, Gl, S, D).permute(0, 3, 1, 2, 4)
    else:
        def run_kernel(i):
            q, k, v = sets[i]
            return ops.attention_model_layout(q, k, v, causal=causal, chunk=chunk,
                                              q_offset=q_offset, kv_len=kv_len)

        def as_model(out):
            return out

    def run_plain(i):
        if layout == "reference":  # the same views ops.attention hands the kernel
            qr, kr, vr = ref_sets[i]
            qm = qr.unflatten(1, (KR, Gl)).permute(0, 3, 1, 2, 4)
            return chunked_attention_ref(qm, kr.transpose(1, 2), vr.transpose(1, 2),
                                         causal=causal, chunk=chunk)
        q, k, v = sets[i]
        return chunked_attention_ref(q, k, v, causal=causal, chunk=chunk,
                                     q_offset=q_offset, kv_len=kv_len)

    # SDPA yardstick on (B,H,S,D) copies made outside the timed region
    sdpa_sets = [(q.permute(0, 2, 3, 1, 4).reshape(B, KR * Gl, S, D).contiguous(),
                  k[:, :kv_end].transpose(1, 2).to(dtype).contiguous(),
                  v[:, :kv_end].transpose(1, 2).to(dtype).contiguous()) for q, k, v in sets]
    mask = None
    if causal and not (q_offset == 0 and S == kv_end):
        mask = (q_offset + torch.arange(S, device=dev))[:, None] >= torch.arange(kv_end, device=dev)[None, :]

    def run_library(i):
        qs, ks, vs = sdpa_sets[i]
        return F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=Gl > 1)

    got = as_model(run_kernel(0)).float()
    torch.cuda.synchronize()
    want = run_plain(0).float()
    # p is rounded to the kv dtype at other tile boundaries than the plain
    # version's chunks: one bf16 rounding apart; float32 differs in sum order
    tol = "f32_chain" if kv_dtype == torch.float32 else "bf16_round"
    rtol, atol = TOLERANCES[tol]
    err = (got - want).abs()
    max_abs_err = err.max().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{name}: kernel vs plain max abs err {max_abs_err} over {tol} ({rtol}, {atol})")

    # visible (query, key) pairs per (b, q head): causal rows see up to their position
    pos = q_offset + np.arange(S)
    pairs = int(np.minimum(pos + 1, kv_end).sum()) if causal else S * kv_end
    flops = 4 * D * pairs * B * KR * Gl
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    pl = fa.plan(B, S, KR, Gl, T, D, dtype, kv_dtype, causal=causal, q_offset=q_offset,
                 kv_len=kv_len)
    rec = {
        "case": name, "dtype": str(dtype).replace("torch.", ""),
        "kv_dtype": str(kv_dtype).replace("torch.", ""),
        "shape": dict(B=B, S=S, T=T, KR=KR, Gl=Gl, D=D, causal=causal,
                      q_offset=q_offset, kv_len=kv_len),
        "variant": pl.variant,
        "max_abs_err": max_abs_err, "tol": tol,
        "ms": time_ms(run_kernel, copies),
        "device_ms": device_ms(run_kernel, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": time_ms(run_library, copies),
        "library_device_ms": device_ms(run_library, copies),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    print(f"  {name:30s} {rec['dtype']:8s} {pl.variant}/{pl.splits} err {max_abs_err:.3g} ({tol}) "
          f"kernel {rec['ms']:.4f} ms (device {_ms(rec['device_ms'])})  plain "
          f"{rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms (device "
          f"{_ms(rec['library_device_ms'])})  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
          f"{flops:.4g} flop, {nbytes:.4g} bytes)", flush=True)
    return rec


def kernel_phase(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = []
    for causal in (True, False):  # the Pallas kernel's contract at full width
        cases.append(kernel_case(f"contract_{'causal' if causal else 'full'}_2x16x2048",
                                 B=2, S=2048, T=2048, KR=16, Gl=1, D=64, dtype=bf16,
                                 causal=causal, chunk=128, layout="reference", gen=gen))
    for dtype in (bf16, f32):  # GQA at D=128
        cases.append(kernel_case("gqa_24q_8kv_1024_d128", B=1, S=1024, T=1024, KR=8, Gl=3,
                                 D=128, dtype=dtype, causal=True, chunk=128,
                                 layout="reference", gen=gen))
    # the qwen loss's own call: model layout, 24 launches per forward
    cases.append(kernel_case("prefill_qwen_loss_2x2048", B=2, S=2048, T=2048, KR=16, Gl=1,
                             D=64, dtype=bf16, causal=True, chunk=1024, layout="model",
                             gen=gen))
    cases.append(kernel_case("prefill_d32_1x8x2048", B=1, S=2048, T=2048, KR=8, Gl=1, D=32,
                             dtype=bf16, causal=True, chunk=1024, layout="model", gen=gen))
    cases.append(kernel_case("prefill_ragged_1000", B=2, S=1000, T=1000, KR=16, Gl=1, D=64,
                             dtype=bf16, causal=True, chunk=1000, layout="model", gen=gen))
    cases.append(kernel_case("continuation_128_of_1024", B=2, S=128, T=1024, KR=16, Gl=1,
                             D=64, dtype=bf16, causal=True, q_offset=896, chunk=1024,
                             layout="model", gen=gen))
    for pos in (0, 37, 1023):  # the serve path's decode: one kv chunk, kv_len = pos + 1
        cases.append(kernel_case(f"decode_8x16_pos{pos}", B=8, S=1, T=1024, KR=16, Gl=1,
                                 D=64, dtype=bf16, causal=False, q_offset=pos,
                                 kv_len=pos + 1, chunk=1024, layout="model", gen=gen))
    cases.append(kernel_case("decode_gqa_8x8x3_d128_pos1023", B=8, S=1, T=1024, KR=8, Gl=3,
                             D=128, dtype=bf16, causal=False, q_offset=1023, kv_len=1024,
                             chunk=1024, layout="model", gen=gen))
    # a float32 model decoding from the bf16 cache
    cases.append(kernel_case("decode_f32q_bf16kv_pos100", B=2, S=1, T=256, KR=16, Gl=1, D=64,
                             dtype=f32, kv_dtype=bf16, causal=False, q_offset=100,
                             kv_len=101, chunk=256, layout="model", gen=gen))
    return cases


# ---------------------------------------------------------------------------------
# flash-attention backward kernel phase
# ---------------------------------------------------------------------------------


def bwd_case(name, *, B, S, KR, Gl, D, dtype, causal, gen):
    """The backward kernel (three launches per bf16 call, two per float32
    call) against its plain version
    on the forward kernel's output and log-sum-exp; kernel, device and plain
    times, SDPA's backward as a yardstick (the port never calls it), and the
    bound."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.ref import flash_attention_bwd_ref

    dev = torch.device("cuda")
    esz = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes = B * S * KR * Gl * D * esz, B * S * KR * D * esz
    # q, o, do read and dq written; k, v read and dk, dv written; lse read
    nbytes = 4 * q_bytes + 4 * kv_bytes + 4 * B * KR * S * Gl
    copies = max(1, min(4, math.ceil(2 * L2_BYTES / nbytes)))

    def inputs():
        q = torch.randn(B, S, KR, Gl, D, generator=gen, device=dev).to(dtype)
        k, v = (torch.randn(B, S, KR, D, generator=gen, device=dev).to(dtype) for _ in range(2))
        do = torch.randn(B, S, KR, Gl, D, generator=gen, device=dev).to(dtype)
        lse = torch.empty(B, KR, S * Gl, device=dev)
        out = fa.flash_attention(q, k, v, causal=causal, lse=lse)
        return q, k, v, out, lse, do

    sets = [inputs() for _ in range(copies)]

    def run_kernel(i):
        q, k, v, out, lse, do = sets[i]
        return fab.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)

    def run_plain(i):
        q, k, v, out, lse, do = sets[i]
        return flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal)

    # SDPA's forward once with the graph kept, its backward timed
    sdpa = []
    for q, k, v, _, _, do in sets:
        leaves = [x.permute(0, 2, 3, 1, 4).reshape(B, KR * Gl, S, D) if x.ndim == 5
                  else x.transpose(1, 2) for x in (q, k, v)]
        leaves = [x.detach().contiguous().requires_grad_() for x in leaves]
        o = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=Gl > 1)
        sdpa.append((o, leaves, do.permute(0, 2, 3, 1, 4).reshape(B, KR * Gl, S, D).contiguous()))

    def run_library(i):
        o, leaves, do = sdpa[i]
        return torch.autograd.grad(o, leaves, do, retain_graph=True)

    got = run_kernel(0)
    torch.cuda.synchronize()
    want = run_plain(0)
    tol = "f32_chain" if dtype == torch.float32 else "bf16_round"
    rtol, atol = TOLERANCES[tol]
    max_abs_err = 0.0
    for which, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        max_abs_err = max(max_abs_err, err.max().item())
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {which}")
        check(bool((err <= atol + rtol * w.abs()).all()),
              f"{name}: {which} kernel vs plain max abs err {err.max().item()} over {tol}")

    # 10 D flops per visible (row, key) pair: five products of 2 D each
    # (S = qf K^T, dP = dO V^T, dq = dS K, dk = dS^T qf, dv = P^T dO)
    pos = np.arange(S)
    pairs = int(np.minimum(pos + 1, S).sum()) if causal else S * S
    flops = 10 * D * pairs * B * KR * Gl
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = {
        "case": name, "dtype": str(dtype).replace("torch.", ""),
        "shape": dict(B=B, S=S, KR=KR, Gl=Gl, D=D, causal=causal),
        "max_abs_err": max_abs_err, "tol": tol,
        "ms": time_ms(run_kernel, copies),
        "device_ms": device_ms(run_kernel, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": time_ms(run_library, copies),
        "library_device_ms": device_ms(run_library, copies),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    passes = device_ms(run_kernel, copies, by_name=True)
    rec["pass_device_ms"] = passes and {_variant(n): v["ms"] for n, v in passes.items()}
    want = (BWD_LAUNCHES_BF16 if dtype == torch.bfloat16 else BWD_LAUNCHES_F32)
    check(not passes or sorted((_variant(n), v["launches"]) for n, v in passes.items())
          == [(v, 1) for v in sorted(want)],
          f"{name}: kernels per call in the trace {passes}, want one of each of {want}")
    print(f"  {name:30s} {rec['dtype']:8s} err {max_abs_err:.3g} ({tol}) kernel {rec['ms']:.4f} ms "
          f"(device {_ms(rec['device_ms'])}; " + ("per launch not measured" if not passes else
          ", ".join(f"{_variant(n)} {v['ms']:.4f}" for n, v in passes.items())) +
          f")  plain {rec['plain_ms']:.4f} ms  sdpa backward {rec['library_ms']:.4f} ms (device "
          f"{_ms(rec['library_device_ms'])})  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}; "
          f"{flops:.4g} flop, {nbytes:.4g} bytes)", flush=True)
    return rec


def bwd_phase(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed + 20)
    bf16, f32 = torch.bfloat16, torch.float32
    return [
        # the qwen training step's call, 24 per step
        bwd_case("train_qwen_4x2048", B=4, S=2048, KR=16, Gl=1, D=64, dtype=bf16, causal=True,
                 gen=gen),
        bwd_case("gqa_3_d128_1x1024", B=1, S=1024, KR=8, Gl=3, D=128, dtype=bf16, causal=True,
                 gen=gen),
        bwd_case("d32_1x8x2048", B=1, S=2048, KR=8, Gl=1, D=32, dtype=bf16, causal=True, gen=gen),
        bwd_case("ragged_2x1000", B=2, S=1000, KR=16, Gl=1, D=64, dtype=bf16, causal=True,
                 gen=gen),
        bwd_case("full_2x16x1024", B=2, S=1024, KR=16, Gl=1, D=64, dtype=bf16, causal=False,
                 gen=gen),
        bwd_case("f32_gqa_2_1x512", B=1, S=512, KR=8, Gl=2, D=64, dtype=f32, causal=True,
                 gen=gen),
    ]


# ---------------------------------------------------------------------------------
# ssd_scan kernel phase
# ---------------------------------------------------------------------------------


def ssd_case(name, *, B, S, H, hd, ds, chunk, gen, recurrence=False, per_pass=False):
    """Inputs with tests/test_kernels.py's distributions; the kernel against
    the plain version (or the float64 recurrence), kernel, device and plain
    times, and the bounds; with ``per_pass``, each pass's device time."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels.ref import ssd_recurrence, ssd_scan_ref

    dev = torch.device("cuda")
    Q = min(chunk, S)
    nc = S // Q
    # x and y once, dt once, B and C once (not per head), A
    nbytes = 4 * (2 * B * S * H * hd + B * S * H + 2 * B * S * ds + H)
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / nbytes)))

    def inputs():
        return (torch.randn(B, S, H, hd, generator=gen, device=dev),
                torch.randn(B, S, H, generator=gen, device=dev).abs() * 0.5,
                torch.randn(B, S, ds, generator=gen, device=dev) * 0.2,
                torch.randn(B, S, ds, generator=gen, device=dev) * 0.2,
                -torch.randn(H, generator=gen, device=dev).abs())

    sets = [inputs() for _ in range(copies)]

    def run_kernel(i):
        return ops.ssd(*sets[i], chunk=chunk)

    def run_plain(i):
        return ssd_scan_ref(*sets[i], chunk)

    got = run_kernel(0)
    torch.cuda.synchronize()
    want = ssd_recurrence(*sets[0]) if recurrence else run_plain(0)
    # the kernel carries the state chunk to chunk where the plain version
    # scans chunk states (and the recurrence steps token by token): the same
    # float32 sums, reassociated
    tol = "f32_chain"
    rtol, atol = TOLERANCES[tol]
    err = (got.double() - want.double()).abs()
    max_abs_err = err.max().item()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    check(bool((err <= atol + rtol * want.double().abs()).all()),
          f"{name}: kernel vs {'recurrence' if recurrence else 'plain'} max abs err "
          f"{max_abs_err} over {tol} ({rtol}, {atol})")

    # what the function needs: the causal half (t >= s) of G = C B^T once per
    # (batch row, chunk); per (batch row, head) the causal half of W x in
    # every chunk, and C S^T and the state update in all chunks but one (the
    # state is zero entering the first chunk, and the one leaving the last is
    # never read).  The kernel runs each product as three TF32 tensor-core
    # products (3xTF32: hi hi + hi lo + lo hi, float32 accuracy), so its bound
    # by operations is 3 flops at the TF32 peak; the bound by float32 FMAs on
    # the CUDA cores, where a kernel without tensor cores would stand, stays
    # beside it.
    causal = Q * (Q + 1) // 2
    flops = B * nc * 2 * ds * causal + B * H * (
        nc * 2 * hd * causal + (nc - 1) * (2 * Q * ds * hd + 2 * Q * hd * ds))
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    pl = ssd_kernel.plan(B, S, H, hd, ds, chunk, sms=ssd_kernel.multiprocessors(dev))
    rec = {
        "case": name, "dtype": "float32",
        "shape": dict(B=B, S=S, H=H, hd=hd, ds=ds, Q=Q),
        "max_abs_err": max_abs_err, "tol": tol,
        "against": "recurrence" if recurrence else "plain",
        "ms": time_ms(run_kernel, copies),
        "dev_ms": device_ms(run_kernel, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": None,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    # counted and planned, not measured: on the printed line only
    f32_fma_ms = max(flops / PEAK_F32_FLOPS * 1e3, t_bytes)
    print(f"  {name:30s} err {max_abs_err:.3g} vs {rec['against']} ({tol}) "
          f"kernel {rec['ms']:.4f} ms (device {_ms(rec['dev_ms'])})  plain "
          f"{rec['plain_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"3xTF32; f32 FMA {f32_fma_ms:.4f}; {flops:.4g} flop, {nbytes:.4g} bytes)  head "
          f"group {pl.head_group}, out grid {pl.out_grid}, scratch {pl.scratch_bytes} bytes",
          flush=True)
    if per_pass:
        passes = device_ms(run_kernel, copies, by_name=True)
        rec["pass_dev_ms"] = passes and {_variant(n): v["ms"] for n, v in passes.items()}
        # kernels that one wrapper call launched, counted in the trace
        rec["launches_per_call"] = passes and sum(v["launches"] for v in passes.values())
        print(f"    per pass (device): " + ("not measured" if not passes else "  ".join(
            f"{_variant(n)} {v['ms']:.4f} ms x{v['launches']}" for n, v in passes.items())),
            flush=True)
    return rec


def ssd_cancelling_sums(gen):
    """Signed x scaled by 10^3 (tests/test_torch_cuda.py's cancelling-sums
    case): the kernel's and the plain float32 version's largest errors
    against float64 on the same inputs; fails unless the kernel's is within
    4x of the plain version's."""
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels.ref import ssd_scan_ref

    dev = torch.device("cuda")
    x, dt, B, C, A = (torch.randn(2, 512, 3, 64, generator=gen, device=dev) * 1e3,
                      torch.randn(2, 512, 3, generator=gen, device=dev).abs() * 0.5,
                      torch.randn(2, 512, 128, generator=gen, device=dev) * 0.2,
                      torch.randn(2, 512, 128, generator=gen, device=dev) * 0.2,
                      -torch.randn(3, generator=gen, device=dev).abs())
    from repro_torch.core.compat import TOLERANCES

    rtol, atol = TOLERANCES["f32_chain"]
    want = ssd_scan_ref(*(t.double() for t in (x, dt, B, C, A)), 128)
    out = {}
    for who, got in (("kernel", ssd_kernel.ssd_scan(x, dt, B, C, A)),
                     ("plain", ssd_scan_ref(x, dt, B, C, A, 128))):
        err = (got.double() - want).abs()
        out[f"{who}_err"] = err.max().item()
        # outputs outside f32_chain against float64: near-zero sums of large terms
        out[f"{who}_outside_f32_chain"] = int((err > atol + rtol * want.abs()).sum().item())
    print(f"  cancelling sums (signed x * 1e3, B2 S512 H3, |y| <= "
          f"{want.abs().max().item():.4g}): max abs err vs float64 kernel "
          f"{out['kernel_err']:.4g}, plain float32 {out['plain_err']:.4g} "
          f"({out['kernel_err'] / out['plain_err']:.3f}x; limit 4x); outputs outside f32_chain "
          f"kernel {out['kernel_outside_f32_chain']}, plain {out['plain_outside_f32_chain']} "
          f"of {want.numel()}", flush=True)
    check(0 < out["plain_err"] and out["kernel_err"] <= 4 * out["plain_err"],
          "ssd_scan: the kernel's error on cancelling sums is over 4x plain float32's")
    return out


def ssd_phase(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed + 10)
    return [
        # the Mamba2 loss phase's shape, per layer
        ssd_case("loss_8x2048_h24", B=8, S=2048, H=24, hd=64, ds=128, chunk=128, gen=gen,
                 per_pass=True),
        ssd_case("loss_1x2048_h24", B=1, S=2048, H=24, hd=64, ds=128, chunk=128, gen=gen,
                 per_pass=True),
        # Q = 48: three chunks of three full m tiles; Q = 36 and Q = 100 (S <
        # chunk), no multiple of 8: rows padded to 40 and 104 in the state
        # pass, 48 and 112 in the output pass; H = 5 at B = 2: groups of 2
        # heads, the last one short, and 16 chunks through the state pass
        ssd_case("chunk48_s144", B=2, S=144, H=24, hd=64, ds=128, chunk=48, gen=gen),
        ssd_case("chunk36_s144", B=2, S=144, H=24, hd=64, ds=128, chunk=36, gen=gen),
        ssd_case("short_s100_q100", B=2, S=100, H=24, hd=64, ds=128, chunk=128, gen=gen),
        ssd_case("heads5_b2_s2048", B=2, S=2048, H=5, hd=64, ds=128, chunk=128, gen=gen),
        ssd_case("short_s64_q64", B=2, S=64, H=24, hd=64, ds=128, chunk=128, gen=gen),
        ssd_case("hd32_ds16", B=1, S=256, H=1, hd=32, ds=16, chunk=128, gen=gen),
        ssd_case("recurrence_s64", B=1, S=64, H=2, hd=32, ds=16, chunk=32, gen=gen,
                 recurrence=True),
    ]


# ---------------------------------------------------------------------------------
# model phases
# ---------------------------------------------------------------------------------


def counted(fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before and
    read just after; returns (fn's result, {kernel: launches})."""
    kernels = _kernel_modules()
    for mod in kernels.values():
        mod.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: mod.launches for name, mod in kernels.items()}


def _kernel_modules():
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ssd_scan

    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan": ssd_scan}


def full_width_model(arch, seed, dtype=None):
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import default_strategy, get_config, reduced_config
    from repro_torch.models import api
    from repro_torch.models.layers import tree_init

    cfg = reduced_config(get_config(arch), 1)
    if arch == "qwen1.5-0.5b":
        got = (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh, cfg.d_ff,
               cfg.vocab_size, cfg.qkv_bias, cfg.dtype)
        want = (24, 1024, 16, 16, 64, 2816, 151936, True, "bfloat16")
    else:
        got = (cfg.family, cfg.num_layers, cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
               cfg.ssm_state, cfg.ssm_conv, cfg.vocab_size, cfg.dtype)
        want = ("ssm", 24, 768, 2, 64, 128, 4, 50280, "bfloat16")
    check(got == want, f"unexpected config {cfg}")
    cfg = cfg.with_(dtype=dtype or cfg.dtype)
    st = get_strategy(default_strategy(arch))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tree_init(api.param_tree(cfg, st), gen, dtype=cfg.dtype, device="cuda")
    return cfg, st, params


def serve_phase(cfg, st, params, seed, kernel):
    """16 greedy requests of 8-64 prompt tokens and 32 new tokens behind
    ``Engine(slots=8, max_len=1024)``; ``kernel`` launches once per layer
    per decode step (None: no kernel launches at all)."""
    from repro_torch.serve.engine import Engine, Request

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(8, 65, size=16)]
    eng = Engine(cfg, st, params, batch_slots=8, max_len=1024)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = counted(lambda: eng.generate(reqs))
    seconds = time.perf_counter() - t0
    steps = eng.pos
    ntok = sum(len(r.out) for r in reqs)
    print(f"serve {cfg.name}: {len(reqs)} requests, {ntok} tokens in {seconds:.3f} s "
          f"({ntok / seconds:.1f} tok/s), {steps} decode steps, "
          f"{1e3 * seconds / steps:.2f} ms/step, launches {launches}", flush=True)
    want = {name: steps * cfg.num_layers if name == kernel else 0 for name in launches}
    check(launches == want, f"launches {launches} != {want} ({steps} steps x {cfg.num_layers})")
    check(all(r.done and len(r.out) == 32 for r in reqs), "a request did not finish")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out), "token out of vocab")
    check(all(bool(torch.isfinite(c).all()) for c in eng.cache.values()), "non-finite cache")
    out = {"requests": len(reqs), "tokens": ntok, "seconds": seconds,
           "tok_per_s": ntok / seconds, "decode_steps": steps,
           "ms_per_step": 1e3 * seconds / steps, "launches": launches,
           "cache_dtypes": {k: str(v.dtype) for k, v in eng.cache.items()}}
    out.update(profile_decode(cfg, st, params, eng, out["ms_per_step"]))
    return out


def profile_device(label, fn, steps, wall_ms_per_step):
    """Device time per step of ``fn(i)`` for i < steps, by kernel name, from a
    torch.profiler trace, beside the wall time per step measured elsewhere."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            fn(i)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        print(f"profile {label}: the trace holds no device events; device busy share not measured")
        return {}
    per_name = {}
    for e in device:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile {label}: {len(device) / steps:.0f} device ops/step, device busy "
          f"{busy:.3f} ms/step = {busy / wall_ms_per_step:.1%} of {wall_ms_per_step:.2f} "
          f"ms/step", flush=True)
    for name, ms in top:
        print(f"  {ms:.4f} ms/step  {name[:90]}")
    return {"device_ops_per_step": len(device) / steps, "device_busy_ms_per_step": busy,
            "device_busy_share": busy / wall_ms_per_step,
            "top": [{"name": n[:120], "ms_per_step": ms} for n, ms in top]}


def profile_decode(cfg, st, params, eng, ms_per_step, steps=5):
    """A few more decode steps into the served cache, each step's logits read
    back as the engine's sampler does."""
    from repro_torch.models import api

    token = torch.zeros((eng.B, 1), dtype=torch.long, device="cuda")
    check(eng.pos + steps < eng.T, "no room in the cache to profile")

    def step(i):
        logits, _ = api.decode_step(cfg, st, params, token, eng.cache, eng.pos + i)
        logits[:, -1].float().cpu()

    return profile_device(f"{cfg.name} decode steps from pos {eng.pos}", step, steps, ms_per_step)


def loss_phase(cfg, st, params, seed, B, S, kernel, reps=3):
    """``loss_fn`` of one batch of random tokens and labels under inference
    mode: the loss is finite and ``kernel`` launched once per layer."""
    from repro_torch.models import api

    rng = np.random.default_rng(seed + 2)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).cuda()
             for k in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        loss, launches = counted(lambda: api.loss_fn(cfg, st, params, batch))
        want = {name: cfg.num_layers if name == kernel else 0 for name in launches}
        check(launches == want, f"{cfg.name} loss launches {launches} != {want}")
        check(bool(torch.isfinite(loss)), f"{cfg.name} loss {loss} is not finite")
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            api.loss_fn(cfg, st, params, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_device(f"{cfg.name} loss B={B} S={S}",
                              lambda i: api.loss_fn(cfg, st, params, batch), 1, ms)
    print(f"loss {cfg.name}: B={B} S={S} loss {loss.item():.4f}, {ms:.2f} ms per forward "
          f"(median of {reps}), {B * S / ms * 1e3:.0f} tokens/s, peak memory {peak:.2f} GiB, "
          f"launches {launches}", flush=True)
    return {"B": B, "S": S, "loss": loss.item(), "ms_per_forward": ms,
            "tokens_per_s": B * S / ms * 1e3, "peak_gib": peak, "launches": launches, **prof}


# Forward vs decode loop: (logits relative error, argmax agreement) limits
# by family.  qwen in bf16: the same model through two kernel branches and
# differently shaped matmuls.  One-ulp bf16 flips (2^-8 relative) at a few
# rounding points per layer compound over 24 layers to about 1e-2 relative;
# the bounds leave room of about 3x.  Mamba2 runs this phase in float32:
# with random weights its bf16 stack is chaotic under rounding (the
# reference itself, op by op, gives a forward-vs-decode relative error of
# 0.11 and 84 % argmax agreement at reduced_config(.., 4)), so bf16 would
# measure rounding, not the kernel.  In float32 the chunked SSD and the
# recurrence differ only in the order of their sums: 4.3e-3 and 99.4 % at
# full width on the card.  Its limits sit about 3x above that, and below
# the reading of a planted fault that each run takes again (the SSD with its
# state dropped at chunk boundaries, ``ssd_state_dropped``).  Argmax may
# differ only where the forward's top-2 margin is within twice the error
# bound of the logits' RMS.
CONSIST = {"dense": (5e-2, 0.90), "ssm": (1.5e-2, 0.98)}


def ssd_state_dropped(x, dt, B, C, A, *, chunk=128):
    """A planted fault for the consistency limits: the SSD with the state
    reset to zero at every chunk boundary, as a kernel that failed to carry
    it would compute (the plain version over the chunks folded into the
    batch)."""
    from repro_torch.kernels.ref import ssd_scan_ref

    Bb, S = x.shape[:2]
    Q = min(chunk, S)

    def fold(t):
        return t.reshape(Bb * (S // Q), Q, *t.shape[2:])

    return ssd_scan_ref(fold(x), fold(dt), fold(B), fold(C), A, Q).reshape(x.shape)


def consistency_phase(cfg, st, params, seed, kernel):
    """``forward`` through ``kernel`` against a loop of ``decode_step``s;
    for Mamba2, also the planted fault, which the limits must reject."""
    from repro_torch.kernels import ops
    from repro_torch.models import api

    B, S = 2, 256
    max_rel, min_agree = CONSIST[cfg.family]
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, S)))
    tokens = tokens.cuda()
    with torch.inference_mode():
        fwd, launches = counted(lambda: api.forward(cfg, st, params, tokens))
        want = {name: cfg.num_layers if name == kernel else 0 for name in launches}
        check(launches == want, f"forward launched {launches} != {want}")
        cache = {k: torch.zeros(v, dtype=torch.float32 if k == "s" else torch.bfloat16,
                                device="cuda")
                 for k, v in api.cache_shapes(cfg, st, B, S).items()}
        dec = []
        for pos in range(S):
            logits, cache = api.decode_step(cfg, st, params, tokens[:, pos:pos + 1], cache, pos)
            dec.append(logits)
        fault = None
        if cfg.family == "ssm":
            kernel_ssd, ops.ssd = ops.ssd, ssd_state_dropped
            try:
                fault = api.forward(cfg, st, params, tokens).float()
            finally:
                ops.ssd = kernel_ssd
    dec = torch.cat(dec, dim=1).float()
    fwd = fwd.float()
    check(fwd.shape == (B, S, cfg.vocab_size) and bool(torch.isfinite(fwd).all())
          and bool(torch.isfinite(dec).all()), "non-finite or misshapen logits")
    rms = fwd.square().mean().sqrt().item()

    def readings(logits):
        rel = ((dec - logits).norm() / logits.norm()).item()
        top2 = logits.topk(2, dim=-1).values
        margin = top2[..., 0] - top2[..., 1]
        agree = dec.argmax(-1) == logits.argmax(-1)
        wide = margin > 2 * max_rel * rms
        widest = margin[~agree].max().item() / rms if bool((~agree).any()) else 0.0
        return rel, agree.float().mean().item(), int((~agree & wide).sum()), widest

    rel, agree, wide_flips, widest = readings(fwd)
    print(f"consistency {cfg.name} ({cfg.dtype}): forward vs {S} decode steps, B={B}: logits "
          f"rel err {rel:.3e} (<= {max_rel}), argmax agree {agree:.4f} (>= {min_agree}), "
          f"disagreements at wide margins {wide_flips} (widest {widest:.4f} x rms), "
          f"logits rms {rms:.3f}", flush=True)
    check(rel <= max_rel, f"forward vs decode rel err {rel}")
    check(agree >= min_agree, "forward vs decode argmax agreement")
    check(wide_flips == 0, "argmax differs where the top-2 margin is wide")
    out = {"dtype": cfg.dtype, "rel_err": rel, "argmax_agree": agree,
           "limits": {"rel_err": max_rel, "argmax_agree": min_agree}}
    if fault is not None:
        f_rel, f_agree, f_wide, _ = readings(fault)
        print(f"  planted fault (SSD state dropped at chunk boundaries): rel err {f_rel:.3e}, "
              f"argmax agree {f_agree:.4f}, disagreements at wide margins {f_wide}", flush=True)
        check(f_rel > max_rel or f_agree < min_agree or f_wide > 0,
              "the consistency limits pass the planted fault")
        out["planted_fault"] = {"rel_err": f_rel, "argmax_agree": f_agree,
                                "wide_disagreements": f_wide}
    return out


TRAIN_STEPS = 10
PROFILED_STEP = 6  # the step traced for device busy time (left out of the wall median)


def train_phase(seed, B=4, S=2048):
    """qwen1.5-0.5b at full width trained through ``launch.train.main`` (the
    port's entry point: float32 master weights, bf16 compute, remat "dots",
    Adafactor) for TRAIN_STEPS steps on the arithmetic pattern.  Checks:
    every loss finite; step 0's loss equal to ``api.loss_fn`` of the same
    weights and batch without autograd; per step, 24 forward launches plus
    24 recomputed in the backward (remat "dots" keeps only the 2-D
    products) and 24 backward calls (three launches each).  Reads: ms per
    step (wall; device busy and the backward kernel's share of it from a
    trace of one step), tokens/s, peak memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import default_strategy, get_config
    from repro_torch.core.compat import assert_close
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch import train as launch_train
    from repro_torch.models import api
    from repro_torch.train.loop import TrainConfig, init_state
    from repro_torch.train.optimizer import get_optimizer

    arch = "qwen1.5-0.5b"
    cfg, st = get_config(arch), get_strategy(default_strategy(arch))
    check(cfg.remat == "dots" and cfg.param_dtype == "float32", f"unexpected config {cfg}")
    params = init_state(cfg, st, get_optimizer("adafactor"), TrainConfig(),
                        torch.Generator("cuda").manual_seed(seed), "cuda")["params"]
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=seed, pattern="arithmetic"))
    batch0 = {k: torch.from_numpy(v).cuda().long() for k, v in pipe.batch_at(0).items()}
    with torch.inference_mode():
        loss0 = api.loss_fn(cfg, st, params, batch0).item()
    del params, batch0
    torch.cuda.empty_cache()

    mods, steps, clock, trace = _kernel_modules(), [], {}, {}

    def fault(step):  # called at the start of each step
        if step == PROFILED_STEP:
            trace["prof"] = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            trace["prof"].start()
        for mod in mods.values():
            mod.launches = 0
        clock["t0"] = time.perf_counter()

    def metrics(step, loss):  # called once the step's loss is on the host
        ms = (time.perf_counter() - clock["t0"]) * 1e3
        if step == PROFILED_STEP:
            torch.cuda.synchronize()
            trace["prof"].stop()
        launches = {name: mod.launches for name, mod in mods.items()}
        steps.append({"step": step, "loss": loss, "ms": ms, "launches": launches})
        print(f"  train step {step}: loss {loss:.6f}, {ms:.1f} ms, launches {launches}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = launch_train.main(
        ["--arch", arch, "--reduce", "1", "--batch", str(B), "--seq", str(S), "--steps",
         str(TRAIN_STEPS), "--data-pattern", "arithmetic", "--seed", str(seed)],
        hooks={"fault": fault, "metrics": metrics})
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
          f"train losses {losses}")
    assert_close(np.float32(losses[0]), np.float32(loss0), "f32",
                 err_msg="step 0's loss against api.loss_fn without autograd")
    L = cfg.num_layers
    want = {"flash_attention": 2 * L, "flash_attention_bwd": L, "ssd_scan": 0}
    for rec in steps:
        check(rec["launches"] == want, f"step {rec['step']} launches {rec['launches']} != {want}")
    wall = statistics.median(r["ms"] for r in steps[1:] if r["step"] != PROFILED_STEP)
    device = [e for e in trace["prof"].events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) if device else None
    bwd = {}  # the backward's launches in the traced step, by variant
    for n, ms in by_name.items():
        if _variant(n) in BWD_LAUNCHES_BF16:
            bwd[_variant(n)] = bwd.get(_variant(n), 0.0) + ms
    bwd_ms = sum(bwd.values()) if device else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"train {arch}: B={B} S={S}, {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (step 0 without autograd {loss0:.6f}); wall {wall:.1f} ms/step "
          f"(median of steps 1-{TRAIN_STEPS - 1} but {PROFILED_STEP}), {B * S / wall * 1e3:.0f} "
          f"tokens/s; step {PROFILED_STEP} device busy {_ms(busy)} ({len(device)} device ops), "
          f"the backward kernel {_ms(bwd_ms)}" + (f" ({bwd_ms / busy:.1%}: " + ", ".join(
              f"{v} {ms:.3f}" for v, ms in sorted(bwd.items())) + ")" if busy else "") +
          f"; peak memory {peak:.2f} GiB", flush=True)
    for name, ms in top:
        print(f"  {ms:.4f} ms/step  {name[:90]}")
    return {"B": B, "S": S, "losses": losses, "loss0_no_grad": loss0, "ms_per_step": wall,
            "tokens_per_s": B * S / wall * 1e3, "device_busy_ms_per_step": busy,
            "bwd_device_ms_per_step": bwd_ms, "bwd_device_ms_by_launch": bwd,
            "device_ops_per_step": len(device), "peak_gib": peak, "steps": steps,
            "launches": {n: sum(r["launches"][n] for r in steps) for n in want},
            "top": [{"name": n[:120], "ms_per_step": ms} for n, ms in top]}


def two_layer_phase(seed, B=2, S=128):
    """qwen1.5-0.5b at full width cut to two layers: ``value_and_grad`` on the
    card (the forward and backward kernels) against the CPU's plain path,
    from the same float32 master weights, per leaf, in float32 and bf16.
    Gradients agree in norm within the rtol of f32_chain (float32: sums in
    another order) or bf16_chain (bf16: cuBLAS and the kernels round some
    activations the other way), as tests/test_torch_cuda.py holds them."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.train.loop import TrainConfig, init_state, value_and_grad
    from repro_torch.train.optimizer import get_optimizer

    st = get_strategy("2d_finalized")
    out = {}
    for dtype, kind in (("float32", "f32_chain"), ("bfloat16", "bf16_chain")):
        cfg = get_config("qwen1.5-0.5b").with_(num_layers=2, dtype=dtype)
        tokens = np.random.default_rng(seed + 4).integers(0, cfg.vocab_size, (B, S + 1))
        batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
                 "labels": torch.from_numpy(tokens[:, 1:])}
        cpu = init_state(cfg, st, get_optimizer("sgd"), TrainConfig(),
                         torch.Generator().manual_seed(seed), "cpu")["params"]
        gpu = tree_map(lambda p: p.detach().cuda().requires_grad_(), cpu)
        (loss_g, grads_g), launches = counted(lambda: value_and_grad(
            cfg, st, gpu, {k: v.cuda() for k, v in batch.items()}))
        want = {"flash_attention": 4, "flash_attention_bwd": 2, "ssd_scan": 0}
        check(launches == want, f"two-layer step launches {launches} != {want}")
        loss_c, grads_c = value_and_grad(cfg, st, cpu, batch)
        rel = {"/".join(path): ((g.cpu().double() - w.double()).norm() / w.double().norm()).item()
               for (path, g), (_, w) in zip(leaves_with_paths(grads_g), leaves_with_paths(grads_c))}
        worst = max(rel, key=rel.get)
        loss_rel = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        print(f"two-layer step {dtype}: loss card {loss_g.item():.6f} cpu {loss_c.item():.6f}; "
              f"gradient relative error per leaf max {rel[worst]:.3e} ({worst}; limit "
              f"{TOLERANCES[kind][0]}, {kind}), launches {launches}", flush=True)
        check(rel[worst] <= TOLERANCES[kind][0], f"{dtype}: {worst} gradient off by {rel[worst]}")
        check(loss_rel <= TOLERANCES[kind][0], f"{dtype}: loss off by {loss_rel}")
        out[dtype] = {"loss_rel_err": loss_rel, "grad_rel_err": rel, "class": kind}
    return out


# the kernels' templates by variant, as the mangled names in ptxas's report,
# in the SASS and in profiler traces show them
VARIANT_OF = {"flash_bwd_prep": "bwd_prep", "flash_bwd_main": "bwd_main",
              "flash_bwd_dq_out": "bwd_dq_out",
              "flash_bwd_dq_f32": "bwd_dq_f32", "flash_bwd_dkdv_f32": "bwd_dkdv_f32",
              "flash_wgmma": "prefill_wgmma", "flash_decode": "decode_splitkv",
              "flash_fwd": "prefill_f32", "ssd_chunk_state": "ssd_chunk_state",
              "ssd_state_pass": "ssd_state_pass", "ssd_chunk_out": "ssd_chunk_out"}
# the kernels whose products run on wgmma (HGMMA in the SASS)
HGMMA_VARIANTS = ("prefill_wgmma", "bwd_main")
# the SSD passes whose products run on the tensor cores with mma.sync
# (ssd_state_pass only moves the states: no product)
HMMA_VARIANTS = ("ssd_chunk_state", "ssd_chunk_out")
# the backward's launches per call
BWD_LAUNCHES_BF16 = ("bwd_prep", "bwd_main", "bwd_dq_out")
BWD_LAUNCHES_F32 = ("bwd_dq_f32", "bwd_dkdv_f32")


def _variant(symbol):
    return next((v for k, v in VARIANT_OF.items() if k in symbol), symbol)


def mma_counts(lib):
    """HGMMA (wgmma) and HMMA (mma.sync) instructions in each instantiation's
    SASS, by mangled name, from ``cuobjdump -sass`` beside nvcc; None when
    the toolkit has no cuobjdump."""
    from repro_torch.kernels.build import nvcc_path

    tool = pathlib.Path(nvcc_path()).parent / "cuobjdump"
    if not tool.exists():
        return None
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn is not None:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                counts[fn][op.group(1)] += 1
    return counts


def build_kernels():
    """Start one nvcc per kernel source together; print ptxas's registers and
    spills per variant and the HGMMA and HMMA counts of each instantiation;
    fail if a build spills, an instantiation of the bf16 prefill or of the
    bf16 backward's bwd_main holds no HGMMA or an instantiation of an SSD
    product pass holds no HMMA."""
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ssd_scan

    t0 = time.perf_counter()
    mods = (("flash_attention", flash_attention), ("flash_attention_bwd", flash_attention_bwd),
            ("ssd_scan", ssd_scan))
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        futures = {name: pool.submit(mod.build) for name, mod in mods}
        libs = {name: f.result() for name, f in futures.items()}
    seconds = time.perf_counter() - t0
    print(f"  kernel builds {seconds:.1f} s (in parallel)", flush=True)
    report = {"build_s": seconds, "variants": {}}
    for name, lib in libs.items():
        ptxas = lib.with_suffix(".log").read_text()
        if "setmaxnreg ignored" in ptxas:
            print(f"  {name}: ptxas ignored setmaxnreg", flush=True)
        funcs = re.findall(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores.*?"
                           r"Used (\d+) registers", ptxas, re.S)
        by_variant = {}
        for sym, spills, regs in funcs:
            v = by_variant.setdefault(_variant(sym), {"instantiations": 0, "registers": set(),
                                                      "spill_stores": 0})
            v["instantiations"] += 1
            v["registers"].add(int(regs))
            v["spill_stores"] += int(spills)
        mma = mma_counts(lib)
        for variant, v in sorted(by_variant.items()):
            v["registers"] = sorted(v["registers"])
            for op in ("HGMMA", "HMMA"):
                if mma is None:
                    v[op.lower()] = "not measured (no cuobjdump beside nvcc)"
                else:
                    v[op.lower()] = sorted(n[op] for sym, n in mma.items()
                                           if _variant(sym) == variant)
            print(f"  {name} {variant}: {v['instantiations']} instantiations, registers "
                  f"{v['registers']}, spill stores {v['spill_stores']} bytes, HGMMA per "
                  f"instantiation {v['hgmma']}, HMMA {v['hmma']}", flush=True)
            check(v["spill_stores"] == 0, f"{name} {variant} spills registers")
            if variant in HGMMA_VARIANTS and mma is not None:
                check(len(v["hgmma"]) == v["instantiations"] and min(v["hgmma"]) > 0,
                      f"an {variant} instantiation holds no HGMMA: {v['hgmma']}")
            if variant in HMMA_VARIANTS and mma is not None:
                check(len(v["hmma"]) == v["instantiations"] and min(v["hmma"]) > 0,
                      f"an {variant} instantiation holds no HMMA: {v['hmma']}")
            report["variants"][variant] = v
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    build = build_kernels()

    print("kernel: flash_attention (CUDA) vs plain PyTorch on the card", flush=True)
    fa_cases = kernel_phase(args.seed)
    print("kernel: flash_attention_bwd (CUDA) vs plain PyTorch on the card", flush=True)
    bwd_cases = bwd_phase(args.seed)
    print("kernel: ssd_scan (CUDA) vs plain PyTorch on the card", flush=True)
    ssd_cases = ssd_phase(args.seed)
    ssd_cancel = ssd_cancelling_sums(torch.Generator(device="cuda").manual_seed(args.seed + 11))

    cfg, st, params = full_width_model("qwen1.5-0.5b", args.seed)
    qwen_serve = serve_phase(cfg, st, params, args.seed, "flash_attention")
    qwen_consistency = consistency_phase(cfg, st, params, args.seed, "flash_attention")
    qwen_loss = loss_phase(cfg, st, params, args.seed, B=2, S=2048, kernel="flash_attention")
    del params
    torch.cuda.empty_cache()
    qwen_train = train_phase(args.seed)
    qwen_two_layer = two_layer_phase(args.seed)

    cfg, st, params = full_width_model("mamba2-130m", args.seed)
    mamba_loss = loss_phase(cfg, st, params, args.seed, B=8, S=2048, kernel="ssd_scan")
    mamba_serve = serve_phase(cfg, st, params, args.seed, None)
    del params
    cfg, st, params = full_width_model("mamba2-130m", args.seed, dtype="float32")
    mamba_consistency = consistency_phase(cfg, st, params, args.seed, "ssd_scan")

    fa_main = next(c for c in fa_cases if c["case"] == "decode_8x16_pos1023")
    fa_prefill = next(c for c in fa_cases if c["case"] == "prefill_qwen_loss_2x2048")
    ssd_main = next(c for c in ssd_cases if c["case"] == "loss_8x2048_h24")
    bwd_main = next(c for c in bwd_cases if c["case"] == "train_qwen_4x2048")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    ssd_keys = ("dev_ms", "pass_dev_ms", "launches_per_call")
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": qwen_serve["launches"]["flash_attention"], "launches_path": "qwen serve",
        **{k: fa_main[k] for k in keys}, "main_case": fa_main["case"],
        "prefill_main_case": {"case": fa_prefill["case"], **{k: fa_prefill[k] for k in keys},
                              "launches": qwen_loss["launches"]["flash_attention"],
                              "launches_path": "qwen loss"},
        "cases": fa_cases,
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:70",
        "launches": mamba_loss["launches"]["ssd_scan"], "launches_path": "mamba2 loss",
        **{k: ssd_main[k] for k in keys + ssd_keys}, "main_case": ssd_main["case"],
        "cancelling_sums": ssd_cancel, "cases": ssd_cases,
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:132",
        "launches": qwen_train["launches"]["flash_attention_bwd"],
        "launches_path": f"qwen train, {TRAIN_STEPS} steps",
        **{k: bwd_main[k] for k in keys}, "main_case": bwd_main["case"],
        "device_ms": bwd_main["device_ms"], "pass_device_ms": bwd_main["pass_device_ms"],
        "cases": bwd_cases,
    }], "build": build, "qwen": {"serve": qwen_serve, "consistency": qwen_consistency,
                                 "loss": qwen_loss, "train": qwen_train,
                                 "two_layer_step": qwen_two_layer},
        "mamba2": {"loss": mamba_loss, "serve": mamba_serve, "consistency": mamba_consistency}}
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
