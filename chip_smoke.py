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
   product passes, or the phase fails); and the scan node with this torch
   (a small loop captured with its gradient, against the eager loop);
2. flash_attention: the CUDA kernel against its plain PyTorch version on the
   card at the shapes of the Pallas kernel's contract, the qwen loss's own
   prefill, the partitioned layer's and train step's folded prefills, GQA,
   D = 32, a ragged prefill, prefill continuation and the serve path's
   decode (with host positions, and with its position on the card at the
   serve shape and the partitioned serve step's fold, B32 KR4, at positions
   0, 1, a split boundary, the one before it and T - 2; and with a position
   per batch row and each row's log-sum-exp at the sequence-sharded serve
   step's fold, 8 devices x 8 slots, KR4, 512 keys per device, across the
   shard boundary and with rows that see no key, in bf16 and float32),
   each case with the variant and split count the
   wrapper's plan() chose, with times (CUDA events) for the kernel, the
   plain version and ``scaled_dot_product_attention`` (a yardstick only: the
   port never calls it) beside the card's bound;
2b. flash_attention_bwd: the backward kernel (bf16: bwd_prep, bwd_main,
   bwd_dq_out; float32: two launches) against its plain version on the
   forward kernel's output and log-sum-exp, at the qwen training call (B4
   S2048 H16 D64), the partitioned train step's folded call (B32 S512 KR4
   D64), GQA at D = 128, D = 32, a ragged S = 1000, non-causal and
   float32, with times for the kernel (and each launch, from the
   trace), the plain version and SDPA's backward (a yardstick only) beside
   the bound;
3. ssd_scan: the CUDA kernel (three passes per call) against its plain
   version (and, at a small size, the exact recurrence) at the Mamba2
   loss's shape and smaller ones, ragged chunks and a short head group,
   with kernel, device (and, at the loss shapes, per-pass) and plain times
   beside the bound (no PyTorch call computes the SSD), A per batch row at
   the loss shape and at the partitioned loss's fold (32 x 2048, 6 heads);
   and, on signed
   inputs scaled by 10^3, its error against float64 beside the plain
   float32 version's;
3b. ssd_scan_bwd: the SSD's backward kernel (six launches per call) at
   the Mamba2 training call (B8 S2048 H24), the partitioned train step's
   fold (32 x 512, 6 heads, A per row), hd 32 with ds 16, S equal to the
   chunk and inputs scaled by 10^3 (non-negative and signed), each of dx,
   ddt, dB, dC and dA against the plain backward in float64 on the card
   within f32_chain (or, where sums cancel, within 4x the plain float32
   version's own error), with kernel, device and per-launch times, the
   plain version's time and the bound (no PyTorch call computes it);
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
   requests (the recurrent decode: no SSD launch); the forward (the
   kernel) against 256 decode steps (the exact recurrence), with a planted
   fault that the phase's limits must reject; training through
   ``launch.train.main --arch mamba2-130m`` (B8 S2048, ten Adafactor
   steps: every loss finite, step 0's loss equal to ``loss_fn`` without
   autograd, per step 48 SSD forward calls with the "dots" recompute and
   24 backward calls; ms per step, device busy and the SSD backward's share
   of it, tokens/s, peak memory); and two full-width layers' float32
   gradients through the kernels and through the plain path, each against
   the plain path in float64 on the card;
6. partition: the port's own partitioner on a simulated (2,4) mesh whose
   eight devices' shards all live on the card, by compiled plan
   (``spmd_partition(..., optimize=False)``: capture, sharding completion
   and the plan once, then the plan's steps on every call) and by the
   dynamic path: qwen1.5-0.5b's SwiGLU MLP at full width (8,192 tokens) in
   float32 and bf16, a contracting-dim product, expert-dim recursive
   grouping, a 2-D spatial halo convolution, and qwen1.5-0.5b's full-width
   decoder layer (B4 S2048; x, positions and weights annotated by
   2d_finalized on ("data" 2, "model" 4)) in bf16 and float32, whose
   attention is the flash kernel, launched once per partitioned call for
   all eight devices.  Each against the same function unsharded on the
   card, with the collectives run, the fallbacks (none that gathers a
   sharded dim, or the phase fails), the largest error against its limit,
   device ms of the three runs and host and wall ms per call (times of the
   simulation: one card does the eight devices' work), peak memory beside
   the plan's modeled peak, the plan's steps and stats, and its
   ``PlanCost`` priced with the committed H100 profile; run in a
   process of its own so that its profiler traces are whole;
7. partitioned training, in the partition phase's process: qwen1.5-0.5b
   at its published widths (bf16 compute, float32 masters, Adafactor)
   trained by ``TrainLoop`` under ``set_mesh`` on ("data" 2, "model" 4),
   the whole step one program through the partitioner (2d_finalized with
   eight layers, ``PARTITION_TRAIN_LAYERS``, cut from 24 for the script's
   time limit: at B8 S512 under remat "none" for three steps, "full" and
   "dots" for two, each held against "none", and "dots" at B4 S2048 for two;
   2d_attempt1 and 2d_attempt2 with two layers for two), against the
   same loop unsharded on the card: losses, the step-0 gradient and
   update, per step one flash forward launch per layer (two under remat)
   and one backward call per layer for all eight devices, no gathering
   fallback, no plan step holding a whole vocabulary dim, the optimized
   plan's modeled peak no higher than the unoptimized plan's, and under
   remat "full" and "dots" the allocator's and the modeled peak below
   "none"'s; first-call seconds (capture, completion, plan compile), plan
   steps and collectives per step, wall, host and device-busy ms per
   step, peak memory beside the plan's modeled peak; then ``compress_grads`` and the
   numeric-fault window (two layers, float32, four steps each) against
   the unsharded steps; then mamba2-130m's train step partitioned (the
   three Table-1 strategies at two layers in float32, B8 S512, step 0's
   loss and each gradient leaf held in norm to the unsharded step; eight
   layers under 2d_finalized in float32 (cut from 24 for the time limit), its loss held
   and its gradient read beside the floor of the unsharded step's own two
   computations, and two steps of ``TrainLoop`` under ``set_mesh`` read
   against the unsharded loop; the same eight-layer step and two loop steps in float64,
   the SSD on its plain route, held within f32_chain of the unsharded
   ones, with planted dropped psums of the SSD gradient that must break
   it; a four-layer gradient in bf16, read only), the SSD and
   its backward one call per layer for all eight devices, no gathering
   fallback, no whole-vocabulary step;
8. partitioned Mamba2 and serving, in a process of their own: mamba2-130m's
   loss (B8 S2048, bf16, no gradient) as one program through the
   partitioner under 2d_finalized against the same loss unsharded (24 SSD
   calls per forward, each one call for all eight devices); and
   ``Engine(slots=8, max_len=1024)`` under ``set_mesh`` (the decode step
   one program, its position an int32 on the card, one plan for the run)
   for qwen1.5-0.5b (eight layers, cut from 24 for the time limit; bf16), mamba2-130m
   (eight layers, bf16 and float32), the two earlier Table-1 attempts
   (qwen, two layers) and qwen (eight layers) with its
   kv cache sharded on the sequence (``shard_kv_seq``: 2d_attempt1 with 8
   slots, 2d_finalized with 1; no plan step holding a whole cache
   sequence), each against the same ``Engine`` unsharded: logits per
   step, the unsharded step rerun on the sharded step's input at a few
   steps, launches per step, no gathering fallback and no plan step
   holding a whole vocabulary dim;
   tokens/s, step wall, host and device-busy ms, the cache's shard and
   unshard ms, syncs per step and peak memory;
8b. observability, in the same process (``obs_phase``): qwen1.5-0.5b's
   partitioned train step at full width (eight layers scanned, remat
   "none", 2d_finalized, B8 S512, bf16) built by ``make_train_step`` under
   ``set_mesh`` (its plan optimized and verified, priced by the committed
   H100 profile), run untraced and under ``TraceConfig(timing="tight")``:
   the traced outputs bit-equal to the untraced ones (within bf16_grad in
   norm per leaf where two untraced calls differ), the traced call's
   path launches equal to the untraced call's and the counters equal to
   them plus the timed repeats', the Chrome trace valid (written to
   ``chiprun_out/``), the calibration table per step class, a profile
   fitted to the spans beside the committed one, and the allocator's peak
   beside ``plan_peak_bytes``;
8b. the autoshard search, in the same process: qwen1.5-0.5b's loss and
   gradient (``value_and_grad``) at its published widths, eight layers
   scanned, B8 S512, bf16, with no mesh set and no annotation, through
   ``spmd_partition(autoshard=AutoshardConfig(...))`` on the simulated
   ("data" 2, "model" 4) mesh with the golden tests' knobs and a budget
   midway between the replicated and the Table-1 modeled peaks: a feasible
   assignment modeled no slower than the Table-1 one, its plan's peak
   within the budget, loss and gradients within bf16_grad in norm of the
   unsharded step, 8 + 8 flash launches over the eight devices, no
   fallback gather or whole-vocabulary step, a second call site lowering
   nothing; the assignment by leaf path, evals and search seconds, both
   assignments' modeled terms and device busy, the allocator's peak
   beside the plan's;
9. the whole-program plan optimizer and the plan verifier, in the same
   process, priced by the committed H100 profile: three paths at full
   width and two layers (qwen1.5-0.5b's partitioned train step, 2d_finalized,
   remat "none", B8 S512, bf16; its sequence-sharded decode step behind
   ``Engine(8 slots, max_len 1024)``, 2d_attempt1; mamba2-130m's
   partitioned train step, float32, B8 S512), each captured and completed
   once and its plan compiled unoptimized and optimized, run in turns
   (unoptimized, optimized, optimized, unoptimized): outputs bit-equal
   where the plan repeats itself, the same kernel launches, the verifier
   passing, no fallback gather and no step holding a whole vocabulary (or
   cache sequence); steps, collective launches, wire bytes and the
   optimizer's passes before and after, its and the verifier's seconds,
   host and device-busy ms and peak memory beside the plan's modeled peak;
   then a guard drill at two layers: ``TrainLoop`` under ``set_mesh`` with
   a plan profile skipping a NaN-poisoned step with the params kept bit
   for bit, ``Engine`` unoptimized and optimized serving the same
   tokens, and the guarded partitioned loss raising ``NumericsFault`` on a
   NaN token embedding.

10. the scan node, in the same process, priced by the committed H100
   profile: each path captured with the layer loop scanned (one scan node
   whose body plan runs once per trip) and unrolled, run in turns
   (scanned, unrolled, unrolled, scanned) with unoptimized plans, and the
   scanned plan once more optimized: qwen1.5-0.5b's partitioned train step
   (2d_finalized, B8 S512, bf16) under remat "none" and "dots" (eight
   layers each; ``SCAN_LAYERS``, cut for the script's time limit) (loss within
   f32_chain, each gradient leaf within bf16_grad in norm, flash launches
   equal, a planted dropped psum in the reverse body beyond the limit),
   mamba2-130m's (eight layers, float32, "dots"; SSD launches equal; in
   float64 on the plain route within 1e-8), qwen's (eight layers) with
   ``grad_accum`` 2 against the
   unsharded ``grad_accum`` 2 step (nested body plans), and ``Engine`` (eight
   layers) for qwen (2d_attempt1, ``shard_kv_seq``, bf16; the float32 twin's planted
   faults inside the body) and Mamba2 (float32): tokens equal, no more
   plan steps holding a whole stacked cache than the unrolled plan; every
   plan verified, the optimized scanned plan equal to the unoptimized one
   where that repeats itself, no fallback gather; plan steps (top level and
   body), first-call seconds, host ms, device busy and peak beside the
   plan's modeled peak;
11. GSPMD §3.3 pipelining, in a process of its own: the gradient of
   ``api.partitionable_pipelined_loss`` (the layer stack stage-stacked,
   one stage body vmapped over four stages, a 7-tick shifting-buffer
   scan, B8 S512 in four microbatches) through the partitioner on a
   simulated ("stage" 4, "model" 2) mesh, 2d_finalized, remat "none", for
   qwen1.5-0.5b in float32 and bf16 and mamba2-130m in float32, both at
   eight layers (``PIPE_CASES``, cut for the script's time limit), against
   the unpipelined partitioned gradient on the same mesh and the unsharded
   one: losses and gradient leaves within their classes, 14 + 14 flash
   (Mamba2: 14 + 14 SSD) calls a call, each one
   launch for every stage and device, one ppermute a tick each way (14 a
   call) moving one stage row, no gathering fallback (scan bodies'
   included), no other collective over "stage" in a tick body than the
   hop and the row sum's psum, every plan verified, and a planted
   wrong-direction ppermute that must fail by 10x;
   first-call seconds, plan steps, host ms, device busy and peak beside the
   plan's modeled peak; with a kernel case at its folded shape in 2 and
   2b;
12. checkpoints, in a process of their own, in a temporary directory under
   ``build/`` (the free space printed first, the directory removed at the
   end): qwen1.5-0.5b at full width trained through ``launch.train.main``
   (B4 S2048, Adafactor, six steps, ``--ckpt-every 3``) uninterrupted,
   crashed at step 4 (``step_00000003`` alone left) and restarted (step 3
   restored at cursor 3, steps 3-5 run): run 2's step 3 restored onto the
   card and saved again with every leaf's crc32 and bytes unchanged, run 3's
   losses within bf16_chain and its final params per leaf in norm within
   bf16_grad of run 1's (whether bit-equal printed: the flash backward's dq
   atomics), flash launches per step as in 4, the verify CLI passing; then
   elastic recovery (13); then qwen (eight layers scanned, full width, B8
   S512; ``CKPT_RESHARD_LAYERS``, 24 before the elastic drill took over the
   (4, 2) restore and its train-on) trained two steps by ``TrainLoop``
   under ``set_mesh`` of ("data" 2, "model" 4) saving each step, its
   manifest's specs the state's partition specs on that mesh, restored by
   ``restore_resharded`` onto ``derive_mesh(4, 4)`` (full and sliced
   reads) and onto ("data" 4, "model" 2) all replicated: bit-equal,
   verified, wire bytes, launches and resharded leaves equal to the pure
   plan's, then one step on (1, 4) against the unsharded step (loss within
   bf16_chain, the update within bf16_grad); a flipped and a truncated
   payload in the largest sharded leaf fall back to step 1 bit-equal, and
   the verify CLI fails; save, restore and verify seconds and GB/s,
   sliced-read I/O counts, ``reshard_s``, peak memory;
13. elastic recovery, in the checkpoint process, in a temporary directory
   under ``build/``: ``ElasticCoordinator`` over a simulated world of 8
   devices (``model_parallel`` 2) drives qwen1.5-0.5b's partitioned train
   step at its published widths (eight layers scanned, remat "none",
   2d_finalized, B8 S512, bf16, Adafactor, 12 steps, a checkpoint every
   two, ``GuardConfig(rewind_after=2)``) through a ``FaultInjector``
   schedule (``ELASTIC_SCHEDULE``): four devices lost at step 3 ((4, 2) ->
   (2, 2)), a two-step NaN burst at 6 (a skip, then a rewind on (2, 2)),
   the newest manifest corrupted and four devices back at 9 ((2, 2) ->
   (4, 2), falling back past the corrupted step).  Gates: the chaos
   harness's invariant battery clean and two planted faults (a loss
   removed, a data cursor off by one) caught; the recovery log as
   ``ELASTIC_LOG``, one restore each, the narrative rebuilt from the
   control events alone; both mesh changes warm-started; no
   ``numerics_fault`` after the rewind; the losses within loss_curve of an
   uninterrupted 12-step run on (4, 2) from the same initial state; on
   every mesh 8 + 8 flash calls a step, each over every simulated device,
   no gathering fallback and no whole-vocabulary plan step.  Printed: each
   recovery's duration, solve (warm, beside the first cold solve), restore
   (seconds, wire bytes, launches, resharded leaves, I/O), the first step
   after the swap and the fault-to-next-finished-step seconds; device busy
   of a step on (4, 2) and (2, 2); the allocator's peak; the phase's
   seconds.

Every path runs with the kernels' launch counts set to 0 just before it and
read just after.  The last two lines of output are the kernels' JSON record
and ``{"ok": true, "device": {...}}``.
"""
import argparse
import collections
import concurrent.futures
import json
import math
import os
import pathlib
import re
import shutil
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


def device_ms(fn, copies, calls=10, by_name=False, warm=True):
    """Device time of one call: the kernels' own durations in a torch.profiler
    trace of ``calls`` calls, without the host's time between launches (None
    when no trace holds every call's device events); with ``by_name``, a
    dict by kernel name of its time and its launches per call.  ``warm``
    calls ``fn`` once before the trace (leave it off where the caller just
    did)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
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

    before = fa.launches
    got = as_model(run_kernel(0)).float()
    torch.cuda.synchronize()
    launched = fa.launches - before
    check(launched == 1, f"{name}: the checked call launched the kernel {launched} times")
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


def decode_position_case(name, *, B, KR, gen, T=1024, D=64):
    """The decode with its position on the device (``ops.flash_decode``: an
    int32 the kernel reads, splits sized by T) against the plain version at
    positions 0 and 1 (fewer keys than splits: empty splits), the one
    before a split boundary and the boundary (the visible keys a multiple
    of 64 per split, and one less), and T - 2; then timed at T - 2 beside
    the plain version, SDPA over the visible keys and the bound, as
    ``kernel_case``.  One launch per call; the host never reads the
    position."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import chunked_attention_ref

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    pl = fa.plan(B, 1, KR, 1, T, D, bf16, bf16, causal=False, q_offset=0, kv_len=1,
                 position_on_device=True)
    boundary = pl.splits * fa.MIN_SPLIT_KEYS - 1  # pos + 1 keys: 64 per split
    positions = (0, 1, boundary - 1, boundary, T - 2)
    last = T - 2
    q_bytes = B * KR * D * 2
    nbytes = 2 * q_bytes + 2 * B * (last + 1) * KR * D * 2 + 4  # q, o, visible k/v, pos
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / (nbytes + 2 * B * T * KR * D * 2))))
    sets = [(torch.randn(B, 1, KR, 1, D, generator=gen, device=dev).to(bf16),
             torch.randn(B, T, KR, D, generator=gen, device=dev).to(bf16),
             torch.randn(B, T, KR, D, generator=gen, device=dev).to(bf16)) for _ in range(copies)]
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    rtol, atol = TOLERANCES["bf16_round"]
    errs = {}
    for p in positions:
        pos.fill_(p)
        q, k, v = sets[0]
        before = fa.launches
        got = ops.flash_decode(q, k, v, pos, T).float()
        torch.cuda.synchronize()
        check(fa.launches == before + 1, f"{name} pos {p}: {fa.launches - before} launches")
        want = chunked_attention_ref(q, k, v, causal=False, chunk=T, q_offset=p,
                                     kv_len=p + 1).float()
        err = (got - want).abs()
        errs[p] = err.max().item()
        check(bool(torch.isfinite(got).all()), f"{name} pos {p}: non-finite output")
        check(bool((err <= atol + rtol * want.abs()).all()),
              f"{name} pos {p}: kernel vs plain max abs err {errs[p]} over bf16_round")
    pos.fill_(last)

    def run_kernel(i):
        return ops.flash_decode(*sets[i], pos, T)

    def run_plain(i):
        q, k, v = sets[i]
        return chunked_attention_ref(q, k, v, causal=False, chunk=T, q_offset=last,
                                     kv_len=last + 1)

    sdpa = [(q.reshape(B, KR, 1, D), k[:, :last + 1].transpose(1, 2).contiguous(),
             v[:, :last + 1].transpose(1, 2).contiguous()) for q, k, v in sets]
    t_ops = 4 * D * (last + 1) * B * KR / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    rec = {
        "case": name, "dtype": "bfloat16", "variant": pl.variant, "splits": pl.splits,
        "shape": dict(B=B, S=1, T=T, KR=KR, Gl=1, D=D), "positions": list(positions),
        "max_abs_err_by_pos": errs, "max_abs_err": max(errs.values()), "tol": "bf16_round",
        "ms": time_ms(run_kernel, copies), "device_ms": device_ms(run_kernel, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(*sdpa[i]), copies),
        "library_device_ms": device_ms(lambda i: F.scaled_dot_product_attention(*sdpa[i]),
                                       copies),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
    }
    print(f"  {name:30s} bfloat16 {pl.variant}/{pl.splits} (position on the device) errs "
          f"{', '.join(f'pos {p}: {e:.3g}' for p, e in errs.items())} (bf16_round); at pos "
          f"{last}: kernel {rec['ms']:.4f} ms (device {_ms(rec['device_ms'])})  plain "
          f"{rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms (device "
          f"{_ms(rec['library_device_ms'])})  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)
    return rec


def decode_row_position_case(name, *, q_dtype, gen, devices=8, slots=8, KR=4, T=512, D=64):
    """The decode at one position per batch row with each row's log-sum-exp
    (``ops.flash_decode_partial``), at the fold of a sequence-sharded serve
    step: ``devices`` x ``slots`` rows, ``KR`` kv heads and ``T`` keys per
    device on ("data" 2, "model" 4), the rows of the devices holding keys T
    to 2T - 1 at the position less T.  Against ``flash_decode_partial_ref``
    at global positions 0, T - 1, T, T + 1 and 2T - 2 (crossing the shard
    boundary; at 0 to T - 1 the second shard's rows see no key): output
    within bf16_round, log-sum-exp within f32_chain, an empty row's output
    0 and log-sum-exp -1e9, one launch per call.  Then timed at 2T - 2
    beside the same launch with one shared position (the unsharded
    decode's call), the plain version, SDPA over T keys and the bound."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import NEG_INF, flash_decode_partial_ref

    dev, bf16 = torch.device("cuda"), torch.bfloat16
    B = devices * slots
    second = ((torch.arange(B, device=dev) // slots) >= devices // 2).int()  # data coord 1
    positions = (0, T - 1, T, T + 1, 2 * T - 2)
    esz = torch.finfo(q_dtype).bits // 8
    nbytes = 2 * B * KR * D * esz + 2 * B * T * KR * D * 2 + 4 * B + 4 * B * KR
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / nbytes)))
    sets = [(torch.randn(B, 1, KR, 1, D, generator=gen, device=dev).to(q_dtype),
             torch.randn(B, T, KR, D, generator=gen, device=dev).to(bf16),
             torch.randn(B, T, KR, D, generator=gen, device=dev).to(bf16)) for _ in range(copies)]
    errs, lse_errs = {}, {}
    o_r, o_a = TOLERANCES["bf16_round"]
    l_r, l_a = TOLERANCES["f32_chain"]
    for p in positions:
        rows = (p - T * second).to(torch.int32)
        q, k, v = sets[0]
        before = fa.launches
        out, lse = ops.flash_decode_partial(q, k, v, rows, T)
        torch.cuda.synchronize()
        check(fa.launches == before + 1, f"{name} pos {p}: {fa.launches - before} launches")
        want, want_lse = flash_decode_partial_ref(q, k, v, rows, T)
        out, want = out.float(), want.float()
        errs[p] = (out - want).abs().max().item()
        lse_errs[p] = (lse - want_lse).abs().max().item()
        empty = rows < 0
        check(bool(torch.isfinite(out).all()) and not bool(torch.isnan(lse).any()),
              f"{name} pos {p}: a NaN or non-finite output")
        check(bool(((out - want).abs() <= o_a + o_r * want.abs()).all()),
              f"{name} pos {p}: output off the plain version by {errs[p]} (bf16_round)")
        check(bool(((lse - want_lse).abs() <= l_a + l_r * want_lse.abs()).all()),
              f"{name} pos {p}: log-sum-exp off the plain version by {lse_errs[p]} (f32_chain)")
        check(bool((out[empty] == 0).all()) and bool((lse[empty] == NEG_INF).all()),
              f"{name} pos {p}: an empty row's output is not 0 or its log-sum-exp not -1e9")
    last = 2 * T - 2
    rows = (last - T * second).to(torch.int32)
    shared = torch.tensor(T - 2, dtype=torch.int32, device=dev)

    def run_kernel(i):
        return ops.flash_decode_partial(*sets[i], rows, T)

    def run_shared(i):
        return ops.flash_decode(*sets[i], shared, T)

    def run_plain(i):
        return flash_decode_partial_ref(*sets[i], rows, T)

    sdpa = [(q.reshape(B, KR, 1, D).to(bf16), k.transpose(1, 2).contiguous(),
             v.transpose(1, 2).contiguous()) for q, k, v in sets]
    keys = int(torch.clamp(rows + 1, max=T).sum())  # visible keys over all rows
    t_ops = 4 * D * keys * KR / (PEAK_F32_FLOPS if q_dtype == torch.float32 else
                                 PEAK_BF16_FLOPS) * 1e3
    t_bytes = (2 * B * KR * D * esz + 2 * keys * KR * D * 2 + 4 * B + 4 * B * KR) / PEAK_BYTES * 1e3
    pl = fa.plan(B, 1, KR, 1, T, D, q_dtype, bf16, causal=False, q_offset=0, kv_len=1,
                 position_on_device=True)
    rec = {
        "case": name, "dtype": str(q_dtype).replace("torch.", ""), "kv_dtype": "bfloat16",
        "variant": pl.variant, "splits": pl.splits,
        "shape": dict(B=B, S=1, T=T, KR=KR, Gl=1, D=D), "positions": list(positions),
        "max_abs_err_by_pos": errs, "lse_max_abs_err_by_pos": lse_errs,
        "max_abs_err": max(errs.values()), "tol": "bf16_round",
        "ms": time_ms(run_kernel, copies), "device_ms": device_ms(run_kernel, copies),
        "shared_position_ms": time_ms(run_shared, copies),
        "shared_position_device_ms": device_ms(run_shared, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": time_ms(lambda i: F.scaled_dot_product_attention(*sdpa[i]), copies),
        "library_device_ms": device_ms(lambda i: F.scaled_dot_product_attention(*sdpa[i]),
                                       copies),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops > t_bytes else "bytes",
    }
    print(f"  {name:30s} {rec['dtype']:8s} {pl.variant}/{pl.splits} (a position per row, with "
          f"lse) errs {', '.join(f'pos {p}: {e:.3g}' for p, e in errs.items())} (bf16_round), "
          f"lse {max(lse_errs.values()):.3g} (f32_chain); at pos {last}: kernel "
          f"{rec['ms']:.4f} ms (device {_ms(rec['device_ms'])})  shared position "
          f"{rec['shared_position_ms']:.4f} ms (device {_ms(rec['shared_position_device_ms'])})"
          f"  plain {rec['plain_ms']:.4f} ms  sdpa {rec['library_ms']:.4f} ms (device "
          f"{_ms(rec['library_device_ms'])})  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)
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
    # the partitioned decoder layer's one launch: q (8 devices x B4/2, S, KR16/4,
    # Gl, D) folded to (16, 2048, 4, 1, 64), in both of that phase's dtypes
    for dtype in (bf16, f32):
        cases.append(kernel_case("partitioned_layer_fold_16x2048_kr4", B=16, S=2048, T=2048,
                                 KR=4, Gl=1, D=64, dtype=dtype, causal=True, chunk=1024,
                                 layout="model", gen=gen))
    # the partitioned train step's forward, folded as its backward (below)
    cases.append(kernel_case("partitioned_train_fold_32x512_kr4", B=32, S=512, T=512, KR=4,
                             Gl=1, D=64, dtype=bf16, causal=True, chunk=512, layout="model",
                             gen=gen))
    # the pipelined step's forward (pipeline_phase): 8 devices x the stage's
    # microbatch 2, S512, KR 16 / 2 on "model", every stage in one launch
    cases.append(kernel_case("pipeline_fold_16x512_kr8", B=16, S=512, T=512, KR=8, Gl=1,
                             D=64, dtype=bf16, causal=True, chunk=512, layout="model",
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
    # the decode with its position on the device: the serve path's call
    # unsharded (B8 KR16) and the partitioned serve step's fold (eight
    # devices' B4 KR4 in one launch)
    cases.append(decode_position_case("decode_devpos_8x16", B=8, KR=16, gen=gen))
    cases.append(decode_position_case("decode_devpos_fold_32x4", B=32, KR=4, gen=gen))
    # a position per row with the log-sum-exp: the sequence-sharded serve
    # step's fold (8 devices x 8 slots, KR 16/4, 1024/2 keys per device)
    for dtype in (bf16, f32):
        cases.append(decode_row_position_case("decode_rowpos_fold_64x4_t512", q_dtype=dtype,
                                              gen=gen))
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
        # the partitioned train step's call, folded: 8 devices x local batch 4
        # (B8 on "data" 2), S512, KR 16 / 4 on "model"; 24 per step
        bwd_case("partitioned_train_fold_32x512_kr4", B=32, S=512, KR=4, Gl=1, D=64,
                 dtype=bf16, causal=True, gen=gen),
        # the pipelined step's call, folded: 8 devices x the stage's microbatch
        # 2, S512, KR 16 / 2 on "model"; 42 per call (6 layers x 7 ticks)
        bwd_case("pipeline_fold_16x512_kr8", B=16, S=512, KR=8, Gl=1, D=64, dtype=bf16,
                 causal=True, gen=gen),
    ]


# ---------------------------------------------------------------------------------
# ssd_scan kernel phase
# ---------------------------------------------------------------------------------


def ssd_case(name, *, B, S, H, hd, ds, chunk, gen, recurrence=False, per_pass=False,
             per_row_a=False):
    """Inputs with tests/test_kernels.py's distributions; the kernel against
    the plain version (or the float64 recurrence), kernel, device and plain
    times, and the bounds; with ``per_pass``, each pass's device time; with
    ``per_row_a``, A (B, H), one per batch row, as a partitioned call folds
    each device's heads into the batch."""
    from repro_torch.analysis.graph_cost import ssd_flops
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels.ref import ssd_recurrence, ssd_scan_ref

    dev = torch.device("cuda")
    Q = min(chunk, S)
    # x and y once, dt once, B and C once (not per head), A
    nbytes = 4 * (2 * B * S * H * hd + B * S * H + 2 * B * S * ds + H * (B if per_row_a else 1))
    copies = max(1, min(8, math.ceil(2 * L2_BYTES / nbytes)))

    def inputs():
        return (torch.randn(B, S, H, hd, generator=gen, device=dev),
                torch.randn(B, S, H, generator=gen, device=dev).abs() * 0.5,
                torch.randn(B, S, ds, generator=gen, device=dev) * 0.2,
                torch.randn(B, S, ds, generator=gen, device=dev) * 0.2,
                -torch.randn(*((B, H) if per_row_a else (H,)), generator=gen, device=dev).abs())

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
    flops = ssd_flops(B, S, H, hd, ds, chunk)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    pl = ssd_kernel.plan(B, S, H, hd, ds, chunk, sms=ssd_kernel.multiprocessors(dev))
    rec = {
        "case": name, "dtype": "float32",
        "shape": dict(B=B, S=S, H=H, hd=hd, ds=ds, Q=Q, A=[B, H] if per_row_a else [H]),
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
        # A per batch row: the unsharded loss shape, and the partitioned
        # Mamba2 loss's one call (eight devices' 4 rows of 6 heads folded)
        ssd_case("loss_8x2048_h24_row_a", B=8, S=2048, H=24, hd=64, ds=128, chunk=128,
                 gen=gen, per_pass=True, per_row_a=True),
        ssd_case("partitioned_loss_fold_32x2048_h6", B=32, S=2048, H=6, hd=64, ds=128,
                 chunk=128, gen=gen, per_pass=True, per_row_a=True),
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
# ssd_scan backward kernel phase
# ---------------------------------------------------------------------------------

SSD_GRADS = ("dx", "ddt", "dB", "dC", "dA")


def ssd_bwd_case(name, *, B, S, H, hd, ds, chunk, gen, per_row_a=False, scale_x=None):
    """The backward kernel (six launches per call) against the plain
    backward run in float64 on the card, with the plain float32 version's
    own distance from float64 beside it; kernel (events), device and
    per-launch device times (profiler), the plain float32 version's time
    and the bound (no PyTorch call computes this gradient).  Each of dx,
    ddt, dB, dC and dA is held in norm within f32_chain's rtol and per
    element within 4x the plain float32 version's largest error: on signed
    inputs the plain float32 version itself lands up to 3x outside
    f32_chain per element (near-zero sums of cancelling terms; measured on
    the CPU at B2 S512 H3), so f32_chain per element would reject float32
    itself.  ``scale_x``: "nonneg" takes x, B, C and dy non-negative and x
    and dy times 10^3: every gradient but ddt is then a sum of terms of one
    sign and is held per element within f32_chain; "signed" takes x times
    10^3."""
    from repro_torch.core.compat import TOLERANCES  # first: the core package loads graph_cost
    from repro_torch.analysis.graph_cost import ssd_bwd_flops
    from repro_torch.kernels import ssd_scan_bwd as ssd_bwd
    from repro_torch.kernels.ref import ssd_scan_bwd_ref

    dev = torch.device("cuda")
    # x, dy and dx; dt and ddt; B, C and their gradients; A and dA
    nbytes = 4 * (3 * B * S * H * hd + 2 * B * S * H + 4 * B * S * ds
                  + 2 * H * (B if per_row_a else 1))
    copies = max(1, min(4, math.ceil(2 * L2_BYTES / nbytes)))

    def inputs():
        x = torch.randn(B, S, H, hd, generator=gen, device=dev)
        dt = torch.randn(B, S, H, generator=gen, device=dev).abs() * 0.5
        Bm = torch.randn(B, S, ds, generator=gen, device=dev) * 0.2
        Cm = torch.randn(B, S, ds, generator=gen, device=dev) * 0.2
        A = -torch.randn(*((B, H) if per_row_a else (H,)), generator=gen, device=dev).abs()
        dy = torch.randn(B, S, H, hd, generator=gen, device=dev)
        if scale_x == "nonneg":
            x, Bm, Cm, dy = x.abs() * 1e3, Bm.abs(), Cm.abs(), dy.abs() * 1e3
        elif scale_x == "signed":
            x = x * 1e3
        return x, dt, Bm, Cm, A, dy

    sets = [inputs() for _ in range(copies)]

    def run_kernel(i):
        return ssd_bwd.ssd_scan_bwd(*sets[i], chunk=chunk)

    def run_plain(i):
        return ssd_scan_bwd_ref(*sets[i], chunk)

    got = run_kernel(0)
    torch.cuda.synchronize()
    exact = ssd_scan_bwd_ref(*(t.double() for t in sets[0]), chunk)
    plain = run_plain(0)
    tol = "f32_chain"
    rtol, atol = TOLERANCES[tol]
    errs = {}
    for n, g, w, pl in zip(SSD_GRADS, got, exact, plain):
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite {n}")
        err = (g.double() - w).abs()
        plain_err = (pl.double() - w).abs().max().item()
        errs[n] = {"max_abs_err": err.max().item(),
                   "err_over_f32_chain": (err / (atol + rtol * w.abs())).max().item(),
                   "rel_err_norm": (err.norm() / w.norm()).item(),
                   "plain_f32_max_abs_err": plain_err,
                   "plain_f32_err_over_f32_chain":
                       ((pl.double() - w).abs() / (atol + rtol * w.abs())).max().item()}
        e = errs[n]
        if scale_x == "nonneg" and n != "ddt":
            check(e["err_over_f32_chain"] <= 1.0,
                  f"{name}: {n} kernel vs float64 plain err/f32_chain {e['err_over_f32_chain']}")
        check(e["rel_err_norm"] <= rtol and e["max_abs_err"] <= 4 * plain_err,
              f"{name}: {n} err {e['max_abs_err']} (plain float32 {plain_err}), in norm "
              f"{e['rel_err_norm']}")
    del exact, plain
    # The card computes float32-accuracy products at 3xTF32 on its tensor
    # cores (as the kernel does), so the bound by operations is 3 flops at
    # the TF32 peak.
    flops = ssd_bwd_flops(B, S, H, hd, ds, chunk)
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = {
        "case": name, "dtype": "float32",
        "shape": dict(B=B, S=S, H=H, hd=hd, ds=ds, Q=min(chunk, S),
                      A=[B, H] if per_row_a else [H], scale_x=scale_x),
        "max_abs_err": max(e["max_abs_err"] for e in errs.values()), "errors": errs, "tol": tol,
        "against": "plain backward in float64",
        "ms": time_ms(run_kernel, copies),
        "dev_ms": device_ms(run_kernel, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": None,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    passes = device_ms(run_kernel, copies, by_name=True)
    rec["pass_dev_ms"] = passes and {_variant(n): v["ms"] for n, v in passes.items()}
    rec["launches_per_call"] = passes and sum(v["launches"] for v in passes.values())
    check(not passes or rec["launches_per_call"] == len(SSD_BWD_LAUNCHES),
          f"{name}: kernels per call in the trace {passes}, want {SSD_BWD_LAUNCHES}")
    print(f"  {name:34s} err/f32_chain kernel (plain f32) " + ", ".join(
        f"{n} {e['err_over_f32_chain']:.3f} ({e['plain_f32_err_over_f32_chain']:.3f})"
        for n, e in errs.items()) + "; max abs err kernel / plain f32 " + ", ".join(
        f"{n} {e['max_abs_err']:.3g}/{e['plain_f32_max_abs_err']:.3g}" for n, e in errs.items()) +
        f"  kernel {rec['ms']:.4f} ms (device {_ms(rec['dev_ms'])})  plain {rec['plain_ms']:.4f} "
        f"ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, 3xTF32; {flops:.4g} flop, "
        f"{nbytes:.4g} bytes)", flush=True)
    print(f"    per launch (device): " + ("not measured" if not passes else "  ".join(
        f"{_variant(n)} {v['ms']:.4f} ms x{v['launches']}" for n, v in passes.items())),
        flush=True)
    return rec


def ssd_bwd_phase(seed):
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    return [
        # the Mamba2 training call, 24 per step
        ssd_bwd_case("train_8x2048_h24", B=8, S=2048, H=24, hd=64, ds=128, chunk=128, gen=gen),
        # the partitioned train step's call: eight devices' 4 rows of 6 heads
        # folded, A per row (B8 S512 on ("data" 2, "model" 4))
        ssd_bwd_case("partitioned_train_fold_32x512_h6", B=32, S=512, H=6, hd=64, ds=128,
                     chunk=128, gen=gen, per_row_a=True),
        ssd_bwd_case("hd32_ds16_2x1024", B=2, S=1024, H=4, hd=32, ds=16, chunk=128, gen=gen),
        ssd_bwd_case("s_equals_q_4x128", B=4, S=128, H=24, hd=64, ds=128, chunk=128, gen=gen),
        ssd_bwd_case("large_x_nonneg_2x512", B=2, S=512, H=3, hd=64, ds=128, chunk=128, gen=gen,
                     scale_x="nonneg"),
        ssd_bwd_case("large_x_signed_2x512", B=2, S=512, H=3, hd=64, ds=128, chunk=128, gen=gen,
                     scale_x="signed"),
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
    from repro_torch.kernels import flash_attention, flash_attention_bwd, ssd_scan, ssd_scan_bwd

    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}


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
    # the layer loop unrolled, as the phases before the scan node measured
    # it (scan_phase sets it either way)
    cfg = cfg.with_(dtype=dtype or cfg.dtype, scan_layers=False)
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

    def step(i):  # as the engine steps: its position an int32 on the card
        eng._pos.fill_(eng.pos + i)
        logits, _ = api.decode_step(cfg, st, params, token, eng.cache, eng._pos)
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


def train_phase(seed, arch="qwen1.5-0.5b", B=4, S=2048):
    """``arch`` at full width trained through ``launch.train.main`` (the
    port's entry point: float32 master weights, bf16 compute, remat "dots",
    Adafactor) for TRAIN_STEPS steps on the arithmetic pattern.  Checks:
    every loss finite; step 0's loss equal to ``api.loss_fn`` of the same
    weights and batch without autograd; per step, the layers' kernel
    launched once per layer forward plus once more in the recompute (remat
    "dots" keeps only the 2-D products) and its backward once per layer
    (qwen: the flash forward and backward, three launches each backward
    call; Mamba2: the SSD scan and its backward, six).  Reads: ms per
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
    fwd, bwd_kernel, bwd_variants = (("ssd_scan", "ssd_scan_bwd", SSD_BWD_LAUNCHES)
                                     if cfg.family == "ssm" else
                                     ("flash_attention", "flash_attention_bwd", BWD_LAUNCHES_BF16))
    want = {name: 0 for name in mods}
    want.update({fwd: 2 * L, bwd_kernel: L})
    for rec in steps:
        check(rec["launches"] == want, f"step {rec['step']} launches {rec['launches']} != {want}")
    wall = statistics.median(r["ms"] for r in steps[1:] if r["step"] != PROFILED_STEP)
    device = [e for e in trace["prof"].events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values()) if device else None
    # the backward kernel's launches in the traced step, by variant
    bwd = {}
    for n, ms in by_name.items():
        if _variant(n) in bwd_variants:
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
    return {"arch": arch, "B": B, "S": S, "losses": losses, "loss0_no_grad": loss0,
            "ms_per_step": wall, "tokens_per_s": B * S / wall * 1e3,
            "device_busy_ms_per_step": busy, "bwd_device_ms_per_step": bwd_ms,
            "bwd_device_ms_by_launch": bwd, "device_ops_per_step": len(device),
            "peak_gib": peak, "steps": steps,
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
        want = {"flash_attention": 4, "flash_attention_bwd": 2, "ssd_scan": 0, "ssd_scan_bwd": 0}
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


def mamba_two_layer_phase(seed, B=2, S=256):
    """mamba2-130m at full width cut to two layers, float32 compute and
    masters: ``value_and_grad`` through the kernels (per layer the SSD
    forward twice, with remat "dots"'s recompute, and its backward kernel
    once) and through the plain path on the same card (``ops._route``
    reading "cpu": the plain forward, which autograd differentiates), each
    held against the plain path in float64 (the same weights widened) on a
    batch of two chunks.  Per leaf, and for the loss: the kernel path's
    error within f32_chain's rtol in norm and its largest element error
    within 4x the plain float32 path's, as ``ssd_bwd_case`` holds the
    kernel itself.  The weights are ``mamba2_published_init``'s, as the
    partitioned float32 cases': from tree_init's, float32 itself lands up
    to 1.3e-4 from float64 in norm (a leaf's gradient; from the published
    init's 3.6e-5: ``tools/mamba2_conditioning.py --layers 2 --against
    float64 --device cpu``, with and without ``--init published``)."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.kernels import ops
    from repro_torch.train.loop import TrainConfig, init_state, value_and_grad
    from repro_torch.train.optimizer import get_optimizer

    cfg = get_config("mamba2-130m").with_(num_layers=2, dtype="float32")
    st = get_strategy("2d_finalized")
    tokens = np.random.default_rng(seed + 5).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]).cuda(),
             "labels": torch.from_numpy(tokens[:, 1:]).cuda()}
    gen = torch.Generator("cuda").manual_seed(seed)
    params = init_state(cfg, st, get_optimizer("sgd"), TrainConfig(), gen, "cuda")["params"]
    mamba2_published_init(params, cfg.num_layers, gen)
    (loss_k, grads_k), launches = counted(lambda: value_and_grad(cfg, st, params, batch))
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 4, "ssd_scan_bwd": 2}
    check(launches == want, f"two-layer Mamba2 step launches {launches} != {want}")
    route = ops._route
    ops._route = lambda t: "cpu"  # the plain versions, on the card's tensors
    try:
        plain = {}
        for dtype, widen in (("float32", torch.Tensor.clone), ("float64", torch.Tensor.double)):
            plain[dtype], plain_launches = counted(lambda: value_and_grad(
                cfg.with_(dtype=dtype), st,
                tree_map(lambda p: widen(p.detach()).requires_grad_(), params), batch))
            check(not any(plain_launches.values()), f"the plain path launched {plain_launches}")
    finally:
        ops._route = route
    (loss_p, grads_p), (loss_x, grads_x) = plain["float32"], plain["float64"]
    rtol = TOLERANCES["f32_chain"][0]
    leaves = {"loss": (loss_k, loss_p, loss_x)}
    leaves.update({"/".join(path): (k, p, x) for (path, k), (_, p), (_, x) in zip(
        leaves_with_paths(grads_k), leaves_with_paths(grads_p), leaves_with_paths(grads_x))})
    errs = {}
    for n, (k, p, x) in leaves.items():
        k, p, x = k.detach().double(), p.detach().double(), x.detach()
        errs[n] = {"rel_err_norm": ((k - x).norm() / x.norm()).item(),
                   "plain_f32_rel_err_norm": ((p - x).norm() / x.norm()).item(),
                   "max_abs_err": (k - x).abs().max().item(),
                   "plain_f32_max_abs_err": (p - x).abs().max().item()}
    worst = max(errs, key=lambda n: errs[n]["rel_err_norm"])
    over = {n: e["max_abs_err"] / (4 * e["plain_f32_max_abs_err"]) if e["plain_f32_max_abs_err"]
            else (math.inf if e["max_abs_err"] else 0.0) for n, e in errs.items()}
    worst_over = max(over, key=over.get)
    print(f"two-layer Mamba2 step float32 B{B} S{S} against the plain path in float64: loss "
          f"kernels {loss_k.item():.6f} plain float32 {loss_p.item():.6f} float64 "
          f"{loss_x.item():.6f}; relative error in norm at most {errs[worst]['rel_err_norm']:.3e} "
          f"({worst}; f32_chain {rtol}); largest element error at most "
          f"{over[worst_over]:.3f} of 4x the plain float32 path's ({worst_over}); launches "
          f"{launches}", flush=True)
    print("  in norm kernels (plain float32): " + ", ".join(
        f"{n} {e['rel_err_norm']:.2e} ({e['plain_f32_rel_err_norm']:.2e})"
        for n, e in errs.items()), flush=True)
    check(errs[worst]["rel_err_norm"] <= rtol,
          f"Mamba2 two layers: {worst} off the float64 plain path by {errs[worst]}")
    check(over[worst_over] <= 1.0, f"Mamba2 two layers: {worst_over}'s largest element error "
          f"beyond 4x the plain float32 path's: {errs[worst_over]}")
    return {"B": B, "S": S, "against": "plain path in float64", "class": "f32_chain",
            "errors": errs, "launches": launches}


def _swiglu(mesh):
    from repro_torch.core import annotate, mesh_split

    def mlp(x, wg, wu, wd):
        x = annotate(x, mesh_split(2, mesh, ["x", -1]))      # tokens on x
        wg = annotate(wg, mesh_split(2, mesh, [-1, "y"]))    # d_ff on y
        wu = annotate(wu, mesh_split(2, mesh, [-1, "y"]))
        return (F.silu(x @ wg) * (x @ wu)) @ wd

    return mlp


def _contracting(mesh):
    from repro_torch.core import annotate, mesh_split

    def f(x, w):
        x = annotate(x, mesh_split(2, mesh, ["x", "y"]))
        w = annotate(w, mesh_split(2, mesh, ["y", -1]))
        return torch.einsum("bd,df->bf", x, w)

    return f


def _expert(mesh):
    from repro_torch.core import annotate, mesh_split

    def f(e1, e2):
        e1 = annotate(e1, mesh_split(3, mesh, ["x", -1, "y"]))
        e2 = annotate(e2, mesh_split(3, mesh, ["x", "y", -1]))
        return torch.einsum("ebm,emh->ebh", e1, e2)

    return f


def _halo2d(mesh):
    from repro_torch.core import annotate, mesh_split

    def f(x, w):
        return F.conv2d(annotate(x, mesh_split(4, mesh, [-1, -1, "x", "y"])), w, padding=1)

    return f


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def host_and_wall_ms(fn, calls=7):
    """Median over ``calls`` of the host's time from a call's entry to its
    return (the device drained before each: what the host spends deciding
    and enqueueing) and of its wall time to the device finishing."""
    host, wall = [], []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(wall)


def card_profile():
    """The ``RooflineParams`` the phases price plans with: the profile fitted
    on an H100 by ``python -m repro_torch.obs profile`` and committed with
    the package (``obs/h100_profile.json``), which the entry points resolve
    by default; returns (params, a record of it)."""
    from repro_torch.analysis.roofline import PROFILE_FILE
    from repro_torch.obs.profile import MachineProfile, resolve_profile

    prof = MachineProfile.load(PROFILE_FILE)
    params = resolve_profile()
    check(params == prof.params, "resolve_profile() is not the committed profile: "
          "is REPRO_TORCH_MACHINE_PROFILE set?")
    rec = {"file": os.path.relpath(PROFILE_FILE, ROOT), "device": prof.device,
           "digest": prof.digest(), **params.as_dict()}
    print(f"  roofline profile: the committed {rec['file']} (fitted on {prof.device}): peak "
          f"{params.peak_flops / 1e12:.2f} TFLOP/s a simulated device, link "
          f"{params.ici_bw / 1e9:.2f} GB/s (the simulated mesh's copies), launch "
          f"{params.collective_launch_s * 1e6:.1f} us, HBM {params.hbm_bw / 1e9:.0f} GB/s, "
          f"overlap {params.overlap_efficiency:g}", flush=True)
    return params, rec


def _watch_fold():
    """Count the flash op's folds that are views and those that copy (the
    partitioner's ``_fold``, wrapped for this phase)."""
    from repro_torch.core import partitioner as pt

    seen = {"view": 0, "copy": 0}
    fold = pt._fold

    def watched(x):
        y = fold(x)
        seen["view" if y.data_ptr() == x.data_ptr() else "copy"] += 1
        return y

    pt._fold = watched
    return seen


def plain_attention(fn):
    """``fn`` with its attention through the plain version: the reference
    for a partitioned program whose attention runs the kernel, so that the
    kernel is not held against itself.  Fails if the kernel launches."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import chunked_attention_ref

    def plain(q, k, v, causal, q_offset, kv_len, chunk):
        return chunked_attention_ref(q, k, v, causal=causal, chunk=chunk, q_offset=q_offset,
                                     kv_len=kv_len)

    def ref(*args):
        kernel, before = ops._flash_forward, fa.launches
        ops._flash_forward = plain
        try:
            out = fn(*args)
        finally:
            ops._flash_forward = kernel
        check(fa.launches == before, "the plain reference launched the flash kernel")
        return out

    return ref


def partition_case(name, fn, args, kind, mesh, counts, params, fold=None, reference=None,
                   allowed_fallbacks=()):
    """``fn`` partitioned on ``mesh`` (every device's shard on this card) by
    compiled plan and by the dynamic path, against ``reference`` (``fn`` by
    default) unsharded on the card: the largest error against its tolerance
    class, collectives by kind, fallbacks (only ``allowed_fallbacks``, and
    none that gathers a sharded dim), device ms of the three runs (profiler;
    a partitioned run is one card doing eight devices' work, so the times
    measure the simulation; the unsharded run is ``fn``), host and wall ms
    per call, peak memory beside the plan's modeled peak × 8, the plan's
    steps and stats, and its ``PlanCost`` priced with ``params``.  With
    ``fold``, the flash kernel must launch exactly once per partitioned
    call."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.plan import plan_cost
    from repro_torch.kernels import flash_attention as fa

    compiled = spmd_partition(fn, mesh, optimize=False, device="cuda", profile=params)
    dynamic = spmd_partition(fn, mesh, compile_plans=False, device="cuda")
    t0 = time.perf_counter()
    got = _first(compiled(*args))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    dyn = _first(dynamic(*args))
    want = _first((reference or fn)(*args))
    unsharded = _first(fn(*args)) if reference is not None else want
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    rtol, atol = TOLERANCES[kind]
    err = (got.float() - want.float()).abs()
    limit = atol + rtol * want.float().abs()
    worst = (err / limit).max().item()
    (entry,) = compiled.plans.values()
    plan = entry.plan
    cost = plan_cost(plan).as_dict()
    rec = {"case": name, "dtype": str(got.dtype).replace("torch.", ""),
           "out_shape": list(got.shape), "max_abs_err": err.max().item(), "tol": kind,
           "err_over_limit": worst, "compiled_equals_dynamic": bool(torch.equal(got, dyn)),
           "reference": "unsharded, plain attention" if reference is not None else "unsharded",
           "max_abs_err_vs_unsharded_fn": (got.float() - unsharded.float()).abs().max().item(),
           "collectives": dict(compiled.collectives), "fallbacks": list(compiled.fallbacks),
           "fallback_gathers": list(compiled.fallback_gathers),
           "dynamic_collectives": dict(dynamic.collectives),
           "plan_steps": len(plan.steps), "plan_stats": plan.stats.as_dict(),
           "modeled_peak_x8_gib": plan.peak_bytes * mesh.size / 2**30,
           "plan_cost": cost, "first_call_ms": first_ms}
    del got, dyn, want, unsharded, err, limit
    if fold is not None:
        for label, runner in (("compiled", compiled), ("dynamic", dynamic)):
            fa.launches = 0
            fold.update(view=0, copy=0)
            runner(*args)
            torch.cuda.synchronize()
            rec[f"{label}_flash_launches_per_call"] = fa.launches
            rec[f"{label}_fold"] = dict(fold)
            check(fa.launches == 1, f"{name}: {label} call launched flash {fa.launches} times")
    runs = (("compiled", lambda i: compiled(*args)), ("dynamic", lambda i: dynamic(*args)),
            ("unsharded", lambda i: fn(*args)))
    for label, call in runs:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call(0)
        torch.cuda.synchronize()
        rec[f"{label}_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        rec[f"{label}_device_ms"] = device_ms(call, 1, calls=5)
        rec[f"{label}_host_ms"], rec[f"{label}_wall_ms"] = host_and_wall_ms(lambda: call(0))
    by_name = device_ms(lambda i: compiled(*args), 1, calls=5, by_name=True) or {}
    rec["compiled_top"] = [{"name": n[:100], "ms": v["ms"], "launches": v["launches"]}
                           for n, v in sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:5]]
    coll = ", ".join(f"{k} x{v}" for k, v in sorted(rec["collectives"].items())) or "none"
    print(f"  {name} ({rec['dtype']}): collectives {coll}; fallbacks {rec['fallbacks'] or 'none'} "
          f"(gathering a sharded dim: {rec['fallback_gathers'] or 'none'})", flush=True)
    print(f"    against the {rec['reference']} program: max abs err {rec['max_abs_err']:.3e}, "
          f"worst err/limit {worst:.3f} ({kind}: rtol {rtol}, atol {atol}); against the "
          f"unsharded program as run: max abs err {rec['max_abs_err_vs_unsharded_fn']:.3e}; "
          f"compiled == dynamic bit for bit: {rec['compiled_equals_dynamic']}", flush=True)
    print(f"    device ms compiled {_ms(rec['compiled_device_ms'])} dynamic "
          f"{_ms(rec['dynamic_device_ms'])} unsharded {_ms(rec['unsharded_device_ms'])}; host ms "
          f"per call compiled {rec['compiled_host_ms']:.3f} dynamic {rec['dynamic_host_ms']:.3f} "
          f"unsharded {rec['unsharded_host_ms']:.3f}; wall ms compiled "
          f"{rec['compiled_wall_ms']:.3f} dynamic {rec['dynamic_wall_ms']:.3f} unsharded "
          f"{rec['unsharded_wall_ms']:.3f}; first compiled call (capture, completion, plan) "
          f"{first_ms:.1f} ms", flush=True)
    print(f"    plan: {rec['plan_steps']} steps, stats {json.dumps(rec['plan_stats'])}", flush=True)
    print(f"    peak above inputs GiB: compiled {rec['compiled_peak_gib']:.3f} (modeled plan peak "
          f"x{mesh.size} {rec['modeled_peak_x8_gib']:.3f}) dynamic {rec['dynamic_peak_gib']:.3f} "
          f"unsharded {rec['unsharded_peak_gib']:.3f}", flush=True)
    print(f"    PlanCost (the committed profile): {json.dumps(cost)}", flush=True)
    if fold is not None:
        print(f"    flash launches per call: compiled {rec['compiled_flash_launches_per_call']}, "
              f"dynamic {rec['dynamic_flash_launches_per_call']}; device-dim fold of q, k, v "
              f"{rec['compiled_fold']}", flush=True)
    for t in rec["compiled_top"]:
        print(f"      compiled, by kernel: {t['ms']:.4f} ms x{t['launches']} {t['name'][:70]}",
              flush=True)
    check(not rec["fallback_gathers"],
          f"{name}: fallbacks gathered a sharded dim: {rec['fallback_gathers']}")
    check(set(rec["fallbacks"]) <= set(allowed_fallbacks),
          f"{name}: ops took the fallback: {rec['fallbacks']} (allowed: {allowed_fallbacks})")
    check(worst <= 1.0, f"{name}: partitioned != unsharded beyond {kind} (err/limit {worst})")
    counts.update(rec["collectives"])
    return rec


# rope's halves: slice and cat along the head dim, which no spec shards, so
# the fallback keeps every sharded dim
ROPE_FALLBACKS = ("aten.slice", "aten.cat")


def partition_phase_in_own_process(seed):
    """Run ``partition_phase`` in a fresh process: late in a long run,
    after the earlier phases' many profiler sessions, its traces came back
    without some kernels' device events (a whole kernel missing passes
    ``device_ms``'s check), while the same phase in its own process traced
    every call.  The kernels' launch counts are read there too: the flash
    kernel launches (once per partitioned decoder-layer call, which
    ``partition_case`` checks), and no other kernel does."""
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); import torch, chip_smoke; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            f"out, n = chip_smoke.counted(lambda: chip_smoke.partition_phase({seed})); "
            f"train, m = chip_smoke.counted(lambda: chip_smoke.partition_train_phase({seed}, "
            "out['card'])); "
            f"options, k = chip_smoke.counted(lambda: chip_smoke.partition_option_phase({seed}, "
            "out['card'])); "
            f"mamba, j = chip_smoke.counted(lambda: chip_smoke.partition_mamba_train_phase("
            f"{seed}, out['card'])); "
            "print(json.dumps({'phase': out, 'launches': n, 'train': train, "
            "'train_launches': m, 'options': options, 'option_launches': k, "
            "'mamba_train': mamba, 'mamba_train_launches': j}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=1000)
    lines = proc.stdout.splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines), flush=True)
    check(proc.returncode == 0 and lines,
          f"partition phase failed ({proc.returncode}): {proc.stderr[-3000:]}")
    res = json.loads(lines[-1])
    launched = res["launches"]
    check(launched["flash_attention"] > 0 and not any(
        n for k, n in launched.items() if k != "flash_attention"),
        f"the partition phase's launches: {launched}")
    check(res["train_launches"]["flash_attention_bwd"] > 0
          and res["train_launches"]["ssd_scan"] == 0,
          f"the partitioned-training phase's launches: {res['train_launches']}")
    check(res["option_launches"]["flash_attention_bwd"] > 0
          and res["option_launches"]["ssd_scan"] == 0,
          f"the partitioned options' launches: {res['option_launches']}")
    check(res["mamba_train_launches"]["ssd_scan_bwd"] > 0
          and res["mamba_train_launches"]["flash_attention"] == 0,
          f"the partitioned Mamba2 training's launches: {res['mamba_train_launches']}")
    res["phase"]["launches"] = launched
    for key in ("train", "train_launches", "options", "option_launches", "mamba_train",
                "mamba_train_launches"):
        res["phase"][key] = res[key]
    return res["phase"]


def partition_phase(seed):
    """The port's partitioner by compiled plan (capture, sharding completion
    and plan compilation once; then the plan's steps: local compute,
    reshards, collectives) and by the dynamic path, on a simulated (2,4)
    mesh, at qwen1.5-0.5b's widths: the SwiGLU MLP (8,192 tokens, d_model,
    d_ff) in float32 and bf16, a contracting-dim product, expert-dim
    recursive grouping, a 2-D spatial halo convolution (cuDNN TF32 off), and
    the full-width decoder layer (B4 S2048, x, positions and weights
    annotated by 2d_finalized on ("data" 2, "model" 4)) in bf16 and float32,
    its attention through the flash kernel."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import transformer
    from repro_torch.models.layers import tree_init

    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 must be off: float32 cases compare float32 products")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"  every number of this phase on {card}; float32 products and convolutions run "
          "without TF32 (cuBLAS and cuDNN)", flush=True)
    mesh = Mesh.create((2, 4), ("x", "y"))
    params, profile = card_profile()
    cfg = get_config("qwen1.5-0.5b")
    T, D, Fd = 8192, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device="cuda").manual_seed(seed + 30)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)

    cases, counts = [], collections.Counter()
    for dtype, kind in ((torch.float32, "f32_chain"), (torch.bfloat16, "bf16_chain")):
        args = (randn(T, D, dtype=dtype), randn(D, Fd, scale=D ** -0.5, dtype=dtype),
                randn(D, Fd, scale=D ** -0.5, dtype=dtype),
                randn(Fd, D, scale=Fd ** -0.5, dtype=dtype))
        cases.append(partition_case(f"qwen_swiglu_mlp_{T}x{D}x{Fd}", _swiglu(mesh), args, kind,
                                    mesh, counts, params))
        del args
    args = (randn(T, D), randn(D, Fd, scale=D ** -0.5))
    cases.append(partition_case(f"contracting_{T}x{D}x{Fd}", _contracting(mesh), args,
                                "f32_chain", mesh, counts, params))
    E = 8
    args = (randn(E, T // E, D), randn(E, D, Fd, scale=D ** -0.5))
    cases.append(partition_case(f"expert_grouping_{E}x{T // E}x{D}x{Fd}", _expert(mesh), args,
                                "f32_chain", mesh, counts, params))
    args = (randn(8, 64, 256, 256), randn(64, 64, 3, 3, scale=(64 * 9) ** -0.5))
    cases.append(partition_case("halo_conv2d_8x64x256x256_k3", _halo2d(mesh), args, "f32_chain",
                                mesh, counts, params))
    del args
    # the full-width decoder layer on ("data", "model")
    st, lmesh, fold = get_strategy("2d_finalized"), make_test_mesh(), _watch_fold()
    B, S = 4, 2048
    for dtype, kind in (("bfloat16", "bf16_chain"), ("float32", "f32_chain")):
        lcfg = cfg.with_(dtype=dtype)
        lp = tree_init(transformer.layer_param_tree(lcfg, st), gen, dtype=dtype, device="cuda")
        x = randn(B, S, D, dtype=getattr(torch, dtype))
        positions = torch.arange(S, device="cuda").expand(B, S)
        fn = transformer.partitionable_layer(lcfg, st, lmesh)
        cases.append(partition_case(f"qwen_decoder_layer_B{B}_S{S}", fn, (lp, x, positions),
                                    kind, lmesh, counts, params, fold=fold,
                                    reference=plain_attention(fn),
                                    allowed_fallbacks=ROPE_FALLBACKS))
        del lp, x
    torch.cuda.empty_cache()
    return {"card": card, "mesh": {"shape": list(mesh.shape), "axes": list(mesh.axis_names)},
            "layer_mesh": {"shape": list(lmesh.shape), "axes": list(lmesh.axis_names)},
            "roofline_profile": profile, "collectives": dict(counts), "cases": cases}


# ---------------------------------------------------------------------------------
# partitioned training: the train step as one program through the partitioner
# ---------------------------------------------------------------------------------

# (strategy, layers, steps, whether step 0's gradient is held per element
# within coarse): the finalized strategy deeper, the two earlier
# attempts of Table 1 cut to two layers to keep the phase short.  At 24
# layers one element of the value bias's gradient read 1.026 x coarse on
# the card (the other leaves at most 0.728), so there each leaf is held in
# norm only; at two layers the largest reading was 0.525
# (strategy, layers, steps, coarse_grads, remat, B, S): remat "none", "full"
# and "dots" at B8 S512 (each remat held against "none"), then "dots" at the
# unsharded launch's B4 S2048, the registered config's default, all cut to
# eight layers for the script's time limit (the B8 S512 cases ran 24 until
# the elastic phase needed their time)
PARTITION_TRAIN_LAYERS = 8
PARTITION_TRAIN = (("2d_finalized", PARTITION_TRAIN_LAYERS, 3, False, "none", 8, 512),
                   ("2d_finalized", PARTITION_TRAIN_LAYERS, 2, False, "full", 8, 512),
                   ("2d_finalized", PARTITION_TRAIN_LAYERS, 2, False, "dots", 8, 512),
                   ("2d_finalized", 8, 2, False, "dots", 4, 2048),
                   ("2d_attempt1", 2, 2, True, "none", 8, 512),
                   ("2d_attempt2", 2, 2, True, "none", 8, 512))
# softmax ignores a shift shared by all keys, so the key bias's exact
# gradient is 0: both runs' gradients of it are rounding noise, printed
# beside the others and not held to a limit
KEY_BIAS = "layers/attn/bk"


def _rel(got, want):
    got, want = got.detach().double(), want.detach().double()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def _err_over(got, want, kind):
    from repro_torch.core.compat import TOLERANCES

    rtol, atol = TOLERANCES[kind]
    got, want = got.detach().float(), want.detach().float()
    return ((got - want).abs() / (atol + rtol * want.abs())).max().item()


def whole_vocab_steps(runner, args, V):
    """The plan steps whose result holds a whole vocabulary dim (size ``V``)
    on a device: a gathered (B,S,V) logits tensor or (V, M) table would."""
    return _plan_of(runner).plan.steps_holding(args, lambda t: V in tuple(t.shape[1:]))


def cache_gather_steps(runner, args, T, dh):
    """The plan steps whose result holds a whole cache sequence (``T`` keys
    of ``dh`` values) on a device: a gathered k or v cache, per layer or
    stacked, would."""
    return _plan_of(runner).plan.steps_holding(
        args, lambda t: t.ndim >= 5 and t.shape[-3] == T and t.shape[-1] == dh)


def partition_train_run(label, cfg, st, opt, state, pipe, steps, mesh, batch, readings=True,
                        optimize=True):
    """``TrainLoop.run`` for ``steps`` steps under ``mesh`` (None: unsharded;
    ``optimize`` is ``TrainLoop``'s) with the kernels' launches per step,
    wall ms per step (the host clock around the step, to its loss on the
    host), the params after step 0 and the peak memory; then, with
    ``readings``, host and wall ms per step (device drained before each)
    and device-busy ms per step (profiler); and, partitioned, the plan's
    readings."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.tree import tree_map
    from repro_torch.train.loop import TrainConfig, TrainLoop

    mods, recs, clock, snap = _kernel_modules(), [], {}, {}

    def fault(step):
        for mod in mods.values():
            mod.launches = 0
        clock["t0"] = time.perf_counter()

    def metrics(step, loss):
        ms = (time.perf_counter() - clock["t0"]) * 1e3
        recs.append({"step": step, "loss": loss, "ms": ms,
                     "launches": {n: mod.launches for n, mod in mods.items()}})
        if step == 0:
            snap["params"] = tree_map(lambda p: p.detach().clone(), state["params"])

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with set_mesh(mesh):
        loop = TrainLoop(cfg, st, opt, TrainConfig(steps=steps, log_every=10**9), pipe,
                         device="cuda", hooks={"fault": fault, "metrics": metrics},
                         **({} if mesh is None else {"optimize": optimize}))
        _, losses = loop.run(initial_state=state)
    torch.cuda.synchronize()
    out = {"label": label, "losses": losses, "steps": recs,
           "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
           "params_after_step0": snap["params"],
           "wall_ms_per_step": statistics.median(r["ms"] for r in recs[1:])}
    call = lambda: loop.step_fn(state, batch)  # noqa: E731 - more steps, after the comparison
    if readings:
        out["host_ms_per_step"], out["drained_wall_ms_per_step"] = host_and_wall_ms(call,
                                                                                    calls=3)
        # one traced step: traced over two, no reading came back (device_ms
        # wants each kernel's count to split evenly over the calls)
        out["device_busy_ms_per_step"] = device_ms(lambda i: call(), 1, calls=1)
    runner = getattr(loop.step_fn, "runner", None)
    if runner is not None:
        (entry,) = runner.plans.values()
        out.update(runner=runner, first_call_s=dict(entry.build_s),
                   plan_steps=len(entry.plan.steps), plan_stats=entry.plan.stats.as_dict(),
                   modeled_peak_x8_gib=entry.plan.peak_bytes * mesh.size / 2**30,
                   collectives_per_step=dict(runner.collectives),
                   fallbacks=dict(collections.Counter(runner.fallbacks)),
                   fallback_gathers=list(runner.fallback_gathers))
    return out


def partition_train_case(strategy, layers, steps, coarse_grads, remat, B, S, seed, card,
                         baselines):
    """qwen1.5-0.5b at its published widths (``layers`` deep; bf16 compute,
    float32 masters, Adafactor, ``remat``, batch B x S) trained by
    ``TrainLoop`` under
    ``set_mesh`` on ("data" 2, "model" 4) (the partitioned step) and without
    a mesh, from the same weights on the same batches with the same kernels.
    Gates: step 0's loss within bf16_chain and the losses within loss_curve
    of the unsharded run; step 0's gradient per leaf (the key bias aside:
    ``KEY_BIAS``) in norm within bf16_grad and, where ``coarse_grads``, per
    element within coarse; the params after step 0 per leaf within coarse
    of the unsharded optimizer's step on the partitioned gradient; against
    the unsharded run, step 0's update over the leaves of two or more dims
    (Adafactor's factored update is continuous in the gradient) in norm
    within bf16_grad, and on 1-D leaves, where the first update is sign(g),
    which a gradient within rounding of 0 flips, 95 % of the signs
    agreeing.  Per step one flash forward launch and one backward call per
    layer (all eight devices in one), no fallback that gathers (rope's slice
    and cat keep their sharding), no plan step holding a whole
    vocabulary dim, and the optimized plan's modeled peak no higher than
    the same program's plan compiled unoptimized.  Under remat "full" and "dots" the forward launches twice
    per layer (the recompute).  ``baselines`` keeps the partitioned gradient
    program's loss and gradient under remat "none" by (strategy, depth,
    batch); a case under another remat with a baseline holds its loss and
    each leaf's gradient (the key bias aside) against it in norm within
    bf16_grad: the flash backward adds dq by atomics, so the card need not
    be bit for bit."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import (TrainConfig, init_state, sharded_value_and_grad,
                                        value_and_grad)
    from repro_torch.train.optimizer import get_optimizer

    cfg = partition_train_config(layers, remat)
    st, opt, mesh = get_strategy(strategy), get_optimizer("adafactor"), make_test_mesh()
    L, V = cfg.num_layers, cfg.vocab_size
    fwd = L if remat == "none" else 2 * L  # forward launches per step: the recompute
    pipe = TokenPipeline(DataConfig(V, S, B, seed=seed, pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    with set_mesh(mesh):
        state0 = init_state(cfg, st, opt, TrainConfig(),
                            torch.Generator("cuda").manual_seed(seed), "cuda")

    def fresh():
        params = tree_map(lambda p: p.detach().clone().requires_grad_(), state0["params"])
        return {"params": params, "opt": opt.init(params), "step": 0}

    # step 0's gradients: the step's own program partitioned, and autograd unsharded
    with set_mesh(mesh):
        grad_runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh,
                                     optimize=False, device="cuda")
        (loss_s, grads_s), launched = counted(lambda: grad_runner(
            tree_map(torch.Tensor.detach, state0["params"]), batch))
    (entry,) = grad_runner.plans.values()
    grad_first = dict(entry.build_s)
    check(launched["flash_attention"] == fwd and launched["flash_attention_bwd"] == L,
          f"{strategy}: the partitioned gradient launched {launched}, want {fwd} and {L}")
    loss_u, grads_u = value_and_grad(cfg, st, fresh()["params"], batch)
    grad = {"/".join(p): {"rel": _rel(g, u), "over_coarse": _err_over(g, u, "coarse"),
                          "norm": g.norm().item(), "norm_unsharded": u.norm().item()}
            for (p, g), u in zip(leaves_with_paths(grads_s), leaves(grads_u))}
    vs_none, key = None, (strategy, L, B, S)
    if remat == "none":
        baselines[key] = (loss_s, grads_s)
    elif key in baselines:
        loss_n, grads_n = baselines[key]
        vs_none = {"loss_rel": abs(loss_s.item() - loss_n.item()) / abs(loss_n.item()),
                   "grad_rel": {"/".join(p): _rel(g, n) for (p, g), n in
                                zip(leaves_with_paths(grads_s), leaves(grads_n))}}
    # the unsharded optimizer's step 0 on the partitioned gradient: what the
    # partitioned step's own update must give
    with torch.no_grad():
        p0 = tree_map(torch.Tensor.detach, state0["params"])
        own_update, _ = opt.apply(grads_s, opt.init(p0), p0, torch.tensor(0))
    del grads_s, grads_u, grad_runner, entry, p0

    sharded = partition_train_run("sharded", cfg, st, opt, fresh(), pipe, steps, mesh, batch)
    runner = sharded.pop("runner")
    # the same program's plan unoptimized: the optimized plan may model no
    # higher a peak (plan_opt.py::_within_peak under the committed profile)
    entry = _plan_of(runner)
    raw = compile_plan(entry.captured, entry.prop, mesh, optimize=False, cost_only=True,
                       verify=False)
    sharded["unoptimized_modeled_peak_x8_gib"] = raw.peak_bytes * mesh.size / 2**30
    del entry, raw
    state = fresh()
    holders = whole_vocab_steps(runner, (tree_map(torch.Tensor.detach, state["params"]),
                                         state["opt"], torch.tensor(0, device="cuda"), batch), V)
    del runner, state
    unsharded = partition_train_run("unsharded", cfg, st, opt, fresh(), pipe, steps, None,
                                    batch)

    upd, upd_s, upd_u, sign_agree = {}, [], [], 1.0
    for (path, p), q, r, p0 in zip(leaves_with_paths(sharded.pop("params_after_step0")),
                                   leaves(unsharded.pop("params_after_step0")),
                                   leaves(own_update), leaves(state0["params"])):
        p0 = p0.detach()
        upd["/".join(path)] = {
            "own_over_coarse": _err_over(p, r, "coarse"),
            "over_coarse": _err_over(p, q, "coarse"), "rel": _rel(p - p0, q - p0),
            "signs": ((p - p0).sign() == (q - p0).sign()).float().mean().item()}
        if p.ndim >= 2:
            upd_s.append((p - p0).flatten())
            upd_u.append((q - p0).flatten())
        else:
            sign_agree = min(sign_agree, upd["/".join(path)]["signs"])
    update_rel_all = _rel(torch.cat(upd_s), torch.cat(upd_u))
    del own_update, upd_s, upd_u
    gated = [n for n in grad if n != KEY_BIAS]
    grad_max = max(gated, key=lambda n: grad[n]["rel"])
    coarse_max = max(gated, key=lambda n: grad[n]["over_coarse"])
    own_max = max(upd, key=lambda n: upd[n]["own_over_coarse"])
    upd_max = max(gated, key=lambda n: upd[n]["rel"])
    params_max = max(gated, key=lambda n: upd[n]["over_coarse"])
    limit = TOLERANCES["bf16_grad"][0]
    rec = {"strategy": strategy, "remat": remat, "layers": L, "steps": steps, "B": B, "S": S,
           "card": card, "label": f"{strategy} {L}L remat {remat} B{B} S{S}",
           "vs_remat_none": vs_none,
           "losses_sharded": sharded["losses"], "losses_unsharded": unsharded["losses"],
           "step0_loss_err_over_bf16_chain": _err_over(torch.tensor(sharded["losses"][0]),
                                                       torch.tensor(unsharded["losses"][0]),
                                                       "bf16_chain"),
           "loss_curve_err_over_limit": _err_over(torch.tensor(sharded["losses"]),
                                                  torch.tensor(unsharded["losses"]),
                                                  "loss_curve"),
           "grad_loss_sharded": loss_s.item(), "grad_loss_unsharded": loss_u.item(),
           "grad_by_leaf": grad, "grad_rel_err_max": [grad_max, grad[grad_max]["rel"]],
           "grad_err_over_coarse_max": [coarse_max, grad[coarse_max]["over_coarse"]],
           "update_by_leaf": upd,
           "params_step0_own_update_err_over_coarse_max": [
               own_max, upd[own_max]["own_over_coarse"]],
           "update_rel_err": update_rel_all, "params_1d_sign_agreement": sign_agree,
           "update_rel_err_max": [upd_max, upd[upd_max]["rel"]],
           "params_step0_err_over_coarse_max": [params_max, upd[params_max]["over_coarse"]],
           "whole_vocab_steps": holders, "grad_program_first_call_s": grad_first,
           **{f"sharded_{k}": v for k, v in sharded.items() if k not in ("losses", "label")},
           **{f"unsharded_{k}": v for k, v in unsharded.items()
              if k not in ("losses", "label")}}
    want = {"flash_attention": fwd, "flash_attention_bwd": L, "ssd_scan": 0, "ssd_scan_bwd": 0}
    print(f"  {strategy}: {L} layers, remat {remat}, B{B} S{S}, {steps} steps on ("
          f"{', '.join(f'{a} {n}' for a, n in zip(mesh.axis_names, mesh.shape))}); {card}",
          flush=True)
    print(f"    losses sharded {sharded['losses']} unsharded {unsharded['losses']}: step 0 "
          f"err/limit {rec['step0_loss_err_over_bf16_chain']:.3f} (bf16_chain), curve "
          f"{rec['loss_curve_err_over_limit']:.3f} (loss_curve)", flush=True)
    print(f"    step-0 gradient per leaf, relative error in norm (bf16_grad {limit}) and "
          "elementwise err/coarse:", flush=True)
    for n, r in grad.items():
        print(f"      {n}: {r['rel']:.3e}, {r['over_coarse']:.3f}; norm {r['norm']:.4e} "
              f"(unsharded {r['norm_unsharded']:.4e})" + ("; not gated" if n == KEY_BIAS else ""),
              flush=True)
    print("    step 0's params per leaf: err/coarse against the unsharded optimizer on the "
          "partitioned gradient; against the unsharded run, err/coarse, the update's relative "
          "error in norm and the share of its signs agreeing:", flush=True)
    for n, r in upd.items():
        print(f"      {n}: {r['own_over_coarse']:.2e}; {r['over_coarse']:.3f}, {r['rel']:.3e}, "
              f"{r['signs']:.4f}", flush=True)
    print(f"    step-0 update against the unsharded run over the leaves of 2-D and up: "
          f"{update_rel_all:.3e} in norm; 1-D update signs agreeing {sign_agree:.4f}", flush=True)
    print(f"    launches per step sharded {[r['launches'] for r in sharded['steps']]}; "
          f"unsharded {[r['launches'] for r in unsharded['steps']]}", flush=True)
    print(f"    first call (gradient program): {json.dumps(grad_first)}; first step: "
          f"{json.dumps(sharded['first_call_s'])}; plan {sharded['plan_steps']} steps; "
          f"collectives per step {json.dumps(sharded['collectives_per_step'])}; fallbacks "
          f"{json.dumps(sharded['fallbacks'])}", flush=True)
    for tag, r in (("sharded", sharded), ("unsharded", unsharded)):
        print(f"    {tag}: wall {r['wall_ms_per_step']:.1f} ms/step (steps 1-{steps - 1}); host "
              f"{r['host_ms_per_step']:.1f} ms, drained wall {r['drained_wall_ms_per_step']:.1f} "
              f"ms, device busy {_ms(r['device_busy_ms_per_step'])} per step; peak "
              f"{r['peak_gib']:.3f} GiB"
              + (f" (plan's modeled peak x8 {r['modeled_peak_x8_gib']:.3f}, unoptimized "
                 f"{r['unoptimized_modeled_peak_x8_gib']:.3f})"
                 if "modeled_peak_x8_gib" in r else ""), flush=True)
    for r in sharded["steps"] + unsharded["steps"]:
        check(r["launches"] == want,
              f"{strategy}: step {r['step']} launched {r['launches']}, want {want}")
    check(not sharded["fallback_gathers"],
          f"{strategy}: fallbacks gathered a sharded dim: {sharded['fallback_gathers']}")
    check(set(sharded["fallbacks"]) <= set(ROPE_FALLBACKS),
          f"{strategy}: ops took the fallback: {sharded['fallbacks']}")
    check(not holders, f"{strategy}: plan steps held a whole vocabulary dim: {holders}")
    check(sharded["modeled_peak_x8_gib"] <= sharded["unoptimized_modeled_peak_x8_gib"],
          f"{strategy} remat {remat}: the optimized plan models a higher peak than the "
          f"unoptimized one ({sharded['modeled_peak_x8_gib']} > "
          f"{sharded['unoptimized_modeled_peak_x8_gib']} GiB)")
    check(all(math.isfinite(x) for x in sharded["losses"]), f"{strategy}: non-finite loss")
    check(rec["step0_loss_err_over_bf16_chain"] <= 1.0, f"{strategy}: step-0 loss off")
    check(rec["loss_curve_err_over_limit"] <= 1.0, f"{strategy}: loss curve off")
    off = {n: grad[n]["rel"] for n in gated if grad[n]["rel"] > limit}
    check(not off, f"{strategy}: step 0's gradient off in norm: {off}")
    off = {n: grad[n]["over_coarse"] for n in gated if grad[n]["over_coarse"] > 1.0}
    check(not (coarse_grads and off),
          f"{strategy}: step 0's gradient off per element (err/coarse): {off}")
    off = {n: r["own_over_coarse"] for n, r in upd.items() if r["own_over_coarse"] > 1.0}
    check(not off, f"{strategy}: step 0's params off the unsharded optimizer's on the same "
          f"gradient (err/coarse): {off}")
    check(update_rel_all <= limit and sign_agree >= 0.95,
          f"{strategy}: step 0's update off ({update_rel_all} in norm, 1-D signs {sign_agree})")
    if vs_none is not None:
        worst = max((n for n in vs_none["grad_rel"] if n != KEY_BIAS),
                    key=lambda n: vs_none["grad_rel"][n])
        print(f"    against the partitioned gradient under remat none: loss {vs_none['loss_rel']:.3e}"
              f", gradient per leaf in norm at most {vs_none['grad_rel'][worst]:.3e} ({worst}; "
              f"bf16_grad {limit}; key bias {vs_none['grad_rel'].get(KEY_BIAS, 0.0):.3e}, not "
              "gated)", flush=True)
        check(vs_none["loss_rel"] <= limit and vs_none["grad_rel"][worst] <= limit,
              f"{strategy} remat {remat}: off the remat-none gradient: {vs_none}")
    return rec


def partition_train_config(layers, remat="none"):
    """qwen1.5-0.5b at its published widths, ``layers`` deep, with ``remat``
    and the layer loop unrolled."""
    from repro_torch.configs.registry import get_config

    cfg = get_config("qwen1.5-0.5b")
    check((cfg.d_model, cfg.num_heads, cfg.dh, cfg.d_ff, cfg.vocab_size, cfg.dtype,
           cfg.param_dtype) == (1024, 16, 64, 2816, 151936, "bfloat16", "float32"),
          f"unexpected config {cfg}")
    return cfg.with_(num_layers=layers, remat=remat, scan_layers=False)


def partition_train_phase(seed, card):
    """The partitioned training step for each strategy of ``PARTITION_TRAIN``
    (``partition_train_case``)."""
    print("partition: qwen1.5-0.5b trained by TrainLoop under set_mesh (the train step as one "
          "program through spmd_partition, its plan optimized by the committed profile) "
          "against the same loop "
          "unsharded on the card", flush=True)
    cases, baselines = [], {}
    for case in PARTITION_TRAIN:
        cases.append(partition_train_case(*case, seed, card, baselines))
        torch.cuda.empty_cache()
    del baselines
    torch.cuda.empty_cache()
    # remat trades compute for memory: under "full" and "dots" the
    # partitioned step's allocator peak and modeled peak fall below "none"'s
    none = {(c["strategy"], c["layers"], c["B"], c["S"]): c for c in cases
            if c["remat"] == "none"}
    for c in cases:
        n = none.get((c["strategy"], c["layers"], c["B"], c["S"]))
        if c["remat"] == "none" or n is None:
            continue
        print(f"  remat {c['remat']} against none ({c['label']}): allocator peak "
              f"{c['sharded_peak_gib']:.3f} against {n['sharded_peak_gib']:.3f} GiB, modeled "
              f"x8 {c['sharded_modeled_peak_x8_gib']:.3f} against "
              f"{n['sharded_modeled_peak_x8_gib']:.3f}; {card}", flush=True)
        check(c["sharded_peak_gib"] < n["sharded_peak_gib"]
              and c["sharded_modeled_peak_x8_gib"] < n["sharded_modeled_peak_x8_gib"],
              f"{c['label']}: remat did not lower the partitioned step's peak below none's")
    return cases


def plan_peaks_phase(seed, card, layers=24, B=8, S=512):
    """``--plan-peaks``: qwen1.5-0.5b's partitioned train step (2d_finalized,
    ``layers`` deep, B8 S512, Adafactor) by ``TrainLoop`` under ``set_mesh``
    on ("data" 2, "model" 4) under remat "none", "full" and "dots", each
    with ``optimize=False`` and with the default optimized plan (in that
    order, from the same state on the same batches): two steps each, the
    allocator's peak, the plan's modeled peak x 8, device-busy, host and
    drained wall ms per step, and the losses, which must agree within
    bf16_grad (the flash backward adds dq by atomics)."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import TrainConfig, init_state
    from repro_torch.train.optimizer import get_optimizer

    st, opt, mesh = get_strategy("2d_finalized"), get_optimizer("adafactor"), make_test_mesh()
    print(f"plan peaks: qwen1.5-0.5b's partitioned train step, 2d_finalized, {layers} layers, "
          f"B{B} S{S}, unoptimized and optimized plans; {card}", flush=True)
    rows = []
    for remat in ("none", "full", "dots"):
        cfg = partition_train_config(layers, remat)
        pipe = TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=seed, pattern="arithmetic"))
        batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
        with set_mesh(mesh):
            state0 = init_state(cfg, st, opt, TrainConfig(),
                                torch.Generator("cuda").manual_seed(seed), "cuda")
        runs = {}
        for tag, optimize in (("unoptimized", False), ("optimized", True)):
            params = tree_map(lambda p: p.detach().clone().requires_grad_(), state0["params"])
            r = partition_train_run(tag, cfg, st, opt,
                                    {"params": params, "opt": opt.init(params), "step": 0},
                                    pipe, 2, mesh, batch, optimize=optimize)
            r.pop("runner")
            r.pop("params_after_step0")
            runs[tag] = r
            print(f"  remat {remat}, {tag}: peak {r['peak_gib']:.3f} GiB (plan's modeled peak "
                  f"x8 {r['modeled_peak_x8_gib']:.3f}); device busy "
                  f"{_ms(r['device_busy_ms_per_step'])}, host {r['host_ms_per_step']:.1f} ms, "
                  f"drained wall {r['drained_wall_ms_per_step']:.1f} ms per step; plan "
                  f"{r['plan_steps']} steps; losses {r['losses']}", flush=True)
            del params
            torch.cuda.empty_cache()
        u, o = runs["unoptimized"], runs["optimized"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(o["losses"], u["losses"]))
        check(rel <= TOLERANCES["bf16_grad"][0], f"plan peaks, remat {remat}: losses {runs}")
        rows.append({"remat": remat, "layers": layers, "B": B, "S": S, "card": card,
                     **{f"{t}_{k}": runs[t][k] for t in runs
                        for k in ("peak_gib", "modeled_peak_x8_gib", "device_busy_ms_per_step",
                                  "host_ms_per_step", "drained_wall_ms_per_step",
                                  "plan_steps", "losses")}})
        del state0
        torch.cuda.empty_cache()
    return rows


OPTION_STEPS = 4


def partition_option_case(kind, seed, card):
    """qwen1.5-0.5b at its published widths cut to two layers, float32
    compute and masters, Adafactor, 2d_finalized, B8 S512: ``OPTION_STEPS``
    steps of the partitioned step (``make_train_step`` under ``set_mesh``)
    with ``kind`` "compress" (``compress_grads``: the error feedback an
    input and an output of the program) or "fault" (a ``NumericFaultSpec``
    with a gradient spike at step 1 and NaN at step 3: ``torch.where`` on
    the step tensor), against the same steps unsharded on the card, in
    tests/test_torch_train.py's classes: losses and grad norms within
    f32_chain (before the NaN); compressed params and error feedback within
    coarse; the fault run's params after step 2 within f32_chain, and step
    3's loss, grad norm and every param NaN in both.  One plan for the run;
    one forward launch and one backward call per layer per step."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import (NumericFaultSpec, TrainConfig, init_state,
                                        make_train_step)
    from repro_torch.train.optimizer import get_optimizer

    cfg = partition_train_config(2).with_(dtype="float32")
    st, opt, mesh = get_strategy("2d_finalized"), get_optimizer("adafactor"), make_test_mesh()
    tc = (TrainConfig(compress_grads=True) if kind == "compress" else
          TrainConfig(numeric_fault=NumericFaultSpec(nan_at_step=3, grad_spike_at_step=1)))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, 512, 8, seed=seed, pattern="arithmetic"))
    batches = [{k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(i).items()}
               for i in range(OPTION_STEPS)]
    with set_mesh(mesh):
        state0 = init_state(cfg, st, opt, tc, torch.Generator("cuda").manual_seed(seed), "cuda")
    mods = _kernel_modules()
    runs = {}
    for tag, m in (("sharded", mesh), ("unsharded", None)):
        state = {k: (v if k == "step" else tree_map(lambda t: t.detach().clone(), v))
                 for k, v in state0.items()}
        tree_map(lambda p: p.requires_grad_(True), state["params"])
        with set_mesh(m):
            step = make_train_step(cfg, st, opt, tc)
        metrics, launches, snap = [], [], None
        for i, batch in enumerate(batches):
            for mod in mods.values():
                mod.launches = 0
            state, out = step(state, batch)
            torch.cuda.synchronize()
            launches.append({n: mod.launches for n, mod in mods.items()})
            metrics.append((out["loss"].item(), out["grad_norm"].item()))
            if i == 2:
                snap = tree_map(lambda t: t.detach().clone(), state["params"])
        runs[tag] = (state, metrics, launches, snap, getattr(step, "runner", None))
    (state, ms, ls, snap, runner), (ustate, ums, uls, usnap, _) = runs["sharded"], runs["unsharded"]
    last = OPTION_STEPS if kind == "compress" else 3
    metric_over = max(max(_err_over(torch.tensor(a), torch.tensor(b), "f32_chain")
                          for a, b in zip(m, u)) for m, u in zip(ms[:last], ums[:last]))
    if kind == "compress":
        params = {"/".join(p): _err_over(a, b, "coarse") for (p, a), b in
                  zip(leaves_with_paths(state["params"]), leaves(ustate["params"]))}
        ef = {"/".join(p): _err_over(a, b, "coarse") for (p, a), b in
              zip(leaves_with_paths(state["ef"]), leaves(ustate["ef"]))}
    else:
        params = {"/".join(p): _err_over(a, b, "f32_chain") for (p, a), b in
                  zip(leaves_with_paths(snap), leaves(usnap))}
        ef = {}
    nan_ok = kind != "fault" or all(
        math.isnan(x[3][0]) and math.isnan(x[3][1]) for x in (ms, ums)) and all(
        bool(torch.isnan(p).all()) for s_ in (state, ustate) for p in leaves(s_["params"]))
    want = {"flash_attention": 2, "flash_attention_bwd": 2, "ssd_scan": 0, "ssd_scan_bwd": 0}
    rec = {"kind": kind, "card": card, "layers": 2, "dtype": "float32", "B": 8, "S": 512,
           "metrics_sharded": ms, "metrics_unsharded": ums,
           "metrics_err_over_f32_chain": metric_over,
           "params_err_over_limit_max": max(params.values()),
           "ef_err_over_coarse_max": max(ef.values()) if ef else None,
           "nan_window_ok": nan_ok, "launches_per_step": ls,
           "plans": len(runner.plans), "plan_misses": runner.cache_stats.misses,
           "plan_hits": runner.cache_stats.hits, "fallback_gathers": list(runner.fallback_gathers)}
    print(f"  {kind}: 2 layers float32, 2d_finalized, B8 S512, {OPTION_STEPS} steps; {card}\n"
          f"    (loss, grad norm) sharded {ms}\n    unsharded {ums}\n    err/f32_chain "
          f"{metric_over:.3f} (steps 0-{last - 1}); params err/"
          f"{'coarse' if kind == 'compress' else 'f32_chain (after step 2)'} "
          f"{rec['params_err_over_limit_max']:.3f}"
          + (f"; error feedback err/coarse {rec['ef_err_over_coarse_max']:.3f}" if ef else
             f"; NaN from step 3 in both: {nan_ok}")
          + f"; plans {rec['plans']} ({rec['plan_misses']} built, {rec['plan_hits']} reused); "
          f"launches per step {ls}", flush=True)
    check(metric_over <= 1.0, f"{kind}: losses or grad norms off the unsharded step")
    check(rec["params_err_over_limit_max"] <= 1.0 and (not ef or max(ef.values()) <= 1.0),
          f"{kind}: params {params} or error feedback {ef} off the unsharded step")
    check(nan_ok, f"{kind}: the NaN window did not poison both runs at step 3")
    check(rec["plans"] == 1 and rec["plan_misses"] == 1 and not rec["fallback_gathers"],
          f"{kind}: {rec['plans']} plans, fallbacks gathered {rec['fallback_gathers']}")
    check(all(x == want for x in ls + uls), f"{kind}: launches {ls} / {uls}, want {want}")
    del runner, state, ustate
    torch.cuda.empty_cache()
    return rec


def partition_option_phase(seed, card):
    print("partition: compress_grads and the numeric-fault window in the partitioned train "
          "step, against the same steps unsharded on the card", flush=True)
    return [partition_option_case(kind, seed, card) for kind in ("compress", "fault")]


# ---------------------------------------------------------------------------------
# Mamba2's train step partitioned
# ---------------------------------------------------------------------------------

# (strategy, layers, dtype, B, S, steps, gate): the three Table-1
# strategies at two layers in float32, the loss and each gradient leaf
# gated ("grads"); the finalized strategy at full depth in float32, its
# loss gated and its gradient read beside the floor ("loss"; two steps of
# the loop read), and in bf16, read only (None: random-weight bf16 Mamba2
# is chaotic under the partitioned rounding schedule, R6; its gradient
# alone, no loop).  The full-depth gradient and loop are gated in float64
# (PARTITION_MAMBA_FLOAT64).
#
# Float32 does not determine this model's gradient at depth: a 1e-7
# relative change of the tree_init weights moves a 24-layer gradient leaf
# by up to 0.33 in norm (the gradient norms reach 1.6e4) and a two-layer
# one by up to 1.5e-4, and of the published init's by 5.3e-2 and 5.8e-5
# (tools/mamba2_conditioning.py on the CPU, full width, B2 S256).  The
# float32 cases start
# from Mamba2's published initialization (A in [1, 16], dt in [1e-3, 1e-1]
# log-uniform; arXiv:2405.21060) with the output projection scaled by
# 1/sqrt(L) (GPT-2's residual scaling), and read each gradient leaf beside
# the floor the run measures: how far the unsharded step's own two float32
# computations of the SSD, the kernels and the plain path, part on the same
# weights.  On the card the floor is at most 4.0e-5 at two layers and
# 0.35-0.39 at 24, where the partitioned step reads 1.0-1.4: there float32
# cannot part a partitioning fault from rounding, and the float64 witness
# below does.  A gated leaf is held to the larger of f32_chain's rtol and
# 4x its floor; a dropped or doubled psum moves a two-layer leaf by order 1
# (tests/test_torch_sharded_ssm.py).
# the float32, bf16 and float64 (PARTITION_MAMBA_FLOAT64) cases at eight and
# four layers: scan_phase runs the step scanned and unrolled (at eight
# layers, float32 and float64), and the script's time limit holds the rest
PARTITION_MAMBA_TRAIN = (("2d_finalized", 8, "float32", 8, 512, 2, "loss"),
                         ("2d_finalized", 4, "bfloat16", 8, 512, 0, None),  # read only
                         ("2d_finalized", 2, "float32", 8, 512, 0, "grads"),
                         ("2d_attempt1", 2, "float32", 8, 512, 0, "grads"),
                         ("2d_attempt2", 2, "float32", 8, 512, 0, "grads"))


def mamba2_published_init(params, layers, gen):
    """In place: A_log = log A with A uniform in [1, 16], dt_bias the
    inverse softplus of dt log-uniform in [1e-3, 1e-1] (Mamba2's published
    initialization), and the output projection scaled by 1/sqrt(layers)."""
    mix = params["layers"]["mixer"]
    with torch.no_grad():
        shape, dev = mix["A_log"].shape, mix["A_log"].device
        mix["A_log"].copy_(torch.log(1 + 15 * torch.rand(shape, generator=gen, device=dev)))
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev))
        mix["dt_bias"].copy_(dt + torch.log(-torch.expm1(-dt)))
        mix["wo"].mul_(1 / math.sqrt(layers))


def partition_mamba_train_case(strategy, layers, dtype, B, S, steps, gate, seed, card):
    """mamba2-130m at its published widths (``layers`` deep; float32
    masters, remat "dots", Adafactor, batch B x S): step 0's loss and
    gradient by the step's own gradient program partitioned on ("data" 2,
    "model" 4) against ``value_and_grad`` unsharded on the card, and, with
    ``steps``, ``TrainLoop`` under ``set_mesh`` (the partitioned step)
    against the same loop unsharded.  Float32 cases start from
    ``mamba2_published_init``'s weights and read each gradient leaf beside
    its floor (the unsharded gradient through the plain SSD, ``ops._route``
    reading "cpu" on the card's tensors, against the unsharded one through
    the kernels).  Gates: ``gate`` "loss", the loss within f32_chain's
    rtol; "grads", also each gradient leaf in norm within the larger of
    f32_chain's rtol and 4x its floor.  Always: per step (and
    in the gradient program) the SSD forward launched twice per layer (the
    "dots" recompute) and its backward once per layer, each one call for
    all eight devices; no fallback that gathers a sharded dim; no plan step
    holding a whole vocabulary dim; the optimized plan's modeled peak no
    higher than the unoptimized plan's; finite losses.  Reads: collectives,
    plan steps, first-call seconds, wall, host and device-busy ms per step
    and peak memory beside the plan's modeled peak x 8."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import (TrainConfig, init_state, sharded_value_and_grad,
                                        value_and_grad)
    from repro_torch.train.optimizer import get_optimizer

    cfg = get_config("mamba2-130m")
    check((cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state, cfg.vocab_size, cfg.remat,
           cfg.param_dtype) == (768, 64, 128, 50280, "dots", "float32"), f"unexpected config {cfg}")
    cfg = cfg.with_(num_layers=layers, dtype=dtype, scan_layers=False)
    st, opt, mesh = get_strategy(strategy), get_optimizer("adafactor"), make_test_mesh()
    L, V = cfg.num_layers, cfg.vocab_size
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 2 * L, "ssd_scan_bwd": L}
    pipe = TokenPipeline(DataConfig(V, S, B, seed=seed, pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    gen = torch.Generator("cuda").manual_seed(seed)
    with set_mesh(mesh):
        state0 = init_state(cfg, st, opt, TrainConfig(), gen, "cuda")
    if dtype == "float32":
        mamba2_published_init(state0["params"], L, gen)

    def fresh():
        params = tree_map(lambda p: p.detach().clone().requires_grad_(), state0["params"])
        return {"params": params, "opt": opt.init(params), "step": 0}

    with set_mesh(mesh):
        grad_runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh,
                                     optimize=False, device="cuda")
        (loss_s, grads_s), launched = counted(lambda: grad_runner(
            tree_map(torch.Tensor.detach, state0["params"]), batch))
    grad_first = dict(_plan_of(grad_runner).build_s)
    grad_fallback_gathers = list(grad_runner.fallback_gathers)
    check(launched == want, f"{strategy} {dtype}: the partitioned gradient launched {launched}, "
          f"want {want}")
    loss_u, grads_u = value_and_grad(cfg, st, fresh()["params"], batch)
    rel = {"/".join(p): _rel(g, u)
           for (p, g), u in zip(leaves_with_paths(grads_s), leaves(grads_u))}
    loss_rel = abs(loss_s.item() - loss_u.item()) / abs(loss_u.item())
    worst = max(rel, key=rel.get)
    limit = TOLERANCES["f32_chain"][0]
    del grads_s
    floor = None
    if dtype == "float32":  # the unsharded step's own two float32 computations of the SSD
        route = ops._route
        ops._route = lambda t: "cpu"  # the plain versions, on the card's tensors
        try:
            _, grads_p = value_and_grad(cfg, st, fresh()["params"], batch)
        finally:
            ops._route = route
        floor = {"/".join(p): _rel(g, u)
                 for (p, g), u in zip(leaves_with_paths(grads_p), leaves(grads_u))}
        del grads_p
    del grads_u, grad_runner
    torch.cuda.empty_cache()
    # the larger of f32_chain's rtol and 4x the floor
    over = {n: rel[n] / max(limit, 4 * floor[n]) for n in rel} if floor else None
    rec = {"strategy": strategy, "layers": L, "dtype": dtype, "B": B, "S": S, "card": card,
           "label": f"mamba2 {strategy} {L}L {dtype} B{B} S{S}", "gate": gate,
           "init": "published" if floor else "tree_init",
           "grad_loss_sharded": loss_s.item(), "grad_loss_unsharded": loss_u.item(),
           "loss_rel_err": loss_rel, "grad_rel_err": rel, "grad_rel_err_max": [worst, rel[worst]],
           "floor_rel_err": floor, "grad_err_over_limit": over,
           "grad_program_first_call_s": grad_first, "grad_launches": launched,
           "grad_fallback_gathers": grad_fallback_gathers}
    print(f"  mamba2 {strategy}: {L} layers, {dtype}, B{B} S{S} on ("
          f"{', '.join(f'{a} {n}' for a, n in zip(mesh.axis_names, mesh.shape))}), "
          + ("Mamba2's published init" if floor else "tree_init weights") + f"; {card}",
          flush=True)
    print(f"    step-0 loss sharded {loss_s.item():.6f} unsharded {loss_u.item():.6f} (rel "
          f"{loss_rel:.3e}; f32_chain {limit}" + ("; gated" if gate else "; read") +
          f"); gradient per leaf in norm at most {rel[worst]:.3e} ({worst}; "
          + ("gated at the larger of f32_chain's rtol and 4x the floor" if gate == "grads"
             else "read, not gated") + f"); within f32_chain's rtol: "
          f"{sum(r <= limit for r in rel.values())} of {len(rel)} leaves"
          + (f"; at most {max(over.values()):.3f} of the larger of f32_chain's rtol and 4x the "
             "floor" if over else ""), flush=True)
    print("    sharded vs unsharded: " + ", ".join(f"{n} {r:.2e}" for n, r in rel.items()),
          flush=True)
    if floor:
        print("    floor (unsharded, plain SSD vs kernels): " + ", ".join(
            f"{n} {r:.2e}" for n, r in floor.items()), flush=True)
    print(f"    gradient program: first call {json.dumps(grad_first)}, launches {launched}",
          flush=True)
    check(not grad_fallback_gathers, f"{strategy}: fallbacks gathered {grad_fallback_gathers}")
    check(math.isfinite(loss_s.item()), f"{strategy}: non-finite loss")
    if gate:
        check(loss_rel <= limit, f"mamba2 {strategy} {L}L: the partitioned step-0 loss off the "
              f"unsharded one by {loss_rel}")
    if gate == "grads":
        off = {n: v for n, v in over.items() if v > 1.0}
        check(not off, f"mamba2 {strategy} {L}L: the partitioned step-0 gradient off the "
              f"unsharded one: leaves over their limit {off}")
    if not steps:
        return rec
    sharded = partition_train_run("sharded", cfg, st, opt, fresh(), pipe, steps, mesh, batch)
    runner = sharded.pop("runner")
    # the same program's plan unoptimized: the optimized plan may model no
    # higher a peak (plan_opt.py::_within_peak under the committed profile)
    entry = _plan_of(runner)
    raw = compile_plan(entry.captured, entry.prop, mesh, optimize=False, cost_only=True,
                       verify=False)
    sharded["unoptimized_modeled_peak_x8_gib"] = raw.peak_bytes * mesh.size / 2**30
    del entry, raw
    state = fresh()
    holders = whole_vocab_steps(runner, (tree_map(torch.Tensor.detach, state["params"]),
                                         state["opt"], torch.tensor(0, device="cuda"), batch), V)
    del runner, state
    sharded.pop("params_after_step0")
    unsharded = partition_train_run("unsharded", cfg, st, opt, fresh(), pipe, steps, None, batch)
    unsharded.pop("params_after_step0")
    rec.update({"losses_sharded": sharded["losses"], "losses_unsharded": unsharded["losses"],
                "whole_vocab_steps": holders,
                **{f"sharded_{k}": v for k, v in sharded.items() if k not in ("losses", "label")},
                **{f"unsharded_{k}": v for k, v in unsharded.items()
                   if k not in ("losses", "label")}})
    print(f"    losses sharded {sharded['losses']} unsharded {unsharded['losses']}", flush=True)
    print(f"    launches per step sharded {[r['launches'] for r in sharded['steps']]}", flush=True)
    print(f"    first step: {json.dumps(sharded['first_call_s'])}; plan {sharded['plan_steps']} "
          f"steps; collectives per step {json.dumps(sharded['collectives_per_step'])}; fallbacks "
          f"{json.dumps(sharded['fallbacks'])}", flush=True)
    for tag, r in (("sharded", sharded), ("unsharded", unsharded)):
        print(f"    {tag}: wall {r['wall_ms_per_step']:.1f} ms/step (steps 1-{steps - 1}); host "
              f"{r['host_ms_per_step']:.1f} ms, drained wall {r['drained_wall_ms_per_step']:.1f} "
              f"ms, device busy {_ms(r['device_busy_ms_per_step'])} per step; peak "
              f"{r['peak_gib']:.3f} GiB"
              + (f" (plan's modeled peak x8 {r['modeled_peak_x8_gib']:.3f}, unoptimized "
                 f"{r['unoptimized_modeled_peak_x8_gib']:.3f})"
                 if "modeled_peak_x8_gib" in r else ""), flush=True)
    for r in sharded["steps"] + unsharded["steps"]:
        check(r["launches"] == want, f"mamba2 {strategy}: step {r['step']} launched "
              f"{r['launches']}, want {want}")
    check(not sharded["fallback_gathers"],
          f"mamba2 {strategy}: fallbacks gathered a sharded dim: {sharded['fallback_gathers']}")
    check(not holders, f"mamba2 {strategy}: plan steps held a whole vocabulary dim: {holders}")
    check(sharded["modeled_peak_x8_gib"] <= sharded["unoptimized_modeled_peak_x8_gib"],
          f"mamba2 {strategy}: the optimized plan models a higher peak than the unoptimized "
          f"one ({sharded['modeled_peak_x8_gib']} > {sharded['unoptimized_modeled_peak_x8_gib']}"
          " GiB)")
    check(all(math.isfinite(x) for x in sharded["losses"] + unsharded["losses"]),
          f"mamba2 {strategy}: non-finite loss")
    if gate:
        err = _err_over(torch.tensor(sharded["losses"][0]), torch.tensor(unsharded["losses"][0]),
                        "f32_chain")
        rec["step0_loss_err_over_f32_chain"] = err
        check(err <= 1.0, f"mamba2 {strategy}: the loops' step-0 losses differ: {err}")
    return rec


# (strategy, layers, B, S, steps): the full-depth partitioned step in
# float64, the witness that parts a partitioning fault from float32's
# conditioning (above)
PARTITION_MAMBA_FLOAT64 = ("2d_finalized", 8, 8, 512, 2)
# the psums of decide_ssd_bwd's op a planted fault drops, by their shape, and
# how many each layer's op runs under 2d_finalized
SSD_BWD_PSUMS = {"dB, dC": (lambda t: t.ndim == 4, 2), "dA": (lambda t: t.ndim == 2, 1)}


class SSDBwdPsumDropped:
    """``core/mesh_runtime.py`` with the psums over ``axis`` that
    ``decide_ssd_bwd``'s op runs for the gradients ``grad`` (a key of
    SSD_BWD_PSUMS: dB's and dC's are (n, b, S, ds), dA's (n, H)) left out;
    every other psum as it was."""

    def __init__(self, grad, axis):
        from repro_torch.core import mesh_runtime

        self._mr, (self._which, self.per_layer), self._axis = (mesh_runtime,
                                                                SSD_BWD_PSUMS[grad], axis)
        self.dropped = 0

    def __getattr__(self, name):
        return getattr(self._mr, name)

    def psum(self, x, mesh, axes):
        caller = sys._getframe(1).f_code.co_qualname
        if (caller.startswith("decide_ssd_bwd.") and self._axis in tuple(axes)
                and self._which(x)):
            self.dropped += 1
            return x
        return self._mr.psum(x, mesh, axes)


def partition_mamba_float64_case(strategy, layers, B, S, steps, seed, card):
    """The float64 witness: the same weights as the float32 full-depth case
    (``mamba2_published_init``), widened to float64, and the model in
    float64, the SSD and its gradient on their plain route (``ops._route``
    reading "cpu" on the card's tensors: the kernels are float32 only).
    Float64 carries the float32 rounding that this model amplifies to
    order 1 at 24 layers (a 1e-7 weight change moved each leaf 0.074-0.083
    on the card) 9 orders lower, so the partitioned step-0 loss and each
    gradient leaf are gated within f32_chain's rtol in norm against the
    same unsharded, and so is ``steps`` steps of ``TrainLoop`` (the
    partitioned train step under ``set_mesh``, its own program): each
    step's loss, and each param after step 0 (Adafactor's update is
    float32 math).  Planted faults, each rerunning the partitioned gradient
    program: dB's and dC's psums over "model" dropped, then dA's over
    "data"; each must put a leaf beyond that limit.  Also gated: the plan
    holds per layer two SSD forward steps and one backward step, no
    fallback gathers a sharded dim, and no kernel launched."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core import partitioner as part
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train.loop import (TrainConfig, init_state, sharded_value_and_grad,
                                        value_and_grad)
    from repro_torch.train.optimizer import get_optimizer

    t0 = time.perf_counter()
    cfg = get_config("mamba2-130m").with_(num_layers=layers, dtype="float32", scan_layers=False)
    st, opt, mesh = get_strategy(strategy), get_optimizer("adafactor"), make_test_mesh()
    L, V = cfg.num_layers, cfg.vocab_size
    pipe = TokenPipeline(DataConfig(V, S, B, seed=seed, pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    gen = torch.Generator("cuda").manual_seed(seed)
    with set_mesh(mesh):
        state0 = init_state(cfg, st, opt, TrainConfig(), gen, "cuda")
    mamba2_published_init(state0["params"], L, gen)  # the float32 case's weights
    params0 = tree_map(lambda p: p.detach().double(), state0["params"])
    del state0
    cfg = cfg.with_(dtype="float64")
    limit = TOLERANCES["f32_chain"][0]

    def fresh():
        params = tree_map(lambda p: p.clone().requires_grad_(), params0)
        return {"params": params, "opt": opt.init(params), "step": 0}

    route = ops._route
    ops._route = lambda t: "cpu"  # the plain versions, on the card's tensors
    try:
        with set_mesh(mesh):
            runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh,
                                    optimize=False, device="cuda")
            (loss_s, grads_s), launched = counted(lambda: runner(params0, batch))
        (entry,) = runner.plans.values()
        ssd_steps = collections.Counter(s.op for s in entry.plan.steps
                                        if s.op.startswith("repro_torch.ssd"))
        loss_u, grads_u = value_and_grad(cfg, st, fresh()["params"], batch)
        names = ["/".join(p) for p, _ in leaves_with_paths(grads_u)]
        rel = {n: _rel(g, u) for n, g, u in zip(names, leaves(grads_s), leaves(grads_u))}
        del grads_s
        faults = {}
        for grad, axis in (("dB, dC", "model"), ("dA", "data")):
            planted = SSDBwdPsumDropped(grad, axis)
            part.mr = planted
            try:
                _, grads_f = runner(params0, batch)
            finally:
                part.mr = planted._mr
            check(planted.dropped == planted.per_layer * L,
                  f"float64 witness: the planted fault dropped {planted.dropped} psums of {grad} "
                  f"over {axis}, want {planted.per_layer} per layer")
            faults[f"{grad} over {axis}"] = max(
                _rel(g, u) for g, u in zip(leaves(grads_f), leaves(grads_u))) / limit
            del grads_f
        del grads_u
        loops = {}
        for label, m in (("sharded", mesh), ("unsharded", None)):
            run = partition_train_run(label, cfg, st, opt, fresh(), pipe, steps, m, batch,
                                      readings=False)
            run.pop("runner", None)
            loops[label] = run
    finally:
        ops._route = route
    torch.cuda.empty_cache()
    sh, un = loops["sharded"], loops["unsharded"]
    loss_rel = abs(loss_s.item() - loss_u.item()) / abs(loss_u.item())
    loop_loss_rel = [abs(a - b) / abs(b) for a, b in zip(sh["losses"], un["losses"])]
    param_rel = {n: _rel(a, b) for n, a, b in zip(names, leaves(sh["params_after_step0"]),
                                                    leaves(un["params_after_step0"]))}
    worst = max(rel, key=rel.get)
    worst_p = max(param_rel, key=param_rel.get)
    rec = {"strategy": strategy, "layers": L, "dtype": "float64", "B": B, "S": S, "card": card,
           "label": f"mamba2 {strategy} {L}L float64 B{B} S{S}", "route": "plain",
           "grad_loss_sharded": loss_s.item(), "grad_loss_unsharded": loss_u.item(),
           "loss_rel_err": loss_rel, "grad_rel_err": rel, "grad_rel_err_max": [worst, rel[worst]],
           "planted_fault_over_limit": faults, "plan_ssd_steps": dict(ssd_steps),
           "grad_launches": launched, "grad_fallback_gathers": list(runner.fallback_gathers),
           "losses_sharded": sh["losses"], "losses_unsharded": un["losses"],
           "loop_loss_rel_err": loop_loss_rel, "params_after_step0_rel_err": param_rel,
           "loop_fallback_gathers": sh["fallback_gathers"],
           "sharded_peak_gib": sh["peak_gib"], "unsharded_peak_gib": un["peak_gib"],
           "seconds": time.perf_counter() - t0}
    print(f"  mamba2 {strategy}: {L} layers, float64 (the float32 case's weights widened; the "
          f"SSD and its gradient on the plain route), B{B} S{S} on ("
          f"{', '.join(f'{a} {n}' for a, n in zip(mesh.axis_names, mesh.shape))}); {card}",
          flush=True)
    print(f"    step-0 loss sharded {loss_s.item():.12f} unsharded {loss_u.item():.12f} (rel "
          f"{loss_rel:.3e}); gradient per leaf in norm at most {rel[worst]:.3e} ({worst}); "
          f"gated at f32_chain's rtol {limit}", flush=True)
    print("    sharded vs unsharded: " + ", ".join(f"{n} {r:.2e}" for n, r in rel.items()),
          flush=True)
    print("    planted faults, largest leaf error over the limit: " + ", ".join(
        f"{n} dropped {r:.4g}" for n, r in faults.items()), flush=True)
    print(f"    loop: losses sharded {sh['losses']} unsharded {un['losses']} (rel "
          f"{', '.join(f'{r:.3e}' for r in loop_loss_rel)}); params after step 0 per leaf in "
          f"norm at most {param_rel[worst_p]:.3e} ({worst_p}); plan SSD steps {dict(ssd_steps)}; "
          f"peak sharded {sh['peak_gib']:.3f} GiB unsharded {un['peak_gib']:.3f} GiB; "
          f"{rec['seconds']:.1f} s", flush=True)
    want = {"repro_torch.ssd_scan": 2 * L, "repro_torch.ssd_scan_bwd": L}
    check(dict(ssd_steps) == want, f"float64 witness: plan SSD steps {dict(ssd_steps)}, "
          f"want {want}")
    check(not any(launched.values()), f"float64 witness: the plain route launched {launched}")
    check(not runner.fallback_gathers and not sh["fallback_gathers"],
          f"float64 witness: fallbacks gathered {runner.fallback_gathers} "
          f"{sh['fallback_gathers']}")
    check(loss_rel <= limit and rel[worst] <= limit,
          f"float64 witness: the partitioned step 0 off the unsharded one: loss {loss_rel}, "
          f"{worst} {rel[worst]}")
    check(max(loop_loss_rel) <= limit and param_rel[worst_p] <= limit,
          f"float64 witness: the partitioned loop off the unsharded one: losses "
          f"{loop_loss_rel}, {worst_p} after step 0 {param_rel[worst_p]}")
    check(all(r > 1.0 for r in faults.values()),
          f"float64 witness: a planted fault went unseen: {faults}")
    return rec


def partition_mamba_train_phase(seed, card):
    print("partition: mamba2-130m's train step through spmd_partition (the gradient programs "
          "unoptimized, TrainLoop's step optimized) on (data 2, model 4) against the same step "
          "unsharded on the card", flush=True)
    # the float64 witness first: it launches no kernel, and its loop sets
    # the launch counts to 0 at each step, which the kernel cases after it
    # then count up again for this phase's own check
    cases = [partition_mamba_float64_case(*PARTITION_MAMBA_FLOAT64, seed, card)]
    torch.cuda.empty_cache()
    for case in PARTITION_MAMBA_TRAIN:
        cases.append(partition_mamba_train_case(*case, seed, card))
        torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------------
# Mamba2's loss partitioned, and serving partitioned
# ---------------------------------------------------------------------------------

SHARDED_LOSS_B, SHARDED_LOSS_S = 8, 2048
# (arch, strategy, layers, dtype, decode steps at least): both families at
# full width under the finalized strategy, Mamba2 in bf16 and in float32
# (bf16 Mamba2 with random weights is chaotic under rounding: its bf16
# logits are read, not held; the float32 run holds the partitioned step
# at every step), and the two earlier attempts of Table 1 at two layers
# for a few steps
# (arch, strategy, layers, dtype, decode steps at least, shard_kv_seq, slots):
# the last two are qwen with its kv cache sharded on the sequence over
# "data" (the reference's shard_kv_seq).  Under 2d_attempt1 the batch is not
# on "data"; under 2d_finalized it is, and the reference's own
# first-dim-wins filter keeps it there unless the slots do not divide
# "data" (the dry run turns shard_kv_seq on for a global batch below 16):
# one slot, one request
# the deep cases at eight layers (cut from 24 for the script's time limit;
# scan_phase serves qwen (2d_attempt1, shard_kv_seq) and Mamba2 (float32)
# at eight too)
SHARDED_SERVE = (("qwen1.5-0.5b", "2d_finalized", 8, "bfloat16", 64, False, 8),
                 ("mamba2-130m", "2d_finalized", 8, "bfloat16", 64, False, 8),
                 ("mamba2-130m", "2d_finalized", 8, "float32", 64, False, 8),
                 ("qwen1.5-0.5b", "2d_attempt1", 2, "bfloat16", 8, False, 8),
                 ("qwen1.5-0.5b", "2d_attempt2", 2, "bfloat16", 8, False, 8),
                 ("qwen1.5-0.5b", "2d_attempt1", 8, "bfloat16", 64, True, 8),
                 ("qwen1.5-0.5b", "2d_finalized", 8, "bfloat16", 64, True, 1))
SERVE_MAX_LEN = 1024
TEACHER_STEPS = (0, 8, 32, 63)  # steps at which the unsharded step reruns the sharded input
BOUNDARY_POS = 700  # a decode position past the cache's half (sequence shards of 512 keys)


def _plan_of(runner):
    (entry,) = runner.plans.values()
    return entry


def _plan_readings(runner, mesh):
    entry = _plan_of(runner)
    return {"first_call_s": dict(entry.build_s), "plan_steps": len(entry.plan.steps),
            "plan_stats": entry.plan.stats.as_dict(),
            "modeled_peak_x8_gib": entry.plan.peak_bytes * mesh.size / 2**30,
            "collectives_per_call": dict(runner.collectives),
            "fallbacks": dict(collections.Counter(runner.fallbacks)),
            "fallback_gathers": list(runner.fallback_gathers)}


def sharded_loss_phase(seed, card):
    """mamba2-130m at its published widths (bf16): ``api.loss_fn`` of a B8
    S2048 batch with no gradient as one program (``api.partitionable_loss``:
    params by their specs, the batch on "data") through
    ``spmd_partition(..., optimize=False)`` under 2d_finalized on ("data" 2,
    "model" 4), against the same loss unsharded on the card: within
    bf16_chain, exactly 24 SSD calls (72 launches) per forward, each one
    call for all eight devices, no fallback that gathers; first-call
    seconds, plan steps and collectives, device-busy, host and wall ms per
    forward sharded and unsharded, peak memory beside the plan's modeled
    peak x 8."""
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import api

    cfg, st, params = full_width_model("mamba2-130m", seed)
    mesh, L = make_test_mesh(), cfg.num_layers
    B, S = SHARDED_LOSS_B, SHARDED_LOSS_S
    rng = np.random.default_rng(seed + 40)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).cuda()
             for k in ("tokens", "labels")}
    runner = spmd_partition(api.partitionable_loss(cfg, st, mesh), mesh, optimize=False,
                            device="cuda")
    runs = {}
    with torch.no_grad():
        for label, fn in (("unsharded", lambda: api.loss_fn(cfg, st, params, batch)),
                          ("sharded", lambda: runner(params, batch))):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            loss, launches = counted(fn)
            _, again = counted(fn)  # the plan alone, after the first call's build
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            host, wall = host_and_wall_ms(fn, calls=3)
            runs[label] = {"loss": loss.item(), "launches_first": launches,
                           "launches": again, "host_ms": host, "wall_ms": wall,
                           "device_busy_ms": device_ms(lambda i: fn(), 1, calls=1),
                           "peak_gib": peak}
    sh, un = runs["sharded"], runs["unsharded"]
    sh.update(_plan_readings(runner, mesh))
    err = abs(sh["loss"] - un["loss"])
    rtol, atol = TOLERANCES["bf16_chain"]
    over = err / (atol + rtol * abs(un["loss"]))
    print(f"partition: mamba2-130m loss B{B} S{S} under 2d_finalized on (data 2, model 4); "
          f"{card}", flush=True)
    print(f"  loss sharded {sh['loss']:.6f} unsharded {un['loss']:.6f}: err/bf16_chain "
          f"{over:.3f}; launches per forward sharded {sh['launches']} unsharded "
          f"{un['launches']}", flush=True)
    print(f"  first call {json.dumps(sh['first_call_s'])}; plan {sh['plan_steps']} steps; "
          f"collectives per forward {json.dumps(sh['collectives_per_call'])}; fallbacks "
          f"{json.dumps(sh['fallbacks'])}", flush=True)
    for tag, r in (("sharded", sh), ("unsharded", un)):
        print(f"  {tag}: device busy {_ms(r['device_busy_ms'])}, host {r['host_ms']:.1f} ms, "
              f"wall {r['wall_ms']:.1f} ms per forward; peak {r['peak_gib']:.3f} GiB"
              + (f" (plan's modeled peak x8 {r['modeled_peak_x8_gib']:.3f})"
                 if "modeled_peak_x8_gib" in r else ""), flush=True)
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": L, "ssd_scan_bwd": 0}
    check(sh["launches"] == want and sh["launches_first"] == want and un["launches"] == want,
          f"SSD calls per forward: sharded {sh['launches']}, unsharded {un['launches']}; "
          f"want {want}")
    check(not sh["fallback_gathers"], f"fallbacks gathered: {sh['fallback_gathers']}")
    check(math.isfinite(sh["loss"]) and over <= 1.0, f"sharded loss off: {sh['loss']} vs "
          f"{un['loss']}")
    return {"arch": "mamba2-130m", "strategy": st.name, "B": B, "S": S, "card": card,
            "loss_err_over_bf16_chain": over, "sharded": sh, "unsharded": un}


def dropped_psum_readings(runner, step):
    """Planted faults in the served bf16 plan, one at a time: the first, the
    middle and the last standalone psum (none where the optimizer fused
    them all) replaced by the local value; each reading is the relative
    change of the step's logits in norm over bf16_grad's limit, beside the
    psum's site.  Read, not gated: the gate is ``float32_twin_readings``."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.compat import TOLERANCES

    plan = _plan_of(runner).plan
    psums = [s for s in plan.steps if s.kind == "collective" and s.reduce_op == "add"]
    planted = [psums[0], psums[len(psums) // 2], psums[-1]] if psums else []
    with torch.no_grad():
        sound = step()[0].float()
        out = []
        for fault in planted:
            run, fault.run = fault.run, plan_mod._alias_run
            try:
                got = step()[0].float()
            finally:
                fault.run = run
            out.append(((got - sound).norm() / sound.norm()).item() / TOLERANCES["bf16_grad"][0])
    return out, _psum_sites(plan, planted)


def _psum_sites(plan, psums):
    """Each standalone psum as "axes local-shape after <the op that made its
    operand>": which reduction a planted fault drops."""
    made = {w: st.op for st in _all_steps(plan) for w in st.writes}
    return [f"{s.axes} {tuple(s.lshape)} after {made.get(s.reads[0], '?')}" for s in psums]


def boundary_state(cfg, st, cache, pos, slots, seed):
    """A decode input past the cache's half, so that both of its sequence
    shards on "data" hold keys (the served run's positions all lie in the
    first): the engine's cache after its run, its rows ``pos`` to
    BOUNDARY_POS - 1 filled with seeded normal values at the served rows'
    scale, a seeded token per slot, and the position BOUNDARY_POS (int32 on
    the card)."""
    from repro_torch.models import api

    whole = api.cache_shapes(cfg, st, slots, SERVE_MAX_LEN)
    gen = torch.Generator(device="cuda").manual_seed(seed + 60)
    out = {}
    for k, v in cache.items():
        v = v[tuple(slice(0, n) for n in whole[k])].clone()
        fill = v[:, :, pos:BOUNDARY_POS]
        fill.copy_(torch.randn(fill.shape, generator=gen, device="cuda")
                   * v[:, :, :pos].float().std())
        out[k] = v
    token = torch.randint(0, cfg.vocab_size, (slots, 1), generator=gen, device="cuda")
    return out, token, torch.tensor(BOUNDARY_POS, dtype=torch.int32, device="cuda")


def float32_twin_readings(cfg, st, params, mesh, runner, state, kv_seq):
    """The planted-fault gate.  The case's decode step again as a float32
    program (the same weights widened, the boundary state's cache widened),
    partitioned under ``mesh`` and unsharded.  In bf16 the partitioned
    step's own rounding (1.6-2.4e-2 in norm at 24 layers) is as large as
    what dropping one layer's norm psum does to the logits, so no bf16
    limit parts the two; in float32 the sound step lies orders of magnitude
    inside f32_chain's rtol in norm and a fault far outside.  Returns the
    sound step's and each planted fault's (the first, middle and last
    standalone psum of the plan, scan body plans included; with ``kv_seq`` also the decode combine's
    all-reduces, each device keeping its own shard's partial) relative
    error in norm against the unsharded step over that limit, the psums'
    sites, and whether the float32 plan has the served program's
    collectives and reshards (what makes it a stand-in for it).  Both are
    compared before the optimizer: the twin's plan is unoptimized, so that
    each psum stands alone to be dropped, and the served program's is
    compiled again unoptimized from the served entry (the optimizer's
    fusion buckets by bytes, and float32 members are twice bf16's)."""
    from repro_torch.core import partitioner
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.tree import tree_map
    from repro_torch.models import api

    cfg32 = cfg.with_(dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    cache, token, pos = state
    cache = {k: v.float() for k, v in cache.items()}
    with set_mesh(mesh):
        twin = partitioner.spmd_partition(api.partitionable_decode(cfg32, st, mesh), mesh,
                                          optimize=False, device="cuda")
    limit = TOLERANCES["f32_chain"][0]
    with torch.no_grad():
        want, _ = api.decode_step(cfg32, st, p32, token, {k: v.clone() for k, v in cache.items()},
                                  pos)
        want = want[:, -1].float()

        def over():
            got = twin(p32, token, cache, pos)[0][:, -1].float()
            return ((got - want).norm() / want.norm()).item() / limit

        sound = over()
        entry = _plan_of(runner)
        plan = _plan_of(twin).plan
        served = plan_mod.compile_plan(entry.captured, entry.prop, mesh, optimize=False,
                                       cost_only=True, verify=False)
        layout = lambda pl: ([(x.op, x.axes, x.reduce_op) for x in _all_steps(pl)  # noqa: E731
                              if x.kind == "collective"],
                             [tuple(y.op for y in x.program.steps) for x in _all_steps(pl)
                              if x.kind == "reshard"])
        psums = [x for x in _all_steps(plan) if x.kind == "collective" and x.reduce_op == "add"]
        planted = dict(zip(("first psum", "middle psum", "last psum"),
                           (psums[0], psums[len(psums) // 2], psums[-1])))
        faults = {}
        for name, fault in planted.items():
            run, fault.run = fault.run, plan_mod._alias_run
            try:
                faults[name] = over()
            finally:
                fault.run = run
        if kv_seq:
            real = partitioner.combine_decode
            partitioner.combine_decode = lambda out, lse, mesh, axes: real(out, lse, mesh, ())
            try:
                faults["combine's all-reduces"] = over()
            finally:
                partitioner.combine_decode = real
    return {"limit": limit, "sound_over_limit": sound, "faults_over_limit": faults,
            "planted_psums": dict(zip(planted, _psum_sites(plan, list(planted.values())))),
            "same_collectives_as_served": layout(plan) == layout(served)}


def _logits_rule(got, want, kind, norm_limit=None):
    """tests/test_torch_serve.py's rule over per-step last-position logits
    (lists of (B, V) float32 tensors): each step within ``kind`` until the
    first step whose greedy tokens differ, where the reference's top-2
    margin must be within twice the tolerance.  With ``norm_limit`` each
    step's logits are held in norm instead (the difference's norm over
    theirs), and ``kind`` gives only the margin's per-logit tolerance.
    Returns (held, the step where the streams part or None, the worst
    err/limit before it)."""
    from repro_torch.core.compat import TOLERANCES

    rtol, atol = TOLERANCES[kind]
    worst = 0.0
    for step, (g, w) in enumerate(zip(got, want)):
        if norm_limit is not None:
            over = ((g - w).norm() / w.norm()).item() / norm_limit
        else:
            over = ((g - w).abs() / (atol + rtol * w.abs())).max().item()
        worst = max(worst, over)
        if worst > 1.0:
            return False, step, worst
        top2 = w.topk(2, dim=-1).values
        differs = g.argmax(-1) != w.argmax(-1)
        if bool(differs.any()):
            near = (top2[:, 0] - top2[:, 1]) <= 2 * (atol + rtol * top2[:, 0].abs())
            return bool(near[differs].all()), step, worst
    return True, None, worst


def float64_step(cfg, st, params, token, cache, pos):
    """The unsharded decode step evaluated in float64: params and cache
    widened, the model's dtype float64 and every ``.float()`` it takes read
    as ``.double()`` for the call.  Returns the last position's logits."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import api

    widen = torch.Tensor.float
    torch.Tensor.float = torch.Tensor.double
    try:
        with torch.no_grad():
            logits, _ = api.decode_step(cfg.with_(dtype="float64"), st,
                                        tree_map(torch.Tensor.double, params), token,
                                        {k: v.double() for k, v in cache.items()}, pos)
    finally:
        torch.Tensor.float = widen
    return logits[:, -1].cpu()


def serve_run(cfg, st, params, mesh, prompts, new_tokens, teacher=None):
    """``Engine(slots=len(prompts), max_len=1024)`` (under ``set_mesh(mesh)``: the
    partitioned step) serving ``prompts``: each decode step's last-position
    logits, wall ms (the device drained before; to the sampler's read of
    the logits) and kernel launches; tokens/s after the first step (whose
    time holds the partitioned program's build); peak memory.  With
    ``teacher``, at the steps it names the unsharded eager step reruns the
    step's input (a copy of the cache, the token and the position) outside
    the timed region, and its logits are kept beside the step's, with, in
    a float32 model, the step's logits evaluated in float64.  The engine is
    the default one: its plan optimized and verified, priced by the
    committed profile."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine, Request

    mods = _kernel_modules()
    slots = len(prompts)
    with set_mesh(mesh):
        eng = Engine(cfg, st, params, batch_slots=slots, max_len=SERVE_MAX_LEN)
    seen, ms, launches, forced = [], [], [], []
    decode = eng._decode

    def timed(tokens):
        step = len(ms)
        if teacher is not None and step in teacher:
            # the unsharded step's cache: Mamba2's heads padded to the mesh
            # (zero states) cut off; a padded kv layout is not taken
            whole = api.cache_shapes(cfg, st, slots, SERVE_MAX_LEN)
            check(cfg.family == "ssm" or all(tuple(v.shape) == whole[k]
                                             for k, v in eng.cache.items()),
                  f"{cfg.name}: a padded kv layout under the mesh")
            copy = {k: v[tuple(slice(0, n) for n in whole[k])].clone()
                    for k, v in eng.cache.items()}
            token, pos = torch.as_tensor(tokens, device="cuda").clone(), eng.pos
        for mod in mods.values():
            mod.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = decode(tokens)
        last = out[0][:, -1].float().cpu()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append({n: mod.launches for n, mod in mods.items()})
        seen.append(last)
        if teacher is not None and step in teacher:
            exact = (float64_step(cfg, st, params, token, copy, pos)
                     if cfg.dtype == "float32" else None)
            with torch.no_grad():
                want, _ = api.decode_step(cfg, st, params, token, copy, pos)
            forced.append((step, last, want[:, -1].float().cpu(), exact))
            del copy
        return out

    eng._decode = timed
    reqs = [Request(prompt=p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        eng.generate(reqs)
    seconds = time.perf_counter() - t0
    ntok = sum(len(r.out) for r in reqs)
    return eng, {
        "steps": eng.pos, "tokens": ntok, "seconds": seconds,
        "tok_per_s_after_first_step": ntok / (seconds - ms[0] / 1e3),
        "step_wall_ms_median": statistics.median(ms[1:]), "first_step_ms": ms[0],
        "launches_per_step": launches, "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2**30,
        "done": all(r.done for r in reqs), "outs": [r.out for r in reqs],
    }, seen, forced


def _syncs_in(fn):
    """The host-device synchronisations ``fn`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them: their count
    and the source lines that made them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    where = [f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return len(where), sorted(set(where))


def sharded_serve_case(arch, strategy, layers, dtype, min_steps, kv_seq, slots, seed, card):
    """``Engine`` under ``set_mesh`` on ("data" 2, "model" 4) (the decode step
    one program through the partitioner: params by their specs, the token on
    "data", the cache by ``api.cache_specs``, the position an int32 on the
    card) against the same ``Engine`` unsharded, from the same bf16 serving
    weights and prompts.  Gates: one plan for the whole run; qwen one
    decode launch per layer per step (all eight devices in one), Mamba2 no
    SSD launch; no fallback that gathers and no plan step holding a whole
    vocabulary dim; the logits by tests/test_torch_serve.py's rule against
    the unsharded run (at two layers per element, bf16_chain; at 24 in
    norm: qwen bf16 within bf16_grad, Mamba2 float32 within CONSIST's
    limit; bf16 Mamba2 printed only), and at the steps of TEACHER_STEPS
    against the unsharded step on the same input (printed; for qwen held
    as the free run).  For qwen at 24 layers, the planted-fault gate of
    ``float32_twin_readings`` at BOUNDARY_POS (``boundary_state``; the bf16
    step there and the bf16 plan's dropped psums are read).
    Readings: tokens/s, step wall,
    host and device-busy ms, the cache's shard and unshard ms per step,
    syncs per step, peak memory.  With ``kv_seq`` (``cfg.shard_kv_seq``) the
    kv cache is sharded on its sequence over "data" (gate) and no plan step
    holds a whole cache sequence (gate): each layer's decode is one launch
    of partial decodes for all eight devices, combined with small
    all-reduces."""
    from repro_torch.configs.base import get_strategy, spec_sharding
    from repro_torch.core import mesh_runtime as mr
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import api

    cfg, _, params = full_width_model(arch, seed, dtype=dtype)
    if layers != cfg.num_layers:
        cfg = cfg.with_(num_layers=layers)
        params = {**params, "layers": _first_layers(params["layers"], layers)}
    cfg = cfg.with_(shard_kv_seq=kv_seq)
    st, mesh, L, V = get_strategy(strategy), make_test_mesh(), cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(seed + 50)
    # one request per slot, prompts of 8-16 tokens: with 64 new tokens each
    # the run takes 72-80 decode steps, with 4 (the two-layer runs) 12-20
    prompts = [rng.integers(0, V, int(n)).tolist()
               for n in rng.integers(8, 17, size=slots)]
    new = 64 if min_steps > 8 else 4
    teacher = TEACHER_STEPS if min_steps > 8 else (0, 5)
    kernel = "flash_attention" if cfg.family == "dense" else None
    eng_u, un, seen_u, _ = serve_run(cfg, st, params, None, prompts, new)
    eng_u_pos = eng_u.pos
    del eng_u
    torch.cuda.empty_cache()
    eng, sh, seen_s, forced = serve_run(cfg, st, params, mesh, prompts, new, teacher)
    runner = eng.runner
    sh.update(_plan_readings(runner, mesh))
    check(sh["steps"] >= min_steps and eng.pos == eng_u_pos,
          f"{arch} {strategy}: {sh['steps']} steps (unsharded {eng_u_pos}), want {min_steps}+")
    # the step again, drained: host and wall ms, device busy, syncs
    token = torch.zeros((slots, 1), dtype=torch.long, device="cuda")
    eng._pos.fill_(eng.pos)

    def step():
        return runner(params, token, eng.cache, eng._pos)

    with torch.no_grad():
        sh["host_ms"], sh["drained_wall_ms"] = host_and_wall_ms(step, calls=3)
        sh["device_busy_ms"] = device_ms(lambda i: step(), 1, calls=1)
        sh["syncs_per_step"], sh["sync_sites"] = _syncs_in(step)
        with set_mesh(mesh):
            specs = api.cache_specs(cfg, st)
        shards = {k: spec_sharding(specs[k], tuple(c.shape), mesh) for k, c in eng.cache.items()}
        stacked = {k: mr.shard(c, shards[k]) for k, c in eng.cache.items()}
        sh["cache_shard_ms"] = time_ms(lambda i: [mr.shard(c, shards[k])
                                                  for k, c in eng.cache.items()], 1)
        sh["cache_unshard_ms"] = time_ms(lambda i: [mr.unshard(v, shards[k])
                                                    for k, v in stacked.items()], 1)
        del stacked
        holders = whole_vocab_steps(runner, (params, token, eng.cache, eng._pos), V)
        gathers = (cache_gather_steps(runner, (params, token, eng.cache, eng._pos),
                                      SERVE_MAX_LEN, cfg.dh) if kv_seq else [])
        whole = api.cache_shapes(cfg, st, slots, SERVE_MAX_LEN)
        cut = {k: v[tuple(slice(0, n) for n in whole[k])].clone() for k, v in eng.cache.items()}
        unsharded_step = lambda: api.decode_step(cfg, st, params, token, cut, eng._pos)  # noqa: E731
        un["host_ms"], un["drained_wall_ms"] = host_and_wall_ms(unsharded_step, calls=3)
        un["device_busy_ms"] = device_ms(lambda i: unsharded_step(), 1, calls=1)
        un["syncs_per_step"], un["sync_sites"] = _syncs_in(unsharded_step)
        twin = None
        if L > 2 and cfg.family == "dense":
            # the planted-fault gate, at an input both sequence shards hold
            # keys of; the bf16 step there against the unsharded step is read
            # (its random cache is no served state: 5.1e-2 in norm once on
            # the card with the cache whole on its sequence)
            b_cache, b_token, b_pos = state = boundary_state(cfg, st, eng.cache, eng.pos, slots,
                                                             seed)
            got = runner(params, b_token, b_cache, b_pos)[0][:, -1].float()
            want, _ = api.decode_step(cfg, st, params, b_token,
                                      {k: v.clone() for k, v in b_cache.items()}, b_pos)
            want = want[:, -1].float()
            sh["boundary_bf16_rel_err_norm"] = ((got - want).norm() / want.norm()).item()
            twin = float32_twin_readings(cfg, st, params, mesh, runner, state, kv_seq)
            del state, b_cache
    # bf16 at 24 layers: the partitioned products round each device's
    # partial sums to bf16 before their psums (as XLA's partitioner does),
    # 3-4 such products a layer, and the logits land a few bf16 ulps away
    # per element (1.3 x bf16_chain at step 0 on the card): held in norm
    # within bf16_grad, the class of that rounding schedule
    kind = "coarse" if dtype == "float32" else "bf16_chain"
    norm_limit = None
    if L > 2:
        norm_limit = CONSIST["ssm"][0] if dtype == "float32" else TOLERANCES["bf16_grad"][0]
    if twin is not None:
        sh["dropped_psum_rel_over_limit"], sh["dropped_psum_sites"] = dropped_psum_readings(
            runner, step)
    held, parted, worst = _logits_rule(seen_s, seen_u, kind, norm_limit)
    elementwise = _logits_rule(seen_s, seen_u, kind)
    rtol, atol = TOLERANCES["bf16_chain"]
    tf = []
    rel = lambda a, b: ((a.double() - b.double()).norm() / b.double().norm()).item()  # noqa: E731
    for step_i, got, want, exact in forced:
        r = {"step": step_i, "rel_err_norm": rel(got, want),
             "err_over_bf16_chain": ((got - want).abs() / (atol + rtol * want.abs())).max().item()}
        if exact is not None:
            r.update(sharded_vs_float64=rel(got, exact), unsharded_vs_float64=rel(want, exact))
        tf.append(r)
    want_launch = {"flash_attention": L if kernel else 0, "flash_attention_bwd": 0,
                   "ssd_scan": 0, "ssd_scan_bwd": 0}
    bad = [i for i, l in enumerate(sh["launches_per_step"]) if l != want_launch]
    bad_u = [i for i, l in enumerate(un["launches_per_step"]) if l != want_launch]
    seq_sharded = [tuple(sh.dims_mapping[2]) for sh in _plan_of(runner).plan.in_shardings
                   if sh.rank == 5]
    rec = {"arch": arch, "strategy": strategy, "layers": L, "dtype": dtype, "card": card,
           "shard_kv_seq": kv_seq, "cache_seq_axes": seq_sharded, "cache_gather_steps": gathers,
           "slots": slots, "max_len": SERVE_MAX_LEN, "requests": len(prompts),
           "logits_rule": {"kind": kind, "norm_limit": norm_limit, "held": held,
                           "parted_at_step": parted, "worst_err_over_limit": worst},
           "logits_elementwise": dict(zip(("held", "parted_at_step", "worst_err_over_limit"),
                                          elementwise)),
           "teacher_forced": tf, "whole_vocab_steps": holders, "float32_twin": twin,
           **{f"sharded_{k}": v for k, v in sh.items() if k not in ("outs", "launches_per_step")},
           **{f"unsharded_{k}": v for k, v in un.items() if k not in ("outs", "launches_per_step")},
           "tokens_equal": sh["outs"] == un["outs"],
           "sharded_launches_per_step": {n: sorted({l[n] for l in sh["launches_per_step"]})
                                         for n in want_launch}}
    print(f"  {arch} {strategy} {L} layers {dtype}"
          + (f", shard_kv_seq (cache sequence on {seq_sharded}; plan steps holding a whole "
             f"cache sequence: {gathers})" if kv_seq else "")
          + f", {slots} slots: {sh['steps']} decode steps, {sh['tokens']} tokens; {card}",
          flush=True)
    rule = kind if norm_limit is None else f"{norm_limit} in norm"
    print(f"    logits vs unsharded ({rule} rule): held {held}, streams part at step {parted}, "
          f"worst err/limit before {worst:.3f}; per element: held {elementwise[0]} (parted at "
          f"{elementwise[1]}, worst {elementwise[2]:.3f}); tokens equal {rec['tokens_equal']}",
          flush=True)
    print("    from the same input, sharded vs unsharded step: " + "; ".join(
        f"step {r['step']}: {r['rel_err_norm']:.3e} in norm, {r['err_over_bf16_chain']:.3f} "
        "x bf16_chain" + (f", against the float64 step sharded {r['sharded_vs_float64']:.3e}, "
                          f"unsharded {r['unsharded_vs_float64']:.3e}"
                          if "sharded_vs_float64" in r else "") for r in tf), flush=True)
    print(f"    one plan: {len(runner.plans)}; first call {json.dumps(sh['first_call_s'])}; "
          f"plan {sh['plan_steps']} steps; collectives per step "
          f"{json.dumps(sh['collectives_per_call'])}; fallbacks {json.dumps(sh['fallbacks'])}",
          flush=True)
    for tag, r in (("sharded", sh), ("unsharded", un)):
        print(f"    {tag}: {r['tok_per_s_after_first_step']:.1f} tok/s after the first step "
              f"(first step {r['first_step_ms']:.1f} ms); step wall {r['step_wall_ms_median']:.2f} "
              f"ms (median), drained: host {r['host_ms']:.2f} ms, wall {r['drained_wall_ms']:.2f} "
              f"ms, device busy {_ms(r['device_busy_ms'])}; syncs per step "
              f"{r['syncs_per_step']} {r['sync_sites']}; peak {r['peak_gib']:.3f} GiB"
              + (f" (plan's modeled peak x8 {r['modeled_peak_x8_gib']:.3f}); cache shard "
                 f"{r['cache_shard_ms']:.3f} ms, unshard {r['cache_unshard_ms']:.3f} ms per step"
                 if "cache_shard_ms" in r else ""), flush=True)
    check(len(runner.plans) == 1 and runner.cache_stats.misses == 1,
          f"{arch} {strategy}: {len(runner.plans)} plans, {runner.cache_stats.misses} builds")
    check(not bad and not bad_u, f"{arch} {strategy}: launches off at steps {bad} (sharded), "
          f"{bad_u} (unsharded); want {want_launch} per step")
    check(not sh["fallback_gathers"], f"{arch} {strategy}: fallbacks gathered: "
          f"{sh['fallback_gathers']}")
    check(not holders, f"{arch} {strategy}: plan steps held a whole vocabulary dim: {holders}")
    check(not kv_seq or (not gathers and seq_sharded and all(a == ("data",) for a in seq_sharded)),
          f"{arch} {strategy}: the kv cache not kept sharded on its sequence: {seq_sharded}, "
          f"whole-sequence steps {gathers}")
    check(sh["done"] and all(bool(torch.isfinite(c.float()).all()) for c in eng.cache.values()),
          f"{arch} {strategy}: unfinished requests or a non-finite cache")
    check(sh["syncs_per_step"] < L, f"{arch} {strategy}: {sh['syncs_per_step']} syncs per step")
    if cfg.family == "ssm":
        # Mamba2's 24-layer stack with random weights is ill-conditioned:
        # in bf16 a rounding flip reaches the logits' leading digits within
        # one step from the same state (R6), and in float32 a batch row's
        # cancelling sums leave even the unsharded step 0.19 off the same
        # step in float64 (while the partitioned step is 2.8e-3 off it).
        # The logits against the unsharded run are read, not held; in
        # float32 each step of TEACHER_STEPS is held to the float64 step:
        # the partitioned step within 4x the unsharded step's error, or
        # within f32_chain's rtol where both are smaller
        check(all(bool(torch.isfinite(x).all()) for x in seen_s), f"{arch}: non-finite logits")
        bad = [r for r in tf if "sharded_vs_float64" in r and r["sharded_vs_float64"] > max(
            4 * r["unsharded_vs_float64"], TOLERANCES["f32_chain"][0])]
        check(not bad, f"{arch} {strategy}: the partitioned step off the float64 step: {bad}")
    else:
        check(held, f"{arch} {strategy}: logits off the unsharded run at step {parted} "
              f"({worst:.3f} x {kind})")
    if twin is not None:
        print(f"    bf16 plan, dropped psums (read): logits' change in norm over bf16_grad "
              + "; ".join(f"{x:.2f} ({site})" for x, site in
                          zip(sh["dropped_psum_rel_over_limit"], sh["dropped_psum_sites"])),
              flush=True)
        print(f"    at pos {BOUNDARY_POS}: the bf16 step against the unsharded step "
              f"{sh['boundary_bf16_rel_err_norm']:.3e} in norm (read); the float32 twin (same "
              f"collectives and reshards as the served plan: "
              f"{twin['same_collectives_as_served']}): sharded vs unsharded in "
              f"norm {twin['sound_over_limit']:.4f} x f32_chain's rtol; planted faults "
              + "; ".join(f"{k} {v:.1f}" for k, v in twin["faults_over_limit"].items())
              + f"; psum sites {json.dumps(twin['planted_psums'])}", flush=True)
        check(twin["same_collectives_as_served"],
              f"{arch} {strategy}: the float32 plan's collectives differ from the served plan's")
        check(twin["sound_over_limit"] <= 1.0,
              f"{arch} {strategy}: the float32 partitioned step off the unsharded step: {twin}")
        check(min(twin["faults_over_limit"].values()) > 1.0,
              f"{arch} {strategy}: a planted fault went unseen by the float32 limit: {twin}")
    if cfg.family == "dense":
        limit = TOLERANCES["bf16_grad"][0]
        check(all(r["rel_err_norm"] <= limit if L > 2 else r["err_over_bf16_chain"] <= 1.0
                  for r in tf), f"{arch} {strategy}: a step from the same input off: {tf}")
    del eng, runner
    torch.cuda.empty_cache()
    return rec


def _first_layers(layers, n):
    """The first ``n`` layers of a stacked param tree."""
    if isinstance(layers, dict):
        return {k: _first_layers(v, n) for k, v in layers.items()}
    return layers[:n]


def sharded_serve_phase(seed, card):
    print("partition: serving under set_mesh (the decode step as one program through "
          "spmd_partition, its plan optimized by the committed profile, its position on the "
          "card) against the same Engine unsharded", flush=True)
    return [sharded_serve_case(*case, seed, card) for case in SHARDED_SERVE]


# ---------------------------------------------------------------------------------
# the whole-program optimizer, the verifier and the guards on the card
# ---------------------------------------------------------------------------------

PLAN_OPT_B, PLAN_OPT_S = 8, 512  # the two train steps' batch
# the depth of plan_opt_phase's three paths: cut from 24 when scan_phase
# took the 24-layer train steps' optimized and unoptimized plans over
PLAN_OPT_LAYERS = 2
GUARD_STEPS, GUARD_NAN_AT = 8, 4  # the guard drill's TrainLoop


def _plan_shape(plan):
    """Steps by kind, collective launches, modeled wire bytes and the
    modeled per-device peak of one plan."""
    from repro_torch.core.plan_opt import whole_collective_launches, whole_wire_bytes

    return {"steps": len(plan.steps),
            "by_kind": dict(collections.Counter(s.kind for s in plan.steps)),
            "collective_launches": whole_collective_launches(plan),
            "wire_bytes": whole_wire_bytes(plan), "peak_x8_gib": plan.peak_bytes * 8 / 2**30}


def _tensors(out):
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]


def plan_opt_case(label, runner, args, mesh, profile, card, repeats, V, kv_seq=None):
    """One path's plan, captured and completed once (``runner.plans``' entry),
    compiled from that entry unoptimized and optimized
    (``plan_opt.optimize_plan`` under ``profile``), both verified; then the
    path run in turns (unoptimized, optimized, optimized, unoptimized) on
    the same inputs ``args`` (per turn one call, timed on the host with the
    device drained before it, then one traced call).  Gates: every output
    leaf of the optimized
    plan equal to the unoptimized plan's bit for bit where the unoptimized
    plan repeats itself bit for bit (every leaf, where ``repeats``); a leaf
    that does not repeat (the flash backward adds dq by atomics) within 4x
    the larger of the two plans' own run-to-run differences in norm; the
    same kernel launches in every turn; the verifier passing on both; no
    fallback gather and no optimized plan step holding a whole vocabulary
    dim (``V``) or, with ``kv_seq`` (the cache's length and head dim), a
    whole cache sequence.  Reads: steps, launches and wire bytes before and
    after, the OptReport's passes, the seconds of ``optimize_plan`` and
    ``verify_plan``, and per turn host, device-busy ms and peak memory."""
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.plan_opt import optimize_plan
    from repro_torch.core.plan_verify import verify_plan

    entry = _plan_of(runner)
    raw = compile_plan(entry.captured, entry.prop, mesh, optimize=False, verify=False,
                       profile=profile)
    t0 = time.perf_counter()
    plan = compile_plan(entry.captured, entry.prop, mesh, optimize=False, verify=False,
                        profile=profile)
    t1 = time.perf_counter()
    optimize_plan(plan)
    t2 = time.perf_counter()
    verify_plan(raw)
    t3 = time.perf_counter()
    verify_plan(plan)
    t4 = time.perf_counter()
    seconds = {"build": t1 - t0, "optimize_plan": t2 - t1, "verify_plan_unoptimized": t3 - t2,
               "verify_plan_optimized": t4 - t3}
    plans = {"unoptimized": raw, "optimized": plan}
    turns, outs = [], {"unoptimized": [], "optimized": []}
    mods = _kernel_modules()
    for name in ("unoptimized", "optimized", "optimized", "unoptimized"):
        entry.plan = plans[name]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods.values():
            mod.launches = 0
        with torch.no_grad():
            t0 = time.perf_counter()
            out = runner(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            host, wall = (t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3
            launched = {n: mod.launches for n, mod in mods.items()}
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            busy = device_ms(lambda i: runner(*args), 1, calls=1, warm=False)
        outs[name].append(_tensors(out))
        del out
        turns.append({"plan": name, "launches": launched, "host_ms": host, "wall_ms": wall,
                      "device_busy_ms": busy, "peak_gib": peak,
                      "modeled_peak_x8_gib": plans[name].peak_bytes * mesh.size / 2**30})
    entry.plan = plan
    with torch.no_grad():
        holders = whole_vocab_steps(runner, args, V)
        gathers = cache_gather_steps(runner, args, *kv_seq) if kv_seq else []
    fallback_gathers = list(runner.fallback_gathers)
    entry.plan = raw
    (u1, u2), (o1, o2) = outs["unoptimized"], outs["optimized"]
    unequal, noisy = [], []
    for i, (a, b, c, d) in enumerate(zip(u1, u2, o1, o2)):
        if torch.equal(a, b):
            if not (torch.equal(c, a) and torch.equal(d, a)):
                unequal.append(i)
        else:
            floor = max(_rel(b, a), _rel(d, c))
            noisy.append({"leaf": i, "rel": _rel(c, a), "floor": floor})
    del outs, u1, u2, o1, o2
    rep = plan.opt_report.as_dict()
    before, after = _plan_shape(raw), _plan_shape(plan)
    print(f"  {label}; {card}", flush=True)
    print(f"    plan before: {json.dumps(before)}", flush=True)
    print(f"    plan after:  {json.dumps(after)}", flush=True)
    print(f"    OptReport: {rep['steps_before']} -> {rep['steps_after']} steps, launches "
          f"{rep['collectives_before']} -> {rep['collectives_after']}, wire bytes "
          f"{rep['wire_bytes_before']:.0f} -> {rep['wire_bytes_after']:.0f}, fused buckets "
          f"{rep['fused_buckets']}, modeled launch s saved {rep['launch_s_saved']:.3e}, "
          f"overlap ratio {rep['overlap']['ratio']:.4f}", flush=True)
    for p in rep["passes"]:
        print(f"      {p['name']}: removed {p['removed_steps']}, wire bytes saved "
              f"{p['wire_bytes_saved']:.0f}, fused {p['fused_buckets']} buckets of "
              f"{p['fused_members']} members, moved {p['moved_steps']}", flush=True)
    print(f"    seconds: {json.dumps({k: round(v, 3) for k, v in seconds.items()})}; first "
          f"call (capture, completion, plan): {json.dumps(entry.build_s)}", flush=True)
    for t in turns:
        print(f"    {t['plan']}: host {t['host_ms']:.1f} ms, wall {t['wall_ms']:.1f} ms, device "
              f"busy {_ms(t['device_busy_ms'])} per call; peak {t['peak_gib']:.3f} GiB (plan's "
              f"modeled peak x8 {t['modeled_peak_x8_gib']:.3f}); launches {t['launches']}",
              flush=True)
    print(f"    outputs: {len(unequal)} leaves unequal where the unoptimized plan "
          f"repeats; {len(noisy)} leaves that do not repeat"
          + (f", optimized against unoptimized at most {max(n['rel'] for n in noisy):.3e} "
             f"in norm, own floor at least {min(n['floor'] for n in noisy):.3e}"
             if noisy else ""), flush=True)
    check(not unequal, f"{label}: optimized outputs differ from unoptimized at leaves {unequal}")
    check(not (repeats and noisy), f"{label}: the plans do not repeat bit for bit: {noisy[:4]}")
    off = [n for n in noisy if n["rel"] > 4 * n["floor"]]
    check(not off, f"{label}: optimized off unoptimized beyond 4x their floor: {off[:4]}")
    check(all(t["launches"] == turns[0]["launches"] for t in turns),
          f"{label}: kernel launches differ across turns: {[t['launches'] for t in turns]}")
    check(not fallback_gathers, f"{label}: fallbacks gathered: {fallback_gathers}")
    check(not holders, f"{label}: optimized plan steps held a whole vocabulary dim: {holders}")
    check(not gathers, f"{label}: optimized plan steps held a whole cache sequence: {gathers}")
    check(after["steps"] < before["steps"] and after["collective_launches"]
          <= before["collective_launches"], f"{label}: the optimizer removed nothing")
    return {"label": label, "card": card, "before": before, "after": after, "opt_report": rep,
            "seconds": seconds, "turns": turns, "unequal_leaves": unequal,
            "nonrepeating_leaves": noisy, "whole_vocab_steps": holders,
            "cache_gather_steps": gathers}


def _train_runner(cfg, st, mesh, seed, published_mamba=False):
    """The partitioned train step of ``cfg`` built through ``make_train_step``
    under ``set_mesh`` and run once (its plan captured, completed and
    compiled, optimized by default); returns the runner and the step's
    inputs."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.loop import TrainConfig, init_state, make_train_step
    from repro_torch.train.optimizer import get_optimizer

    opt = get_optimizer("adafactor")
    gen = torch.Generator("cuda").manual_seed(seed)
    with set_mesh(mesh):
        state = init_state(cfg, st, opt, TrainConfig(), gen, "cuda")
        step = make_train_step(cfg, st, opt, TrainConfig())
    if published_mamba:
        mamba2_published_init(state["params"], cfg.num_layers, gen)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, PLAN_OPT_S, PLAN_OPT_B, seed=seed,
                                    pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    step(state, batch)
    args = (tree_map(torch.Tensor.detach, state["params"]), state["opt"],
            torch.tensor(state["step"], dtype=torch.int64), batch)
    return step.runner, args


def guard_drill(seed, card, profile, mesh):
    """At two layers (qwen1.5-0.5b's published widths, bf16 compute,
    2d_finalized, B8 S512): ``TrainLoop`` under ``set_mesh`` with
    ``plan_profile`` (its plan optimized and verified),
    ``GuardConfig(rewind_after=3)`` and NaN poisoning step 4 over eight
    steps: step 4 skipped, the params after it equal those before it bit for
    bit, seven finite losses, the counters; ``Engine`` under ``set_mesh``
    with ``optimize=False`` and with its default optimized plan serving the
    same tokens; and
    ``spmd_partition(api.partitionable_loss, guard=GuardConfig())`` raising
    ``NumericsFault`` naming a non-finite leaf on a NaN token embedding
    (clean first)."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.plan import GuardConfig, NumericsFault
    from repro_torch.core.tree import leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import api
    from repro_torch.serve.engine import Engine, Request
    from repro_torch.train.loop import NumericFaultSpec, TrainConfig, TrainLoop, init_state
    from repro_torch.train.optimizer import get_optimizer

    cfg = partition_train_config(2)
    st, opt = get_strategy("2d_finalized"), get_optimizer("adafactor")
    V = cfg.vocab_size
    tc = TrainConfig(steps=GUARD_NAN_AT, log_every=10**9, guard=GuardConfig(rewind_after=3),
                     numeric_fault=NumericFaultSpec(nan_at_step=GUARD_NAN_AT))
    pipe = TokenPipeline(DataConfig(V, PLAN_OPT_S, PLAN_OPT_B, seed=seed, pattern="arithmetic"))
    events = []
    with set_mesh(mesh):
        state = init_state(cfg, st, opt, tc, torch.Generator("cuda").manual_seed(seed), "cuda")
        loop = TrainLoop(cfg, st, opt, tc, pipe, device="cuda", plan_profile=profile,
                         hooks={"numerics_fault": lambda s, f, c: events.append(
                             (s, c, [x["leaf"] for x in f][:3]))})
        state, first = loop.run(initial_state=state)
        before = [p.detach().clone() for p in leaves(state["params"])]
        tc.steps = GUARD_NAN_AT + 1
        state, poisoned = loop.run(initial_state=state)
        kept = all(torch.equal(p, q) for p, q in zip(leaves(state["params"]), before))
        tc.steps = GUARD_STEPS
        state, rest = loop.run(initial_state=state)
    plan = _plan_of(loop.step_fn.runner).plan
    losses = first + poisoned + rest
    print(f"  guard drill: qwen 2 layers, TrainLoop under set_mesh with plan_profile, NaN at "
          f"step {GUARD_NAN_AT}: losses {losses}; skipped {loop.skipped_steps}; counters "
          f"{loop.guard_counters}; params kept bit for bit {kept}; hook {events}; plan "
          f"{len(plan.steps)} steps, OptReport {plan.opt_report is not None}", flush=True)
    check(loop.skipped_steps == [GUARD_NAN_AT] and kept and not poisoned
          and len(losses) == GUARD_STEPS - 1 and all(math.isfinite(x) for x in losses)
          and loop.guard_counters == {"faults": 1, "skips": 1, "rewinds": 0}
          and plan.opt_report is not None, "the guard drill did not skip the poisoned step")
    # the same two-layer Engine unoptimized and optimized
    served = {}
    scfg, _, params = full_width_model("qwen1.5-0.5b", seed)
    scfg = scfg.with_(num_layers=2)
    params = {**params, "layers": _first_layers(params["layers"], 2)}
    rng = np.random.default_rng(seed + 70)
    prompts = [rng.integers(0, V, 8).tolist() for _ in range(8)]
    for tag, optimize in (("unoptimized", False), ("optimized", True)):
        with set_mesh(mesh):
            eng = Engine(scfg, st, params, batch_slots=8, max_len=64, plan_profile=profile,
                         optimize=optimize)
        reqs = [Request(prompt=p, max_new_tokens=4) for p in prompts]
        with torch.no_grad():
            eng.generate(reqs)
        served[tag] = [r.out for r in reqs]
        check((_plan_of(eng.runner).plan.opt_report is not None) == optimize,
              f"Engine optimize {tag}")
    print(f"  Engine at two layers with optimize=False and True served the same tokens: "
          f"{served['optimized'] == served['unoptimized']}", flush=True)
    check(served["optimized"] == served["unoptimized"], f"Engine tokens differ: {served}")
    # the guarded partitioned loss on a NaN token embedding
    runner = spmd_partition(api.partitionable_loss(cfg, st, mesh), mesh, guard=GuardConfig(),
                            profile=profile, device="cuda")
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    p = tree_map(lambda t: t.detach().clone(), state["params"])
    clean = runner(p, batch).item()
    p["embed"]["embedding"][batch["tokens"][0, 0]] = float("nan")
    try:
        runner(p, batch)
        raised = None
    except NumericsFault as e:
        raised = e
    print(f"  guarded partitioned loss: clean {clean:.6f}; NaN token embedding -> "
          f"{raised!s}", flush=True)
    check(raised is not None and any(f["kind"] == "nonfinite" for f in raised.faults),
          "the guarded loss did not raise NumericsFault on a NaN embedding")
    return {"losses": losses, "skipped_steps": loop.skipped_steps,
            "guard_counters": loop.guard_counters, "params_kept": kept, "hook": events,
            "engine_tokens_equal": True, "clean_loss": clean, "fault": str(raised)}


def plan_opt_phase(seed, card):
    """The whole-program optimizer and verifier on three paths at full width
    and ``PLAN_OPT_LAYERS`` deep on the simulated ("data" 2, "model" 4) mesh, priced by a
    committed H100 profile (``card_profile``): qwen1.5-0.5b's
    partitioned train step (2d_finalized, remat "none", B8 S512, bf16),
    its sequence-sharded decode step (``Engine(8 slots, max_len 1024)``,
    2d_attempt1, ``shard_kv_seq``) and mamba2-130m's partitioned train step
    (float32, B8 S512), each by ``plan_opt_case``; then ``guard_drill``."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compat import set_mesh
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serve.engine import Engine, Request

    t0 = time.perf_counter()
    mesh = make_test_mesh()
    profile, prof_rec = card_profile()
    from repro_torch.analysis.roofline import fusion_bucket_bytes

    cap = fusion_bucket_bytes(profile)
    print(f"plan_opt: the whole-program optimizer and verifier on the card, fusion bucket cap "
          f"{cap / 2**20:.1f} MiB (the committed profile); {card}", flush=True)
    cases = []
    cfg = partition_train_config(PLAN_OPT_LAYERS)
    runner, args = _train_runner(cfg, get_strategy("2d_finalized"), mesh, seed)
    cases.append(plan_opt_case(f"qwen1.5-0.5b train step, {PLAN_OPT_LAYERS} layers, 2d_finalized, "
                               "remat none, "
                               f"B{PLAN_OPT_B} S{PLAN_OPT_S}, bf16", runner, args, mesh,
                               profile, card, repeats=False, V=cfg.vocab_size))
    del runner, args
    torch.cuda.empty_cache()
    print(f"  at {time.perf_counter() - t0:.0f} s", flush=True)

    cfg, _, params = full_width_model("qwen1.5-0.5b", seed)
    cfg = cfg.with_(shard_kv_seq=True, num_layers=PLAN_OPT_LAYERS)
    params = {**params, "layers": _first_layers(params["layers"], PLAN_OPT_LAYERS)}
    st = get_strategy("2d_attempt1")
    with set_mesh(mesh):
        eng = Engine(cfg, st, params, batch_slots=8, max_len=SERVE_MAX_LEN)
    rng = np.random.default_rng(seed + 60)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 8).tolist(), max_new_tokens=2)
            for _ in range(8)]
    with torch.no_grad():
        eng.generate(reqs)
    eng._pos.fill_(eng.pos)
    args = (params, torch.zeros((8, 1), dtype=torch.long, device="cuda"), eng.cache, eng._pos)
    cases.append(plan_opt_case(f"qwen1.5-0.5b decode step, {PLAN_OPT_LAYERS} layers, 2d_attempt1, "
                               "shard_kv_seq, "
                               "Engine(8 slots, max_len 1024), bf16", eng.runner, args, mesh,
                               profile, card, repeats=True, V=cfg.vocab_size,
                               kv_seq=(SERVE_MAX_LEN, cfg.dh)))
    del eng, args, params
    torch.cuda.empty_cache()
    print(f"  at {time.perf_counter() - t0:.0f} s", flush=True)

    cfg = get_config("mamba2-130m").with_(num_layers=PLAN_OPT_LAYERS, dtype="float32",
                                          scan_layers=False)
    runner, args = _train_runner(cfg, get_strategy("2d_finalized"), mesh, seed,
                                 published_mamba=True)
    cases.append(plan_opt_case(f"mamba2-130m train step, {PLAN_OPT_LAYERS} layers, 2d_finalized, "
                               "float32, "
                               f"B{PLAN_OPT_B} S{PLAN_OPT_S}", runner, args, mesh, profile,
                               card, repeats=True, V=cfg.vocab_size))
    del runner, args
    torch.cuda.empty_cache()
    print(f"  at {time.perf_counter() - t0:.0f} s", flush=True)
    drill = guard_drill(seed, card, profile, mesh)
    seconds = time.perf_counter() - t0
    print(f"plan_opt: {seconds:.1f} s", flush=True)
    return {"profile": prof_rec, "fusion_bucket_bytes": cap, "cases": cases, "guard": drill,
            "seconds": seconds}


# ---------------------------------------------------------------------------------
# the scan node: each path captured scanned and unrolled
# ---------------------------------------------------------------------------------

SCAN_B, SCAN_S = 8, 512  # the train steps' batch
SCAN_TURNS = ("scanned", "unrolled", "unrolled", "scanned")
# the paths' layers, cut from the published 24 to eight for the script's
# time limit (the pipeline phase and the partition phase run 24)
SCAN_LAYERS = {"none": 8, "dots": 8, "mamba2": 8, "grad_accum": 8, "serve": 8}
SCAN_SERVE_PROMPTS, SCAN_SERVE_NEW = 8, 4  # prompts of 8 tokens, new tokens each


def _plan_parts(plan):
    """A plan's top-level steps, each scan body plan's steps (nested ones
    too) and how deep the bodies nest."""
    def depth(p):
        return max((1 + depth(s.inner) for s in p.steps if s.inner is not None), default=0)

    return {"top_steps": len(plan.steps), "body_steps": [len(b.steps) for b in plan.body_plans()],
            "depth": depth(plan)}


def _all_steps(plan):
    """The steps of a plan and of every scan body plan under it, each once."""
    return list(plan.steps) + [s for b in plan.body_plans() for s in b.steps]


def scan_turns(runners, args, mesh, profile):
    """``runners`` {"scanned", "unrolled"}, each built by a first call on
    ``args``, with unoptimized plans: one call per turn in the order
    scanned, unrolled, unrolled, scanned (kernel launches, host ms with the
    device drained before the call, wall ms, peak memory; device busy from
    one traced call after each plan's first turn); both plans verified;
    then the scanned plan compiled again optimized under ``profile``
    (verified) and run once, its outputs against its unoptimized ones bit
    for bit where the unoptimized plan repeats itself, and its launches
    against theirs.  (The unrolled plans' optimizer is ``plan_opt_phase``'s,
    at two layers: at 24 it would take this phase's budget.)  Returns the
    turns, the readings per runner and each runner's first outputs."""
    from repro_torch.core.plan import compile_plan
    from repro_torch.core.plan_verify import verify_plan

    mods = _kernel_modules()
    outs, turns = {"scanned": [], "unrolled": []}, []
    for name in SCAN_TURNS:
        run = runners[name]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for mod in mods.values():
            mod.launches = 0
        with torch.no_grad():
            t0 = time.perf_counter()
            out = run(*args)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            launched = {n: mod.launches for n, mod in mods.items()}
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            busy = (device_ms(lambda i: run(*args), 1, calls=1, warm=False)
                    if not outs[name] else None)
        outs[name].append(_tensors(out))
        del out
        turns.append({"plan": name, "launches": launched, "host_ms": (t1 - t0) * 1e3,
                      "wall_ms": wall, "device_busy_ms": busy, "peak_gib": peak})
    readings = {}
    for name, run in runners.items():
        from repro_torch.core.plan_opt import whole_collective_launches, whole_wire_bytes

        entry = _plan_of(run)
        raw = entry.plan
        first, again = outs[name]
        repeats = [torch.equal(a, b) for a, b in zip(first, again)]
        mine = [t for t in turns if t["plan"] == name]
        t0 = time.perf_counter()
        checked = [verify_plan(raw).plans]
        readings[name] = {
            "plan": _plan_parts(raw), "first_call_s": dict(entry.build_s),
            "launches_collective": whole_collective_launches(raw),
            "wire_bytes": whole_wire_bytes(raw), "verify_s": time.perf_counter() - t0,
            "verified_plans": checked, "leaves": len(first), "leaves_repeating": sum(repeats),
            "host_ms": [t["host_ms"] for t in mine],
            "device_busy_ms": [t["device_busy_ms"] for t in mine if t["device_busy_ms"]],
            "peak_gib": [t["peak_gib"] for t in mine],
            "modeled_peak_x8_gib": raw.peak_bytes * mesh.size / 2**30,
            "fallback_gathers": list(run.fallback_gathers)}
        check(not run.fallback_gathers, f"{name}: fallbacks gathered {run.fallback_gathers}")
        if name != "scanned":
            continue
        t0 = time.perf_counter()
        opt = compile_plan(entry.captured, entry.prop, mesh, optimize=True, verify=False,
                           profile=profile)
        t1 = time.perf_counter()
        checked.append(verify_plan(opt).plans)
        entry.plan = opt
        try:
            with torch.no_grad():
                got, launched = counted(lambda: _tensors(run(*args)))
        finally:
            entry.plan = raw
        unequal = [i for i, (a, r, c) in enumerate(zip(first, repeats, got))
                   if r and not torch.equal(a, c)]
        rep = opt.opt_report.as_dict()
        readings[name].update({
            "plan_optimized": _plan_parts(opt), "optimize_s": t1 - t0,
            "hoisted_reshards": rep["hoisted_reshards"], "opt_report": rep,
            # buckets fused inside body plans, at trip count (the report is
            # the outer plan's own passes)
            "body_fused_buckets": sum(s.call["trips"] * s.inner.opt_report.fused_buckets
                                      for s in opt.steps if s.inner is not None),
            "launches_optimized": launched, "optimized_unequal_leaves": unequal})
        check(not unequal, f"{name}: the optimized plan's outputs differ from the unoptimized "
              f"plan's at leaves {unequal}")
        check(launched == mine[0]["launches"], f"{name}: the optimized plan launched {launched}, "
              f"the unoptimized {mine[0]['launches']}")
    del outs["scanned"][1:], outs["unrolled"][1:]
    check(all(t["launches"] == turns[0]["launches"] for t in turns),
          f"scanned and unrolled launches differ: {[t['launches'] for t in turns]}")
    return turns, readings, {n: o[0] for n, o in outs.items()}


def _scan_print(label, card, readings, vs):
    print(f"  {label}; {card}", flush=True)
    for name in ("scanned", "unrolled"):
        r = readings[name]
        print(f"    {name}: plan {json.dumps(r['plan'])}; first call "
              f"{json.dumps({k: round(v, 2) for k, v in r['first_call_s'].items()})}; host ms per "
              f"call {', '.join(f'{x:.1f}' for x in r['host_ms'])}; device busy "
              f"{', '.join(_ms(x) for x in r['device_busy_ms'])}; peak "
              f"{', '.join(f'{x:.3f}' for x in r['peak_gib'])} GiB (plan's modeled peak x8 "
              f"{r['modeled_peak_x8_gib']:.3f}); collective launches {r['launches_collective']}"
              f", wire bytes {r['wire_bytes']:.0f} at trip count; leaves repeating "
              f"{r['leaves_repeating']} of {r['leaves']}; verified {r['verified_plans']} plans "
              f"in {r['verify_s']:.2f} s", flush=True)
        if "opt_report" not in r:
            continue
        rep = r["opt_report"]
        passes = ", ".join(f"{p['name']} -{p['removed_steps']}"
                           + (f" ({p['fused_buckets']} buckets)" if p["fused_buckets"] else "")
                           + (f" ({p['hoisted_reshards']} hoisted)" if p["hoisted_reshards"]
                              else "")
                           for p in rep["passes"])
        print(f"      optimized: plan {json.dumps(r['plan_optimized'])} in {r['optimize_s']:.2f} "
              f"s; launches {r['launches_optimized']}; OptReport: collective launches "
              f"{rep['collectives_before']} -> {rep['collectives_after']}, wire bytes "
              f"{rep['wire_bytes_before']:.0f} -> {rep['wire_bytes_after']:.0f}; passes "
              f"{passes}; buckets fused in body plans at trip count {r['body_fused_buckets']}",
              flush=True)
    print(f"    scanned against unrolled: {json.dumps(vs)}", flush=True)


def _scan_vs(first, names, kind_loss, limit_grad, skip=()):
    """Scanned against unrolled on a gradient program's outputs (the loss,
    then the gradient leaves ``names``): bit-equal or not, the largest
    element difference, the loss's err over ``kind_loss`` and each leaf's
    relative error in norm (``skip`` printed, not gated)."""
    s, u = first["scanned"], first["unrolled"]
    rel = {n: _rel(a, b) for n, a, b in zip(names, s[1:], u[1:])}
    gated = [n for n in rel if n not in skip]
    worst = max(gated, key=rel.get)
    return {"bit_equal": all(torch.equal(a, b) for a, b in zip(s, u)),
            "max_abs_diff": max((a.double() - b.double()).abs().max().item() for a, b in zip(s, u)),
            "loss_err_over_limit": _err_over(s[0], u[0], kind_loss),
            "grad_rel_max": [worst, rel[worst]], "grad_over_limit": rel[worst] / limit_grad,
            "skipped": {n: rel[n] for n in skip if n in rel}}


def _body_psum_fault(run, args, first, names, limit):
    """The planted fault inside a scan body: the reverse body's largest
    standalone psum over "data" (a weight gradient's sum over the batch;
    the largest of any axes where none is over "data") replaced by the
    local value, the scanned plan run once; the largest leaf error over
    ``limit`` against the unrolled run, and the psum's site."""
    from repro_torch.core import plan as plan_mod

    plan = _plan_of(run).plan
    body = plan.body_plans()[-1]
    psums = [s for s in body.steps if s.kind == "collective" and s.reduce_op == "add"]
    check(psums, "the reverse scan body holds no standalone psum to drop")
    fault = max([s for s in psums if "data" in s.axes] or psums, key=lambda s: s.in_bytes)
    saved, fault.run = fault.run, plan_mod._alias_run
    try:
        with torch.no_grad():
            got = _tensors(run(*args))
    finally:
        fault.run = saved
    rel = max(_rel(a, b) for a, b in zip(got[1:], first["unrolled"][1:]))
    return {"site": _psum_sites(body, [fault])[0], "grad_over_limit": rel / limit}


def _grad_runners(cfgs, st, mesh, params, batch):
    """The gradient program of each config (``sharded_value_and_grad``)
    partitioned with an unoptimized plan and built by a first call."""
    from repro_torch.core.compat import set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.train.loop import sharded_value_and_grad

    runners = {}
    for name, cfg in cfgs.items():
        with set_mesh(mesh):
            runners[name] = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh,
                                           optimize=False, device="cuda")
        with torch.no_grad():
            runners[name](params, batch)
        torch.cuda.synchronize()
    return runners


def scan_train_case(remat, seed, card, mesh, profile):
    """qwen1.5-0.5b's partitioned train step at its published widths,
    ``SCAN_LAYERS[remat]`` layers, 2d_finalized, B8 S512, bf16 compute with
    float32 masters,
    ``remat``: its gradient program (``sharded_value_and_grad``) captured
    with the layer loop scanned and unrolled, by ``scan_turns``.  Gates:
    the loss within f32_chain and each gradient leaf in norm within
    bf16_grad (the key bias, whose gradient is 0, read only) of the
    unrolled run; flash launches per call equal (L + L under "none", 2L +
    L under "dots"); the planted dropped psum in the reverse body beyond
    that limit; the verifier on every plan; optimized equal to unoptimized
    where the unoptimized plan repeats itself; no fallback gather."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.loop import TrainConfig, init_state
    from repro_torch.train.optimizer import get_optimizer

    t0 = time.perf_counter()
    cfg = partition_train_config(SCAN_LAYERS[remat], remat)
    st, L = get_strategy("2d_finalized"), cfg.num_layers
    with set_mesh(mesh):
        state = init_state(cfg, st, get_optimizer("adafactor"), TrainConfig(),
                           torch.Generator("cuda").manual_seed(seed), "cuda")
    params = tree_map(torch.Tensor.detach, state["params"])
    del state
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SCAN_S, SCAN_B, seed=seed,
                                    pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    runners = _grad_runners({"scanned": cfg.with_(scan_layers=True), "unrolled": cfg}, st, mesh,
                            params, batch)
    turns, readings, first = scan_turns(runners, (params, batch), mesh, profile)
    names = ["/".join(p) for p, _ in leaves_with_paths(params)]
    limit = TOLERANCES["bf16_grad"][0]
    vs = _scan_vs(first, names, "f32_chain", limit, skip=(KEY_BIAS,))
    vs["planted"] = _body_psum_fault(runners["scanned"], (params, batch), first, names, limit)
    del first, runners
    label = f"qwen1.5-0.5b train step, {L} layers, 2d_finalized, remat {remat}, B{SCAN_B} S{SCAN_S}"
    _scan_print(label, card, readings, vs)
    want = {"flash_attention": L if remat == "none" else 2 * L, "flash_attention_bwd": L,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
    check(turns[0]["launches"] == want, f"{label}: launched {turns[0]['launches']}, want {want}")
    check(vs["loss_err_over_limit"] <= 1.0 and vs["grad_over_limit"] <= 1.0,
          f"{label}: scanned off unrolled: {vs}")
    check(vs["planted"]["grad_over_limit"] > 1.0, f"{label}: the planted fault went unseen: "
          f"{vs['planted']}")
    seconds = time.perf_counter() - t0
    print(f"    {seconds:.1f} s", flush=True)
    return {"label": label, "card": card, "turns": turns, "readings": readings, "vs": vs,
            "seconds": seconds}


def scan_mamba_case(seed, card, mesh, profile):
    """mamba2-130m's partitioned train step, ``SCAN_LAYERS["mamba2"]``
    layers, 2d_finalized, B8 S512, remat "dots", from
    ``mamba2_published_init``'s weights: its gradient program scanned and
    unrolled in float32 by ``scan_turns`` (the SSD launches equal, 2L + L
    per call; bit-equality read), then both in
    float64 with the SSD and its gradient on the plain route (the gate of
    ``partition_mamba_float64_case``): the loss and each gradient leaf in
    norm within 1e-8 of the unrolled run."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.train.loop import TrainConfig, init_state
    from repro_torch.train.optimizer import get_optimizer

    t0 = time.perf_counter()
    cfg = get_config("mamba2-130m").with_(num_layers=SCAN_LAYERS["mamba2"], dtype="float32",
                                          scan_layers=False)
    st, L = get_strategy("2d_finalized"), cfg.num_layers
    gen = torch.Generator("cuda").manual_seed(seed)
    with set_mesh(mesh):
        state = init_state(cfg, st, get_optimizer("adafactor"), TrainConfig(), gen, "cuda")
    mamba2_published_init(state["params"], L, gen)
    params = tree_map(torch.Tensor.detach, state["params"])
    del state
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SCAN_S, SCAN_B, seed=seed,
                                    pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    names = ["/".join(p) for p, _ in leaves_with_paths(params)]
    runners = _grad_runners({"scanned": cfg.with_(scan_layers=True), "unrolled": cfg}, st, mesh,
                            params, batch)
    turns, readings, first = scan_turns(runners, (params, batch), mesh, profile)
    vs = _scan_vs(first, names, "f32_chain", TOLERANCES["f32_chain"][0])
    del first, runners
    torch.cuda.empty_cache()
    p64 = tree_map(torch.Tensor.double, params)
    cfg64 = cfg.with_(dtype="float64")
    route = ops._route
    ops._route = lambda t: "cpu"  # the plain versions, on the card's tensors
    try:
        runners = _grad_runners({"scanned": cfg64.with_(scan_layers=True), "unrolled": cfg64},
                                st, mesh, p64, batch)
        with torch.no_grad():
            (s64, u64), launched = counted(lambda: [_tensors(r(p64, batch))
                                                    for r in runners.values()])
    finally:
        ops._route = route
    rel64 = {n: _rel(a, b) for n, a, b in zip(["loss"] + names, s64, u64)}
    worst = max(rel64, key=rel64.get)
    vs["float64"] = {"bit_equal": all(torch.equal(a, b) for a, b in zip(s64, u64)),
                     "rel_max": [worst, rel64[worst]],
                     "top_steps": [len(_plan_of(r).plan.steps) for r in runners.values()]}
    del s64, u64, runners, p64
    label = f"mamba2-130m train step, {L} layers, 2d_finalized, float32, dots, B{SCAN_B} S{SCAN_S}"
    _scan_print(label, card, readings, vs)
    want = {"flash_attention": 0, "flash_attention_bwd": 0, "ssd_scan": 2 * L, "ssd_scan_bwd": L}
    check(turns[0]["launches"] == want, f"{label}: launched {turns[0]['launches']}, want {want}")
    check(not any(launched.values()), f"{label}: the float64 plain route launched {launched}")
    check(rel64[worst] <= 1e-8, f"{label}: float64 scanned off unrolled: {vs['float64']}")
    seconds = time.perf_counter() - t0
    print(f"    {seconds:.1f} s", flush=True)
    return {"label": label, "card": card, "turns": turns, "readings": readings, "vs": vs,
            "seconds": seconds}


def scan_grad_accum_case(seed, card, mesh):
    """qwen1.5-0.5b's partitioned train step with ``grad_accum=2``
    (microbatches of 4), ``SCAN_LAYERS["grad_accum"]`` layers, 2d_finalized,
    B8 S512, remat "none",
    the layer loop scanned: the microbatch loop one scan whose body holds
    the layers' scan and its reverse scan.  Its gradient program against
    ``value_and_grad(grad_accum=2)`` unsharded on the card, as
    ``partition_train_case`` holds the partitioned step's: the loss within
    bf16_chain, each gradient leaf (the key bias read only) in norm within
    bf16_grad; per call two flash launches forward and two backward per
    layer; body plans two deep; no fallback gather (``TrainLoop`` with
    ``grad_accum`` 2 under the mesh runs in tests/test_torch_scan.py
    against the reference)."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.plan_verify import verify_plan
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.train.loop import (TrainConfig, init_state, sharded_value_and_grad,
                                        value_and_grad)
    from repro_torch.train.optimizer import get_optimizer

    t0 = time.perf_counter()
    cfg = partition_train_config(SCAN_LAYERS["grad_accum"], "none").with_(scan_layers=True)
    st, L, opt = get_strategy("2d_finalized"), cfg.num_layers, get_optimizer("adafactor")
    with set_mesh(mesh):
        state0 = init_state(cfg, st, opt, TrainConfig(),
                            torch.Generator("cuda").manual_seed(seed), "cuda")
    params = tree_map(torch.Tensor.detach, state0["params"])
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SCAN_S, SCAN_B, seed=seed,
                                    pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    with set_mesh(mesh):
        runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh, grad_accum=2), mesh,
                                optimize=False, device="cuda")
    with torch.no_grad():
        (loss_s, grads_s), launched = counted(lambda: runner(params, batch))
        torch.cuda.synchronize()
        host, wall = host_and_wall_ms(lambda: runner(params, batch), calls=3)
        busy = device_ms(lambda i: runner(params, batch), 1, calls=1)
    entry = _plan_of(runner)
    plan, fallback_gathers, first = entry.plan, list(runner.fallback_gathers), dict(entry.build_s)
    live = tree_map(lambda p: p.clone().requires_grad_(), params)
    loss_u, grads_u = value_and_grad(cfg, st, live, batch, grad_accum=2)
    del live
    names = ["/".join(p) for p, _ in leaves_with_paths(params)]
    rel = {n: _rel(g, u) for n, g, u in zip(names, leaves(grads_s), leaves(grads_u))}
    gated = [n for n in rel if n != KEY_BIAS]
    worst = max(gated, key=rel.get)
    loss_over = _err_over(loss_s, loss_u, "bf16_chain")
    verified = verify_plan(plan).plans
    parts = _plan_parts(plan)
    del grads_s, grads_u, runner, entry, plan
    torch.cuda.empty_cache()
    label = f"qwen1.5-0.5b train step, grad_accum 2, {L} layers, 2d_finalized, B{SCAN_B} S{SCAN_S}"
    limit = TOLERANCES["bf16_grad"][0]
    rec = {"label": label, "card": card, "plan": parts, "first_call_s": first,
           "verified_plans": verified, "launches": launched, "host_ms": host, "wall_ms": wall,
           "device_busy_ms": busy, "loss_sharded": loss_s.item(), "loss_unsharded": loss_u.item(),
           "loss_err_over_bf16_chain": loss_over, "grad_rel_max": [worst, rel[worst]],
           "key_bias_rel": rel.get(KEY_BIAS), "fallback_gathers": fallback_gathers}
    print(f"  {label}; {card}", flush=True)
    print(f"    plan {json.dumps(parts)} (nested body plans), {verified} plans verified; first "
          f"call {json.dumps({k: round(v, 2) for k, v in first.items()})}; "
          f"launches {launched}; host {host:.1f} ms, wall {wall:.1f} ms, device busy "
          f"{_ms(busy)} per call; loss sharded {loss_s.item():.6f} unsharded "
          f"{loss_u.item():.6f} (err/bf16_chain {loss_over:.3f}); gradient per leaf in norm at "
          f"most {rel[worst]:.3e} ({worst}; bf16_grad {limit})", flush=True)
    want = {"flash_attention": 2 * L, "flash_attention_bwd": 2 * L, "ssd_scan": 0,
            "ssd_scan_bwd": 0}
    check(launched == want, f"{label}: launched {launched}, want {want}")
    check(parts["depth"] == 2, f"{label}: body plans nest {parts['depth']} deep, want 2")
    check(loss_over <= 1.0 and rel[worst] <= limit, f"{label}: off the unsharded step: {rec}")
    check(not fallback_gathers, f"{label}: fallbacks gathered {fallback_gathers}")
    rec["seconds"] = time.perf_counter() - t0
    print(f"    {rec['seconds']:.1f} s", flush=True)
    return rec


def _stacked_cache_writes(runner, args, L, dh):
    """How many whole stacked caches (stacked shards holding the layer dim
    and the head dim) each op's plan steps write in one call, scan bodies
    included; a getitem (the scan's ys taken out of its results) and an
    alias or unchanged annotation write no new tensor and are left out."""
    from torch.utils._pytree import tree_flatten

    from repro_torch.core import mesh_runtime as mr

    plan = _plan_of(runner).plan
    n = collections.Counter()

    def look(step, env):
        if step.op in ("getitem", "alias", "annotate"):
            return
        for w in step.writes:
            vals = env[w] if isinstance(env[w], list) else [env[w]]
            n[step.op] += sum(1 for t in vals if isinstance(t, torch.Tensor) and t.ndim >= 6
                              and t.shape[1] == L and t.shape[-1] == dh)

    with torch.no_grad():
        plan.execute(*(mr.shard(a, s) for a, s in zip(tree_flatten(args)[0], plan.in_shardings)),
                     on_step=look)
    return +n


def scan_serve_case(arch, strategy, dtype, kv_seq, seed, card, mesh):
    """``Engine(8 slots, max_len 1024)`` under ``set_mesh`` serving 8
    prompts of 8 tokens, 4 new each, with the decode step's layer loop
    scanned and unrolled (each its own engine, the same weights): tokens
    equal; per engine host and wall ms of one decode call (device drained
    before), device busy (one traced call), peak, plan steps, the whole
    stacked caches the plan's steps write (no more scanned than unrolled).
    With ``kv_seq`` (qwen), the planted-fault gate on the scanned plan's
    float32 twin (``float32_twin_readings``, its psums taken from the
    body plan)."""
    from repro_torch.configs.base import get_strategy

    t0 = time.perf_counter()
    cfg, _, params = full_width_model(arch, seed, dtype=dtype)
    cfg = cfg.with_(shard_kv_seq=kv_seq, num_layers=SCAN_LAYERS["serve"])
    params = {**params, "layers": _first_layers(params["layers"], cfg.num_layers)}
    st = get_strategy(strategy)
    rng = np.random.default_rng(seed + 70)
    prompts = [rng.integers(0, cfg.vocab_size, 8).tolist() for _ in range(SCAN_SERVE_PROMPTS)]
    runs, twin = {}, None
    for name, scan in (("scanned", True), ("unrolled", False)):
        c = cfg.with_(scan_layers=scan)
        eng, rec, _, _ = serve_run(c, st, params, mesh, prompts, SCAN_SERVE_NEW)
        args = (params, torch.zeros((len(prompts), 1), dtype=torch.long, device="cuda"),
                eng.cache, eng._pos)
        with torch.no_grad():
            host, wall = host_and_wall_ms(lambda: eng.runner(*args), calls=3)
            busy = device_ms(lambda i: eng.runner(*args), 1, calls=1)
            holders = _stacked_cache_writes(eng.runner, args, cfg.num_layers,
                                            args[2][next(iter(args[2]))].shape[-1])
        entry = _plan_of(eng.runner)
        runs[name] = {"outs": rec["outs"], "host_ms": host, "wall_ms": wall,
                      "device_busy_ms": busy, "peak_gib": rec["peak_gib"],
                      "step_wall_ms_median": rec["step_wall_ms_median"],
                      "launches_per_step": rec["launches_per_step"][-1],
                      "plan": _plan_parts(entry.plan), "first_call_s": dict(entry.build_s),
                      "stacked_cache_writes": holders,
                      "fallback_gathers": list(eng.runner.fallback_gathers)}
        if kv_seq and scan:
            state = boundary_state(c, st, eng.cache, eng.pos, len(prompts), seed)
            twin = float32_twin_readings(c, st, params, mesh, eng.runner, state, kv_seq)
        del eng, args
        torch.cuda.empty_cache()
    s, u = runs["scanned"], runs["unrolled"]
    label = (f"{arch} Engine under {strategy}{', shard_kv_seq' if kv_seq else ''}, "
             f"{cfg.num_layers} layers, {dtype or cfg.dtype}, {len(prompts)} slots")
    print(f"  {label}; {card}", flush=True)
    for name, r in runs.items():
        print(f"    {name}: plan {json.dumps(r['plan'])}; first call "
              f"{json.dumps({k: round(v, 2) for k, v in r['first_call_s'].items()})}; host "
              f"{r['host_ms']:.1f} ms, wall {r['wall_ms']:.1f} ms, device busy "
              f"{_ms(r['device_busy_ms'])} per decode call; served step wall "
              f"{r['step_wall_ms_median']:.1f} ms; peak {r['peak_gib']:.3f} GiB; launches per "
              f"step {r['launches_per_step']}; whole stacked caches written "
              f"{dict(r['stacked_cache_writes'])}", flush=True)
    if twin is not None:
        print(f"    float32 twin of the scanned plan: sound {twin['sound_over_limit']:.4f} of "
              f"f32_chain's rtol; planted faults "
              f"{json.dumps({k: round(v, 2) for k, v in twin['faults_over_limit'].items()})} at "
              f"{json.dumps(twin['planted_psums'])}", flush=True)
    check(s["outs"] == u["outs"], f"{label}: scanned tokens {s['outs']} unrolled {u['outs']}")
    check(s["launches_per_step"] == u["launches_per_step"],
          f"{label}: launches {s['launches_per_step']} against {u['launches_per_step']}")
    check(sum(s["stacked_cache_writes"].values()) <= sum(u["stacked_cache_writes"].values()),
          f"{label}: the scanned plan writes whole stacked caches "
          f"{dict(s['stacked_cache_writes'])}, the unrolled {dict(u['stacked_cache_writes'])}")
    check(not s["fallback_gathers"] and not u["fallback_gathers"], f"{label}: fallbacks gathered")
    if twin is not None:
        check(twin["sound_over_limit"] <= 1.0 and all(
            v > 1.0 for v in twin["faults_over_limit"].values()),
            f"{label}: the float32 twin's planted-fault gate failed: {twin}")
    seconds = time.perf_counter() - t0
    print(f"    {seconds:.1f} s", flush=True)
    return {"label": label, "card": card, "runs": {k: {**v, "stacked_cache_writes": dict(
        v["stacked_cache_writes"])} for k, v in runs.items()}, "twin": twin, "seconds": seconds}


def scan_phase(seed, card):
    """The scan node on the card (``core/scan.py``): each path captured with
    the layer loop scanned and unrolled, on the simulated ("data" 2,
    "model" 4) mesh, priced by the committed H100 profile: qwen's
    partitioned train step under remat "none" and "dots" and Mamba2's
    (``scan_train_case``, ``scan_mamba_case``), qwen's with ``grad_accum``
    2 (``scan_grad_accum_case``), and ``Engine`` for qwen with
    ``shard_kv_seq`` and Mamba2 in float32 (``scan_serve_case``)."""
    from repro_torch.launch.mesh import make_test_mesh

    t0 = time.perf_counter()
    mesh = make_test_mesh()
    profile, prof_rec = card_profile()
    print(f"scan: the scan node, each path scanned and unrolled on the card; {card}", flush=True)
    cases = []
    for remat in ("none", "dots"):
        cases.append(scan_train_case(remat, seed, card, mesh, profile))
        torch.cuda.empty_cache()
    cases.append(scan_mamba_case(seed, card, mesh, profile))
    torch.cuda.empty_cache()
    cases.append(scan_grad_accum_case(seed, card, mesh))
    torch.cuda.empty_cache()
    cases.append(scan_serve_case("qwen1.5-0.5b", "2d_attempt1", None, True, seed, card, mesh))
    cases.append(scan_serve_case("mamba2-130m", "2d_finalized", "float32", False, seed, card,
                                 mesh))
    seconds = time.perf_counter() - t0
    print(f"scan: {seconds:.1f} s", flush=True)
    return {"profile": prof_rec, "cases": cases, "seconds": seconds}


# ---------------------------------------------------------------------------------
# observability: the partitioned train step traced, calibrated and fitted
# ---------------------------------------------------------------------------------

OBS_REPEATS = 3  # tight timing's timed repeats per plan step


def obs_phase(seed, card):
    """The observability layer (``repro_torch/obs``) under qwen1.5-0.5b's
    partitioned train step at its published widths (``SCAN_LAYERS["none"]``
    layers scanned, remat "none", 2d_finalized, B8 S512, bf16 compute,
    float32 masters, Adafactor) on the simulated ("data" 2, "model" 4) mesh,
    built by ``make_train_step`` under ``set_mesh`` (its plan optimized and
    verified, priced by the committed profile) and run untraced twice and
    under ``TraceConfig(timing="tight")``: the traced outputs bit-equal to
    the untraced ones where two untraced calls repeat themselves, else
    within bf16_grad in norm per leaf (the flash backward's atomics), the
    traced call's path launches equal to the untraced call's (the timed
    repeats' launches counted apart), the Chrome trace valid, the per-class
    calibration table, a profile fitted to the spans beside the committed
    one, and the allocator's peak of an untraced call beside the plan's
    modeled peak."""
    from repro_torch.analysis.roofline import PROFILE_FILE
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.obs import (MachineProfile, TraceConfig, attach_profile,
                                 calibration_report, collect_samples, device_memory_stats,
                                 fit_profile, memory_report, rescore_report,
                                 validate_trace_events)
    from repro_torch.train.loop import TrainConfig, init_state, make_train_step
    from repro_torch.train.optimizer import get_optimizer

    t0 = time.perf_counter()
    mesh = make_test_mesh()
    committed = MachineProfile.load(PROFILE_FILE)
    cfg = partition_train_config(SCAN_LAYERS["none"]).with_(scan_layers=True)
    st, opt, L = get_strategy("2d_finalized"), get_optimizer("adafactor"), cfg.num_layers
    label = (f"qwen1.5-0.5b train step, {L} layers scanned, 2d_finalized, remat none, "
             f"B{SCAN_B} S{SCAN_S}, bf16")
    print(f"obs: plan-step tracing, calibration and a fitted profile under the {label}; {card}",
          flush=True)
    with set_mesh(mesh):
        state = init_state(cfg, st, opt, TrainConfig(), torch.Generator("cuda").manual_seed(seed),
                           "cuda")
        step = make_train_step(cfg, st, opt, TrainConfig())
        traced_step = make_train_step(cfg, st, opt, TrainConfig(),
                                      trace=TraceConfig(timing="tight", repeats=OBS_REPEATS))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SCAN_S, SCAN_B, seed=seed,
                                    pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    twin = {**state, "params": tree_map(lambda t: t.detach().clone(), state["params"]),
            "opt": tree_map(torch.Tensor.clone, state["opt"])}
    step(state, batch)
    first_s = time.perf_counter() - t0
    traced_step(twin, batch)  # the traced runner's capture, plan and first traced call
    del twin
    runner, traced = step.runner, traced_step.runner
    tracer = traced.tracer
    args = (tree_map(torch.Tensor.detach, state["params"]), state["opt"],
            torch.tensor(state["step"], dtype=torch.int64), batch)
    plan = _plan_of(runner).plan
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = device_memory_stats()
    with torch.no_grad():
        want, launches = counted(lambda: runner(*args))
    mem = memory_report(plan, mem0, device_memory_stats())
    with torch.no_grad():
        again, _ = counted(lambda: runner(*args))
    flat_want = _tensors(want)
    repeats = all(torch.equal(a, b) for a, b in zip(flat_want, _tensors(again)))
    del again
    path0, timing0 = dict(tracer.launches["path"]), dict(tracer.launches["timing"])
    with torch.no_grad():
        got, traced_launches = counted(lambda: traced(*args))
    path = {k: tracer.launches["path"][k] - path0.get(k, 0) for k in launches}
    timing = {k: tracer.launches["timing"][k] - timing0.get(k, 0) for k in launches}
    flat_got = _tensors(got)
    equal = len(flat_got) == len(flat_want) and all(
        torch.equal(a, b) for a, b in zip(flat_got, flat_want))
    diverged = [i for i, (a, b) in enumerate(zip(flat_got, flat_want)) if not torch.equal(a, b)]
    # where two untraced calls differ (the flash backward adds dq by
    # atomics), the traced call is held to them in norm per leaf instead
    worst_rel = max((_rel(a, b) for a, b in zip(flat_got, flat_want)
                     if a.is_floating_point()), default=0.0)
    same_shapes = len(flat_got) == len(flat_want) and all(
        a.shape == b.shape and a.dtype == b.dtype for a, b in zip(flat_got, flat_want))
    del got, want
    doc = tracer.chrome_trace()
    problems = validate_trace_events(doc["traceEvents"])
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path = tracer.write(str(out_dir / "obs_train_step_trace.json"))
    report = calibration_report(doc)
    spans = tracer.measured_events()
    samples = collect_samples(_plan_of(traced).plan, spans)
    fitted = fit_profile(samples, committed.params, device=card,
                         source=f"chip_smoke.obs_phase: tight spans of the {label}")
    attach_profile(report, fitted)
    rescore = rescore_report(samples, fitted.params, committed.params)
    gib = 2 ** 30
    print(f"  plan: {len(plan.steps)} steps, optimized {plan.opt_report is not None}, priced by "
          f"the committed profile {plan.params == committed.params}; first call {first_s:.1f} s",
          flush=True)
    print(f"  untraced calls repeat bit for bit: {repeats}; traced (tight, {OBS_REPEATS} "
          f"repeats) == untraced bit for bit: {equal}"
          + (f" (leaves differing: {diverged[:8]})" if diverged else "")
          + f"; largest relative error in norm of a leaf {worst_rel:.3e} (bf16_grad "
          f"{TOLERANCES['bf16_grad'][0]} where the untraced calls do not repeat)", flush=True)
    print(f"  launches: untraced {launches}; traced call's path {path}, its timed repeats "
          f"{timing}, counted {traced_launches}", flush=True)
    print(f"  Chrome trace: {len(doc['traceEvents'])} events ({len(spans)} measured spans over "
          f"{tracer.calls} traced calls), {len(problems)} problems; written to "
          f"{os.path.relpath(trace_path, ROOT)}", flush=True)
    print("  calibration (measured tight seconds / modeled seconds by the committed profile, "
          f"per traced call; {card}):", flush=True)
    print("    " + report.table().replace("\n", "\n    "), flush=True)
    print(f"  profile fitted to these spans ({fitted.n_samples} samples, {fitted.dropped} "
          f"dropped, fitted {fitted.fitted}) beside the committed one ({committed.device}):",
          flush=True)
    for k, v in sorted(fitted.params.as_dict().items()):
        print(f"    {k:<20} {v:.6g}  (committed {committed.params.as_dict()[k]:.6g})", flush=True)
    print(f"    residuals under the fit {fitted.residuals}, flagged {fitted.flagged}; rescored "
          f"in-band classes {rescore['in_band_classes']}, improved all "
          f"{rescore['improved_all']}", flush=True)
    print(f"  memory of an untraced call ({card}): allocator peak "
          f"{mem['measured_peak_bytes'] / gib:.3f} GiB (live after "
          f"{mem['measured_live_bytes'] / gib:.3f}, peak above the start "
          f"{mem['measured_peak_delta_bytes'] / gib:.3f}) against plan_peak_bytes "
          f"{mem['modeled_peak_bytes'] / gib:.3f} GiB a device x {mem['devices']} = "
          f"{mem['modeled_peak_bytes_all_devices'] / gib:.3f} GiB", flush=True)
    seconds = time.perf_counter() - t0
    print(f"obs: {seconds:.1f} s", flush=True)
    check(problems == [], f"obs: the Chrome trace has problems: {problems[:5]}")
    check(equal if repeats else same_shapes and worst_rel <= TOLERANCES["bf16_grad"][0],
          f"obs: traced outputs differ from untraced: leaves {diverged[:8]}, largest relative "
          f"error in norm {worst_rel:.3e} (untraced calls repeat: {repeats})")
    check(path == launches and launches["flash_attention"] == L
          and launches["flash_attention_bwd"] == L,
          f"obs: launches untraced {launches}, traced path {path}")
    check(traced_launches == {k: path[k] + timing[k] for k in launches},
          f"obs: the counters {traced_launches} are not path {path} + timing {timing}")
    check(report.complete, f"obs: a priced class has no measured span: {report.as_dict()}")
    del state, args, runner, traced, step, traced_step
    torch.cuda.empty_cache()
    return {"label": label, "card": card, "plan_steps": len(plan.steps),
            "untraced_repeats": repeats, "traced_equal": equal, "diverged_leaves": diverged,
            "traced_rel_err_max": worst_rel,
            "launches": launches, "traced_path_launches": path,
            "traced_timing_launches": timing, "trace_events": len(doc["traceEvents"]),
            "trace_problems": problems, "calibration": report.as_dict(),
            "fitted_profile": fitted.as_dict(), "committed_profile": committed.as_dict(),
            "rescore": rescore, "memory": mem, "first_call_s": first_s, "seconds": seconds}


# ---------------------------------------------------------------------------------
# autoshard: the annotation-free sharding search behind spmd_partition(autoshard=)
# ---------------------------------------------------------------------------------

AUTOSHARD_KNOBS = dict(top_n=3, sa_steps=4, max_candidates=8)  # the golden tests' knobs


def annotation_free_value_and_grad(cfg, st):
    """``value_and_grad`` as a program with no mesh set and no annotation:
    what ``spmd_partition(autoshard=)`` searches the input shardings of."""
    from repro_torch.core.tree import tree_map
    from repro_torch.train.loop import value_and_grad

    def program(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            return value_and_grad(cfg, st, live, batch)

    return program


def autoshard_phase(seed, card):
    """The autoshard search (``repro_torch/autoshard``) behind
    ``spmd_partition(autoshard=)`` on the annotation-free loss and gradient
    of qwen1.5-0.5b at its published widths (``SCAN_LAYERS["none"]`` layers
    scanned, remat "none", B8 S512, bf16 compute, float32 masters) on the
    simulated ("data" 2, "model" 4) mesh, with the golden tests' knobs and
    the budget midway between the modeled peaks of the replicated and the
    Table-1 assignments (``sharded_value_and_grad``'s annotations on the
    same inputs), both priced by the port's ``Evaluator`` under the
    committed profile.  Gates: a feasible assignment, modeled no slower
    than the baseline, its plan's modeled peak within the budget; loss and
    gradients within bf16_grad in norm per leaf of the unsharded
    ``value_and_grad`` on the card (the key bias, whose gradient is 0, read
    only); one flash forward and one backward launch a layer, each over all
    eight simulated devices; no fallback gather and no whole-vocabulary
    plan step; a second call site with the same config lowers nothing
    new.  Printed: the assignment by leaf path, the search's evals and
    seconds, both assignments' modeled terms, their device busy on the card
    beside the modeled ratio, and the allocator's peak beside the plan's."""
    import dataclasses

    from repro_torch import autoshard
    from repro_torch.autoshard import api as as_api
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, capture, set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.tree import leaves_with_paths, tree_from_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import api as model_api
    from repro_torch.models.layers import tree_init, tree_specs
    from repro_torch.obs import device_memory_stats, memory_report
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train.loop import sharded_value_and_grad, value_and_grad

    t0 = time.perf_counter()
    mesh = make_test_mesh()
    profile, _ = card_profile()
    cfg = partition_train_config(SCAN_LAYERS["none"]).with_(scan_layers=True)
    st, L, V = get_strategy("2d_finalized"), cfg.num_layers, cfg.vocab_size
    label = (f"qwen1.5-0.5b loss and gradient, {L} layers scanned, remat none, B{SCAN_B} "
             f"S{SCAN_S}, bf16, no annotation")
    print(f"autoshard: the sharding search behind spmd_partition(autoshard=) on the {label}; "
          f"{card}", flush=True)
    decls = model_api.param_tree(cfg, st)
    with set_mesh(mesh):  # the Table-1 specs, as sharded_value_and_grad reads them
        specs = dict(leaves_with_paths(tree_specs(model_api.param_tree(cfg, st))))
    # the inputs in the JAX package's leaf order: params by sorted keys, then
    # labels, tokens (an assignment's index i is the i-th leaf path)
    params = tree_from_paths(leaves_with_paths(tree_init(
        decls, torch.Generator("cuda").manual_seed(seed), dtype=cfg.param_dtype,
        device="cuda")))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, SCAN_S, SCAN_B, seed=seed,
                                    pattern="arithmetic"))
    raw = pipe.batch_at(0)
    batch = {k: torch.from_numpy(raw[k]).to("cuda").long() for k in ("labels", "tokens")}
    paths = ["/".join(p) for p, _ in leaves_with_paths(params)] + ["labels", "tokens"]
    program = annotation_free_value_and_grad(cfg, st)

    # the budget: midway between the replicated and the Table-1 modeled peaks
    captured = capture(program, params, batch)
    free = autoshard.Evaluator(captured, mesh, profile=profile)
    shapes = free.invar_shapes()
    base_specs = [specs[tuple(p.split("/"))] for p in paths[:-2]] + [("data",), ("data",)]
    baseline = [autoshard.sharding_from_spec(mesh, s, shape)
                for s, shape in zip(base_specs, shapes)]
    repl_ev, base_ev = free([None] * len(shapes)), free(baseline)
    budget = (repl_ev.cost.peak_bytes + base_ev.cost.peak_bytes) / 2.0
    t_budget = time.perf_counter() - t0
    check(base_ev.feasible and repl_ev.feasible, f"autoshard: the bounds do not lower: "
          f"{repl_ev.reason} {base_ev.reason}")
    config = autoshard.AutoshardConfig(budget_bytes=budget, **AUTOSHARD_KNOBS)

    # the searched program: one spmd_partition call site, then a second
    autoshard.clear_assignment_cache()
    evals0 = obs_metrics.registry().counter("autoshard.evals").value
    search_ms0 = obs_metrics.registry().histogram("autoshard.search_ms").summary()["sum"]
    t1 = time.perf_counter()
    runner = spmd_partition(program, mesh, autoshard=config)
    runner(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t1
    search_s = (obs_metrics.registry().histogram("autoshard.search_ms").summary()["sum"]
                - search_ms0) / 1e3
    found = as_api.solve_jaxpr_cached(captured, mesh, dataclasses.replace(config,
                                                                          profile=profile))
    evals = obs_metrics.registry().counter("autoshard.evals").value - evals0
    check(found.evaluation.feasible, f"autoshard: infeasible: {found.evaluation.reason}")
    plan = _plan_of(runner).plan
    args = (params, batch)

    seen, restore = _fold_shapes()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem0 = device_memory_stats()
        got, launches = counted(lambda: runner(*args))
        mem = memory_report(plan, mem0, device_memory_stats())
    finally:
        restore()
    fallbacks, gathers = list(runner.fallbacks), list(runner.fallback_gathers)
    t2 = time.perf_counter()
    with torch.enable_grad():
        want = value_and_grad(cfg, st, tree_map(lambda p: p.detach().requires_grad_(), params),
                              batch)
    limit = TOLERANCES["bf16_grad"][0]
    loss_rel = _rel(got[0], want[0])
    grad_rel = {"/".join(p): _rel(g, w) for (p, g), (_, w) in zip(
        leaves_with_paths(got[1]), leaves_with_paths(want[1]))}
    gated = {k: v for k, v in grad_rel.items() if k != KEY_BIAS}
    del got, want
    vocab_steps = whole_vocab_steps(runner, args, V)
    tokens_sh = plan.in_shardings[paths.index("tokens")]
    fold_rows = mesh.size * (SCAN_B // tokens_sh.num_shards(0))

    # a second call site with the same config: the assignment comes from the
    # process cache (its own plan, no process plan cache), no new lowering
    t3 = time.perf_counter()
    n_cached, evals1 = len(as_api._ASSIGNMENT_CACHE), obs_metrics.registry().counter(
        "autoshard.evals").value
    runner2 = spmd_partition(program, mesh, autoshard=config, process_cache=False)
    runner2(*args)
    second_lowerings = obs_metrics.registry().counter("autoshard.evals").value - evals1
    same_plan = [s.dims_mapping for s in _plan_of(runner2).plan.in_shardings] == \
        [s.dims_mapping for s in plan.in_shardings]
    del runner2

    t4 = time.perf_counter()
    # the Table-1 program on the card, for the measured ratio
    base_runner = spmd_partition(sharded_value_and_grad(cfg, st, mesh), mesh)
    base_runner(*args)
    busy = {"searched": device_ms(lambda i: runner(*args), 1, calls=1, warm=False),
            "baseline": device_ms(lambda i: base_runner(*args), 1, calls=1, warm=False)}
    base_plan = _plan_of(base_runner).plan
    del base_runner
    t5 = time.perf_counter()
    split = {"budget": t_budget, "first_call": first_s, "gated_call": t2 - t1 - first_s,
             "unsharded_and_vocab": t3 - t2, "second_call_site": t4 - t3,
             "table1_and_busy": t5 - t4}
    modeled_ratio = found.evaluation.score / base_ev.score
    measured_ratio = (busy["searched"] / busy["baseline"]
                      if busy["searched"] and busy["baseline"] else None)
    assignment = {p: (None if s is None else repr(s)) for p, s in zip(paths, found.assignment)}
    gib = 2 ** 30

    def terms(ev):
        c = ev.cost
        return {k: c.as_dict()[k] for k in ("wire_bytes", "launches", "flops_per_device",
                                             "peak_bytes", "compute_s", "collective_s",
                                             "mem_s", "total_s")}

    print(f"  budget {budget / gib:.4f} GiB a device: replicated peak "
          f"{repl_ev.cost.peak_bytes / gib:.4f}, Table-1 peak {base_ev.cost.peak_bytes / gib:.4f} "
          f"(both priced by the committed profile, {t_budget:.1f} s with the capture)",
          flush=True)
    print(f"  search: {evals} evals ({found.evals} in the result), {search_s:.2f} s; first call "
          f"{first_s:.1f} s with capture, search and plan; searched inputs "
          f"{[paths[i] for i in found.searched_invars]}", flush=True)
    print("  assignment (None: left to propagation): "
          + ", ".join(f"{p}={s}" for p, s in assignment.items() if s is not None), flush=True)
    print(f"  modeled, searched: {terms(found.evaluation)}", flush=True)
    print(f"  modeled, Table-1:  {terms(base_ev)}", flush=True)
    print(f"  device busy on the card ({card}): searched {_ms(busy['searched'])}, Table-1 "
          f"{_ms(busy['baseline'])}; measured ratio "
          f"{'not measured' if measured_ratio is None else f'{measured_ratio:.3f}'} beside the "
          f"modeled {modeled_ratio:.3f}", flush=True)
    print(f"  memory ({card}): allocator peak {mem['measured_peak_bytes'] / gib:.3f} GiB "
          f"(above the start {mem['measured_peak_delta_bytes'] / gib:.3f}) against "
          f"plan_peak_bytes {plan.peak_bytes / gib:.4f} GiB x {mesh.size} = "
          f"{mem['modeled_peak_bytes_all_devices'] / gib:.3f} GiB (Table-1 plan "
          f"{base_plan.peak_bytes / gib:.4f} GiB a device)", flush=True)
    print(f"  launches {launches}, fold rows {seen}, fallbacks {collections.Counter(fallbacks)}, "
          f"gathers {gathers}, whole-vocab steps {vocab_steps}; loss rel {loss_rel:.3e}, "
          f"largest gradient rel {max(gated.values()):.3e} (bf16_grad {limit}); second call "
          f"site: {second_lowerings} lowerings, cache {n_cached} -> "
          f"{len(as_api._ASSIGNMENT_CACHE)}, same plan inputs {same_plan}", flush=True)
    seconds = time.perf_counter() - t0
    print(f"autoshard: {seconds:.1f} s ({', '.join(f'{k} {v:.1f}' for k, v in split.items())})",
          flush=True)
    check(found.evaluation.score <= base_ev.score * (1 + 1e-9),
          f"autoshard: searched {found.evaluation.score} above the Table-1 {base_ev.score}")
    check(plan.peak_bytes <= budget, f"autoshard: plan peak {plan.peak_bytes} over {budget}")
    check(loss_rel <= limit and max(gated.values()) <= limit,
          f"autoshard: off the unsharded run: loss {loss_rel:.3e}, grads {gated}")
    check(launches["flash_attention"] == L and launches["flash_attention_bwd"] == L,
          f"autoshard: launches {launches}")
    check(seen.get("flash_attention", (0,))[0] == fold_rows
          and seen.get("flash_attention_bwd", (0,))[0] == fold_rows,
          f"autoshard: a flash launch does not cover the eight devices: {seen}, want "
          f"{fold_rows} rows")
    check(gathers == [] and vocab_steps == [],
          f"autoshard: fallback gathers {gathers}, whole-vocab steps {vocab_steps}")
    check(second_lowerings == 0 and len(as_api._ASSIGNMENT_CACHE) == n_cached and same_plan,
          f"autoshard: the second call site lowered {second_lowerings}")
    del runner, params, batch, args
    torch.cuda.empty_cache()
    return {"label": label, "card": card, "budget_bytes": budget,
            "replicated": terms(repl_ev), "baseline": terms(base_ev),
            "searched": terms(found.evaluation), "assignment": assignment,
            "searched_invars": [paths[i] for i in found.searched_invars],
            "evals": evals, "search_s": search_s, "first_call_s": first_s,
            "launches": launches, "fold": seen, "loss_rel": loss_rel, "grad_rel": grad_rel,
            "fallbacks": dict(collections.Counter(fallbacks)), "fallback_gathers": gathers,
            "whole_vocab_steps": vocab_steps, "busy_ms": busy,
            "modeled_ratio": modeled_ratio, "measured_ratio": measured_ratio, "memory": mem,
            "baseline_plan_peak_bytes": base_plan.peak_bytes,
            "second_call_site_lowerings": second_lowerings, "seconds": seconds,
            "split_s": split}

# ---------------------------------------------------------------------------------
# GSPMD §3.3 pipelining (pipeline/stages.py) on a simulated ("stage" 4, "model" 2) mesh
# ---------------------------------------------------------------------------------

PIPE_B, PIPE_S = 8, 512  # the partitioned train steps' batch
PIPE_STAGES, PIPE_MICRO = 4, 4  # 7 ticks
# (arch, layers, dtypes): both cut to eight layers (two a stage) for the
# script's time limit; Mamba2 in float32 only (bf16 Mamba2 with random
# weights is chaotic under rounding, ROADMAP R6)
PIPE_CASES = (("qwen1.5-0.5b", 8, ("float32", "bfloat16")), ("mamba2-130m", 8, ("float32",)))


# device time by kind of kernel, by substrings of the kernels' names
KERNEL_KINDS = (("flash", ("flash_",)), ("ssd", ("ssd_",)),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass")),
                ("copy", ("copy", "Copy", "memcpy", "Memcpy", "memset")),
                ("elementwise", ("elementwise",)), ("reduce", ("reduce",)))


def _pipe_config(arch, layers, dtype):
    """``arch`` at its published widths, ``layers`` deep, remat "none", the
    unpipelined program's layer loop scanned."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if arch == "qwen1.5-0.5b":
        got = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh, cfg.d_ff, cfg.vocab_size)
        want = (1024, 16, 16, 64, 2816, 151936)
    else:
        got = (cfg.d_model, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_expand, cfg.vocab_size)
        want = (768, 64, 128, 2, 50280)
    check(got == want, f"unexpected config {cfg}")
    return cfg.with_(num_layers=layers, dtype=dtype, remat="none", scan_layers=True)


def _pipe_value_and_grad(program):
    """(loss, gradient leaves in ``leaves`` order) of ``program(params, batch)``,
    the gradient taken inside the program."""
    from repro_torch.core.tree import leaves, tree_map

    def vg(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss = program(live, batch)
            return loss, list(torch.autograd.grad(loss, leaves(live)))

    return vg


def _tick_scans(plan):
    """The tick scans of a pipelined gradient plan: (forward, reverse), each
    a call step whose body holds a ppermute."""
    found = [s for s in plan.steps if s.op == "scan" and s.inner is not None
             and any(t.op in ("ppermute", "fused-ppermute") for t in s.inner.steps)]
    check(len(found) == 2, f"the plan holds {len(found)} tick scans, want 2")
    return found


def _stage_collectives(plan, axis="stage"):
    """The collectives over ``axis`` that a plan's own steps launch: its
    collective and fused steps, and the gathers and all-to-alls of its
    reshard steps (a reshard's slices move nothing)."""
    found = []
    for s in plan.steps:
        if s.kind in ("collective", "fused") and axis in s.axes:
            found.append(s.op)
        elif s.kind == "reshard":
            found += [c.describe() for c in s.program.steps
                      if c.axis == axis and c.op != "dynamic_slice"]
    return sorted(found)


def _fold_shapes():
    """Wrap the kernels' wrappers to record the shape of each call's first
    operand (the folded batch); returns the record and the restore."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ssd_scan as ssd_kernel
    from repro_torch.kernels import ssd_scan_bwd as ssd_bwd_kernel

    seen, saved = {}, []
    for mod, name in ((fa, "flash_attention"), (fab, "flash_attention_bwd"),
                      (ssd_kernel, "ssd_scan"), (ssd_bwd_kernel, "ssd_scan_bwd")):
        fn = getattr(mod, name)

        def watched(*args, fn=fn, name=name, **kw):
            seen.setdefault(name, tuple(args[0].shape))
            return fn(*args, **kw)

        setattr(mod, name, watched)
        saved.append((mod, name, fn))

    def restore():
        for mod, name, fn in saved:
            setattr(mod, name, fn)

    return seen, restore


def _pipe_run(run, args, mesh=None):
    """One call for its outputs (launches counted, fold shapes recorded, host
    ms with the device drained before, peak memory above the inputs), then
    one traced call for device busy."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    seen, restore = _fold_shapes()
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            out, launched = counted(lambda: run(*args))
            host = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    with torch.no_grad():
        by_name = device_ms(lambda i: run(*args), 1, calls=1, warm=False, by_name=True)
    busy = sum(v["ms"] for v in by_name.values()) if by_name else None
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms"])[:8] if by_name else []
    kinds = collections.Counter()
    for n, v in (by_name or {}).items():
        kind = next((k for k, keys in KERNEL_KINDS if any(w in n for w in keys)), "other")
        kinds[kind] += v["ms"]
    return out, {"launches": launched, "folds": seen, "host_ms_drained_wall": host,
                 "device_busy_ms": busy, "peak_gib": peak, "device_ms_by_kind": dict(kinds),
                 "top_kernels": [[n[:60], v["ms"], v["launches"]] for n, v in top]}


def _mirror_fault(runner, args, mesh):
    """The planted fault: the pipelined plan compiled again with the forward
    tick body's ppermute sending each boundary row the wrong way (the
    reverse body's perm), run once; returns its outputs."""
    from repro_torch.core import mesh_runtime as mr
    from repro_torch.core import plan as plan_mod

    entry = _plan_of(runner)
    bad = plan_mod.compile_plan(entry.captured, entry.prop, mesh, optimize=False, verify=False)
    fwd, rev = _tick_scans(bad)
    (pp,) = [t for t in fwd.inner.steps if t.op == "ppermute"]
    (rp,) = [t for t in rev.inner.steps if t.op == "ppermute"]
    perm, axis = rp.call["perm"], pp.axes[0]
    pp.run = plan_mod._compute_run(lambda b: mr.ppermute(b, mesh, axis, perm))
    pp.call = {"perm": perm}
    raw, entry.plan = entry.plan, bad
    try:
        with torch.no_grad():
            return _tensors(runner(*args))
    finally:
        entry.plan = raw


def pipeline_case(arch, layers, dtype, seed, card, mesh):
    """``arch`` at its published widths, ``layers`` deep, in ``dtype``
    (float32 masters), B8 S512 in four microbatches: the gradient of
    ``api.partitionable_pipelined_loss`` (the layer stack pipelined over
    the four "stage" rows, 2d_finalized filtered to the mesh, the batch on
    "stage" outside the pipelined region: ``pipeline.stage_batch``) through
    ``spmd_partition``, against the unpipelined partitioned gradient
    (``sharded_value_and_grad`` on the same mesh) and against the unsharded
    ``value_and_grad``.  Gates: the losses within f32_chain (bf16:
    bf16_chain) of each other, each gradient leaf in norm within
    f32_chain's rtol (bf16: bf16_grad; Mamba2 float32: the larger of that
    and 4x its floor, the unsharded gradient through the plain SSD against
    the kernels', as ``partition_mamba_train_case``); per call 7 x the
    stage's layers forward and backward kernel calls, one launch each for
    every stage and device; one ppermute over "stage" in the forward tick
    body, perm ((0,1),(1,2),(2,3)), one in the reverse body with the
    mirror perm, 14 ppermute launches a call, each moving one stage row of
    the local buffer; no fallback gather (scan bodies' included); over
    "stage" in each tick body only the hop and the row sum's psum, no
    reshard gathering the stage dim; every plan and body plan
    verified; in float32 the planted wrong-direction ppermute off by at
    least 10x f32_chain.  Reads: first-call seconds, plan steps, host ms
    and device busy per call beside the unpipelined step's, peak beside
    the plan's modeled peak x 8, the kernels' fold shapes."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.partitioner import spmd_partition
    from repro_torch.core.plan_opt import _collective_step_wire_bytes
    from repro_torch.core.plan_verify import verify_plan
    from repro_torch.core.reshard import shard_shape
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import ops
    from repro_torch.models import api
    from repro_torch.models.layers import tree_init
    from repro_torch.pipeline import (PipelineDecision, plan_ppermute_bytes, stage_batch,
                                      stage_stack_params)
    from repro_torch.train.loop import sharded_value_and_grad, value_and_grad

    t0 = time.perf_counter()
    cfg = _pipe_config(arch, layers, dtype)
    # the batch on "stage" outside the pipelined region (and in the
    # unpipelined step): with it replicated there, every "stage" row would
    # hold the whole batch's logits, and the unpipelined step would compute
    # every layer four times over: at float32 neither fits the card
    st, L = get_strategy("2d_finalized"), cfg.num_layers
    outer = stage_batch(st, "stage")
    decision = PipelineDecision("stage", PIPE_STAGES, PIPE_MICRO)
    ticks, per_stage = decision.ticks, L // PIPE_STAGES
    gen = torch.Generator("cuda").manual_seed(seed)
    with set_mesh(mesh):
        params = tree_init(api.param_tree(cfg, st), gen, dtype=cfg.param_dtype, device="cuda")
    if arch == "mamba2-130m":
        mamba2_published_init(params, L, gen)
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, PIPE_S, PIPE_B, seed=seed,
                                    pattern="arithmetic"))
    batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe.batch_at(0).items()}
    staged = {**params, "layers": stage_stack_params(params["layers"], PIPE_STAGES)}
    names = ["/".join(p) for p, _ in leaves_with_paths(params)]
    with set_mesh(mesh):
        runners = {
            "pipelined": spmd_partition(_pipe_value_and_grad(
                api.partitionable_pipelined_loss(cfg, st, mesh, decision)),
                mesh, optimize=False, device="cuda"),
            "unpipelined": spmd_partition(sharded_value_and_grad(cfg, outer, mesh), mesh,
                                          optimize=False, device="cuda")}
    args = {"pipelined": (staged, batch), "unpipelined": (params, batch)}
    outs, reads = {}, {}
    for name, run in runners.items():
        t1 = time.perf_counter()
        with torch.no_grad():
            run(*args[name])  # the first call: capture, completion, the plan
        torch.cuda.synchronize()
        first = time.perf_counter() - t1
        out, reads[name] = _pipe_run(run, args[name])
        loss, grads = out
        outs[name] = [loss] + [g.reshape(p.shape) for g, p in zip(
            grads if name == "pipelined" else leaves(grads), leaves(params))]
        del out, loss, grads
        entry = _plan_of(run)
        reads[name].update({
            "first_call_s": first, "build_s": dict(entry.build_s), "plan": _plan_parts(entry.plan),
            "modeled_peak_x8_gib": entry.plan.peak_bytes * mesh.size / 2**30,
            "verified_plans": verify_plan(entry.plan).plans,
            "fallback_gathers": list(run.fallback_gathers)})
        torch.cuda.empty_cache()
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, grads = value_and_grad(cfg, st, live, batch)
    outs["unsharded"] = [loss.detach()] + [g.detach() for g in leaves(grads)]
    del live, loss, grads
    floor = {}
    if arch == "mamba2-130m":  # the float32 gradient's own floor, as partition_mamba_train_case
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        route, ops._route = ops._route, lambda t: "cpu"
        try:
            with torch.enable_grad():
                _, plain = value_and_grad(cfg, st, live, batch)
        finally:
            ops._route = route
        floor = {n: _rel(a, b) for n, a, b in zip(names, leaves(plain), outs["unsharded"][1:])}
        del live, plain

    # the plan: one ppermute a tick each way, 14 launches, a stage row each
    plan = _plan_of(runners["pipelined"]).plan
    fwd, rev = _tick_scans(plan)
    pf = [t for t in fwd.inner.steps if t.op == "ppermute"]
    pr = [t for t in rev.inner.steps if t.op == "ppermute"]
    perm = tuple((i, i + 1) for i in range(PIPE_STAGES - 1))
    nc = fwd.call["num_consts"]
    buf = shard_shape((PIPE_STAGES, PIPE_B // PIPE_MICRO, PIPE_S, cfg.d_model),
                      fwd.inner.in_shardings[nc])
    pbytes, plaunch = plan_ppermute_bytes(plan)
    struct = {
        "ticks": [fwd.call["trips"], rev.call["trips"]],
        "ppermutes_per_tick": [len(pf), len(pr)],
        "axes": [list(t.axes) for t in pf + pr], "perms": [list(t.call["perm"]) for t in pf + pr],
        "ppermute_launches_per_call": plaunch, "ppermute_wire_bytes_per_call": pbytes,
        "wire_bytes_per_tick": [_collective_step_wire_bytes(mesh, t) for t in pf + pr],
        "local_buffer": list(buf), "stage_row_bytes": float(np.prod(buf[1:])) * pf[0].dbytes,
        "stage_collectives": [_stage_collectives(fwd.inner), _stage_collectives(rev.inner)]}
    row_lshape = (1,) + tuple(buf[1:])
    limit = TOLERANCES["f32_chain" if dtype == "float32" else "bf16_grad"][0]
    kind = "f32_chain" if dtype == "float32" else "bf16_chain"
    vs = {}
    for a, b in (("pipelined", "unpipelined"), ("pipelined", "unsharded"),
                 ("unpipelined", "unsharded")):
        rel = {n: _rel(x, y) for n, x, y in zip(names, outs[a][1:], outs[b][1:])}
        gated = {n: r for n, r in rel.items() if n != KEY_BIAS}
        limits = {n: max(limit, 4 * floor[n]) if floor else limit for n in gated}
        worst = max(gated, key=lambda n: gated[n] / limits[n])
        vs[f"{a} vs {b}"] = {"loss_err_over_limit": _err_over(outs[a][0], outs[b][0], kind),
                             "grad_rel_worst": [worst, gated[worst], limits[worst]],
                             "grad_over_limit": gated[worst] / limits[worst],
                             "key_bias_rel": rel.get(KEY_BIAS)}
    planted = None
    if dtype == "float32":
        bad = _mirror_fault(runners["pipelined"], args["pipelined"], mesh)
        planted = {"loss_err_over_f32_chain": _err_over(bad[0], outs["unpipelined"][0],
                                                        "f32_chain")}
        del bad
    del runners, outs
    torch.cuda.empty_cache()

    label = f"{arch} {L}L {dtype}, pipelined {PIPE_STAGES} stages x {PIPE_MICRO} microbatches"
    rp, ru = reads["pipelined"], reads["unpipelined"]
    print(f"  {label}, B{PIPE_B} S{PIPE_S}; {card}", flush=True)
    for name, r in reads.items():
        print(f"    {name}: first call {r['first_call_s']:.1f} s "
              f"({json.dumps({k: round(v, 2) for k, v in r['build_s'].items()})}); plan "
              f"{json.dumps(r['plan'])}; launches {json.dumps(r['launches'])}; folds "
              f"{json.dumps(r['folds'])}; host {r['host_ms_drained_wall']:.1f} ms a call (drained "
              f"wall); device busy {_ms(r['device_busy_ms'])}; peak {r['peak_gib']:.3f} GiB "
              "(plan's "
              f"modeled peak x8 {r['modeled_peak_x8_gib']:.3f}); verified {r['verified_plans']} "
              f"plans", flush=True)
        print("      device ms by kind: " + json.dumps(
            {k: round(v, 2) for k, v in r["device_ms_by_kind"].items()}) + "; by kernel "
              "(launches): " + "; ".join(f"{n} {ms:.2f} ({k})" for n, ms, k in r["top_kernels"]),
              flush=True)
    print(f"    plan: {json.dumps(struct)}", flush=True)
    print(f"    vs: {json.dumps(vs)}" + (f"; planted {json.dumps(planted)}" if planted else "")
          + (f"; floor max {max(floor.values()):.3e}" if floor else ""), flush=True)

    mods = ("flash_attention", "flash_attention_bwd") if arch == "qwen1.5-0.5b" \
        else ("ssd_scan", "ssd_scan_bwd")
    want = {k: 0 for k in ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")}
    want.update({m: ticks * per_stage for m in mods})
    check(rp["launches"] == want, f"{label}: launched {rp['launches']}, want {want}")
    want_u = dict(want, **{m: L for m in mods})
    check(ru["launches"] == want_u,
          f"{label}: unpipelined launched {ru['launches']}, want {want_u}")
    check(struct["ticks"] == [ticks, ticks] and struct["ppermutes_per_tick"] == [1, 1],
          f"{label}: tick scans {struct}")
    check(struct["axes"] == [["stage"], ["stage"]], f"{label}: ppermute axes {struct['axes']}")
    check(pf[0].call["perm"] == perm and pr[0].call["perm"] == tuple((j, i) for i, j in perm),
          f"{label}: perms {struct['perms']}")
    check(plaunch == 2 * ticks, f"{label}: {plaunch} ppermute launches a call, want {2 * ticks}")
    check(tuple(pf[0].lshape) == row_lshape and pf[0].in_bytes == struct["wire_bytes_per_tick"][0],
          f"{label}: the forward ppermute moves {pf[0].lshape}, one stage row is {row_lshape}")
    check(not rp["fallback_gathers"] and not ru["fallback_gathers"],
          f"{label}: fallbacks gathered {rp['fallback_gathers']} {ru['fallback_gathers']}")
    # nothing else in a tick moves data over "stage": no reshard gathers the
    # stage dim, only the shift's hop and the row sum's psum cross stages
    check(struct["stage_collectives"] == [["all-reduce", "ppermute"]] * 2,
          f"{label}: collectives over \"stage\" in the tick bodies "
          f"{struct['stage_collectives']}, want the hop and the row sum's psum")
    for pair, v in vs.items():
        check(v["loss_err_over_limit"] <= 1.0 and v["grad_over_limit"] <= 1.0,
              f"{label}: {pair} off: {v}")
    if planted is not None:
        check(planted["loss_err_over_f32_chain"] >= 10.0,
              f"{label}: the planted wrong-direction ppermute went unseen: {planted}")
    seconds = time.perf_counter() - t0
    print(f"    {seconds:.1f} s", flush=True)
    return {"label": label, "card": card, "reads": reads, "plan": struct, "vs": vs,
            "planted": planted, "floor": floor or None, "seconds": seconds}


def pipeline_phase(seed, card):
    """GSPMD §3.3 pipelining on the card (``pipeline_case``): qwen1.5-0.5b
    in float32 and bf16 and mamba2-130m in float32, at the depths of
    ``PIPE_CASES``, each pipelined over four stages on a simulated ("stage"
    4, "model" 2) mesh."""
    from repro_torch.core.sharding import Mesh

    t0 = time.perf_counter()
    mesh = Mesh.create((PIPE_STAGES, 2), ("stage", "model"))
    print(f"pipeline: the stage-stacked pipeline through the partitioner; {card}", flush=True)
    cases = []
    for arch, layers, dtypes in PIPE_CASES:
        for dtype in dtypes:
            cases.append(pipeline_case(arch, layers, dtype, seed, card, mesh))
            torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    print(f"pipeline: {seconds:.1f} s", flush=True)
    return {"cases": cases, "seconds": seconds}


def pipeline_phase_in_own_process(seed, card, timeout=300):
    """``pipeline_phase`` in a fresh process, with its own time limit."""
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); import torch, chip_smoke; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            f"print(json.dumps(chip_smoke.pipeline_phase({seed}, {card!r})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines), flush=True)
    check(proc.returncode == 0 and lines,
          f"the pipeline phase failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def sharded_phases_in_own_process(seed, card):
    """``sharded_loss_phase``, ``sharded_serve_phase``, ``obs_phase``,
    ``autoshard_phase``, ``plan_opt_phase`` and ``scan_phase`` in a fresh process (whole profiler traces, as
    ``partition_phase_in_own_process``), the first two with the kernels'
    launch counts set to 0 before and read after (the SSD launches in the
    loss and not in serving; the flash kernel in qwen's serving), the last
    with them set and read around every call it compares."""
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); import torch, chip_smoke; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            f"loss, n = chip_smoke.counted(lambda: chip_smoke.sharded_loss_phase({seed}, "
            f"{card!r})); "
            f"serve, m = chip_smoke.counted(lambda: chip_smoke.sharded_serve_phase({seed}, "
            f"{card!r})); "
            f"obs = chip_smoke.obs_phase({seed}, {card!r}); "
            f"autoshard = chip_smoke.autoshard_phase({seed}, {card!r}); "
            f"plan_opt = chip_smoke.plan_opt_phase({seed}, {card!r}); "
            f"scan = chip_smoke.scan_phase({seed}, {card!r}); "
            "print(json.dumps({'loss': loss, 'loss_launches': n, 'serve': serve, "
            "'serve_launches': m, 'obs': obs, 'autoshard': autoshard, 'plan_opt': plan_opt, "
            "'scan': scan}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=1100)
    lines = proc.stdout.splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines), flush=True)
    check(proc.returncode == 0 and lines,
          f"sharded phases failed ({proc.returncode}): {proc.stderr[-3000:]}")
    res = json.loads(lines[-1])
    check(res["loss_launches"]["ssd_scan"] > 0 and res["serve_launches"]["ssd_scan"] == 0
          and res["serve_launches"]["flash_attention"] > 0,
          f"the sharded phases' launches: {res['loss_launches']}, {res['serve_launches']}")
    return res


# ---------------------------------------------------------------------------------
# checkpoints: crash and restart through the entry point, and a cross-mesh
# restore through the partitioner
# ---------------------------------------------------------------------------------

CKPT_ARGV = ("--arch", "qwen1.5-0.5b", "--reduce", "1", "--batch", "4", "--seq", "2048",
             "--steps", "6", "--ckpt-every", "3", "--data-pattern", "arithmetic")
CKPT_FAIL_AT = 4
CKPT_RESHARD_B, CKPT_RESHARD_S = 8, 512
CKPT_RESHARD_LAYERS = 8  # 24 until the elastic drill took over the (4, 2) restore


def _meta_state(cfg, st, opt):
    """The train state's structure on the meta device (shapes and dtypes,
    no memory): a restore target."""
    from repro_torch.launch.elastic import meta_state
    from repro_torch.train.loop import TrainConfig

    return meta_state(cfg, st, opt, TrainConfig())


def checkpoint_reshard_config():
    """qwen1.5-0.5b at its published widths, ``CKPT_RESHARD_LAYERS`` layers,
    the layer loop scanned, remat "none", 2d_finalized, Adafactor."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.train.optimizer import get_optimizer

    cfg = partition_train_config(CKPT_RESHARD_LAYERS, "none").with_(scan_layers=True)
    return cfg, get_strategy("2d_finalized"), get_optimizer("adafactor")


def checkpoint_restores():
    """The restores of ``checkpoint_reshard_case``: (label, mesh, target
    specs: the state's own or all replicated).  Named axes keep their
    meaning on the new mesh, so the state's own specs move no leaf that
    (2,4) kept sharded (the tiles are cut anew as the leaves are read); the
    replicated target gathers every sharded leaf.  The restore onto (4, 2)
    under the state's own specs, with sliced reads and a fallback, is the
    elastic drill's (``elastic_phase``)."""
    from repro_torch.launch.elastic import derive_mesh
    from repro_torch.core.sharding import Mesh

    m1 = Mesh.create((4, 2), ("data", "model"))
    return (("M2", derive_mesh(n_devices=4, model_parallel=4), "own"),
            ("M1 replicated", m1, "replicated"))


def checkpoint_plan_prediction(profile=None):
    """Pure planning, no tensors: the checkpoint of ``checkpoint_reshard_config``'s
    train state saved on ("data" 2, "model" 4) (its leaves, bytes and the
    specs the loop records, from meta shapes) and ``restore_resharded``'s
    plan for each of ``checkpoint_restores``: wire bytes, launches,
    resharded leaves.  The same on the CPU (``tools/ckpt_plan.py``) and on
    the card."""
    from repro_torch.core.plan import dtype_bytes
    from repro_torch.launch.elastic import specs_by_key, state_partition_specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainConfig, checkpoint_specs

    cfg, st, opt = checkpoint_reshard_config()
    tc = TrainConfig()
    meta = _meta_state(cfg, st, opt)
    specs = checkpoint_specs(cfg, st, opt, tc, meta, make_test_mesh())
    table = []
    for key, leaf in ckpt._flatten_with_paths(meta):
        shape = list(getattr(leaf, "shape", ()))
        dtype = "int32" if isinstance(leaf, int) else str(leaf.dtype).replace("torch.", "")
        table.append({"key": key, "shape": shape, "dtype": dtype,
                      "spec": [list(a) for a in specs[key].dims_mapping]})
    manifest = {"leaves": table}
    nbytes = sum(int(np.prod(l["shape"], dtype=np.int64)) * dtype_bytes(l["dtype"])
                 for l in table)
    target = specs_by_key(state_partition_specs(cfg, st, opt, tc))
    keys = [(l["key"], None) for l in table]
    out = {"leaves": len(table), "bytes": nbytes,
           "sharded_leaves": sum(1 for l in table if any(l["spec"])), "meshes": {}}
    for name, mesh, specs in checkpoint_restores():
        rep = ckpt.plan_restore_reshard(manifest, keys, mesh, target if specs == "own" else None,
                                        profile=profile).report()
        out["meshes"][name] = {"shape": list(mesh.shape), **{
            k: rep[k] for k in ("wire_bytes", "launches", "resharded_leaves", "leaves",
                                "gather_all_bytes", "ratio_vs_gather_all", "reshard_s",
                                "collectives")}}
    return out


def _timed(mod, name, log):
    """Wrap ``mod.name`` so that each call's seconds (the card drained before
    and after) and the bytes under the step directory it returns (a save)
    land in ``log``; returns the original."""
    fn = getattr(mod, name)

    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        rec = {"s": time.perf_counter() - t0}
        if isinstance(out, str) and os.path.isdir(out):
            rec["bytes"] = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        log.append(rec)
        return out

    setattr(mod, name, wrapped)
    return fn


def _gbs(rec, nbytes=None):
    b = rec.get("bytes", nbytes)
    return None if not b else b / rec["s"] / 1e9


def _verify_cli(d):
    """``python -m repro_torch.train.checkpoint verify d``: (exit code,
    seconds, output)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.train.checkpoint", "verify", d],
                          capture_output=True, text=True, env=env, timeout=300)
    return proc.returncode, time.perf_counter() - t0, proc.stdout


def _same_state(got, want):
    """The keys of ``got`` whose values differ from ``want``'s (tensors bit
    for bit, numbers by value)."""
    from repro_torch.core.tree import leaves, leaves_with_paths

    off = []
    for (path, a), b in zip(leaves_with_paths(got), leaves(want)):
        if isinstance(a, torch.Tensor):
            same = (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.detach(), b.detach().to(a.device)))
        else:
            same = a == b
        if not same:
            off.append("/".join(path))
    return off


def checkpoint_restart_case(seed, card, root):
    """Crash and restart through ``launch.train.main``: qwen1.5-0.5b at full
    width (B4 S2048, Adafactor, remat "dots", six steps, a checkpoint every
    three), uninterrupted (run 1), then crashed at step 4 (run 2: exactly
    ``step_00000003`` left, no ``.tmp-``), then restarted (run 3: restores
    step 3 at cursor 3, runs steps 3-5, saves step 6).  Gates: run 2's step
    3 restored onto the card and saved again has every leaf's crc32 of run
    2's manifest, and the restored tensors equal the files (exact); run 3's
    losses within bf16_chain of run 1's steps 3-5 and its step-6 params per
    leaf in norm within bf16_grad of run 1's (the key bias, whose exact
    gradient is 0 and whose update is rounding, printed; the flash backward's dq
    atomics change the sum order run to run, so neither need be bit-equal;
    whether it is is printed); per step 48 flash forward launches (remat)
    and 24 backward calls; the verify CLI passes run 3's directory."""
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import get_config
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import get_optimizer

    cfg, st, opt = get_config("qwen1.5-0.5b"), get_strategy("2d_finalized"), get_optimizer(
        "adafactor")
    L = cfg.num_layers
    mods = _kernel_modules()
    want = {name: 0 for name in mods}
    want.update(flash_attention=2 * L, flash_attention_bwd=L)
    saves, restores = [], []
    save0, restore0 = _timed(ckpt, "save", saves), _timed(ckpt, "restore", restores)

    def run(tag, d, *extra):
        recs, logs, clock = [], [], {}

        def fault(step):
            for mod in mods.values():
                mod.launches = 0
            clock["t0"] = time.perf_counter()

        def metrics(step, loss):
            recs.append({"step": step, "loss": loss,
                         "ms": (time.perf_counter() - clock["t0"]) * 1e3,
                         "launches": {n: mod.launches for n, mod in mods.items()}})

        def log(msg):
            logs.append(msg)
            print(f"    [{tag}] {msg}", flush=True)

        err, losses, n_saves = None, None, len(saves)
        t0 = time.perf_counter()
        try:
            losses = launch_train.main(list(CKPT_ARGV) + ["--seed", str(seed), "--ckpt-dir", d,
                                                          *extra],
                                       hooks={"fault": fault, "metrics": metrics, "log": log})
        except RuntimeError as e:
            err = str(e)
        for r in recs:
            check(r["launches"] == want, f"{tag}: step {r['step']} launched {r['launches']}, "
                  f"want {want}")
        return {"losses": losses, "error": err, "logs": logs, "steps": recs,
                "seconds": time.perf_counter() - t0, "saves": saves[n_saves:]}

    try:
        d1, d2, dfid = (os.path.join(root, n) for n in ("run1", "run2", "resave"))
        run1 = run("run 1", d1)
        check(run1["error"] is None and len(run1["losses"]) == 6
              and all(math.isfinite(x) for x in run1["losses"]), f"run 1: {run1}")
        check(ckpt.intact_steps(d1) == [3, 6], f"run 1 saved {ckpt.intact_steps(d1)}")
        shutil.rmtree(os.path.join(d1, "step_00000003"))  # disk: only step 6 is compared
        run2 = run("run 2", d2, "--fail-at-step", str(CKPT_FAIL_AT))
        check(run2["error"] == f"injected failure at step {CKPT_FAIL_AT}",
              f"run 2 did not fail as injected: {run2['error']}")
        check(sorted(os.listdir(d2)) == ["step_00000003"], f"run 2 left {os.listdir(d2)}")

        # restore fidelity: run 2's step 3 onto the card, saved again
        meta = _meta_state(cfg, st, opt)
        restored, man = ckpt.restore(d2, meta, step=3, device="cuda")
        fid_restore = restores[-1]
        ckpt.save(dfid, 3, restored, extra=man["extra"])
        fid_save = saves[-1]
        again = {l["key"]: l["checksum"] for l in ckpt._load_manifest(dfid, 3)["leaves"]}
        crc_off = [l["key"] for l in man["leaves"] if again.get(l["key"]) != l["checksum"]]
        file_off = []
        for l in man["leaves"]:
            arr = np.load(os.path.join(d2, "step_00000003", l["file"]))
            got = restored
            for k in l["key"].split("/"):
                got = got[k]
            if isinstance(got, torch.Tensor):
                same = (not got.requires_grad and got.device.type == "cuda"
                        and np.array_equal(got.cpu().numpy(), arr))
            else:
                same = got == int(arr)
            if not same:
                file_off.append(l["key"])
        nbytes = fid_save["bytes"]
        del restored
        shutil.rmtree(dfid)
        torch.cuda.empty_cache()
        check(not crc_off and not file_off and man["restore_report"]["missing"] == []
              and man["restore_report"]["unused"] == [],
              f"restore fidelity: crc32 off {crc_off}, tensors off the files {file_off}")

        run3 = run("run 3", d2)
        check(run3["error"] is None and "restored checkpoint step=3 cursor=3" in run3["logs"],
              f"run 3 did not restore step 3 at cursor 3: {run3['logs'][:3]} {run3['error']}")
        check([r["step"] for r in run3["steps"]] == [3, 4, 5] and ckpt.intact_steps(d2) == [3, 6],
              f"run 3 ran {[r['step'] for r in run3['steps']]}, saved {ckpt.intact_steps(d2)}")
        loss_over = _err_over(torch.tensor(run3["losses"]), torch.tensor(run1["losses"][3:]),
                              "bf16_chain")
        m1, m3 = ckpt._load_manifest(d1, 6), ckpt._load_manifest(d2, 6)
        params_rel, crc_equal = {}, True
        for a, b in zip(m1["leaves"], m3["leaves"]):
            crc_equal &= a["checksum"] == b["checksum"]
            if a["key"].startswith("params/"):
                x = torch.from_numpy(np.load(os.path.join(d1, "step_00000006", a["file"]))).cuda()
                y = torch.from_numpy(np.load(os.path.join(d2, "step_00000006", b["file"]))).cuda()
                params_rel[a["key"]] = _rel(y, x)
        rc, verify_s, verify_out = _verify_cli(d2)
    finally:
        ckpt.save, ckpt.restore = save0, restore0
    limit = TOLERANCES["bf16_grad"][0]
    worst = max((k for k in params_rel if k != "params/" + KEY_BIAS), key=params_rel.get)
    rec = {"losses_run1": run1["losses"], "losses_run3": run3["losses"],
           "loss_err_over_bf16_chain": loss_over,
           "losses_bit_equal": run3["losses"] == run1["losses"][3:],
           "params_rel_by_leaf": params_rel, "params_rel_max": [worst, params_rel[worst]],
           "state_bit_equal": crc_equal, "checkpoint_bytes": nbytes,
           "save_s": [r["s"] for r in run1["saves"] + run2["saves"] + run3["saves"]],
           "save_gbs": [_gbs(r) for r in run1["saves"] + run2["saves"] + run3["saves"]],
           "restore_s": {"fidelity": fid_restore["s"], "run3": restores[-1]["s"]},
           "restore_gbs": {"fidelity": _gbs(fid_restore, nbytes),
                           "run3": _gbs(restores[-1], nbytes)},
           "resave_s": fid_save["s"], "verify_s": verify_s, "verify_rc": rc,
           "verify_gbs": 2 * nbytes / verify_s / 1e9,
           "run_seconds": [run1["seconds"], run2["seconds"], run3["seconds"]],
           "launches_per_step": want}
    print(f"  restart: {nbytes / 1e9:.3f} GB a checkpoint ({len(m1['leaves'])} leaves); run 3's "
          f"losses {run3['losses']} against run 1's {run1['losses'][3:]}: err/limit "
          f"{loss_over:.3f} (bf16_chain), bit-equal {rec['losses_bit_equal']}; step-6 params "
          f"per leaf in norm at most {params_rel[worst]:.3e} ({worst}; bf16_grad {limit}; the "
          f"key bias, whose exact gradient is 0, {params_rel['params/' + KEY_BIAS]:.3e}, not "
          f"gated), every leaf's crc32 equal {crc_equal}; {card}", flush=True)
    print(f"    save s {[round(x, 3) for x in rec['save_s']]} (GB/s "
          f"{[round(x, 2) for x in rec['save_gbs']]}); restore s fidelity "
          f"{fid_restore['s']:.3f}, run 3 {restores[-1]['s']:.3f}; resave {fid_save['s']:.3f}; "
          f"verify CLI {verify_s:.3f} s on two steps (exit {rc}); runs "
          f"{[round(x, 1) for x in rec['run_seconds']]} s", flush=True)
    check(rc == 0, f"verify CLI on run 3's directory: exit {rc}: {verify_out[-2000:]}")
    check(loss_over <= 1.0, f"run 3's losses off run 1's: {loss_over}")
    check(params_rel[worst] <= limit, f"run 3's params off run 1's: {worst} {params_rel[worst]}")
    return rec


def checkpoint_reshard_case(seed, card, root):
    """The partitioned state saved on ("data" 2, "model" 4) by ``TrainLoop``
    under ``set_mesh`` (qwen1.5-0.5b, ``CKPT_RESHARD_LAYERS`` layers scanned,
    full width, remat "none", 2d_finalized, B8 S512, Adafactor; two steps, a
    checkpoint after each), restored by ``restore_resharded`` onto
    ``derive_mesh(4, 4)`` = ("data" 1, "model" 4) under the state's own
    specs, full and sliced reads, and onto ("data" 4, "model" 2) all
    replicated (every sharded leaf gathered), then trained one step on
    (1, 4) against the same step unsharded.
    Gates: the manifest's specs are the state's partition specs projected
    onto (2,4); every restore bit-equal to the saved state, verified, at
    most the gather-all bytes, with wire bytes, launches and resharded
    leaves equal to the pure plan's (``checkpoint_plan_prediction``); the
    step on each mesh: loss within bf16_chain of the unsharded step's, the
    update over leaves of two or more dims in norm within bf16_grad and 95 %
    of the 1-D update's signs agreeing, a flash forward launch and a
    backward call a layer, no gathering fallback; a flipped payload byte in the
    largest sharded leaf raises ``CheckpointCorruptError`` naming it on a
    pinned restore and falls back to step 1 (bit-equal) without one, and so
    does a truncated file under sliced reads; the verify CLI fails."""
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.plan_verify import verify_state_reshard
    from repro_torch.core.sharding import project_dims_mapping
    from repro_torch.core.tree import leaves_with_paths, tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.elastic import specs_by_key, state_partition_specs
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import TrainConfig, TrainLoop, init_state

    cfg, st, opt = checkpoint_reshard_config()
    L, V = cfg.num_layers, cfg.vocab_size
    mesh = make_test_mesh()
    profile, _ = card_profile()
    predicted = checkpoint_plan_prediction(profile)
    d = os.path.join(root, "partitioned")
    pipe = TokenPipeline(DataConfig(V, CKPT_RESHARD_S, CKPT_RESHARD_B, seed=seed,
                                    pattern="arithmetic"))
    mods = _kernel_modules()
    want = {name: 0 for name in mods}
    want.update(flash_attention=L, flash_attention_bwd=L)
    target = specs_by_key(state_partition_specs(cfg, st, opt, TrainConfig()))
    meta = _meta_state(cfg, st, opt)
    saves = []
    save0 = _timed(ckpt, "save", saves)
    try:
        with set_mesh(mesh):
            state = init_state(cfg, st, opt, TrainConfig(),
                               torch.Generator("cuda").manual_seed(seed), "cuda")
            snap = {}

            def metrics(step, loss):
                if step == 0:  # the state saved as step 1
                    snap["state"] = {"params": tree_map(lambda p: p.detach().clone(),
                                                        state["params"]),
                                     "opt": tree_map(torch.Tensor.clone, state["opt"]),
                                     "step": 1}

            loop = TrainLoop(cfg, st, opt, TrainConfig(steps=2, ckpt_dir=d, ckpt_every=1,
                                                       log_every=10**9), pipe, device="cuda",
                             hooks={"metrics": metrics})
            t0 = time.perf_counter()
            saved, losses = loop.run(initial_state=state, start_step=0)
            train_s = time.perf_counter() - t0
        (entry,) = loop.step_fn.runner.plans.values()
        first_call = dict(entry.build_s)
        del loop, entry
    finally:
        ckpt.save = save0
    check(ckpt.intact_steps(d) == [1, 2], f"saved steps {ckpt.intact_steps(d)}")
    man = ckpt._load_manifest(d, 2)
    spec_off = []
    for l in man["leaves"]:
        dm = ckpt._dims_mapping(target[l["key"]], len(l["shape"]))
        want_spec = project_dims_mapping(mesh, [tuple(a) for a in dm], l["shape"])
        if l["spec"] != [list(a) for a in want_spec.dims_mapping]:
            spec_off.append((l["key"], l["spec"]))
    check(not spec_off and man["mesh"] == {"shape": [2, 4], "axes": ["data", "model"]},
          f"the manifest's specs: {spec_off}, mesh {man['mesh']}")
    nbytes = sum(os.path.getsize(os.path.join(d, "step_00000002", f))
                 for f in os.listdir(os.path.join(d, "step_00000002")))
    print(f"  reshard: saved {losses} at steps 1, 2 on (data 2, model 4): {len(man['leaves'])} "
          f"leaves, {nbytes / 1e9:.3f} GB a step; predicted {json.dumps(predicted)}", flush=True)

    keys = [(l["key"], None) for l in man["leaves"]]
    base_state = sum(t.numel() * t.element_size() for _, t in leaves_with_paths(saved)
                     if isinstance(t, torch.Tensor))
    restores, trained = {}, {}
    for name, new, own in checkpoint_restores():
        pred, specs = predicted["meshes"][name], target if own == "own" else None
        kept = None
        for sharded_io in (False, True) if own == "own" else (False,):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tree, _, rep = ckpt.restore_resharded(d, meta, new, specs, step=2,
                                                  sharded_io=sharded_io, device="cuda",
                                                  profile=profile)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - before
            off = _same_state(tree, saved)
            plan = ckpt.plan_restore_reshard(man, keys, new, specs)
            got = {k: rep[k] for k in ("wire_bytes", "launches", "resharded_leaves")}
            label = f"{name} {'sliced' if sharded_io else 'full'}"
            restores[label] = {"s": secs, "gbs": nbytes / secs / 1e9, "peak_gib": peak / 2**30,
                               "state_gib": base_state / 2**30, "report": rep,
                               "bit_equal": not off}
            print(f"    restore onto {name} {tuple(new.shape)} ({'sliced' if sharded_io else 'full'}"
                  f" reads): {secs:.3f} s ({nbytes / secs / 1e9:.2f} GB/s), peak "
                  f"{peak / 2**30:.3f} GiB above {base_state / 2**30:.3f} GiB of state; "
                  f"{json.dumps({k: rep[k] for k in rep if k not in ('missing', 'unused')})}",
                  flush=True)
            check(not off, f"{label}: restored leaves off the saved state: {off}")
            check(verify_state_reshard(plan).ok, f"{label}: the reshard plan did not verify")
            check(rep["ratio_vs_gather_all"] <= 1.0, f"{label}: {rep['ratio_vs_gather_all']}")
            check(got == {k: pred[k] for k in got}, f"{label}: plan {got} != predicted {pred}")
            if sharded_io or own != "own":
                del tree
            else:
                kept = tree
        if kept is not None:
            trained[name] = checkpoint_train_on(cfg, st, opt, pipe, new, kept, want)
        del kept
        torch.cuda.empty_cache()

    # planted faults on step 2's largest sharded leaf
    big = max((l for l in man["leaves"] if any(l["spec"])),
              key=lambda l: int(np.prod(l["shape"], dtype=np.int64)))
    path = os.path.join(d, "step_00000002", big["file"])
    offset = ckpt._npy_header(path)[3]
    with open(path, "r+b") as f:
        f.seek(offset + (os.path.getsize(path) - offset) // 2)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    new, faults = checkpoint_restores()[0][1], {}
    try:
        ckpt.restore_resharded(d, meta, new, target, step=2, device="cuda")
        faults["pinned"] = "no error"
    except ckpt.CheckpointCorruptError as e:
        faults["pinned"] = e.key
    tree, _, rep = ckpt.restore_resharded(d, meta, new, target, device="cuda")
    faults["flipped"] = {"step": rep["step"], "fell_back_from": rep["fell_back_from"],
                         "off": _same_state(tree, snap["state"])}
    del tree
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    tree, _, rep = ckpt.restore_resharded(d, meta, new, target, sharded_io=True, device="cuda")
    faults["truncated"] = {"step": rep["step"], "fell_back_from": rep["fell_back_from"],
                           "off": _same_state(tree, snap["state"])}
    del tree
    rc, verify_s, verify_out = _verify_cli(d)
    faults["verify_rc"] = rc
    print(f"    planted faults in {big['key']}: {json.dumps(faults)}; verify CLI {verify_s:.3f} s",
          flush=True)
    check(faults["pinned"] == big["key"], f"the flipped byte: {faults['pinned']}")
    for kind in ("flipped", "truncated"):
        check(faults[kind] == {"step": 1, "fell_back_from": [2], "off": []},
              f"the {kind} leaf's fallback: {faults[kind]}")
    check(rc != 0, "the verify CLI passed a corrupt directory")
    return {"losses": losses, "train_s": train_s, "first_call_s": first_call,
            "save_s": [r["s"] for r in saves], "save_gbs": [_gbs(r) for r in saves],
            "checkpoint_bytes": nbytes, "predicted": predicted, "restores": restores,
            "train_on": trained, "faults": faults, "largest_sharded_leaf": big["key"],
            "verify_corrupt_s": verify_s, "card": card}


def checkpoint_train_on(cfg, st, opt, pipe, mesh, restored, want):
    """One ``TrainLoop`` step (step 2) under ``mesh`` from the restored
    state against the same step unsharded from a copy of it."""
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.tree import leaves, leaves_with_paths, tree_map
    from repro_torch.train.loop import TrainConfig, TrainLoop

    mods = _kernel_modules()
    copy = lambda s: {"params": tree_map(lambda p: p.detach().clone().requires_grad_(),  # noqa
                                         s["params"]),
                      "opt": tree_map(torch.Tensor.clone, s["opt"]), "step": s["step"]}
    twin, before = copy(restored), tree_map(lambda p: p.detach().clone(), restored["params"])
    runs = {}
    for tag, m, state in (("sharded", mesh, restored), ("unsharded", None, twin)):
        counts = {}

        def fault(step):
            for mod in mods.values():
                mod.launches = 0

        def metrics(step, loss):
            counts.update({n: mod.launches for n, mod in mods.items()})

        t0 = time.perf_counter()
        with set_mesh(m):
            loop = TrainLoop(cfg, st, opt, TrainConfig(steps=3, log_every=10**9), pipe,
                             device="cuda", hooks={"fault": fault, "metrics": metrics})
            after, (loss,) = loop.run(initial_state=state, start_step=2)
        runs[tag] = {"loss": loss, "params": after["params"], "launches": counts,
                     "seconds": time.perf_counter() - t0,
                     "runner": getattr(loop.step_fn, "runner", None)}
    runner = runs["sharded"].pop("runner")
    (entry,) = runner.plans.values()
    two, one, sign_agree = [], [], 1.0
    for (path, p), q, p0 in zip(leaves_with_paths(runs["sharded"]["params"]),
                                leaves(runs["unsharded"]["params"]), leaves(before)):
        du, dq = (p.detach() - p0).flatten(), (q.detach() - p0).flatten()
        if p.ndim >= 2:
            two.append(du)
            one.append(dq)
        else:
            sign_agree = min(sign_agree, (du.sign() == dq.sign()).float().mean().item())
    update_rel = _rel(torch.cat(two), torch.cat(one))
    loss_over = _err_over(torch.tensor(runs["sharded"]["loss"]),
                          torch.tensor(runs["unsharded"]["loss"]), "bf16_chain")
    limit = TOLERANCES["bf16_grad"][0]
    rec = {"shape": list(mesh.shape), "loss_sharded": runs["sharded"]["loss"],
           "loss_unsharded": runs["unsharded"]["loss"], "loss_err_over_bf16_chain": loss_over,
           "update_rel_2d": update_rel, "sign_agreement_1d": sign_agree,
           "first_call_s": dict(entry.build_s), "plan_steps": len(entry.plan.steps),
           "launches": runs["sharded"]["launches"],
           "fallback_gathers": list(runner.fallback_gathers),
           "seconds": {t: r["seconds"] for t, r in runs.items()}}
    print(f"    train on {tuple(mesh.shape)}: loss {rec['loss_sharded']:.6f} against unsharded "
          f"{rec['loss_unsharded']:.6f} (err/limit {loss_over:.3f}, bf16_chain); update over "
          f"2-D+ leaves {update_rel:.3e} in norm (bf16_grad {limit}), 1-D signs agreeing "
          f"{sign_agree:.4f}; first call {json.dumps(rec['first_call_s'])}; plan "
          f"{rec['plan_steps']} steps; launches {rec['launches']}", flush=True)
    check(rec["launches"] == want and runs["unsharded"]["launches"] == want,
          f"train on {mesh.shape}: launches {rec['launches']}, "
          f"{runs['unsharded']['launches']}, want {want}")
    check(not rec["fallback_gathers"], f"train on {mesh.shape}: {rec['fallback_gathers']}")
    check(loss_over <= 1.0 and update_rel <= limit and sign_agree >= 0.95,
          f"train on {mesh.shape}: off the unsharded step: {rec}")
    return rec


def checkpoint_phase(seed, card):
    """Checkpoints on the card (``checkpoint_restart_case``, then
    ``elastic_phase``, then ``checkpoint_reshard_case``), in temporary
    directories under ``build/`` removed at the end."""
    import tempfile

    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="ckpt-", dir=str(build))
    free = shutil.disk_usage(root).free
    print(f"checkpoint: crash and restart through launch.train.main, and a cross-mesh restore "
          f"through the partitioner; {free / 1e9:.1f} GB free under {build}; {card}", flush=True)
    try:
        restart = checkpoint_restart_case(seed, card, root)
        torch.cuda.empty_cache()
        elastic = elastic_phase(seed, card)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        reshard = checkpoint_reshard_case(seed, card, root)
        reshard["seconds"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"checkpoint: {seconds:.1f} s (elastic {elastic['seconds']:.1f} s, reshard "
          f"{reshard['seconds']:.1f} s of it)", flush=True)
    return {"restart": restart, "elastic": elastic, "reshard": reshard,
            "free_disk_gb": free / 1e9, "seconds": seconds}


def checkpoint_phase_in_own_process(seed, card, timeout=450):
    """``checkpoint_phase`` in a fresh process, with its own time limit."""
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); import torch, chip_smoke; "
            "torch.backends.cuda.matmul.allow_tf32 = False; "
            "torch.backends.cudnn.allow_tf32 = False; "
            f"print(json.dumps(chip_smoke.checkpoint_phase({seed}, {card!r})))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout)
    lines = proc.stdout.splitlines()
    print("\n".join(lines[:-1] if proc.returncode == 0 else lines), flush=True)
    check(proc.returncode == 0 and lines,
          f"the checkpoint phase failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------------
# elastic recovery (launch/elastic.py): shrink, rewind and regrow under the
# partitioned train step
# ---------------------------------------------------------------------------------

ELASTIC_STEPS = 12
ELASTIC_SCHEDULE = {"version": 1, "events": [  # a FaultInjector schedule, as its JSON
    {"kind": "device_loss", "step": 3, "lose": 4},
    {"kind": "nan_burst", "step": 6, "steps": 2},
    {"kind": "manifest_corrupt", "step": 9},
    {"kind": "device_return", "step": 9, "gain": 4},
]}
# the recovery log the schedule gives: classes, restored from, the mesh after,
# rewound to, fell back from (the reference's coordinator gives the same at a
# world of one, lose and gain 0)
ELASTIC_LOG = [
    (["device_loss"], 2, [2, 2], None, None),
    (["numerics"], 6, [2, 2], 6, None),
    (["corrupt_checkpoint", "device_return"], 6, [4, 2], None, [8]),
]
ELASTIC_KNOBS = dict(top_n=2, sa_steps=2, max_candidates=6)  # the reference tests' knobs


def _elastic_gates(co, state, events, spec, corrupted):
    """The drill's invariant battery (``chaos.check_invariants``) and two
    planted faults it must catch: the loss log with one step removed, and
    the newest manifest's data cursor off by one (re-checksummed, so that
    it still verifies).  Returns (violations, planted violations)."""
    import types

    from repro_torch.launch import chaos
    from repro_torch.train import checkpoint as ckpt

    violations = chaos.check_invariants(co, state, events, spec, corrupted)
    gap = dict(co.losses)
    del gap[max(set(gap) - set(co.loop.skipped_steps))]  # a step the guard never skipped
    planted = {"loss_removed": chaos.check_invariants(
        types.SimpleNamespace(losses=gap, loop=co.loop, tc=co.tc, injector=co.injector,
                              recoveries=co.recoveries), state, events, spec, corrupted)}
    d, last = co.tc.ckpt_dir, ckpt.latest_step(co.tc.ckpt_dir)
    man = ckpt._load_manifest(d, last)
    man["extra"]["data_cursor"] += 1
    man.pop("checksum")
    man["checksum"] = ckpt._manifest_checksum(man)
    with open(os.path.join(d, f"step_{last:08d}", "manifest.json"), "w") as f:
        json.dump(man, f)
    planted["cursor_off_by_one"] = chaos.check_invariants(co, state, events, spec, corrupted)
    return violations, planted


def elastic_phase(seed, card):
    """``ElasticCoordinator`` (``launch/elastic.py``) through
    ``ELASTIC_SCHEDULE`` under qwen1.5-0.5b's partitioned train step at its
    published widths (``SCAN_LAYERS["none"]`` layers scanned, remat "none",
    2d_finalized, B8 S512, bf16 compute, float32 masters, Adafactor) over a
    simulated world of eight devices with ``model_parallel`` 2, so that it
    starts on ("data" 4, "model" 2), shrinks to (2, 2), rewinds and grows
    back; then the same 12 steps uninterrupted on (4, 2) from the same
    initial state.  In a temporary directory under ``build/``, removed at
    the end.  Gates and readings: module docstring, phase 13."""
    import tempfile

    from repro_torch.autoshard import AutoshardConfig
    from repro_torch.configs.base import get_strategy
    from repro_torch.core.compat import TOLERANCES, set_mesh
    from repro_torch.core.plan import GuardConfig, NumericsFault
    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.launch import chaos
    from repro_torch.launch.elastic import (DeviceLossError, DeviceReturnError,
                                            ElasticCoordinator, FaultInjector, derive_mesh)
    from repro_torch.obs import control_events, recovery_narrative
    from repro_torch.train.loop import TrainConfig, TrainLoop
    from repro_torch.train.optimizer import get_optimizer

    t_phase = time.perf_counter()
    cfg = partition_train_config(SCAN_LAYERS["none"]).with_(scan_layers=True)
    st, opt, L, V = get_strategy("2d_finalized"), get_optimizer("adafactor"), cfg.num_layers, \
        cfg.vocab_size
    profile, _ = card_profile()
    pipe = lambda: TokenPipeline(DataConfig(V, SCAN_S, SCAN_B, seed=seed,  # noqa: E731
                                            pattern="arithmetic"))
    guard = GuardConfig(rewind_after=2)
    label = (f"qwen1.5-0.5b train step, {L} layers scanned, 2d_finalized, remat none, "
             f"B{SCAN_B} S{SCAN_S}, bf16, {ELASTIC_STEPS} steps")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="elastic-", dir=str(build))
    print(f"elastic: ElasticCoordinator over 8 simulated devices (model_parallel 2) under the "
          f"{label}; schedule {json.dumps(ELASTIC_SCHEDULE['events'])}; {card}", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mods = _kernel_modules()
    steps, faults_at, runners, rows, clock = [], [], {}, [], {}
    saved = [(fa, "flash_attention", fa.flash_attention),
             (fab, "flash_attention_bwd", fab.flash_attention_bwd)]
    for mod, name, fn in saved:  # each call's folded rows: every simulated device's

        def watched(*args, fn=fn, name=name, **kw):
            rows.append((name, int(args[0].shape[0])))
            return fn(*args, **kw)

        setattr(mod, name, watched)
    try:
        tc = TrainConfig(steps=ELASTIC_STEPS, ckpt_dir=os.path.join(root, "ck"), ckpt_every=2,
                         keep_ckpts=3, log_every=10**9, guard=guard)
        inj = FaultInjector.load_schedule(json.loads(json.dumps(ELASTIC_SCHEDULE)))

        def on_numerics(step, leaves, consecutive):
            if consecutive >= guard.rewind_after:
                faults_at.append(("numerics", step, time.perf_counter()))

        co = ElasticCoordinator(cfg, st, opt, tc, pipe(), n_devices=8, model_parallel=2,
                                autoshard_config=AutoshardConfig(**ELASTIC_KNOBS),
                                injector=inj, max_recoveries=4, device="cuda",
                                gen=torch.Generator("cuda").manual_seed(seed),
                                plan_profile=profile, hooks={"numerics_fault": on_numerics})
        check(co.mesh.shape == (4, 2), f"elastic: starts on {co.mesh.shape}")
        inner_fault, inner_metrics = co.loop.hooks["fault"], co.loop.hooks["metrics"]

        def fault(step):
            for mod in mods.values():
                mod.launches = 0
            rows.clear()
            clock["t0"] = time.perf_counter()
            try:
                inner_fault(step)
            except (DeviceLossError, DeviceReturnError) as e:
                faults_at.append((type(e).__name__, step, time.perf_counter()))
                raise

        def metrics(step, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            runner = co.loop.step_fn.runner
            first = id(runner) not in runners
            if first:
                (entry,) = runner.plans.values()
                runners[id(runner)] = {"runner": runner, "mesh": list(co.mesh.shape),
                                       "build_s": dict(entry.build_s), "first_step": step}
            steps.append({"step": step, "loss": loss, "mesh": list(co.mesh.shape),
                          "wall_s": now - clock["t0"], "at": now, "first_of_runner": first,
                          "launches": {n: m.launches for n, m in mods.items()},
                          "rows": sorted(set(rows)),
                          "fallback_gathers": list(runner.fallback_gathers)})
            inner_metrics(step, loss)

        co.loop.hooks.update(fault=fault, metrics=metrics)
        t0 = time.perf_counter()
        cold = co.solve_assignment()
        cold_rec = {"s": time.perf_counter() - t0, "evals": cold.evals,
                    "warm_started": cold.warm_started}
        n0 = len(control_events())
        state, losses = co.run()
        events = control_events()[n0:]
        drill_s = time.perf_counter() - t0
        corrupted = [ev["corrupted_step"] for ev in inj.schedule
                     if ev.get("corrupted_step") is not None]
        spec = chaos.CampaignSpec(seed=seed, steps=ELASTIC_STEPS, ckpt_every=2, keep_ckpts=3,
                                  rewind_after=guard.rewind_after, world=8, model_parallel=2,
                                  schedule=ELASTIC_SCHEDULE["events"])
        violations, planted = _elastic_gates(co, state, events, spec, corrupted)
        narrative = recovery_narrative(events)

        # per mesh: device busy of one step and the whole-vocabulary check,
        # on the final state (the runners are functional: nothing written back)
        batch = {k: torch.from_numpy(v).to("cuda").long() for k, v in pipe().batch_at(0).items()}
        args = (tree_map(torch.Tensor.detach, state["params"]), state["opt"],
                torch.tensor(0, dtype=torch.int64, device="cuda"), batch)
        per_runner, busy = [], {}
        for rec in reversed(list(runners.values())):
            per_runner.insert(0, {k: rec[k] for k in ("mesh", "first_step", "build_s")})
            key = str(tuple(rec["mesh"]))
            if key in busy:  # the mesh's last runner (the clean (2, 2), the regrown (4, 2))
                continue     # reads for it; the earlier one differs by the fault window
            run = rec["runner"]
            with torch.no_grad():
                per_runner[0]["whole_vocab_steps"] = whole_vocab_steps(run, args, V)
                busy[key] = device_ms(lambda i: run(*args), 1, calls=1, warm=False)
        del args, runners
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        recoveries, final_mesh = co.recoveries, list(co.mesh.shape)
        del co, state, inj
        torch.cuda.empty_cache()

        # the same 12 steps uninterrupted on (4, 2) from the same initial state
        t1 = time.perf_counter()
        with set_mesh(derive_mesh(8, 2)):
            loop = TrainLoop(cfg, st, opt, TrainConfig(steps=ELASTIC_STEPS, log_every=10**9,
                                                       guard=guard), pipe(), device="cuda",
                             gen=torch.Generator("cuda").manual_seed(seed), plan_profile=profile)
            _, want = loop.run()
        straight_s = time.perf_counter() - t1
        del loop
        torch.cuda.empty_cache()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        shutil.rmtree(root, ignore_errors=True)

    # readings per recovery: the fault, the first finished step after it
    readings = []
    for rec, (kind, fstep, ft) in zip(recoveries, faults_at):
        nxt = next((s for s in steps if s["at"] > ft), None)
        first_runner = next((r for r in per_runner if nxt and r["first_step"] == nxt["step"]
                             and r["mesh"] == nxt["mesh"]), None)
        readings.append({
            "classes": rec["classes"], "step": rec["step"], "mesh": rec["mesh"],
            "restored_from": rec.get("restored_from"), "rewound_to": rec.get("rewound_to"),
            "fell_back_from": rec.get("fell_back_from"), "duration_ms": rec["duration_ms"],
            "solve": ({"s": rec["solve_s"], "evals": rec["evals"],
                       "warm_started": rec["warm_started"], "degraded": rec["degraded"]}
                      if "evals" in rec else None),
            "restore": {"s": rec.get("restore_s"), **rec.get("reshard", {}),
                        "io": rec.get("io")},
            "first_step_after": (None if nxt is None else {
                "step": nxt["step"], "wall_s": nxt["wall_s"],
                "build_s": first_runner["build_s"] if first_runner else None}),
            "fault_to_next_step_s": None if nxt is None else nxt["at"] - ft,
            "fault": kind})
    after_rewind = False
    numerics_after_rewind = []
    for e in events:
        if e["name"] == "rewind":
            after_rewind = True
        elif e["name"] == "numerics_fault" and after_rewind:
            numerics_after_rewind.append(e["args"].get("step"))
    loss_over = _err_over(torch.tensor(losses), torch.tensor(want), "loss_curve")
    seconds = time.perf_counter() - t_phase
    for r in readings:
        print(f"  recovery {r['classes']} at step {r['step']} ({r['fault']}): mesh "
              f"{r['mesh']['from']} -> {r['mesh']['to']}, restored step {r['restored_from']}, "
              f"rewound to {r['rewound_to']}, fell back from {r['fell_back_from']}"
              f"; {r['duration_ms']:.1f} ms; solve {json.dumps(r['solve'])}; restore "
              f"{json.dumps(r['restore'], default=str)}; first step after "
              f"{json.dumps(r['first_step_after'])}; fault to the next finished step "
              f"{r['fault_to_next_step_s']:.3f} s", flush=True)
    print(f"  the first (cold) solve on (4, 2): {json.dumps(cold_rec)}; drill {drill_s:.1f} s, "
          f"uninterrupted run {straight_s:.1f} s; final mesh {final_mesh}", flush=True)
    print(f"  losses {losses}", flush=True)
    print(f"  uninterrupted {want}; err/limit {loss_over:.4f} (loss_curve)", flush=True)
    print(f"  per step: " + "; ".join(
        f"{s['step']} {tuple(s['mesh'])} {s['launches']['flash_attention']}+"
        f"{s['launches']['flash_attention_bwd']} rows {s['rows']} {s['wall_s'] * 1e3:.0f} ms"
        for s in steps), flush=True)
    print(f"  runners: {json.dumps(per_runner)}", flush=True)
    print(f"  device busy a step ({card}): {json.dumps(busy)}; allocator peak {peak:.3f} GiB "
          f"above the phase's start", flush=True)
    print(f"  invariants {violations}; planted: {json.dumps(planted)}; narrative "
          f"{json.dumps([{k: ep[k] for k in ('classes', 'restores', 'mesh')} for ep in narrative])}",
          flush=True)
    print(f"elastic: {seconds:.1f} s", flush=True)

    check(violations == [], f"elastic: invariants {violations}")
    check(all(planted.values()), f"elastic: a planted fault passed the battery: {planted}")
    got_log = [(r["classes"], r.get("restored_from"), r["mesh"]["to"], r.get("rewound_to"),
                r.get("fell_back_from")) for r in recoveries]
    check(got_log == ELASTIC_LOG, f"elastic: recovery log {got_log}, want {ELASTIC_LOG}")
    restores = [e for e in events if e["name"] == "restore"]
    check(len(restores) == 3 and [ep["restores"] for ep in narrative] == [1, 1, 1]
          and [sorted(ep["classes"]) for ep in narrative] == [c for c, *_ in ELASTIC_LOG],
          f"elastic: {len(restores)} restores, narrative {narrative}")
    check(all(r["solve"]["warm_started"] and not r["solve"]["degraded"]
              for r in readings if r["solve"] is not None)
          and sum(r["solve"] is not None for r in readings) == 2,
          f"elastic: mesh changes not warm-started: {[r['solve'] for r in readings]}")
    check(numerics_after_rewind == [], f"elastic: faults after the rewind at "
                                        f"{numerics_after_rewind}")
    check(len(losses) == ELASTIC_STEPS and len(want) == ELASTIC_STEPS and loss_over <= 1.0,
          f"elastic: losses off the uninterrupted run ({loss_over:.3f} of loss_curve)")
    meshes = {tuple(s["mesh"]) for s in steps}
    check(meshes == {(4, 2), (2, 2)}, f"elastic: meshes {meshes}")
    for s in steps:
        m = s["mesh"]
        fold = m[0] * m[1] * (SCAN_B // m[0])
        check(s["launches"]["flash_attention"] == L and s["launches"]["flash_attention_bwd"] == L
              and s["rows"] == [("flash_attention", fold), ("flash_attention_bwd", fold)]
              and s["fallback_gathers"] == [],
              f"elastic: step {s['step']} on {m}: {s['launches']}, rows {s['rows']} (want "
              f"{fold}), gathers {s['fallback_gathers']}")
    vocab = [r["whole_vocab_steps"] for r in per_runner if "whole_vocab_steps" in r]
    check(len(vocab) == 2 and vocab == [[], []], f"elastic: whole-vocab steps {vocab}")
    return {"card": card, "label": label, "schedule": ELASTIC_SCHEDULE["events"],
            "recoveries": readings, "cold_solve": cold_rec, "losses": losses,
            "uninterrupted": want, "loss_err_over_loss_curve": loss_over,
            "steps": [{k: v for k, v in s.items() if k != "at"} for s in steps],
            "runners": per_runner, "busy_ms": busy, "peak_gib": peak,
            "launches_per_step": {str(tuple(s["mesh"])): s["launches"] for s in steps},
            "invariants": violations, "planted": planted, "drill_s": drill_s,
            "uninterrupted_s": straight_s, "seconds": seconds}


# the kernels' templates by variant, as the mangled names in ptxas's report,
# in the SASS and in profiler traces show them
VARIANT_OF = {"flash_bwd_prep": "bwd_prep", "flash_bwd_main": "bwd_main",
              "flash_bwd_dq_out": "bwd_dq_out",
              "flash_bwd_dq_f32": "bwd_dq_f32", "flash_bwd_dkdv_f32": "bwd_dkdv_f32",
              "flash_wgmma": "prefill_wgmma", "flash_decode": "decode_splitkv",
              "flash_fwd": "prefill_f32", "ssd_chunk_state": "ssd_chunk_state",
              "ssd_state_pass": "ssd_state_pass", "ssd_chunk_out": "ssd_chunk_out",
              "ssd_bwd_chunk_local": "ssd_bwd_chunk_local", "ssd_bwd_scans": "ssd_bwd_scans",
              "ssd_bwd_inter": "ssd_bwd_inter", "ssd_bwd_intra": "ssd_bwd_intra",
              "ssd_bwd_dbc": "ssd_bwd_dbc", "ssd_bwd_da": "ssd_bwd_da"}
# the kernels whose products run on wgmma (HGMMA in the SASS)
HGMMA_VARIANTS = ("prefill_wgmma", "bwd_main")
# the SSD launches whose products run on the tensor cores with mma.sync
# (ssd_state_pass and ssd_bwd_scans only move the states, ssd_bwd_da sums:
# no product)
HMMA_VARIANTS = ("ssd_chunk_state", "ssd_chunk_out", "ssd_bwd_chunk_local", "ssd_bwd_inter",
                 "ssd_bwd_intra", "ssd_bwd_dbc")
# the backward's launches per call
BWD_LAUNCHES_BF16 = ("bwd_prep", "bwd_main", "bwd_dq_out")
BWD_LAUNCHES_F32 = ("bwd_dq_f32", "bwd_dkdv_f32")
# the SSD backward's launches per call
SSD_BWD_LAUNCHES = ("ssd_bwd_chunk_local", "ssd_bwd_scans", "ssd_bwd_inter", "ssd_bwd_intra",
                    "ssd_bwd_dbc", "ssd_bwd_da")


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


def scan_node_check():
    """The scan node (``core/scan.py``) with this torch, early: a small loop
    on the card captured with its gradient (one ``scan_fwd`` node and its
    reverse ``scan``), the captured graph run against the eager loop."""
    from repro_torch.core.compat import capture
    from repro_torch.core.scan import scan

    gen = torch.Generator(device="cuda").manual_seed(3)
    W, x0 = torch.randn(4, 64, 64, generator=gen, device="cuda"), torch.randn(8, 64, device="cuda")

    def prog(W, x0):
        W, x0 = W.detach().requires_grad_(), x0.detach().requires_grad_()
        with torch.enable_grad():
            h, ys = scan(lambda c, w: (torch.tanh(c @ w), c.sum()), x0, W)
            loss = h.sum() + ys.sum()
            return (loss,) + torch.autograd.grad(loss, [W, x0])

    cap = capture(prog, W, x0)
    nodes = collections.Counter(str(n.target) for n in cap.graph.nodes if n.op == "call_function")
    err = max(_err_over(a, b, "f32") for a, b in zip(cap.gm(W, x0), prog(W, x0)))
    print(f"  scan node under capture on torch {torch.__version__}: "
          f"{nodes['repro_torch.scan_fwd.default']} scan_fwd and "
          f"{nodes['repro_torch.scan.default']} scan nodes, err/f32 {err:.3f} against the "
          "eager loop", flush=True)
    check(nodes["repro_torch.scan_fwd.default"] == 1 and nodes["repro_torch.scan.default"] == 1
          and err <= 1.0, f"the scan node: {dict(nodes)}, err/f32 {err}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--plan-peaks", action="store_true",
                    help="only build the kernels and run plan_peaks_phase (qwen's partitioned "
                         "train step with unoptimized and optimized plans); no result line")
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
    t0 = time.perf_counter()
    build = build_kernels()
    if args.plan_peaks:
        rows = plan_peaks_phase(args.seed, smi)
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "plan_peaks.json").write_text(json.dumps(rows, indent=1))
        print(f"plan peaks: done at {time.perf_counter() - t0:.0f} s", flush=True)
        return 0
    scan_node_check()

    print("kernel: flash_attention (CUDA) vs plain PyTorch on the card", flush=True)
    fa_cases = kernel_phase(args.seed)
    print("kernel: flash_attention_bwd (CUDA) vs plain PyTorch on the card", flush=True)
    bwd_cases = bwd_phase(args.seed)
    print("kernel: ssd_scan (CUDA) vs plain PyTorch on the card", flush=True)
    ssd_cases = ssd_phase(args.seed)
    ssd_cancel = ssd_cancelling_sums(torch.Generator(device="cuda").manual_seed(args.seed + 11))
    print("kernel: ssd_scan_bwd (CUDA) vs the plain backward in float64 on the card", flush=True)
    ssd_bwd_cases = ssd_bwd_phase(args.seed)

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
    del params
    torch.cuda.empty_cache()
    mamba_train = train_phase(args.seed, arch="mamba2-130m", B=8, S=2048)
    torch.cuda.empty_cache()
    mamba_two_layer = mamba_two_layer_phase(args.seed)
    torch.cuda.empty_cache()

    print(f"partition (at {time.perf_counter() - t0:.0f} s): the port's partitioner on a "
          "simulated (2,4) mesh, by compiled plan and by the dynamic path, against the same "
          "functions unsharded on the card", flush=True)
    partition = partition_phase_in_own_process(args.seed)
    print(f"partition (at {time.perf_counter() - t0:.0f} s): Mamba2's loss and serving of both "
          "families through the partitioner, against the same paths unsharded on the card",
          flush=True)
    sharded = sharded_phases_in_own_process(args.seed, partition["card"])
    print(f"pipeline (at {time.perf_counter() - t0:.0f} s): GSPMD §3.3 pipelining through the "
          "partitioner on a simulated (\"stage\" 4, \"model\" 2) mesh, against the unpipelined "
          "and the unsharded steps", flush=True)
    pipeline = pipeline_phase_in_own_process(args.seed, partition["card"])
    print(f"checkpoint (at {time.perf_counter() - t0:.0f} s): crash and restart through "
          "launch.train.main, and the partitioned state restored onto other meshes", flush=True)
    checkpoint = checkpoint_phase_in_own_process(args.seed, partition["card"])
    print(f"phases done at {time.perf_counter() - t0:.0f} s (obs {sharded['obs']['seconds']:.0f} "
          f"s, autoshard {sharded['autoshard']['seconds']:.0f} s, plan_opt {sharded['plan_opt']['seconds']:.0f} s, scan "
          f"{sharded['scan']['seconds']:.0f} s, "
          f"pipeline {pipeline['seconds']:.0f} s, checkpoint {checkpoint['seconds']:.0f} s "
          f"with elastic {checkpoint['elastic']['seconds']:.0f} s of them)", flush=True)

    fa_main = next(c for c in fa_cases if c["case"] == "decode_8x16_pos1023")
    fa_prefill = next(c for c in fa_cases if c["case"] == "prefill_qwen_loss_2x2048")
    ssd_main = next(c for c in ssd_cases if c["case"] == "loss_8x2048_h24")
    ssd_fold = next(c for c in ssd_cases if c["case"] == "partitioned_loss_fold_32x2048_h6")
    devpos = {c["case"]: c for c in fa_cases if c["case"].startswith("decode_devpos")}
    rowpos = {f"{c['case']} {c['dtype']}": c for c in fa_cases
              if c["case"].startswith("decode_rowpos")}
    ssd_bwd_main = next(c for c in ssd_bwd_cases if c["case"] == "train_8x2048_h24")
    ssd_bwd_fold = next(c for c in ssd_bwd_cases
                        if c["case"] == "partitioned_train_fold_32x512_h6")
    bwd_main = next(c for c in bwd_cases if c["case"] == "train_qwen_4x2048")
    bwd_fold = next(c for c in bwd_cases if c["case"] == "partitioned_train_fold_32x512_kr4")
    fa_fold = next(c for c in fa_cases if c["case"] == "partitioned_train_fold_32x512_kr4")
    fa_pipe = next(c for c in fa_cases if c["case"] == "pipeline_fold_16x512_kr8")
    bwd_pipe = next(c for c in bwd_cases if c["case"] == "pipeline_fold_16x512_kr8")
    pipe_launches = {  # per call of each pipelined gradient program
        name: {c["label"]: c["reads"]["pipelined"]["launches"][name] for c in pipeline["cases"]}
        for name in ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")}
    train_launches = {  # per step of each case's partitioned TrainLoop run
        name: {c["label"]: [r["launches"][name] for r in c["sharded_steps"]]
               for c in partition["train"]}
        for name in ("flash_attention", "flash_attention_bwd")}
    def scanned_launches(c, name):
        if "turns" in c:
            return c["turns"][0]["launches"][name]
        if "launches" in c:
            return c["launches"][name]
        return c["runs"]["scanned"]["launches_per_step"][name]

    elastic_launches = {  # per step of the elastic drill, by mesh
        name: {mesh: c[name] for mesh, c in checkpoint["elastic"]["launches_per_step"].items()}
        for name in ("flash_attention", "flash_attention_bwd")}
    scan_launches = {  # per call (per decode step for the engines) of the scanned plans
        name: {c["label"]: scanned_launches(c, name) for c in sharded["scan"]["cases"]}
        for name in ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    ssd_keys = ("dev_ms", "pass_dev_ms", "launches_per_call")
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "scan_launches_per_call": scan_launches["flash_attention"],
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": qwen_serve["launches"]["flash_attention"], "launches_path": "qwen serve",
        **{k: fa_main[k] for k in keys}, "main_case": fa_main["case"],
        "prefill_main_case": {"case": fa_prefill["case"], **{k: fa_prefill[k] for k in keys},
                              "launches": qwen_loss["launches"]["flash_attention"],
                              "launches_path": "qwen loss"},
        "partition_launches_per_call": {
            f"{c['case']} {c['dtype']}": c["compiled_flash_launches_per_call"]
            for c in partition["cases"] if "compiled_flash_launches_per_call" in c},
        "partition_train_launches_per_step": train_launches["flash_attention"],
        "partition_train_case": {"case": fa_fold["case"], **{k: fa_fold[k] for k in keys}},
        "pipeline_launches_per_call": pipe_launches["flash_attention"],
        "pipeline_case": {"case": fa_pipe["case"], **{k: fa_pipe[k] for k in keys}},
        "autoshard_launches_per_call": sharded["autoshard"]["launches"]["flash_attention"],
        "elastic_launches_per_step": elastic_launches["flash_attention"],
        "decode_position_on_device": {n: {k: c[k] for k in keys + ("device_ms", "splits")}
                                      for n, c in devpos.items()},
        "decode_position_per_row": {n: {k: c[k] for k in keys + (
            "device_ms", "splits", "shared_position_ms", "shared_position_device_ms")}
            for n, c in rowpos.items()},
        "partition_serve_launches_per_step": {
            f"{c['arch']} {c['strategy']} {c['layers']}L {c['dtype']}"
            + (" shard_kv_seq" if c["shard_kv_seq"] else ""):
            c["sharded_launches_per_step"]["flash_attention"] for c in sharded["serve"]},
        "cases": fa_cases,
    }, {
        "name": "ssd_scan", "route": "cuda",
        "scan_launches_per_call": scan_launches["ssd_scan"],
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:70",
        "launches": mamba_loss["launches"]["ssd_scan"], "launches_path": "mamba2 loss",
        **{k: ssd_main[k] for k in keys + ssd_keys}, "main_case": ssd_main["case"],
        "pipeline_launches_per_call": pipe_launches["ssd_scan"],
        "partition_loss_launches_per_forward": sharded["loss"]["sharded"]["launches"]["ssd_scan"],
        "partition_loss_case": {"case": ssd_fold["case"], **{k: ssd_fold[k] for k in keys + ssd_keys}},
        "cancelling_sums": ssd_cancel, "cases": ssd_cases,
    }, {
        "name": "flash_attention_bwd", "route": "cuda",
        "scan_launches_per_call": scan_launches["flash_attention_bwd"],
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:132",
        "launches": qwen_train["launches"]["flash_attention_bwd"],
        "launches_path": f"qwen train, {TRAIN_STEPS} steps",
        **{k: bwd_main[k] for k in keys}, "main_case": bwd_main["case"],
        "device_ms": bwd_main["device_ms"], "pass_device_ms": bwd_main["pass_device_ms"],
        "partition_train_launches_per_step": train_launches["flash_attention_bwd"],
        "partition_train_case": {"case": bwd_fold["case"], **{k: bwd_fold[k] for k in keys},
                                 "device_ms": bwd_fold["device_ms"]},
        "pipeline_launches_per_call": pipe_launches["flash_attention_bwd"],
        "autoshard_launches_per_call": sharded["autoshard"]["launches"]["flash_attention_bwd"],
        "elastic_launches_per_step": elastic_launches["flash_attention_bwd"],
        "pipeline_case": {"case": bwd_pipe["case"], **{k: bwd_pipe[k] for k in keys},
                          "device_ms": bwd_pipe["device_ms"]},
        "cases": bwd_cases,
    }, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "scan_launches_per_call": scan_launches["ssd_scan_bwd"],
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/models/ssm.py:76",
        "launches": mamba_train["launches"]["ssd_scan_bwd"],
        "launches_path": f"mamba2 train, {TRAIN_STEPS} steps",
        **{k: ssd_bwd_main[k] for k in keys + ssd_keys}, "main_case": ssd_bwd_main["case"],
        "errors": ssd_bwd_main["errors"],
        "pipeline_launches_per_call": pipe_launches["ssd_scan_bwd"],
        "partition_train_launches_per_step": {
            c["label"]: [r["launches"]["ssd_scan_bwd"] for r in c.get("sharded_steps", [])]
            for c in partition["mamba_train"]},
        "partition_train_case": {"case": ssd_bwd_fold["case"],
                                 **{k: ssd_bwd_fold[k] for k in keys + ssd_keys}},
        "cases": ssd_bwd_cases,
    }], "build": build, "qwen": {"serve": qwen_serve, "consistency": qwen_consistency,
                                 "loss": qwen_loss, "train": qwen_train,
                                 "two_layer_step": qwen_two_layer},
        "mamba2": {"loss": mamba_loss, "serve": mamba_serve, "consistency": mamba_consistency,
                   "train": mamba_train, "two_layer_step": mamba_two_layer},
        "partition": partition, "sharded": sharded, "pipeline": pipeline,
        "checkpoint": checkpoint}
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
