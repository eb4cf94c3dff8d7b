#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: the card's name and power limit, torch and CUDA versions,
   and the build of the flash-attention kernel from ``src/repro_torch``;
2. kernel: the CUDA kernel against its plain PyTorch version on the card at
   the shapes of the Pallas kernel's contract, GQA, prefill continuation and
   the serve path's decode, with times (CUDA events) for the kernel, the plain
   version and ``scaled_dot_product_attention`` (a yardstick only: the port
   never calls it) beside the card's bound for the same work;
3. serve: qwen1.5-0.5b at full width (random weights from the seed) behind
   ``Engine(slots=8, max_len=1024)`` answering 16 greedy requests; every
   decode step must launch the kernel once per layer;
4. consistency: ``forward`` (the kernel's causal branch) against the decode
   loop over the same tokens (its decode branch).

The last two lines of output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
import argparse
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
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
L2_BYTES = 50 * 2**20


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


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
    rec = {
        "case": name, "dtype": str(dtype).replace("torch.", ""),
        "kv_dtype": str(kv_dtype).replace("torch.", ""),
        "shape": dict(B=B, S=S, T=T, KR=KR, Gl=Gl, D=D, causal=causal,
                      q_offset=q_offset, kv_len=kv_len),
        "max_abs_err": max_abs_err, "tol": tol,
        "ms": time_ms(run_kernel, copies),
        "plain_ms": time_ms(run_plain, copies),
        "library_ms": time_ms(run_library, copies),
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "flops": flops, "bytes": nbytes,
    }
    print(f"  {name:30s} {rec['dtype']:8s} err {max_abs_err:.3g} ({tol}) "
          f"kernel {rec['ms']:.4f} ms  plain {rec['plain_ms']:.4f} ms  "
          f"sdpa {rec['library_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
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
    cases.append(kernel_case("continuation_128_of_1024", B=2, S=128, T=1024, KR=16, Gl=1,
                             D=64, dtype=bf16, causal=True, q_offset=896, chunk=1024,
                             layout="model", gen=gen))
    for pos in (0, 37, 1023):  # the serve path's decode: one kv chunk, kv_len = pos + 1
        cases.append(kernel_case(f"decode_8x16_pos{pos}", B=8, S=1, T=1024, KR=16, Gl=1,
                                 D=64, dtype=bf16, causal=False, q_offset=pos,
                                 kv_len=pos + 1, chunk=1024, layout="model", gen=gen))
    # a float32 model decoding from the bf16 cache
    cases.append(kernel_case("decode_f32q_bf16kv_pos100", B=2, S=1, T=256, KR=16, Gl=1, D=64,
                             dtype=f32, kv_dtype=bf16, causal=False, q_offset=100,
                             kv_len=101, chunk=256, layout="model", gen=gen))
    return cases


# ---------------------------------------------------------------------------------
# serve and consistency phases
# ---------------------------------------------------------------------------------


def full_width_model(seed):
    from repro_torch.configs.base import get_strategy
    from repro_torch.configs.registry import default_strategy, get_config, reduced_config
    from repro_torch.models import api
    from repro_torch.models.layers import tree_init

    cfg = reduced_config(get_config("qwen1.5-0.5b"), 1)
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.dh, cfg.d_ff,
           cfg.vocab_size, cfg.qkv_bias, cfg.dtype)
          == (24, 1024, 16, 16, 64, 2816, 151936, True, "bfloat16"), f"unexpected config {cfg}")
    st = get_strategy(default_strategy("qwen1.5-0.5b"))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = tree_init(api.param_tree(cfg, st), gen, dtype=cfg.dtype, device="cuda")
    return cfg, st, params


def serve_phase(cfg, st, params, seed):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.engine import Engine, Request

    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(8, 65, size=16)]
    eng = Engine(cfg, st, params, batch_slots=8, max_len=1024)
    reqs = [Request(prompt=p, max_new_tokens=32) for p in prompts]
    torch.cuda.synchronize()
    fa.launches = 0
    t0 = time.perf_counter()
    eng.generate(reqs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fa.launches
    steps = eng.pos
    ntok = sum(len(r.out) for r in reqs)
    print(f"serve: {len(reqs)} requests, {ntok} tokens in {seconds:.3f} s "
          f"({ntok / seconds:.1f} tok/s), {steps} decode steps, "
          f"{1e3 * seconds / steps:.2f} ms/step, flash_attention launches {launches}", flush=True)
    check(launches == steps * cfg.num_layers,
          f"launches {launches} != decode steps {steps} x {cfg.num_layers} layers")
    check(all(r.done and len(r.out) == 32 for r in reqs), "a request did not finish")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out), "token out of vocab")
    check(all(bool(torch.isfinite(c).all()) for c in eng.cache.values()), "non-finite kv cache")
    out = {"requests": len(reqs), "tokens": ntok, "seconds": seconds,
           "tok_per_s": ntok / seconds, "decode_steps": steps,
           "ms_per_step": 1e3 * seconds / steps, "launches": launches}
    out.update(profile_decode(cfg, st, params, eng, out["ms_per_step"]))
    return out


def profile_decode(cfg, st, params, eng, ms_per_step, steps=5):
    """Device time per decode step, from a torch.profiler trace of a few more
    steps into the served cache (each step's logits read back, as the
    engine's sampler does), beside the serve phase's wall time per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    token = torch.zeros((eng.B, 1), dtype=torch.long, device="cuda")
    check(eng.pos + steps < eng.T, "no room in the cache to profile")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            logits, _ = api.decode_step(cfg, st, params, token, eng.cache, eng.pos + i)
            logits[:, -1].float().cpu()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        print("profile: the trace holds no device events; device busy share not measured")
        return {}
    per_name = {}
    for e in device:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    busy = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:5]
    print(f"profile: {steps} decode steps from pos {eng.pos}: {len(device) / steps:.0f} device "
          f"ops/step, device busy {busy:.3f} ms/step = {busy / ms_per_step:.1%} of the serve "
          f"phase's {ms_per_step:.2f} ms/step", flush=True)
    for name, ms in top:
        print(f"  {ms:.4f} ms/step  {name[:90]}")
    return {"device_ops_per_step": len(device) / steps, "device_busy_ms_per_step": busy,
            "device_busy_share": busy / ms_per_step}


# forward vs decode: the same model in bf16 through two kernel branches and
# differently shaped matmuls.  One-ulp bf16 flips (2^-8 relative) at a few
# rounding points per layer compound over 24 layers to about 1e-2 relative;
# the bounds leave room of about 3x.  Argmax may differ only where the
# forward's top-2 margin is within twice the error bound of the logits' RMS
# (bf16 logits tie often), and must agree at 90 % of positions or more.
CONSIST_REL_ERR = 5e-2
CONSIST_AGREE = 0.90


def consistency_phase(cfg, st, params, seed):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api

    B, S = 2, 256
    tokens = torch.from_numpy(np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (B, S)))
    tokens = tokens.cuda()
    fa.launches = 0
    fwd, _ = api.forward(cfg, st, params, tokens)
    check(fa.launches == cfg.num_layers, f"forward launched {fa.launches}")
    cache = {k: torch.zeros(v, dtype=torch.bfloat16, device="cuda")
             for k, v in api.cache_shapes(cfg, st, B, S).items()}
    dec = []
    for pos in range(S):
        logits, cache = api.decode_step(cfg, st, params, tokens[:, pos:pos + 1], cache, pos)
        dec.append(logits)
    dec = torch.cat(dec, dim=1).float()
    fwd = fwd.float()
    check(fwd.shape == (B, S, cfg.vocab_size) and bool(torch.isfinite(fwd).all())
          and bool(torch.isfinite(dec).all()), "non-finite or misshapen logits")
    rel = ((dec - fwd).norm() / fwd.norm()).item()
    rms = fwd.square().mean().sqrt().item()
    top2 = fwd.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    agree = dec.argmax(-1) == fwd.argmax(-1)
    wide = margin > 2 * CONSIST_REL_ERR * rms
    print(f"consistency: forward vs {S} decode steps, B={B}: logits rel err {rel:.3e} "
          f"(<= {CONSIST_REL_ERR}), argmax agree {agree.float().mean().item():.4f} "
          f"(>= {CONSIST_AGREE}), disagreements at wide margins "
          f"{int((~agree & wide).sum())}, logits rms {rms:.3f}", flush=True)
    check(rel <= CONSIST_REL_ERR, f"forward vs decode rel err {rel}")
    check(agree.float().mean().item() >= CONSIST_AGREE, "forward vs decode argmax agreement")
    check(bool((agree | ~wide).all()), "argmax differs where the top-2 margin is wide")
    return {"rel_err": rel, "argmax_agree": agree.float().mean().item()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    lib = fa.build()
    build_s = time.perf_counter() - t0
    ptxas = lib.with_suffix(".log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill stores", ptxas))
    print(smi)
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | "
          f"kernel build {build_s:.1f} s ({lib.name})", flush=True)
    print(f"  ptxas: {len(regs)} kernel instantiations, registers {sorted(set(regs))}, "
          f"spill stores {spills} bytes", flush=True)

    print("kernel: flash_attention (CUDA) vs plain PyTorch on the card", flush=True)
    cases = kernel_phase(args.seed)
    cfg, st, params = full_width_model(args.seed)
    serve = serve_phase(cfg, st, params, args.seed)
    consistency_phase(cfg, st, params, args.seed)

    main_case = next(c for c in cases if c["case"] == "decode_8x16_pos1023")
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:81",
        "launches": serve["launches"],
        **{k: main_case[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
        "main_case": main_case["case"],
        "cases": cases,
    }], "serve": serve}
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
