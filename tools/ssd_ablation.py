#!/usr/bin/env python3
"""Where the SSD-scan kernel's time goes, by ablation, on one NVIDIA GPU.

    python3 tools/ssd_ablation.py [VARIANT]

Builds variants of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` with one part
of the work taken out or done the plain float32 way and prints each pass's
device time (torch.profiler) at the Mamba2 loss shape (B8 S2048 H24 hd64
ds128, Q 128) and at B1, with the largest error against the plain version
and whether it is within ``f32_chain``; then, over 12 seeds of
``tests/test_torch_cuda.py``'s cancelling-sums inputs (signed x * 10^3),
the ratio of the variant's largest error against float64 to the plain
float32 version's:

- ``kernel``: the source as it is;
- ``into_d``: each 3xTF32 step summed by the tensor core straight into the
  running accumulator, not into a fresh one;
- ``float32_l``: l by a plain float32 scan, without its compensation;
- ``into_d_float32_l``: both;
- ``1xTF32``: one tensor-core product per product instead of three;
- ``no_Wx``, ``no_CS``, ``no_G``: ssd_chunk_out without W x, without C S_in^T
  or without G = C B^T (their outputs are wrong by design; only their
  times count).

Then a mutation check: the kernel with the hi * lo term of its 3xTF32 split
dropped must fail both of ``tests/test_torch_cuda.py``'s large-x tests (the
non-negative one and the cancelling sums).  Each variant
runs in a process of its own (a long run of profiler sessions in one
process now and then loses device events).  Exits non-zero if a variant's
text is no longer in the source, a variant fails, or the mutation passes.

A one-off: it made the SSD redesign's ablation readings in PERF.md.  Its
variants are exact text edits of the kernel source as it stood then, so
after a change to those lines it stops with the variant's name rather than
measure something else; nothing else runs it.
"""
import pathlib
import statistics
import subprocess
import sys
import tempfile

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

MMA3 = """  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];"""
INTO_D = [(MMA3, """  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);""")]
FLOAT32_L = [("      rl += r + e;", "      rl = 0.f;"), ("      il += nl + r;", "      il = 0.f;")]
VARIANTS = {
    "kernel": [],
    "into_d": INTO_D,
    "float32_l": FLOAT32_L,
    "into_d_float32_l": INTO_D + FLOAT32_L,
    "1xTF32": [(MMA3, "  mma_tf32(d, ah, bh);")],
    "no_Wx": [("""      for (int j = 0; j < NTG; ++j) {
        if (j < ns) {
          const int s0""", """      for (int j = 0; j < NTG; ++j) {
        if (false) {
          const int s0""")],
    "no_CS": [("""          for (int n = 0; n < NTY; ++n) {
            uint32_t bh[2], bl[2];
            load_b_nmajor(sS""", """          for (int n = 0; n < 0; ++n) {
            uint32_t bh[2], bl[2];
            load_b_nmajor(sS""")],
    "no_G": [("""  if (active) {
#pragma unroll 2
    for (int k = 0; k < DS; k += 8) {""", """  if (false) {
#pragma unroll 2
    for (int k = 0; k < DS; k += 8) {""")],
}
DROP_HI_LO = [(MMA3, MMA3.replace("  mma_tf32(t, ah, bl);\n", ""))]


def variant_source(tmp, name, edits):
    text = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: its text is no longer in ssd_scan.cu")
        text = text.replace(old, new)
    path = pathlib.Path(tmp) / f"ssd_scan_{name}.cu"
    path.write_text(text)
    return path


def use(kernel_module, path):
    """Point the wrapper at another source: it builds and loads it at the next call."""
    kernel_module._SRC, kernel_module._lib = path, None
    kernel_module.build()


def measure(name):
    """Build variant ``name`` and print each pass's device time at B8 and B1."""
    import chip_smoke
    from repro_torch.core.compat import TOLERANCES
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kernel
    from repro_torch.kernels.ref import ssd_scan_ref
    from test_torch_cuda import _ssd_inputs

    rtol, atol = TOLERANCES["f32_chain"]
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version stays float32
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        use(kernel, variant_source(tmp, name, VARIANTS[name]))
        for B in (8, 1):
            S, H = 2048, 24
            sets = [(torch.randn(B, S, H, 64, generator=gen, device="cuda"),
                     torch.randn(B, S, H, generator=gen, device="cuda").abs() * 0.5,
                     torch.randn(B, S, 128, generator=gen, device="cuda") * 0.2,
                     torch.randn(B, S, 128, generator=gen, device="cuda") * 0.2,
                     -torch.randn(H, generator=gen, device="cuda").abs()) for _ in range(2)]
            want = ssd_scan_ref(*sets[0], 128)
            err = (ops.ssd(*sets[0]) - want).abs()
            within = bool((err <= atol + rtol * want.abs()).all())
            passes = chip_smoke.device_ms(lambda i: ops.ssd(*sets[i]), 2, by_name=True)
            print(f"{name:16s} B{B}: err {err.max().item():.3g} "
                  f"({'within' if within else 'outside'} f32_chain)  " + (
                      "not measured" if not passes else "  ".join(
                          f"{chip_smoke._variant(n)} {v['ms']:.4f} ms" for n, v in passes.items())
                      + f"  total {sum(v['ms'] for v in passes.values()):.4f} ms"), flush=True)
        ratios = []
        for seed in range(12):
            x, dt, B, C, A = _ssd_inputs(torch.device("cuda"), 2, 512, 3, 64, 128, seed=seed)
            x = x * 1e3
            want = ssd_scan_ref(*(t.double() for t in (x, dt, B, C, A)), 128)
            plain = (ssd_scan_ref(x, dt, B, C, A, 128).double() - want).abs().max().item()
            ratios.append((kernel.ssd_scan(x, dt, B, C, A).double() - want).abs().max().item()
                          / plain)
        print(f"{name:16s} cancelling sums, 12 seeds: error / plain float32's max "
              f"{max(ratios):.2f} median {statistics.median(ratios):.2f} (per seed "
              + " ".join(f"{r:.2f}" for r in ratios) + ")", flush=True)


def mutation_fails():
    """True if the kernel without the hi * lo term fails both large-x tests."""
    import test_torch_cuda
    from repro_torch.kernels import ssd_scan as kernel

    tests = (test_torch_cuda.test_ssd_kernel_keeps_float32_accuracy_at_large_x,
             test_torch_cuda.test_ssd_kernel_keeps_float32_accuracy_on_cancelling_sums)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version stays float32
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        use(kernel, variant_source(tmp, "drop_hi_lo", DROP_HI_LO))
        for test in tests:
            try:
                test(torch.device("cuda"))
            except AssertionError as err:
                lines = [ln.strip() for ln in str(err).splitlines()
                         if "Mismatch" in ln or "assert" in ln][:2]
                print(f"mutation (hi * lo dropped) fails {test.__name__}: " + "; ".join(lines),
                      flush=True)
                failed += 1
            else:
                print(f"mutation (hi * lo dropped) passes {test.__name__}", file=sys.stderr)
    return failed == len(tests)


def main(argv):
    if not torch.cuda.is_available():
        print("ssd_ablation: no CUDA device", file=sys.stderr)
        return 2
    if argv:
        measure(argv[0])
        return 0
    failed = [name for name in VARIANTS
              if subprocess.run([sys.executable, __file__, name]).returncode != 0]
    if failed:
        print(f"ssd_ablation: variants {failed} failed", file=sys.stderr)
        return 1
    return 0 if mutation_fails() else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
