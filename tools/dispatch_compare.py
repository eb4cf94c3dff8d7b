#!/usr/bin/env python3
"""The host cost of attention's call route, serving and the loss forward of
two source trees, in turns on one NVIDIA GPU.

    python3 tools/dispatch_compare.py TREE_A TREE_B

Each tree is a checkout of this repository (its ``chip_smoke.py`` and
``src/``), for example the parent commit unpacked with ``git archive`` and
this one.  The turns run A, B, B, A, each in a process of its own that
builds the tree's kernels into the tree's own ``build/``.  A turn runs the
tree's ``chip_smoke.kernel_case`` at the serve path's decode call (B8 S1
T1024 KR16 D64, bf16, kv_len 1024: wall and device ms per call), and where
the tree has the ``repro_torch::flash_attention`` operator, the host time
per call of the operator beside the direct call of the same kernel on the
same inputs (2000 calls each, the device drained at the end); then
qwen1.5-0.5b at full width: ``chip_smoke.serve_phase`` (16 requests, ms per
decode step, device busy) and ``chip_smoke.loss_phase`` (B2 S2048, ms per
forward).  Each turn prints one line ``COMPARE {json}``.  Exits non-zero if
a turn fails.
"""
import json
import pathlib
import subprocess
import sys
import time


def per_call_us(fn, calls=2000):
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def turn(tree: pathlib.Path) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(20)
    dec = chip_smoke.kernel_case("decode_8x16_pos1023", B=8, S=1, T=1024, KR=16, Gl=1, D=64,
                                 dtype=torch.bfloat16, causal=False, q_offset=1023,
                                 kv_len=1024, chunk=1024, layout="model", gen=gen)
    q = torch.randn(8, 1, 16, 1, 64, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(8, 1024, 16, 64, generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    route = {"direct_us": per_call_us(
        lambda: fa.flash_attention(q, k, v, causal=False, q_offset=1023, kv_len=1024)),
        "layout_us": per_call_us(
        lambda: ops.attention_model_layout(q, k, v, causal=False, q_offset=1023,
                                           kv_len=1024))}
    if hasattr(ops, "flash_attention_op"):
        route["operator_us"] = per_call_us(
            lambda: ops.flash_attention_op(q, k, v, False, 1023, 1024, 1024))
    del q, k, v
    cfg, st, params = chip_smoke.full_width_model("qwen1.5-0.5b", 0)
    serve = chip_smoke.serve_phase(cfg, st, params, 0, "flash_attention")
    loss = chip_smoke.loss_phase(cfg, st, params, 0, B=2, S=2048, kernel="flash_attention")
    return {"tree": str(tree), "device": torch.cuda.get_device_name(0),
            "decode_call_ms": dec["ms"], "decode_call_device_ms": dec["device_ms"],
            **route, "serve_ms_per_step": serve["ms_per_step"],
            "serve_tok_per_s": serve["tok_per_s"],
            "serve_device_busy_ms_per_step": serve.get("device_busy_ms_per_step"),
            "loss_ms_per_forward": loss["ms_per_forward"],
            "loss_device_busy_ms": loss.get("device_busy_ms_per_step")}


def main(argv):
    if len(argv) == 3 and argv[1] == "--turn":
        print("COMPARE " + json.dumps(turn(pathlib.Path(argv[2]).resolve())), flush=True)
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (pathlib.Path(t).resolve() for t in argv[1:])
    for tree in (a, b, b, a):
        print(f"turn: {tree}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--turn", str(tree)])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
