#!/usr/bin/env python3
"""A backward kernel and its model's training step, of two source trees, in
turns on one NVIDIA GPU.

    python3 tools/bwd_compare.py [--ssd] TREE_A TREE_B

Each tree is a checkout of this repository (its ``chip_smoke.py`` and
``src/``), for example the parent commit unpacked with ``git archive`` and
this one.  The turns run A, B, B, A, each in a process of its own that
builds the tree's kernels into the tree's own ``build/``.  A turn prints
one line ``COMPARE {json}``.  Exits non-zero if a turn fails.

Without ``--ssd`` a turn runs the tree's ``chip_smoke.bwd_case`` at the
training call (B4 S2048 H16 D64, causal, bf16: the flash backward against
its plain version, device ms per call and per launch, SDPA's backward) and
its ``chip_smoke.train_phase`` (qwen1.5-0.5b at full width, ten steps:
device busy of one traced step, wall ms per step, peak memory).

With ``--ssd`` it runs the tree's ``chip_smoke.ssd_bwd_phase`` (the SSD
backward's six cases against the float64 plain backward: the Mamba2
training call B8 S2048 H24, the partitioned train step's fold 32 x 512 H6
with A per row, hd 32 with ds 16, S equal to the chunk, and x scaled by
10^3; ms and device ms per call and per launch) and
``chip_smoke.train_phase`` for mamba2-130m (B8 S2048, ten steps: device
busy of one traced step, the SSD backward's share of it, wall ms per step,
peak memory).
"""
import json
import pathlib
import subprocess
import sys


def flash_turn(chip_smoke, torch) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(20)
    bwd = chip_smoke.bwd_case("train_qwen_4x2048", B=4, S=2048, KR=16, Gl=1, D=64,
                              dtype=torch.bfloat16, causal=True, gen=gen)
    train = chip_smoke.train_phase(0)
    # the backward's kernels in the traced step: their own total where the
    # tree reports it, else those among the step's largest kernels
    bwd_step = train.get("bwd_device_ms_per_step")
    if bwd_step is None:
        bwd_step = sum(t["ms_per_step"] for t in train["top"] if "flash_bwd" in t["name"])
    return {"bwd_ms": bwd["ms"], "bwd_device_ms": bwd["device_ms"],
            "bwd_pass_device_ms": bwd["pass_device_ms"], "bwd_max_abs_err": bwd["max_abs_err"],
            "sdpa_bwd_device_ms": bwd["library_device_ms"], "bound_ms": bwd["bound_ms"],
            "step_device_busy_ms": train["device_busy_ms_per_step"],
            "step_bwd_device_ms": bwd_step, "step_wall_ms": train["ms_per_step"],
            "peak_gib": train["peak_gib"], "loss0": train["losses"][0]}


def ssd_turn(chip_smoke, torch) -> dict:
    cases = chip_smoke.ssd_bwd_phase(0)
    train = chip_smoke.train_phase(0, arch="mamba2-130m", B=8, S=2048)
    return {"cases": {c["case"]: {"ms": c["ms"], "device_ms": c["dev_ms"],
                                  "launch_device_ms": c["pass_dev_ms"],
                                  "max_abs_err": c["max_abs_err"], "plain_ms": c["plain_ms"],
                                  "bound_ms": c["bound_ms"]} for c in cases},
            "step_device_busy_ms": train["device_busy_ms_per_step"],
            "step_bwd_device_ms": train["bwd_device_ms_per_step"],
            "step_bwd_device_ms_by_launch": train["bwd_device_ms_by_launch"],
            "step_wall_ms": train["ms_per_step"], "peak_gib": train["peak_gib"],
            "loss0": train["losses"][0]}


def turn(tree: pathlib.Path, ssd: bool) -> dict:
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = (ssd_turn if ssd else flash_turn)(chip_smoke, torch)
    return {"tree": str(tree), "device": torch.cuda.get_device_name(0), **rec}


def main(argv):
    args = argv[1:]
    ssd = "--ssd" in args
    args = [a for a in args if a != "--ssd"]
    if len(args) == 2 and args[0] == "--turn":
        rec = turn(pathlib.Path(args[1]).resolve(), ssd)
        print("COMPARE " + json.dumps(rec), flush=True)
        return 0
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (pathlib.Path(t).resolve() for t in args)
    for tree in (a, b, b, a):
        print(f"turn: {tree}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--turn", str(tree)]
                              + (["--ssd"] if ssd else []))
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
