#!/usr/bin/env python3
"""Print the checkpoint and the cross-mesh restore plan that
``chip_smoke.py::checkpoint_reshard_case`` saves and replays, by pure
planning on the host (no tensors, no device): qwen1.5-0.5b's train state at
full width (``chip_smoke.CKPT_RESHARD_LAYERS`` layers, Adafactor) saved on
("data" 2, "model" 4), its leaves and bytes, and ``restore_resharded``'s
plan onto ``derive_mesh(4, 4)`` and onto ("data" 4, "model" 2) all
replicated: wire bytes, launches, resharded leaves.  The card run must give
the same plan.

    PYTHONPATH=src python tools/ckpt_plan.py
"""
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main():
    print(json.dumps(chip_smoke.checkpoint_plan_prediction(), indent=1))


if __name__ == "__main__":
    main()
