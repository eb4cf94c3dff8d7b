"""Build the port's CUDA sources into shared libraries and bind them.

Each source under ``csrc/`` has a plain C interface.  ``build_library``
compiles it with ``nvcc`` for ``sm_90a`` at its first use, into
``build/repro_torch_kernels/`` beside ``src/`` (named by the source's hash,
so an edited source rebuilds), and the wrappers load it with ``ctypes``.
nvcc's output, with ptxas's register report, is kept beside the library with
the suffix ``.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def nvcc_path() -> str:
    """nvcc on the PATH, else under CUDA_HOME (or /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_library(src: pathlib.Path) -> pathlib.Path:
    """Compile ``src`` if this content has not been built yet, and return the
    library's path."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    lib_path = BUILD_DIR / f"lib{src.stem}_{digest}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(tmp), str(src),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib_path.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def strides_arg(t: torch.Tensor, name: str):
    """Element strides of every dim but the last, as a C ``long long`` array;
    the last dim must have unit stride."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: the last dim must have unit stride, got {t.stride()}")
    dims = t.stride()[:-1]
    return (ctypes.c_longlong * len(dims))(*dims)
