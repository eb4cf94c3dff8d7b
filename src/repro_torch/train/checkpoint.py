"""Fault-tolerant sharded checkpointing with plan-lowered cross-mesh restore
(a port of the JAX package's ``train/checkpoint.py``, in its on-disk format).

Layout:  ``<dir>/step_<N>/`` with one ``.npy`` per leaf + ``manifest.json``.
The manifest (format 2) stores, per leaf, the file name, shape, dtype, a
content checksum (crc32), and the **partition spec** the leaf was saved under
(its ``dims_mapping`` by mesh-axis name, passed in ``specs``: a torch tensor
carries no sharding), plus the saving mesh and the caller's ``extra`` dict
(data cursor, guard counters, ...).  A step directory written by either
package restores bit for bit in the other: the same file names, headers,
bytes and checksums.  A bfloat16 leaf is written as the reference's
``np.save`` of an ``ml_dtypes.bfloat16`` array writes it (descr ``'<V2'``,
the raw 2-byte values) with ``"bfloat16"`` in the manifest, and is read
back as bfloat16 by the manifest's dtype.

Writes are atomic: a ``.tmp-`` directory is renamed into place only after
the manifest's fsync, so a crash mid-save never corrupts the latest
checkpoint (the orphan tmp dir is inert: ``latest_step`` only counts
directories with a manifest).

Restores are *verified* and *resilient*:

* every leaf's checksum is validated: a flipped byte raises a typed
  :class:`CheckpointCorruptError` (which leaf, which step, which file);
* transient I/O errors are retried with backoff;
* when no explicit ``step`` was requested, a corrupt or unreadable step
  falls back to the previous intact ``step_N`` directory;
* a manifest/target mismatch raises a ``KeyError`` naming the missing leaf,
  the step and the available keys, or, under ``strict=False``, keeps the
  target's value and reports the leaf in ``manifest["restore_report"]``;
* the manifest carries a self-checksum (crc32 of its canonical JSON body);
* ``python -m repro_torch.train.checkpoint verify <dir> [--step N]``
  validates every manifest and leaf checksum on the host, exiting non-zero
  on corruption.

Restored leaves take the target's form: a tensor of the target leaf's dtype
on ``device`` (default: the target leaf's device; a meta target lands on
the CPU), never requiring grad; a Python int for an int (the port's step
counter, saved as the reference's 0-d int32).

Cross-mesh restore (``restore_resharded``) is a **plan-lowered reshard
program**: each manifest spec is projected onto the new mesh
(``core/sharding.project_dims_mapping``), ``core/plan.compile_state_reshard``
lowers one collective program per leaf, and each leaf, built as the stacked
shards of its source layout on the simulated mesh (``core/mesh_runtime``),
replays its program and comes back global under its target sharding (the
form the port's partitioned step takes).  Leaves run one at a time, each
stacked copy freed before the next.  The port has no separate runtime mesh
(the reference's ``jmesh``), and a sharded read fetches every simulated
device's tile in this one process.

The module imports torch only where a tensor is made or read, so the
``verify`` CLI runs on a host without it.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import shutil
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

FORMAT = 2


class CheckpointError(Exception):
    """Base for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """A shard failed checksum validation (or was unreadable/garbled)."""

    def __init__(self, step: int, key: str, path: str, detail: str = ""):
        self.step, self.key, self.path = step, key, path
        super().__init__(
            f"checkpoint step {step} corrupt: leaf '{key}' at {path}"
            + (f" ({detail})" if detail else "")
        )


# -- I/O retry policy (transient FS errors on network storage) -------------------
_IO_RETRIES = 3
_IO_BACKOFF_S = 0.05
_IO_THREADS = 4  # leaf files written or read at once, each with its crc32

# fault-injection hook (armed by tests): called as fn(leaf_index, key) before
# each leaf write; raising simulates a crash mid-save (the tmp dir is left
# behind, the final dir never appears)
_SAVE_FAULT: Optional[Callable[[int, str], None]] = None

_BF16_DESCR = "<V2"  # what np.save writes for an ml_dtypes.bfloat16 array


def set_save_fault(fn: Optional[Callable[[int, str], None]]) -> None:
    global _SAVE_FAULT
    _SAVE_FAULT = fn


def _retry(fn, desc: str, retries: int = None, backoff: float = None):
    retries = _IO_RETRIES if retries is None else retries
    backoff = _IO_BACKOFF_S if backoff is None else backoff
    last = None
    for attempt in range(max(retries, 1)):
        try:
            return fn()
        except (OSError, ValueError) as e:  # ValueError: truncated .npy
            last = e
            if attempt + 1 < retries:
                time.sleep(backoff * (2 ** attempt))
    raise last if last is not None else OSError(f"retry exhausted: {desc}")


@contextlib.contextmanager
def _io_pool():
    """Threads for leaf files (writes, reads and crc32 release the GIL);
    on the way out, queued work is cancelled and running work waited for."""
    pool = concurrent.futures.ThreadPoolExecutor(_IO_THREADS)
    try:
        yield pool
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def _checksum(arr: np.ndarray) -> str:
    """crc32 of the array's raw bytes in C order (no copy when contiguous)."""
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return f"crc32:{zlib.crc32(flat):08x}"


def _manifest_checksum(manifest: Dict) -> str:
    """Self-checksum over the canonical JSON of the manifest body (without
    ``checksum`` and any in-memory ``restore_report``)."""
    body = {k: v for k, v in manifest.items() if k not in ("checksum", "restore_report")}
    blob = json.dumps(body, sort_keys=True, separators=(",", ":"), default=str).encode()
    return f"crc32:{zlib.crc32(blob):08x}"


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` with "/"-joined keys, dicts in sorted-key order (the
    reference's ``jax.tree_util`` keys for the same nested dicts; an empty
    dict has no leaves), as ``core/tree.py::leaves_with_paths`` orders them."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(_flatten_with_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def _rebuild(target, values: Dict[str, Any], path: Tuple[str, ...] = ()):
    """``target``'s nested dicts with each leaf replaced by ``values[key]``
    (empty dicts, which have no leaves, are kept)."""
    if isinstance(target, dict):
        return {k: _rebuild(target[k], values, path + (k,)) for k in target}
    return values["/".join(path)]


# ---------------------------------------------------------------------------------
# host arrays: the bytes on disk
# ---------------------------------------------------------------------------------


def _host(leaf) -> Tuple[np.ndarray, str]:
    """``(array, dtype name)`` of one leaf as written, in C order as the
    reference writes every leaf (a transposed tensor would otherwise save
    in Fortran order, which sliced reads refuse): a bfloat16 leaf is its
    raw 2-byte values (uint16); a Python int (the step counter) is a 0-d
    int32, as the reference's state holds it."""
    import torch

    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
        arr = t.cpu().numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32), "int32"
    arr = np.require(np.asarray(leaf), requirements="C")
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _write_npy(path: str, arr: np.ndarray, dtype: str) -> None:
    """``np.save``, with a bfloat16 leaf under the reference's header."""
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.require(arr, requirements="C")  # keeps a 0-d leaf 0-d
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(arr.reshape(-1).view(np.uint8).data)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> str:
    """Write one leaf's file; returns its crc32."""
    _write_npy(path, arr, dtype)
    return _checksum(arr)


def _dtype_matches(dtype: np.dtype, name: str) -> bool:
    """A ``.npy`` header's dtype against the manifest's name (a bfloat16
    leaf's header reads as a 2-byte void)."""
    if name == "bfloat16":
        return dtype.kind == "V" and dtype.itemsize == 2
    return str(dtype) == name


def _to_torch(arr: np.ndarray, name: str) -> "torch.Tensor":
    """A host array as read from disk, as a CPU tensor of the manifest's
    dtype."""
    import torch

    arr = np.require(arr, requirements="C")
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _want(tgt, name: str) -> "torch.dtype":
    """The dtype a restored leaf takes: the target tensor's, else the
    manifest's."""
    import torch

    return tgt.dtype if isinstance(tgt, torch.Tensor) else getattr(torch, name)


def _target_device(tgt, device):
    import torch

    if device is not None:
        return torch.device(device)
    if isinstance(tgt, torch.Tensor) and tgt.device.type != "meta":
        return tgt.device
    return torch.device("cpu")


def _finish(t, tgt):
    """A restored tensor in the target leaf's form: an int for an int (the
    step counter), else the tensor."""
    return int(t) if isinstance(tgt, int) else t


def _placeholder(tgt, device):
    """A missing leaf's value under ``strict=False``: the target's own, or
    zeros for a meta (abstract) target."""
    import torch

    if isinstance(tgt, torch.Tensor) and tgt.device.type == "meta":
        return torch.zeros(tgt.shape, dtype=tgt.dtype, device=_target_device(tgt, device))
    return tgt


# ---------------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------------


def _dims_mapping(ent, rank: int) -> List[List[str]]:
    dm = []
    for e in list(ent)[:rank]:
        if e is None:
            dm.append([])
        elif isinstance(e, str):
            dm.append([e])
        else:
            dm.append(list(e))
    return dm + [[] for _ in range(rank - len(dm))]


def _spec_entry(specs, key: str, rank: int) -> Tuple[Optional[List[List[str]]], Optional[Dict]]:
    """The recorded spec of one leaf from ``specs`` (dict or callable): a
    ``Sharding`` (its mesh lands in the manifest), a PartitionSpec-like
    tuple or a ``dims_mapping``; None records no spec."""
    ent = specs(key) if callable(specs) else (specs.get(key) if specs is not None else None)
    if ent is None:
        return None, None
    if hasattr(ent, "dims_mapping"):  # a Sharding
        mesh = ent.mesh
        return ([list(a) for a in ent.dims_mapping],
                {"shape": list(mesh.shape), "axes": list(mesh.axis_names)})
    return _dims_mapping(ent, rank), None


def save(ckpt_dir: str, step: int, state, extra: Optional[Dict[str, Any]] = None,
         specs=None) -> str:
    """Atomic checkpoint save.  ``state`` is a nested dict of tensors (on any
    device), numpy arrays and Python numbers.

    ``specs`` optionally names each leaf's partition spec (dict key ->
    ``Sharding`` / PartitionSpec-like tuple / dims_mapping, or a callable);
    the first ``Sharding`` gives the manifest's ``mesh``.  ``extra`` lands in
    the manifest verbatim (the training loop stores its data cursor there).
    Leaves are copied to the host in order and written, each with its
    crc32, by ``_IO_THREADS`` threads.
    """
    step = int(step)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        "format": FORMAT, "step": step, "time": time.time(),
        "mesh": None, "leaves": [], "extra": extra or {},
    }
    with _io_pool() as pool:
        written = []
        for i, (key, leaf) in enumerate(_flatten_with_paths(state)):
            if _SAVE_FAULT is not None:
                _SAVE_FAULT(i, key)
            arr, dtype = _host(leaf)
            dm, mesh_d = _spec_entry(specs, key, arr.ndim)
            fname = key.replace("/", "__") + ".npy"
            if mesh_d is not None and manifest["mesh"] is None:
                manifest["mesh"] = mesh_d
            entry = {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype,
                     "checksum": None, "spec": dm}
            manifest["leaves"].append(entry)
            written.append((entry, pool.submit(_write_leaf, os.path.join(tmp, fname), arr,
                                               dtype)))
        for entry, crc in written:
            entry["checksum"] = crc.result()
    manifest["checksum"] = _manifest_checksum(manifest)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def intact_steps(ckpt_dir: str) -> List[int]:
    """All steps with a committed manifest, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_")
        and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))
    )


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = intact_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_manifest(ckpt_dir: str, step: int) -> Dict:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")

    def rd():
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)

    try:
        manifest = _retry(rd, f"manifest step {step}")
    except (OSError, ValueError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(step, "<manifest>", os.path.join(d, "manifest.json"), str(e))
    recorded = manifest.get("checksum")
    if recorded:
        got = _manifest_checksum(manifest)
        if got != recorded:
            raise CheckpointCorruptError(
                step, "<manifest>", os.path.join(d, "manifest.json"),
                f"manifest self-checksum {got} != recorded {recorded}")
    return manifest


def _load_leaf(ckpt_dir: str, step: int, info: Dict, verify: bool = True) -> np.ndarray:
    """One leaf's host array as on disk (a bfloat16 leaf as 2-byte voids),
    checksum and shape checked."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", info["file"])
    try:
        arr = _retry(lambda: np.load(path), f"leaf {info['key']}")
    except (OSError, ValueError) as e:
        raise CheckpointCorruptError(step, info["key"], path, str(e))
    if verify and info.get("checksum"):
        got = _checksum(arr)
        if got != info["checksum"]:
            raise CheckpointCorruptError(
                step, info["key"], path, f"checksum {got} != recorded {info['checksum']}")
    if list(arr.shape) != list(info.get("shape", arr.shape)):
        raise CheckpointCorruptError(
            step, info["key"], path, f"shape {list(arr.shape)} != recorded {info['shape']}")
    return arr


# ---------------------------------------------------------------------------------
# sharded slice reads: each device's tile read by byte range
# ---------------------------------------------------------------------------------


def _npy_header(path: str) -> Tuple[Tuple[int, ...], np.dtype, bool, int]:
    """Parse a ``.npy`` header on the host: ``(shape, dtype, fortran_order,
    payload_offset)``.  Validates the file size against the header, so a
    torn write is caught before any slice is read."""
    def parse():
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            try:
                shape, fortran, dtype = np.lib.format._read_array_header(f, version)
            except AttributeError:  # older numpy: public per-version readers
                reader = {(1, 0): np.lib.format.read_array_header_1_0,
                          (2, 0): np.lib.format.read_array_header_2_0}[version]
                shape, fortran, dtype = reader(f)
            return shape, fortran, dtype, f.tell()

    shape, fortran, dtype, offset = _retry(parse, f"npy header {path}")
    want = offset + int(np.prod(shape or (1,), dtype=np.int64)) * dtype.itemsize
    got = os.path.getsize(path)
    if got != want:
        raise ValueError(f"torn write: {path} is {got} bytes, header promises {want}")
    return tuple(int(s) for s in shape), dtype, bool(fortran), offset


def _normalize_index(index, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
    """One concrete step-1 ``slice`` per dim."""
    idx = list(index) + [slice(None)] * (len(shape) - len(index))
    out = []
    for sl, n in zip(idx, shape):
        start, stop, step = sl.indices(n)
        if step != 1:
            raise ValueError(f"strided shard slices unsupported: {sl}")
        out.append(slice(start, stop))
    return tuple(out)


def read_npy_slice(path: str, index, *, expected: Optional[Dict] = None,
                   stats: Optional[Dict] = None) -> np.ndarray:
    """Read one shard slice of a ``.npy`` file by byte range.

    ``index`` is a tuple of step-1 slices, one per dim (a device's tile:
    ``mesh_runtime.shard_slices``).  The tile is copied out of a read-only
    memory map of the payload, so only the pages holding its rows are read;
    ``stats`` counts the contiguous runs a row-major read of it takes (the
    longest suffix of whole dims plus the partial dim before it is one run)
    as ``reads`` and its bytes as ``bytes_read``, as the reference's
    seek-and-read loop counts them.  The read is retried with backoff.
    ``expected`` (a manifest leaf entry) cross-checks the header's shape and
    dtype; a mismatch or a torn write raises ``ValueError``.  A bfloat16
    leaf comes back as 2-byte voids.
    """
    shape, dtype, fortran, offset = _npy_header(path)
    if expected is not None:
        if list(shape) != list(expected.get("shape", shape)):
            raise ValueError(f"header shape {list(shape)} != manifest {expected['shape']}")
        if "dtype" in expected and not _dtype_matches(dtype, expected["dtype"]):
            raise ValueError(f"header dtype {dtype} != manifest {expected['dtype']}")
    if fortran:
        raise ValueError("fortran-order .npy unsupported for slice reads")
    if not shape:  # 0-d scalar: the whole payload is one element
        arr = np.fromfile(path, dtype=dtype, count=1, offset=offset)
        if stats is not None:
            stats["reads"] = stats.get("reads", 0) + 1
            stats["bytes_read"] = stats.get("bytes_read", 0) + arr.nbytes
        return arr.reshape(())
    idx = _normalize_index(index, shape)
    local = tuple(sl.stop - sl.start for sl in idx)
    out = np.empty(local, dtype=dtype)
    if 0 in local:
        return out
    tail = len(shape)
    while tail > 0 and idx[tail - 1].start == 0 and idx[tail - 1].stop == shape[tail - 1]:
        tail -= 1
    runs = int(np.prod(local[:max(tail - 1, 0)], dtype=np.int64))

    def read():
        payload = np.memmap(path, dtype=dtype, mode="r", offset=offset, shape=shape)
        out[...] = payload[idx]
        del payload

    _retry(read, f"slice read {path}")
    if stats is not None:
        stats["reads"] = stats.get("reads", 0) + runs
        stats["bytes_read"] = stats.get("bytes_read", 0) + out.nbytes
    return out


def _missing_key_error(key: str, step: int, by_key: Dict) -> KeyError:
    avail = sorted(by_key)
    shown = ", ".join(avail[:12]) + (" …" if len(avail) > 12 else "")
    return KeyError(
        f"checkpoint step {step} has no leaf '{key}' for the restore target "
        f"(manifest has {len(avail)} leaves: {shown}); pass strict=False to "
        f"skip missing leaves"
    )


def _candidate_steps(ckpt_dir: str, step: Optional[int]) -> List[int]:
    """Steps to try, newest first.  An explicit ``step`` pins exactly one (no
    fallback); ``None`` walks every intact step until one restores."""
    if step is not None:
        return [step]
    steps = intact_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    return steps[::-1]


# ---------------------------------------------------------------------------------
# restore
# ---------------------------------------------------------------------------------


def restore(ckpt_dir: str, target, step: Optional[int] = None, strict: bool = True,
            verify: bool = True, device=None):
    """Restore into the structure of ``target`` (a nested dict of tensors,
    meta tensors and ints).  Returns ``(tree,
    manifest)``.  Tensor leaves land on ``device`` (default: each target
    leaf's own device, the CPU for a meta target) in the target's dtype.

    Checksums are validated (``verify=False`` skips), I/O is retried with
    backoff, and, when ``step`` is None, a corrupt step falls back to the
    previous intact one.  ``strict=False`` keeps the target's value for
    leaves missing from the manifest and reports them in
    ``manifest["restore_report"]["missing"]``.
    """
    fell_back: List[int] = []
    last_err: Optional[Exception] = None
    for s in _candidate_steps(ckpt_dir, step):
        try:
            out, manifest = _restore_step(ckpt_dir, s, target, strict, verify, device)
            manifest["restore_report"]["fell_back_from"] = fell_back
            return out, manifest
        except CheckpointCorruptError as e:
            fell_back.append(s)
            last_err = e
    raise last_err


def _prefetch(pool, ckpt_dir, step, by_key, keys, verify):
    """Each present leaf's ``_load_leaf`` (read and crc32) queued on the I/O
    threads, in order: the caller takes the results in order, so the first
    corrupt leaf raises first."""
    return {k: pool.submit(_load_leaf, ckpt_dir, step, by_key[k], verify)
            for k in keys if k in by_key}


def _restore_step(ckpt_dir, step, target, strict, verify, device):
    manifest = _load_manifest(ckpt_dir, step)
    by_key = {l["key"]: l for l in manifest["leaves"]}
    leaves = _flatten_with_paths(target)
    missing = [k for k, _ in leaves if k not in by_key]
    if missing and strict:
        raise _missing_key_error(missing[0], step, by_key)
    out: Dict[str, Any] = {}
    with _io_pool() as pool:
        loads = _prefetch(pool, ckpt_dir, step, by_key, [k for k, _ in leaves], verify)
        for key, tgt in leaves:
            if key not in loads:
                out[key] = _placeholder(tgt, device)
                continue
            info = by_key[key]
            t = _to_torch(loads.pop(key).result(), info["dtype"])
            out[key] = _finish(t.to(_target_device(tgt, device), _want(tgt, info["dtype"])), tgt)
    manifest["restore_report"] = {"step": step, "missing": missing,
                                  "unused": sorted(set(by_key) - {k for k, _ in leaves})}
    return _rebuild(target, out), manifest


# ---------------------------------------------------------------------------------
# cross-mesh restore: a plan-lowered reshard program on the new mesh
# ---------------------------------------------------------------------------------


def _as_target_sharding(mesh, spec, shape):
    """One target-spec entry as a Sharding on ``mesh`` (projected: axes
    absent from the mesh or not dividing are dropped)."""
    from ..core.sharding import project_dims_mapping, replicated

    if spec is None:
        return replicated(mesh, len(shape))
    if hasattr(spec, "dims_mapping"):
        return project_dims_mapping(mesh, spec.dims_mapping, shape)
    return project_dims_mapping(mesh, [tuple(a) for a in _dims_mapping(spec, len(shape))], shape)


def plan_restore_reshard(manifest: Dict, target_leaves, mesh, target_specs=None, profile=None):
    """Compile the manifest->target reshard program (pure planning).

    ``target_leaves`` is the ``(key, leaf)`` list of the restore target;
    ``target_specs`` maps key -> Sharding / PartitionSpec-like tuple /
    dims_mapping (dict or callable; missing or None is replicated).  Source
    shardings are the manifest's specs projected onto ``mesh``.  ``profile``
    (a ``RooflineParams``) prices ``reshard_s``.  Returns
    ``core.plan.StateReshardPlan``.
    """
    from ..core.plan import compile_state_reshard
    from ..core.sharding import project_dims_mapping

    by_key = {l["key"]: l for l in manifest["leaves"]}
    items = []
    for key, _ in target_leaves:
        info = by_key[key]
        shape = tuple(info["shape"])
        src = project_dims_mapping(mesh, [tuple(a) for a in info["spec"] or []], shape)
        spec = None
        if callable(target_specs):
            spec = target_specs(key)
        elif target_specs is not None:
            spec = target_specs.get(key)
        items.append((key, src, _as_target_sharding(mesh, spec, shape), shape, info["dtype"]))
    return compile_state_reshard(items, mesh, profile=profile)


def _stacked_full(arr, info, src, want, device):
    """One leaf's stacked source shards from a full read of its file."""
    from ..core import mesh_runtime as mr

    return mr.shard(_to_torch(arr, info["dtype"]).to(device, want), src)


def _sharded_leaf(ckpt_dir, step, info, src, want, device, stats: Dict):
    """One leaf's stacked source shards read **by slice**: each simulated
    device's tile is a byte-range read of the ``.npy``, each distinct tile
    read once and copied to ``device`` once (the reference's per-leaf slice
    cache), the stack built there.  Structural corruption (torn write, header/manifest
    mismatch, short read) raises :class:`CheckpointCorruptError`; a read
    covering the whole leaf (a replicated leaf) also verifies its crc32.
    Value corruption of a sharded leaf is the ``verify`` CLI's to find, as
    on a fleet where no host sees every byte."""
    import torch

    from ..core import mesh_runtime as mr
    from ..core.plan import dtype_bytes

    path = os.path.join(ckpt_dir, f"step_{step:08d}", info["file"])
    shape = tuple(info["shape"])
    slices = mr.shard_slices(shape, src)
    local = tuple(sl.stop - sl.start for sl in slices[0])
    out = torch.empty((len(slices),) + local, dtype=want, device=device)
    cache: Dict[Tuple, "torch.Tensor"] = {}
    for p, idx in enumerate(slices):
        key = tuple((sl.start, sl.stop) for sl in idx)
        if key not in cache:
            try:
                arr = read_npy_slice(path, idx, expected=info, stats=stats)
            except (OSError, ValueError) as e:
                raise CheckpointCorruptError(step, info["key"], path, str(e))
            if info.get("checksum") and all(sl.start == 0 and sl.stop == n
                                             for sl, n in zip(idx, shape)):
                got = _checksum(arr)
                if got != info["checksum"]:
                    raise CheckpointCorruptError(
                        step, info["key"], path, f"checksum {got} != recorded {info['checksum']}")
            cache[key] = _to_torch(arr, info["dtype"]).to(device, want)
            stats["unique_slices"] = stats.get("unique_slices", 0) + 1
        out[p].copy_(cache[key])
    stats["leaves"] = stats.get("leaves", 0) + 1
    stats["full_bytes"] = stats.get("full_bytes", 0) + int(
        np.prod(shape or (1,), dtype=np.int64)) * dtype_bytes(info["dtype"])
    return out


def restore_resharded(ckpt_dir: str, target, mesh, target_specs=None, step: Optional[int] = None,
                      strict: bool = True, verify: bool = True, sharded_io: bool = False,
                      device=None, profile=None):
    """Restore onto a *different* mesh through a plan-lowered reshard program.

    Each leaf is built as the stacked shards of its **source** layout (the
    manifest spec projected onto ``mesh``) on ``device`` (default: the
    target leaf's device), replays its program from the compiled
    :class:`~repro_torch.core.plan.StateReshardPlan`, and is returned global
    (``mesh_runtime.unshard`` under its target sharding), one leaf at a
    time.  Returns ``(tree, manifest, report)``: the plan's report (wire
    bytes, launches, ``reshard_s`` under ``profile``) plus the restore
    bookkeeping of :func:`restore`.

    ``sharded_io=True`` reads each device's tile by byte range
    (:func:`read_npy_slice`) instead of the whole file: crc32 then covers
    only reads that span a whole leaf, sharded leaves are checked
    structurally, and the report gains ``"io"`` (bytes_read,
    unique_slices, reads, full_bytes, leaves).
    """
    from ..core import mesh_runtime as mr

    fell_back: List[int] = []
    last_err: Optional[Exception] = None
    for s in _candidate_steps(ckpt_dir, step):
        try:
            manifest = _load_manifest(ckpt_dir, s)
            by_key = {l["key"]: l for l in manifest["leaves"]}
            leaves = _flatten_with_paths(target)
            missing = [k for k, _ in leaves if k not in by_key]
            if missing and strict:
                raise _missing_key_error(missing[0], s, by_key)
            present = [(k, t) for k, t in leaves if k in by_key]
            plan = plan_restore_reshard(manifest, present, mesh, target_specs, profile)
            io_stats: Dict[str, Any] = {}
            out: Dict[str, Any] = {}
            with _io_pool() as pool:
                loads = {} if sharded_io else _prefetch(pool, ckpt_dir, s, by_key,
                                                        [k for k, _ in present], verify)
                for i, ((key, tgt), leaf) in enumerate(zip(present, plan.leaves)):
                    info = by_key[key]
                    want, dev = _want(tgt, info["dtype"]), _target_device(tgt, device)
                    if sharded_io:
                        x = _sharded_leaf(ckpt_dir, s, info, leaf.src, want, dev, io_stats)
                    else:
                        x = _stacked_full(loads.pop(key).result(), info, leaf.src, want, dev)
                    x = plan.execute_leaf(i, x)
                    out[key] = _finish(mr.unshard(x, leaf.dst), tgt)
                    del x
            for key, tgt in leaves:
                if key not in out:
                    out[key] = _placeholder(tgt, device)
            report = plan.report()
            report.update({"step": s, "missing": missing,
                           "unused": sorted(set(by_key) - {k for k, _ in leaves}),
                           "fell_back_from": fell_back, "sharded_io": sharded_io})
            if sharded_io:
                report["io"] = io_stats
            manifest["restore_report"] = report
            return _rebuild(target, out), manifest, report
        except CheckpointCorruptError as e:
            fell_back.append(s)
            last_err = e
    raise last_err


# ---------------------------------------------------------------------------------
# offline verification: `python -m repro_torch.train.checkpoint verify <dir>`
# ---------------------------------------------------------------------------------


def verify_step(ckpt_dir: str, step: int) -> Dict[str, Any]:
    """Validate one checkpoint step on the host: the manifest's
    self-checksum, then every leaf file's crc32 and recorded shape and
    dtype (plain ``np.load``; nothing touches a device).  Returns
    ``{"step", "ok", "leaves", "errors": [str, ...]}``."""
    errors: List[str] = []
    leaves = 0
    try:
        manifest = _load_manifest(ckpt_dir, step)
    except CheckpointCorruptError as e:
        return {"step": step, "ok": False, "leaves": 0, "errors": [str(e)]}
    for info in manifest.get("leaves", []):
        leaves += 1
        path = os.path.join(ckpt_dir, f"step_{step:08d}", info["file"])
        try:
            arr = np.load(path)
        except (OSError, ValueError) as e:
            errors.append(f"leaf '{info['key']}': unreadable ({e})")
            continue
        if info.get("checksum"):
            got = _checksum(arr)
            if got != info["checksum"]:
                errors.append(f"leaf '{info['key']}': checksum {got} != recorded "
                              f"{info['checksum']}")
        if list(arr.shape) != list(info.get("shape", arr.shape)):
            errors.append(f"leaf '{info['key']}': shape {list(arr.shape)} != recorded "
                          f"{info['shape']}")
        if "dtype" in info and not _dtype_matches(arr.dtype, info["dtype"]):
            errors.append(f"leaf '{info['key']}': dtype {arr.dtype} != recorded "
                          f"{info['dtype']}")
    return {"step": step, "ok": not errors, "leaves": leaves, "errors": errors}


def verify_dir(ckpt_dir: str, step: Optional[int] = None) -> Dict[str, Any]:
    """Validate every intact step in ``ckpt_dir`` (or one pinned ``step``).
    Returns ``{"dir", "ok", "steps": [verify_step reports]}``."""
    steps = [step] if step is not None else intact_steps(ckpt_dir)
    reports = [verify_step(ckpt_dir, s) for s in steps]
    return {"dir": ckpt_dir, "ok": bool(reports) and all(r["ok"] for r in reports),
            "steps": reports}


def _cli(argv: List[str]) -> int:
    if len(argv) < 2 or argv[0] != "verify":
        print("usage: python -m repro_torch.train.checkpoint verify <dir> [--step N]")
        return 2
    ckpt_dir = argv[1]
    step = None
    if "--step" in argv:
        step = int(argv[argv.index("--step") + 1])
    report = verify_dir(ckpt_dir, step)
    if not report["steps"]:
        print(f"{ckpt_dir}: no intact checkpoint steps")
        return 1
    for r in report["steps"]:
        status = "ok" if r["ok"] else "CORRUPT"
        print(f"step {r['step']}: {status} ({r['leaves']} leaves)")
        for err in r["errors"]:
            print(f"  - {err}")
    return 0 if report["ok"] else 1


def cleanup(ckpt_dir: str, keep: int = 3, remove_tmp: bool = False,
            protect_verified: bool = True):
    """Drop all but the newest ``keep`` steps; ``remove_tmp`` also clears
    orphan ``.tmp-`` dirs left by crashed saves (never the committed steps).

    With ``protect_verified`` (the default) the most recent step that passes
    :func:`verify_step` is never deleted, even outside the ``keep`` window,
    so a run whose newest checkpoints are corrupt keeps a restore point.
    The scan walks newest to oldest and stops at the first verifying step."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    doomed = steps[:-keep] if keep > 0 else list(steps)
    if doomed and protect_verified:
        for s in reversed(steps):
            if verify_step(ckpt_dir, s)["ok"]:
                doomed = [d for d in doomed if d != s]
                break
    for s in doomed:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"), ignore_errors=True)
    if remove_tmp:
        for d in os.listdir(ckpt_dir):
            if d.startswith(".tmp-"):
                shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys

    sys.exit(_cli(sys.argv[1:]))
