"""Elastic meshes: fault-tolerant training as mesh re-derivation and reshard
(a port of the JAX package's ``launch/elastic.py``).

GSPMD's premise is that a partitioned program is annotations over a
single-device program, so surviving a device failure is "re-derive the
mesh, re-solve the annotations, reshard the state", not "restart the job".
This module is that recovery loop:

* :class:`FaultInjector`: deterministic fault hooks for tests and drills:
  one-shot fields (device loss and return, a crash mid-save, a straggler
  stall, numeric faults applied inside the train step through
  ``TrainConfig.numeric_fault``) and a **schedule** of event dicts
  (``dump_schedule`` / ``load_schedule``), the replayable campaign format
  of the chaos harness (``launch/chaos.py``).
* :func:`derive_mesh`: the largest ``("data", "model")`` mesh over a
  number of devices, after a loss (shrink) or a return (regrow).
* :class:`ElasticCoordinator`: a single-pass recovery state machine.  An
  escalated fault (:class:`DeviceLossError`, :class:`DeviceReturnError`,
  ``core.plan.NumericsFault``) is classified together with every coincident
  armed fault (a numeric window the replay would enter, a device event due
  within the coincidence window) and handled in one pass: adjust the device
  world, re-derive the mesh, re-solve the sharding assignment warm-started
  from the previous solve's JSON dump (``autoshard.remap_assignment`` on a
  shrink, ``autoshard.expand_assignment`` on a regrow), then exactly **one**
  ``checkpoint.restore_resharded`` from the newest intact step onto the new
  mesh (a corrupt newest step falls back inside that call), a new train
  step swapped into the loop, and training resumed at the manifest's data
  cursor.  Fault and recovery provenance lands in the manifests' ``extra``
  and on the obs control lane; the counters are ``elastic.*``,
  ``train.guard.rewinds`` and the ``elastic.recovery_ms`` histogram.  An
  infeasible warm re-solve degrades to the data-parallel-only restriction
  of the baseline instead of aborting.

The device world is a count of simulated devices (``n_devices``; the
port's meshes are simulated in one process, ``core/mesh_runtime.py``), and
the train step always runs partitioned on the coordinator's mesh, a
world of one on a (1, 1) mesh.  As in the JAX package, the searched
assignment is solved, dumped and used as the next warm start, while the
train step runs the declared specs (``make_train_step`` takes no
assignment).  Restores build each leaf from meta-tensor targets on the
loop's device, so a recovery allocates the restored state once.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

from ..core.plan import NumericsFault
from ..core.sharding import Mesh
from ..obs import metrics as obs_metrics
from ..obs.trace import control_event
from ..train import checkpoint as ckpt_lib


class DeviceLossError(RuntimeError):
    """Raised (by the fault hook) when devices drop out of the world."""

    def __init__(self, step: int, lost: int = 1):
        self.step, self.lost = step, lost
        super().__init__(f"lost {lost} device(s) at step {step}")


class DeviceReturnError(RuntimeError):
    """Raised (by the fault hook) when devices rejoin the world, the regrow
    trigger.  An exception, like :class:`DeviceLossError`, so that it unwinds
    the training loop and the coordinator re-derives a larger mesh."""

    def __init__(self, step: int, gained: int = 1):
        self.step, self.gained = step, gained
        super().__init__(f"regained {gained} device(s) at step {step}")


# Schedule-event kinds a FaultInjector understands.  Mechanical events fire
# from the host hook; numeric events are applied inside the train step
# (numeric_spec), because the guard sentinels must catch them in-program.
SCHEDULE_KINDS = ("device_loss", "device_return", "nan_burst", "grad_spike",
                  "straggler", "crash_save", "manifest_corrupt")
_NUMERIC_KINDS = ("nan_burst", "grad_spike")


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault injection for the elastic recovery loop.

    Each fault fires once.  ``hook`` is installed as ``TrainLoop``'s
    ``"fault"`` hook (called inside the measured step window);
    ``arm_save_fault`` plumbs the crash mid-save into
    ``checkpoint.set_save_fault``.

    Beside the one-shot fields, ``schedule`` holds a list of event dicts
    (``{"kind": ..., "step": ..., **params}``, kinds in
    :data:`SCHEDULE_KINDS`) that round-trips through JSON
    (:meth:`dump_schedule` / :meth:`load_schedule`): a failing chaos soak
    replays from its campaign artifact alone.  Every schedule event that
    fires emits a ``chaos_event`` control instant, so the trace tells the
    injections apart from the recoveries they cause.
    """

    device_loss_at: int = -1   # step at which devices drop
    lose: int = 1              # how many
    device_return_at: int = -1  # step at which devices rejoin (regrow)
    gain: int = 1               # how many return
    straggler_at: int = -1     # step to stall
    stall_s: float = 0.0       # injected stall duration
    crash_save_at_leaf: int = -1  # raise mid-save after writing k leaves
    nan_at_step: int = -1        # numeric: NaN-poison grads and loss at this step
    grad_spike_at_step: int = -1  # numeric: spike grads at this step
    spike_factor: float = 1e12
    numeric_steps: int = 1       # numeric fault window (consecutive steps)
    schedule: List[Dict] = dataclasses.field(default_factory=list)
    ckpt_dir: Optional[str] = None  # manifest_corrupt events need the directory
    fired: set = dataclasses.field(default_factory=set)

    def __post_init__(self):
        for ev in self.schedule:
            if ev.get("kind") not in SCHEDULE_KINDS:
                raise ValueError(f"unknown schedule event kind: {ev!r}")
            if "step" not in ev:
                raise ValueError(f"schedule event missing step: {ev!r}")

    # -- JSON round trip (replayable campaigns) -----------------------------
    def dump_schedule(self, path: Optional[str] = None) -> Dict:
        doc = {"version": 1, "events": [dict(e) for e in self.schedule]}
        if path:
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc

    @classmethod
    def load_schedule(cls, src) -> "FaultInjector":
        """An injector from a :meth:`dump_schedule` doc, a bare event list,
        or the path of the JSON artifact."""
        if isinstance(src, str):
            with open(src) as f:
                src = json.load(f)
        events = src["events"] if isinstance(src, dict) else src
        return cls(schedule=[dict(e) for e in events])

    # -- host-hook faults ----------------------------------------------------
    def hook(self, step: int) -> None:
        if step == self.straggler_at and "straggler" not in self.fired:
            self.fired.add("straggler")
            time.sleep(self.stall_s)
        if step == self.device_loss_at and "device_loss" not in self.fired:
            self.fired.add("device_loss")
            raise DeviceLossError(step, self.lose)
        if step == self.device_return_at and "device_return" not in self.fired:
            self.fired.add("device_return")
            raise DeviceReturnError(step, self.gain)
        for i, ev in enumerate(self.schedule):
            tag = f"sched:{i}"
            kind = ev["kind"]
            if tag in self.fired or kind in _NUMERIC_KINDS:
                continue  # numeric events are consumed through numeric_spec / ack
            if step < ev["step"]:
                continue
            self.fired.add(tag)
            control_event("chaos_event", kind=kind, step=step, sched_step=ev["step"])
            if kind == "device_loss":
                raise DeviceLossError(step, ev.get("lose", 1))
            if kind == "device_return":
                raise DeviceReturnError(step, ev.get("gain", 1))
            if kind == "straggler":
                time.sleep(ev.get("stall_s", 0.2))
            elif kind == "crash_save":
                self._arm_sched_save_fault(ev)
            elif kind == "manifest_corrupt":
                ev["corrupted_step"] = self._corrupt_latest_manifest()

    def arm_save_fault(self) -> None:
        if self.crash_save_at_leaf < 0:
            return

        def fault(i: int, key: str) -> None:
            if i >= self.crash_save_at_leaf and "crash_save" not in self.fired:
                self.fired.add("crash_save")
                raise OSError(f"injected crash mid-save (leaf {i}: {key})")

        ckpt_lib.set_save_fault(fault)

    def _arm_sched_save_fault(self, ev: Dict) -> None:
        at_leaf = ev.get("at_leaf", 0)
        once = {"done": False}

        def fault(i: int, key: str) -> None:
            if i >= at_leaf and not once["done"]:
                once["done"] = True
                raise OSError(f"injected crash mid-save (leaf {i}: {key})")

        ckpt_lib.set_save_fault(fault)

    def _corrupt_latest_manifest(self) -> Optional[int]:
        """Flip the middle byte of the newest committed manifest: its
        self-checksum catches it at the next restore, which then falls back
        to the previous intact step in the same pass."""
        if not self.ckpt_dir:
            return None
        last = ckpt_lib.latest_step(self.ckpt_dir)
        if last is None:
            return None
        path = os.path.join(self.ckpt_dir, f"step_{last:08d}", "manifest.json")
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            data[len(data) // 2] ^= 0xFF
            f.seek(0)
            f.write(bytes(data))
        return last

    def disarm(self) -> None:
        ckpt_lib.set_save_fault(None)

    # -- numeric faults (inside the step, through TrainConfig.numeric_fault) --
    def numeric_spec(self):
        """The ``train.loop.NumericFaultSpec`` of the armed numeric mode, or
        None when none is pending.  Numeric faults are applied inside the
        train step (``train/loop.py::_with_faults``), where the guard
        sentinels watch, not from the host hook.  The one-shot fields win;
        else the earliest numeric schedule event not yet acknowledged is
        armed (one window per step build: the next event arms at the next
        swap)."""
        from ..train.loop import NumericFaultSpec

        if self.nan_at_step >= 0 or self.grad_spike_at_step >= 0:
            return NumericFaultSpec(nan_at_step=self.nan_at_step,
                                    grad_spike_at_step=self.grad_spike_at_step,
                                    spike_factor=self.spike_factor, steps=self.numeric_steps)
        pend = [(i, ev) for i, ev in enumerate(self.schedule)
                if ev["kind"] in _NUMERIC_KINDS and f"sched:{i}" not in self.fired]
        if not pend:
            return None
        _, ev = min(pend, key=lambda t: t[1]["step"])
        if ev["kind"] == "nan_burst":
            return NumericFaultSpec(nan_at_step=ev["step"], steps=ev.get("steps", 1))
        return NumericFaultSpec(grad_spike_at_step=ev["step"],
                                spike_factor=ev.get("factor", 1e12), steps=ev.get("steps", 1))

    def ack_numeric(self, upto_step: int) -> None:
        """Consume every armed numeric fault whose window opened at or
        before ``upto_step`` (one-shot fields and schedule events): after a
        recovery restores behind such a window, its replay must run clean."""
        self.nan_at_step = -1
        self.grad_spike_at_step = -1
        for i, ev in enumerate(self.schedule):
            tag = f"sched:{i}"
            if (ev["kind"] in _NUMERIC_KINDS and tag not in self.fired
                    and ev["step"] <= upto_step):
                self.fired.add(tag)
                control_event("chaos_event", kind=ev["kind"], step=ev["step"],
                              sched_step=ev["step"])

    def numeric_coincident(self, step: int, window: int = 1,
                           floor: Optional[int] = None) -> bool:
        """True when an armed numeric window could poison the recovery: it
        opens at or before ``step + window`` and has not fully elapsed
        before ``floor`` (the restore point: a window wholly behind the
        newest intact checkpoint cannot be replayed into)."""
        spec = self.numeric_spec()
        if spec is None:
            return False
        at = spec.nan_at_step if spec.nan_at_step >= 0 else spec.grad_spike_at_step
        if at > step + window:
            return False
        if floor is not None and at + spec.steps <= floor:
            return False
        return True

    def take_device_event(self, step: int, window: int = 1):
        """Consume an armed, unfired device loss or return due at or before
        ``step + window``: the coincident-fault fold, so that a numerics
        rewind about to restore handles an imminent device event in the same
        pass.  Returns ``("device_loss", lost)``, ``("device_return",
        gained)`` or None."""
        if (self.device_loss_at >= 0 and "device_loss" not in self.fired
                and self.device_loss_at <= step + window):
            self.fired.add("device_loss")
            return ("device_loss", self.lose)
        if (self.device_return_at >= 0 and "device_return" not in self.fired
                and self.device_return_at <= step + window):
            self.fired.add("device_return")
            return ("device_return", self.gain)
        for i, ev in enumerate(self.schedule):
            tag = f"sched:{i}"
            if tag in self.fired:
                continue
            if ev["kind"] in ("device_loss", "device_return") and ev["step"] <= step + window:
                self.fired.add(tag)
                control_event("chaos_event", kind=ev["kind"], step=step, sched_step=ev["step"])
                if ev["kind"] == "device_loss":
                    return ("device_loss", ev.get("lose", 1))
                return ("device_return", ev.get("gain", 1))
        return None


def derive_mesh(n_devices: int, model_parallel: Optional[int] = None) -> Mesh:
    """The largest ``(data, model)`` mesh over ``n_devices`` devices.

    ``model_parallel`` (default ``min(16, n_devices)``) is clamped to the
    largest divisor of ``n_devices`` not above it, so a world that lost a
    device still derives a mesh.
    """
    n = int(n_devices)
    mp = min(model_parallel or min(16, n), n)
    while n % mp:
        mp -= 1
    return Mesh.create((n // mp, mp), ("data", "model"))


def state_partition_specs(cfg, st, opt, tc) -> Dict[str, Any]:
    """Partition-spec tree (tuples) shaped like the train loop's state:
    params by their declared specs, the optimizer state sharded like the
    params (``opt_state_specs``), the step replicated, and the error
    feedback like the params when ``tc.compress_grads``."""
    from ..models import api
    from ..models.layers import tree_shapes, tree_specs
    from ..train.optimizer import opt_state_specs
    from ..core.tree import tree_map

    tree = api.param_tree(cfg, st)
    pspecs = tree_specs(tree)
    ospecs = opt_state_specs(opt, pspecs, tree_shapes(tree, cfg.param_dtype))
    fill = lambda t: tree_map(lambda s: () if s is None else tuple(s), t)
    spec_state = {"params": fill(pspecs), "opt": fill(ospecs), "step": ()}
    if tc.compress_grads:
        spec_state["ef"] = fill(pspecs)
    return spec_state


def specs_by_key(spec_state) -> Dict[str, Any]:
    """A spec tree flattened to the checkpoint's ``/``-joined leaf keys."""
    return dict(ckpt_lib._flatten_with_paths(spec_state))


def sharding_problem(cfg, st, mesh: Mesh, local_batch: int, seq_len: int):
    """Capture ``cfg``'s loss annotation-free on meta tensors and build the
    Table-1 baseline assignment on ``mesh`` (as ``autoshard.registry_problem``
    does, for a config that need not be in the registry).  The inputs are the
    JAX package's leaf for leaf: params by sorted keys, then ``labels`` and
    ``tokens``, int32.  Pure planning: no device is touched.  Returns
    ``(captured, baseline)``."""
    from ..autoshard.api import _capture_with_baseline, _meta_batch
    from ..models import api

    tree = api.param_tree(cfg, st)
    return _capture_with_baseline(lambda p, b: api.loss_fn(cfg, st, p, b), tree, cfg, mesh,
                                  _meta_batch(local_batch, seq_len))


def meta_state(cfg, st, opt, tc) -> Dict[str, Any]:
    """The train state's structure on the meta device (shapes and dtypes,
    no memory): a restore target that allocates nothing until the restore
    writes each leaf."""
    import torch

    from ..core.tree import tree_map
    from ..models import api
    from ..models.layers import tree_shapes

    shapes = tree_shapes(api.param_tree(cfg, st), cfg.param_dtype)
    state = {"params": shapes, "opt": opt.init(shapes), "step": 0}
    if tc.compress_grads:
        state["ef"] = tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                     device="meta"), shapes)
    return state


class ElasticCoordinator:
    """Drive a :class:`~repro_torch.train.loop.TrainLoop` through injected
    faults.

    One instance owns the device world (``world`` simulated devices, of
    which ``n_live`` are up), the current mesh, the last autoshard
    assignment (dumped to JSON beside the checkpoints) and the recovery log.
    ``run()`` returns ``(state, losses)`` as ``TrainLoop.run`` does, with
    ``losses`` one per step, continuous across recoveries.  ``device``,
    ``gen``, ``plan_profile`` and ``optimize`` are the loop's; the restore
    prices its reshard with ``plan_profile`` as resolved.
    """

    def __init__(self, cfg, st, opt, tc, pipeline, *, n_devices: int = 1,
                 model_parallel: Optional[int] = None, autoshard_config=None,
                 injector: Optional[FaultInjector] = None,
                 hooks: Optional[Dict[str, Callable]] = None, max_recoveries: int = 3,
                 coincidence_window: int = 1, sharded_restore_io: bool = True,
                 device="cuda", gen=None, plan_profile=None, optimize: bool = True):
        from .. import autoshard
        from ..core.compat import set_mesh
        from ..obs.profile import resolve_profile
        from ..train.loop import TrainLoop

        self.cfg, self.st, self.opt, self.tc = cfg, st, opt, tc
        self.pipeline = pipeline
        self.model_parallel = model_parallel
        # `world` is the pool devices rejoin from (the regrow ceiling);
        # `n_live` the devices the current mesh is derived over
        self.world = int(n_devices)
        self.n_live = self.world
        self.mesh = derive_mesh(self.n_live, model_parallel)
        self.profile = resolve_profile(plan_profile)
        config = autoshard_config or autoshard.AutoshardConfig(top_n=4, sa_steps=4)
        # the search prices with the profile the plans are priced by, unless
        # the config names one (as spmd_partition(autoshard=) does)
        self.ashard_config = (config if config.profile is not None
                              else dataclasses.replace(config, profile=self.profile))
        self.injector = injector
        self.max_recoveries = max_recoveries
        self.coincidence_window = coincidence_window
        self.sharded_restore_io = sharded_restore_io
        self.recoveries: List[Dict] = []
        # keyed by step: a replay after a recovery overwrites rather than
        # duplicates, so the returned curve is one loss per step
        self.losses: Dict[int, float] = {}
        self.assignment = None   # the last AutoshardResult
        self.degraded = False    # True after a data-parallel-only fallback
        self.dump_path = os.path.join(tc.ckpt_dir, "assignment.json") if tc.ckpt_dir else None
        loop_hooks = dict(hooks or {})
        if injector is not None:
            loop_hooks["fault"] = injector.hook
            injector.arm_save_fault()
            if injector.ckpt_dir is None:
                injector.ckpt_dir = tc.ckpt_dir
            spec = injector.numeric_spec()
            if spec is not None:
                # numeric faults live inside the step: arm before it is built
                tc.numeric_fault = spec
        loop_hooks["metrics"] = lambda step, loss: self.losses.__setitem__(step, loss)
        loop_hooks.setdefault("ckpt_extra", self._manifest_extra)
        with set_mesh(self.mesh):
            self.loop = TrainLoop(cfg, st, opt, tc, pipeline, gen=gen, hooks=loop_hooks,
                                  device=device, plan_profile=plan_profile, optimize=optimize)

    def _manifest_extra(self) -> Dict[str, Any]:
        """Coordinator state merged into every manifest's ``extra``: the
        assignment dump's path, the live mesh and, after a recovery, its
        provenance (what was classified, what was restored from), so that a
        post-mortem reads the history off the checkpoints."""
        extra: Dict[str, Any] = {
            "mesh": {"shape": list(self.mesh.shape), "axes": list(self.mesh.axis_names)}}
        if self.dump_path:
            extra["assignment_path"] = self.dump_path
        if self.recoveries:
            last = self.recoveries[-1]
            extra["recovery"] = {
                "count": len(self.recoveries),
                "last": {k: last[k] for k in ("classes", "step", "restored_from", "mesh",
                                              "fell_back_from", "crash_save") if k in last},
            }
        return extra

    # -- sharding re-solve ---------------------------------------------------
    def _problem(self, mesh: Mesh):
        return sharding_problem(self.cfg, self.st, mesh, self.pipeline.local_batch,
                                self.pipeline.cfg.seq_len)

    def solve_assignment(self, warm=None, warm_mesh=None):
        """(Re-)solve the sharding assignment on the current mesh.  ``warm``
        is a prior mesh's assignment (``autoshard.load(dump)[1]``) and
        ``warm_mesh`` that mesh: on a larger mesh (a regrow) the warm point
        is lifted by ``expand_assignment`` (freed axes proposed again on the
        largest dividing dims), else projected by ``remap_assignment``.  An
        infeasible solve degrades to the data-parallel-only restriction of
        the baseline."""
        from .. import autoshard
        from ..core.rules import aval

        captured, baseline = self._problem(self.mesh)
        shapes = [tuple(aval(v).shape) for v in captured.invars]
        ws = None
        if warm is not None:
            grew = warm_mesh is not None and self.mesh.size > warm_mesh.size
            project = autoshard.expand_assignment if grew else autoshard.remap_assignment
            ws = project(warm, self.mesh, shapes)
        res = autoshard.solve_problem(captured, self.mesh, self.ashard_config,
                                      baseline=baseline, warm_start=ws)
        self.degraded = False
        if not res.evaluation.feasible:
            dp = autoshard.restrict_assignment(baseline, self.mesh, shapes)
            res = autoshard.solve_problem(
                captured, self.mesh, dataclasses.replace(self.ashard_config, top_n=0, sa_steps=0),
                baseline=dp, warm_start=dp)
            res.assignment = dp
            self.degraded = True
        self.assignment = res
        if self.dump_path:
            os.makedirs(os.path.dirname(self.dump_path), exist_ok=True)
            res.dump(self.dump_path)
        return res

    # -- recovery ------------------------------------------------------------
    def _classify(self, err) -> Dict[str, Any]:
        """The fault classes of one escalated fault and of everything armed
        and coincident with it.  Keys: ``device_loss`` (lost count),
        ``device_return`` (gained count), ``numerics`` (the NumericsFault, or
        None when folded in before it escalated).  An armed numeric window
        the replay would enter, or a device event due within
        ``coincidence_window`` steps, would start a second recovery moments
        after a single-fault handler resumes, so they join this pass."""
        classes: Dict[str, Any] = {}
        if isinstance(err, DeviceLossError):
            classes["device_loss"] = err.lost
        elif isinstance(err, DeviceReturnError):
            classes["device_return"] = err.gained
        elif isinstance(err, NumericsFault):
            classes["numerics"] = err
        step = getattr(err, "step", 0)
        if self.injector is not None:
            floor = ckpt_lib.latest_step(self.tc.ckpt_dir) if self.tc.ckpt_dir else None
            if "numerics" not in classes and self.injector.numeric_coincident(
                    step, self.coincidence_window, floor=floor):
                classes["numerics"] = None
            if not ({"device_loss", "device_return"} & set(classes)):
                taken = self.injector.take_device_event(step, self.coincidence_window)
                if taken is not None:
                    classes[taken[0]] = taken[1]
        return classes

    def _restore(self):
        """The single restore pass: the newest intact step (older ones on a
        corrupt newest, inside ``restore_resharded``) onto the current mesh,
        from meta targets on the loop's device, the params marked for
        autograd again.  Returns ``(state, manifest, report)``."""
        from ..core.tree import leaves

        specs = specs_by_key(state_partition_specs(self.cfg, self.st, self.opt, self.tc))
        state, manifest, report = ckpt_lib.restore_resharded(
            self.tc.ckpt_dir, meta_state(self.cfg, self.st, self.opt, self.tc), self.mesh,
            target_specs=specs, sharded_io=self.sharded_restore_io, device=self.loop.device,
            profile=self.profile)
        for p in leaves(state["params"]):
            p.requires_grad_(True)
        return state, manifest, report

    def _recover_combined(self, err):
        """One recovery pass for every coincident fault class: adjust the
        device world (shrink or regrow), re-derive the mesh, warm re-solve,
        then exactly **one** restore from the newest intact step onto the
        new mesh (a corrupt newest step falls back inside it,
        ``ckpt_fallback``).  Acknowledges a consumed numeric injection,
        swaps in a new train step built on the mesh, and returns ``(state,
        start_step)`` (``(None, None)``: no checkpoint, start afresh)."""
        from .. import autoshard
        from ..core.compat import set_mesh
        from ..train.loop import make_train_step

        t0 = time.perf_counter()
        classes = self._classify(err)
        step = getattr(err, "step", None)
        # the fault's own instants keep the single-fault vocabulary...
        if isinstance(err, DeviceLossError):
            control_event("device_loss", step=err.step, lost=err.lost)
            obs_metrics.inc("elastic.device_losses")
        elif isinstance(err, DeviceReturnError):
            control_event("device_return", step=err.step, gained=err.gained)
            obs_metrics.inc("elastic.device_returns")
        if isinstance(err, NumericsFault):
            control_event("rewind", step=err.step, consecutive=err.consecutive)
            obs_metrics.inc("elastic.rewinds")
        # ...and a combined_recovery instant marks the single-pass fold
        if len(classes) > 1:
            control_event("combined_recovery", step=step, classes=sorted(classes))
            obs_metrics.inc("elastic.combined_recoveries")
        event: Dict[str, Any] = {"classes": sorted(classes), "step": step}
        old_shape = self.mesh.shape
        mesh_changed = False
        if "device_loss" in classes:
            self.n_live = max(self.n_live - classes["device_loss"], 1)
            event["lost"] = classes["device_loss"]
        if "device_return" in classes:
            self.n_live = min(self.n_live + classes["device_return"], self.world)
            event["gained"] = classes["device_return"]
        if {"device_loss", "device_return"} & set(classes):
            self.mesh = derive_mesh(self.n_live, self.model_parallel)
            mesh_changed = True
            control_event("mesh_grow" if "device_return" in classes else "mesh_shrink",
                          mesh_from=list(old_shape), mesh_to=list(self.mesh.shape), step=step)
        event["mesh"] = {"from": list(old_shape), "to": list(self.mesh.shape)}
        if isinstance(err, NumericsFault):
            event["numerics"] = True
            event["consecutive"] = err.consecutive
            event["faults"] = [dict(f) for f in err.faults[:8]]
        # re-solve only when the mesh changed: a pure rewind keeps the plan
        if mesh_changed:
            warm, warm_mesh = None, None
            if self.dump_path and os.path.exists(self.dump_path):
                warm_mesh, warm = autoshard.load(self.dump_path)
            t_solve = time.perf_counter()
            res = self.solve_assignment(warm=warm, warm_mesh=warm_mesh)
            event.update({"warm_started": res.warm_started, "degraded": self.degraded,
                          "evals": res.evals, "solve_s": time.perf_counter() - t_solve})
        # the single restore pass (the fallback to older intact steps inside)
        state, start = None, None
        if self.tc.ckpt_dir and ckpt_lib.latest_step(self.tc.ckpt_dir) is not None:
            t_restore = time.perf_counter()
            state, manifest, report = self._restore()
            start = int(manifest.get("extra", {}).get("data_cursor", manifest["step"]))
            if report.get("fell_back_from"):
                classes["corrupt_checkpoint"] = report["fell_back_from"]
                event["classes"] = sorted(classes)
                event["fell_back_from"] = report["fell_back_from"]
                control_event("ckpt_fallback", step=step, skipped=report["fell_back_from"],
                              restored=report["step"])
                obs_metrics.inc("elastic.ckpt_fallbacks")
            control_event("restore", step=report["step"], leaves=report["leaves"],
                          resharded=report["resharded_leaves"],
                          sharded_io=bool(report.get("sharded_io")))
            obs_metrics.inc("elastic.restores")
            event["restored_from"] = int(report["step"])
            event["reshard"] = {k: report[k] for k in ("leaves", "resharded_leaves",
                                                       "wire_bytes", "launches", "reshard_s",
                                                       "step")}
            event["restore_s"] = time.perf_counter() - t_restore
            if report.get("sharded_io"):
                event["io"] = dict(report.get("io", {}))
            if "numerics" in classes:
                event["rewound_to"] = int(report["step"])
        if "numerics" in classes:
            # acknowledge the consumed injection (replaying its window would
            # fault again) and arm the next pending one, if any
            if self.injector is not None:
                self.injector.ack_numeric(step if step is not None else 1 << 30)
                self.tc.numeric_fault = self.injector.numeric_spec()
            else:
                self.tc.numeric_fault = None
            self.loop.guard_counters["rewinds"] += 1
            obs_metrics.inc("train.guard.rewinds")
            self.loop._consecutive_faults = 0
        # a new step on the (new) mesh: a fresh capture and plan, so that
        # neither the old mesh nor the old fault window runs again
        with set_mesh(self.mesh):
            self.loop.swap_plan(make_train_step(self.cfg, self.st, self.opt, self.tc,
                                                plan_profile=self.loop.plan_profile,
                                                optimize=self.loop.optimize))
        reason = "rewind" if set(classes) == {"numerics"} else "+".join(sorted(classes))
        control_event("plan_swap", reason=reason, step=step, mesh=list(self.mesh.shape),
                      rewound_to=event.get("rewound_to"))
        event["duration_ms"] = (time.perf_counter() - t0) * 1e3
        obs_metrics.observe("elastic.recovery_ms", event["duration_ms"])
        self.recoveries.append(event)
        return state, start

    def run(self):
        """Train to completion, recovering in process from injected faults."""
        from ..core.compat import set_mesh

        if self.assignment is None:
            self.solve_assignment()
        state, start = None, None
        attempts = 0
        while True:
            try:
                with set_mesh(self.mesh):
                    final, _ = self.loop.run(initial_state=state, start_step=start)
                return final, [self.losses[s] for s in sorted(self.losses)]
            except (DeviceLossError, DeviceReturnError, NumericsFault) as e:
                # one classified pass handles the fault and everything
                # coincident with it: shrink or regrow, rewind and a corrupt
                # step's fallback collapse into a single restore
                attempts += 1
                if attempts > self.max_recoveries:
                    raise
                state, start = self._recover_combined(e)
            except OSError:
                # a crash mid-save: the atomic rename never committed, so the
                # newest intact step is still the restore point; disarm the
                # injector and resume from it on the same mesh
                attempts += 1
                if attempts > self.max_recoveries:
                    raise
                if self.injector is not None:
                    self.injector.disarm()
                state, start = None, None
                control_event("crash_save", resumed=True)
                obs_metrics.inc("elastic.crash_saves")
                self.recoveries.append({"crash_save": True, "classes": ["crash_save"]})
