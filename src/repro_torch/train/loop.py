"""Training loop: step builder, gradient accumulation, gradient compression,
numeric-fault injection, numerics guards and a straggler watchdog (port of
the JAX package's ``train/loop.py``).

``make_train_step`` builds the step:
  loss (compute dtype) -> gradients of the float32 master weights ->
  [bf16 exchange + float32 error feedback] -> optimizer update.
PyTorch runs it eagerly; the update lands in place (the reference donates
its state to ``jit``).  Gradient accumulation is the reference's
microbatch loop: ``scan_or_loop`` over the microbatches with the gradient
inside the body, the float32 gradients summed in order (one scan node
under capture with ``cfg.scan_layers``, holding the layer stack's scan and
its reverse scan); remat is the model config's
(``models/layers.py::stack_layers``).  ``TrainLoop.run`` records per-step
wall times and tokens per second and flags straggler steps (> k x median)
through a hook.

Under an ambient mesh (``core.compat.set_mesh``) ``make_train_step``
builds the step as one partitioned program instead
(``partitioned_train_step``): the functional step ``(params, opt_state,
step, batch) -> (params', opt_state', loss, grad_norm)``, its inputs
annotated at entry (params by their declared specs, the optimizer state by
``opt_state_specs``, the batch on "data") and the gradient taken inside it,
runs through ``spmd_partition``: capture, completion and the plan on the
first call, the plan alone on every later one.  The plan is optimized and
verified, as the reference's ``spmd_partition`` does by default, priced by
``plan_profile`` (``None``: ``$REPRO_TORCH_MACHINE_PROFILE``, then the
profile fitted on an H100 and committed with the package;
``obs/profile.py::resolve_profile``); ``optimize=False`` keeps the
unoptimized (verified) plan.  The step writes the results back into the
state's tensors, so callers see the same in-place contract.

**Numerics guards** (``TrainConfig.guard``, a ``core/plan.py::GuardConfig``):
both steps compute a non-finite / abs-max sentinel over the guarded tensors
(loss, gradients, optionally the optimizer's moments) and a fault flag; on a
fault a ``torch.where`` keeps the old params, optimizer state and error
feedback (inside the captured program on the partitioned step) while the
step counter still advances, so the data moves past the poisoned batch.
``TrainLoop`` decodes the leaves (``plan.guard_faults``), counts faults and
skips, calls the ``numerics_fault`` hook, and raises ``NumericsFault`` after
``guard.rewind_after`` consecutive faults.

**Checkpoint/restart** (``TrainConfig.ckpt_dir``, ``train/checkpoint.py``):
``run`` saves after every ``ckpt_every``-th step (a skipped step too) and
once at the end, the manifest's ``extra`` holding the data cursor (the next
batch index: the resume point) and the guard counters; under an ambient
mesh each leaf's spec is the layout ``partitioned_train_step`` annotates it
with (``launch/elastic.py::state_partition_specs`` projected onto the
mesh).  A run with no ``initial_state`` restores the newest checkpoint in
``ckpt_dir`` and resumes at its cursor.

**Observability** (``obs/``): ``run`` observes ``train.step_ms`` and
``train.tokens_per_s`` for every step, counts ``train.guard.faults`` and
``train.guard.skips``, and emits the reference's control events
(``ckpt_save``, ``numerics_fault``, ``skip_step``, ``straggler``) beside
its hooks.

The rewind to a checkpoint after escalated faults is the elastic
coordinator's (``launch/elastic.py::ElasticCoordinator``): the loop raises
``NumericsFault``, and the coordinator restores, acknowledges the fault
window and swaps in a new step (``swap_plan``).  The dense family and Mamba2
train (attention's and the SSD's gradients are kernels on the card:
``kernels/ops.py``); the families with no model yet raise (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, Strategy
from ..core.compat import get_abstract_mesh, set_mesh
from ..core.plan import GuardConfig, NumericsFault, guard_faults
from ..core.scan import scan_or_loop
from ..core.device import resolve_device
from ..core.tree import leaves, leaves_with_paths, tree_from_paths, tree_map
from ..models import api
from ..models.layers import annotate_spec, annotate_tree, tree_init, tree_shapes, tree_specs
from ..obs import metrics as obs_metrics
from ..obs.trace import control_event
from . import checkpoint as ckpt_lib
from .optimizer import Optimizer, opt_state_specs


@dataclasses.dataclass(frozen=True)
class NumericFaultSpec:
    """Deterministic numeric-fault injection inside the step: for ``steps``
    consecutive steps from the armed step, gradients (and the loss, for the
    NaN mode) are poisoned after differentiation."""

    nan_at_step: int = -1         # poison grads+loss with NaN at this step
    grad_spike_at_step: int = -1  # multiply grads by spike_factor at this step
    spike_factor: float = 1e12
    steps: int = 1                # window length (consecutive faulted steps)


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep_ckpts: int = 3
    grad_accum: int = 1
    compress_grads: bool = False  # bf16 gradient exchange + fp32 error feedback
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: int = -1  # fault-injection for tests
    guard: Optional[GuardConfig] = None  # numerics sentinels
    numeric_fault: Optional[NumericFaultSpec] = None


def _require_trainable(cfg: ModelConfig, tc: TrainConfig):
    api.family_module(cfg)  # the families with no model yet raise, naming their item


def value_and_grad(cfg: ModelConfig, st: Strategy, params, batch, grad_accum: int = 1):
    """(loss, grads) of ``api.loss_fn``: with ``grad_accum`` > 1 the batch is
    split into that many microbatches along its first dim, whose losses and
    float32 gradients are summed in order (``scan_or_loop`` over the
    microbatches, the params its consts, the gradient taken inside the
    body, as the reference's ``grads_of``) and divided by their count."""
    pairs = leaves_with_paths(params)
    flat = [leaf for _, leaf in pairs]

    def one(leaves, mb):
        tree = tree_from_paths((path, leaf) for (path, _), leaf in zip(pairs, leaves))
        loss = api.loss_fn(cfg, st, tree, mb)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    if grad_accum <= 1:
        loss, grads = one(flat, batch)
    else:
        B = batch["tokens"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} is not a multiple of grad_accum {grad_accum}")
        mbs = {k: v.reshape((grad_accum, B // grad_accum) + v.shape[1:]) for k, v in batch.items()}

        def micro(carry, mb, *leaves):
            loss_sum, g_sum = carry
            l, g = one(list(leaves), mb)
            return (loss_sum + l, [a + b for a, b in zip(g_sum, g)]), None

        zero = (torch.zeros((), dtype=torch.float32, device=flat[0].device),
                [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat])
        (loss, grads), _ = scan_or_loop(micro, zero, mbs, cfg, consts=tuple(flat))
        inv = 1.0 / grad_accum
        loss, grads = loss * inv, [g * inv for g in grads]
    return loss, tree_from_paths((path, g) for (path, _), g in zip(pairs, grads))


def make_train_step(cfg: ModelConfig, st: Strategy, opt: Optimizer, tc: TrainConfig,
                    plan_profile=None, optimize: bool = True, trace=None):
    """Returns step(state, batch) -> (state, metrics); state = {"params",
    "opt", "step"[, "ef"]}, updated in place.  Under an ambient mesh, the
    partitioned step (``partitioned_train_step``, which takes
    ``plan_profile``, ``optimize`` and ``trace``)."""
    _require_trainable(cfg, tc)
    mesh = get_abstract_mesh()
    if mesh is not None:
        return partitioned_train_step(cfg, st, opt, tc, mesh, plan_profile=plan_profile,
                                      optimize=optimize, trace=trace)

    def step_fn(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        loss, grads = value_and_grad(cfg, st, params, batch, tc.grad_accum)
        t = torch.tensor(step, device=loss.device)
        loss, grads = _with_faults(tc.numeric_fault, t, loss, grads)
        new_ef = None
        if tc.compress_grads:
            grads, new_ef = _compressed(grads, state["ef"])
        gnorm = _grad_norm(grads, loss.device)
        metrics = {"loss": loss, "grad_norm": torch.sqrt(gnorm)}
        with torch.no_grad():
            if tc.guard is None:
                if new_ef is not None:
                    tree_map(torch.Tensor.copy_, state["ef"], new_ef)
                opt.update(grads, opt_state, params, step)
            else:
                new_params, new_opt = opt.apply(grads, opt_state, params, t)
                metrics.update(_guarded(tc.guard, loss, grads, new_opt, metrics["grad_norm"]))
                keep = _keep(metrics["fault"])
                tree_map(lambda o, n: o.copy_(keep(o, n)), params, new_params)
                tree_map(lambda o, n: o.copy_(keep(o, n)), opt_state, new_opt)
                if new_ef is not None:
                    tree_map(lambda o, n: o.copy_(keep(o, n)), state["ef"], new_ef)
        state["step"] = step + 1
        return state, metrics

    return step_fn


def _grad_norm(grads, device):
    """The squared global gradient norm, summed in the reference's leaf order."""
    gnorm = torch.zeros((), dtype=torch.float32, device=device)
    for g in leaves(grads):
        gnorm = gnorm + g.float().square().sum()
    return gnorm


def _guard_stat(x):
    """The sentinel of one tensor: [non-finite count, abs max] in float32."""
    x = x.float()
    nonfin = (~torch.isfinite(x)).sum().float()
    amax = x.abs().amax() if x.numel() else torch.zeros((), device=x.device)
    return torch.stack([nonfin, amax])


def _guard_tensors(gc: GuardConfig, loss, grads, opt_state):
    """``(name, tensor)`` in one fixed order, shared by both steps and by the
    host's decoder (``guard_leaf_names``)."""
    out = []
    if gc.loss:
        out.append(("loss", loss))
    if gc.grads:
        out.extend(("grads/" + "/".join(p), g) for p, g in leaves_with_paths(grads))
    if gc.moments:
        out.extend(("opt/" + "/".join(p), m) for p, m in leaves_with_paths(opt_state))
    return out


def guard_leaf_names(gc: GuardConfig, state) -> tuple:
    """The leaves the step's guard vector describes, in its order, for
    ``plan.guard_faults`` on the host."""
    return tuple(name for name, _ in _guard_tensors(gc, None, state["params"], state["opt"]))


def _guarded(gc: GuardConfig, loss, grads, new_opt, grad_norm):
    """The ``guard`` vector ((2k,): [non-finite, abs max] per leaf) and the
    ``fault`` flag (a 0-d bool), as the reference's step computes them."""
    gvec = torch.stack([_guard_stat(x) for _, x in _guard_tensors(gc, loss, grads, new_opt)])
    fault = (gvec[:, 0] > 0).any() | (~torch.isfinite(gvec[:, 1])).any()
    if np.isfinite(gc.max_abs):
        fault = fault | (gvec[:, 1] > gc.max_abs).any()
    if np.isfinite(gc.max_grad_norm):
        fault = fault | ~torch.isfinite(grad_norm) | (grad_norm > gc.max_grad_norm)
    return {"guard": gvec.reshape(-1), "fault": fault}


def _keep(fault):
    """On a fault keep the old value: the poisoned update never lands."""
    return lambda old, new: torch.where(fault, old, new)


def sharded_value_and_grad(cfg: ModelConfig, st: Strategy, mesh, grad_accum: int = 1):
    """The program ``(params, batch) -> (loss, grads)`` of the partitioned
    step: params annotated at entry by their declared specs filtered to
    ``mesh``, tokens and labels on ("data",), the gradient taken with
    autograd inside the program (``value_and_grad``, with ``grad_accum``
    microbatches).  The program sets ``mesh`` as the ambient mesh while it
    runs, so that the model's own annotations (``Strategy.constrain``)
    apply wherever the step is called from."""
    with set_mesh(mesh):
        decls = api.param_tree(cfg, st)

    def program(params, batch):
        with set_mesh(mesh):
            params = annotate_tree(decls, params, mesh)
            batch = {k: annotate_spec(v, ("data",), mesh) for k, v in batch.items()}
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                return value_and_grad(cfg, st, live, batch, grad_accum)

    return program


def _with_faults(nf: Optional[NumericFaultSpec], step: torch.Tensor, loss, grads):
    """(loss, grads) under the fault window, as data: factors from the 0-d
    int64 step by ``torch.where``, as the reference's ``jnp.where`` (NaN
    inside the NaN window, the spike factor inside the spike window, else
    1), so that one program serves every step.  Both train steps apply it."""
    if nf is None:
        return loss, grads

    def where(at, inside):
        hit = (step >= at) & (step < at + nf.steps)
        one = torch.ones((), dtype=torch.float32, device=step.device)
        return torch.where(hit, torch.full_like(one, inside), one)

    if nf.nan_at_step >= 0:
        poison = where(nf.nan_at_step, float("nan"))
        loss, grads = loss * poison, tree_map(lambda g: g * poison, grads)
    if nf.grad_spike_at_step >= 0:
        spike = where(nf.grad_spike_at_step, nf.spike_factor)
        grads = tree_map(lambda g: g * spike, grads)
    return loss, grads


def _compressed(grads, ef):
    """The bf16 gradient exchange with float32 error feedback, in the
    reference's order: add the feedback, round to bf16, keep the residual,
    widen for the optimizer.  Returns (grads, new ef)."""
    grads = tree_map(torch.add, grads, ef)
    q = tree_map(lambda g: g.to(torch.bfloat16), grads)
    new_ef = tree_map(lambda g, qq: g - qq.float(), grads, q)
    return tree_map(lambda qq: qq.float(), q), new_ef


def partitioned_train_step(cfg: ModelConfig, st: Strategy, opt: Optimizer, tc: TrainConfig,
                           mesh, plan_profile=None, optimize: bool = True, trace=None):
    """The train step as one SPMD program on ``mesh`` (the simulated mesh
    of ``core/mesh_runtime.py``), through the port's partitioner.

    The program takes (params, opt_state, step, batch[, ef]) at global
    shapes, annotates them at entry (params and the error feedback ``ef`` by
    ``tree_specs``, the state by ``opt_state_specs``, tokens and labels on
    ("data",), as the reference's ``launch/elastic.py::state_partition_specs``
    places them), takes the loss's gradient with autograd inside the
    program (attention's through the flash operators, the SSD's through
    ``repro_torch::ssd_scan`` and its gradient operator; remat per
    ``cfg.remat``, its recompute captured in the graph), applies the fault
    window (``_with_faults``: data, not a branch) and the bf16 exchange
    (``_compressed``) where ``tc`` asks for them, applies ``opt.apply`` and,
    with ``tc.guard``, the sentinel and the keep of the old state on a
    fault; it returns (params', opt_state', loss, grad_norm[, ef'][, guard,
    fault]).  ``spmd_partition`` captures, completes and plans it on the
    first call, on the device the params are on, verified and (unless
    ``optimize=False``) optimized, priced by ``plan_profile`` as
    ``spmd_partition`` resolves it; every later call runs the plan, traced
    when ``trace`` (an ``obs.trace.TraceConfig``) asks.  The step writes
    the results into ``state``'s tensors.  The runner is
    ``step.runner``."""
    from ..core.partitioner import spmd_partition

    with set_mesh(mesh):
        decls = api.param_tree(cfg, st)
    pspecs = tree_specs(decls)
    ospecs = opt_state_specs(opt, pspecs, tree_shapes(decls, cfg.param_dtype))

    grad_program = sharded_value_and_grad(cfg, st, mesh, tc.grad_accum)
    gc = tc.guard

    def program(params, opt_state, step, batch, *ef):
        opt_state = tree_map(lambda t, spec: annotate_spec(t, spec, mesh), opt_state, ospecs)
        loss, grads = grad_program(params, batch)
        with torch.no_grad():
            loss, grads = _with_faults(tc.numeric_fault, step, loss, grads)
            new_ef = ()
            if ef:
                fed = tree_map(lambda t, spec: annotate_spec(t, spec, mesh), ef[0], pspecs)
                grads, fed = _compressed(grads, fed)
                new_ef = (fed,)
            new_params, new_opt = opt.apply(grads, opt_state, params, step)
            gnorm = torch.sqrt(_grad_norm(grads, loss.device))
            guard = ()
            if gc is not None:
                g = _guarded(gc, loss, grads, new_opt, gnorm)
                keep = _keep(g["fault"])
                new_params = tree_map(keep, params, new_params)
                new_opt = tree_map(keep, opt_state, new_opt)
                if ef:
                    new_ef = (tree_map(keep, ef[0], new_ef[0]),)
                guard = (g["guard"], g["fault"])
        return (new_params, new_opt, loss, gnorm) + new_ef + guard

    runners = {}

    def step_fn(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        dev = leaves(params)[0].device
        runner = runners.get(dev)
        if runner is None:
            runner = runners[dev] = spmd_partition(program, mesh, optimize=optimize,
                                                   verify=True, profile=plan_profile,
                                                   trace=trace, device=str(dev))
            step_fn.runner = runner
        ef = (state["ef"],) if tc.compress_grads else ()
        with torch.no_grad():
            new_params, new_opt, loss, gnorm, *rest = runner(
                tree_map(torch.Tensor.detach, params), opt_state,
                torch.tensor(step, dtype=torch.int64), batch, *ef)
            tree_map(lambda p, n: p.copy_(n), params, new_params)
            tree_map(lambda s, n: s.copy_(n), opt_state, new_opt)
            if ef:
                tree_map(lambda s, n: s.copy_(n), state["ef"], rest[0])
        state["step"] = step + 1
        metrics = {"loss": loss, "grad_norm": gnorm}
        if gc is not None:
            metrics["guard"], metrics["fault"] = rest[-2:]
        return state, metrics

    step_fn.runner = None
    return step_fn


def init_state(cfg: ModelConfig, st: Strategy, opt: Optimizer, tc: TrainConfig,
               gen: torch.Generator, device) -> Dict[str, Any]:
    """Float32 master weights (``cfg.param_dtype``) from ``gen`` on
    ``device``, the optimizer's state and the step counter."""
    _require_trainable(cfg, tc)
    params = tree_init(api.param_tree(cfg, st), gen, dtype=cfg.param_dtype, device=device)
    for p in leaves(params):
        p.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params), "step": 0}
    if tc.compress_grads:
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
    return state


def checkpoint_specs(cfg: ModelConfig, st: Strategy, opt: Optimizer, tc: TrainConfig, state,
                     mesh) -> Dict[str, Any]:
    """Each leaf's ``Sharding`` on ``mesh`` by checkpoint key: the state's
    partition specs (``launch/elastic.py::state_partition_specs``) projected
    onto the mesh, the layout ``partitioned_train_step`` annotates the state
    with at entry.  ``state``'s leaves may be meta tensors: only their
    shapes are read."""
    from ..core.sharding import project_dims_mapping
    from ..launch.elastic import specs_by_key, state_partition_specs

    by_key = specs_by_key(state_partition_specs(cfg, st, opt, tc))
    out = {}
    for key, leaf in ckpt_lib._flatten_with_paths(state):
        shape = tuple(getattr(leaf, "shape", ()))
        out[key] = project_dims_mapping(
            mesh, ckpt_lib._dims_mapping(by_key.get(key, ()), len(shape)), shape)
    return out


class TrainLoop:
    """Drives training with checkpoint/restart, a straggler watchdog and the
    numerics guards' skip and escalation.  ``step_times`` (seconds) and
    ``tokens_per_s`` hold each finished step's wall time (host clock around
    the step, ending when its loss reaches the host) and throughput;
    ``guard_counters`` (faults, skips, rewinds; restored from a checkpoint's
    ``extra``) and ``skipped_steps`` what the guards did.  ``plan_profile``
    and ``optimize`` are ``make_train_step``'s (under a mesh only).  A
    ``ckpt_extra`` hook's dict merges into every manifest's ``extra``."""

    def __init__(self, cfg, st, opt, tc: TrainConfig, pipeline, gen=None, step_fn=None,
                 hooks=None, device="cuda", plan_profile=None, optimize: bool = True):
        self.cfg, self.st, self.opt, self.tc = cfg, st, opt, tc
        self.pipeline = pipeline
        self.hooks = hooks or {}
        self.device = resolve_device(device)
        self.plan_profile, self.optimize = plan_profile, optimize
        self.step_fn = step_fn or make_train_step(cfg, st, opt, tc, plan_profile=plan_profile,
                                                  optimize=optimize)
        self.gen = gen if gen is not None else torch.Generator(self.device).manual_seed(0)
        self.step_times = []
        self.tokens_per_s = []
        self.guard_counters = {"faults": 0, "skips": 0, "rewinds": 0}
        self.skipped_steps: list = []
        self.guard_leaves: Optional[tuple] = None
        self._consecutive_faults = 0

    def swap_plan(self, step_fn) -> None:
        """Replace the step function without restarting the process (the
        elastic coordinator's, after a mesh change or a rewind)."""
        self.step_fn = step_fn
        self.step_times = []  # old timings are not comparable post-reshard

    def _ckpt_extra(self, step: int) -> Dict[str, Any]:
        """Manifest ``extra``: the data cursor (next batch index) is the
        resume point, so a restart replays nothing and skips nothing; the
        guard counters ride along, and a ``ckpt_extra`` hook merges its
        dict in."""
        extra = {"data_cursor": step + 1}
        if self.tc.guard is not None:
            extra["guard"] = dict(self.guard_counters)
        if "ckpt_extra" in self.hooks:
            extra.update(self.hooks["ckpt_extra"]() or {})
        return extra

    def _save(self, save_step: int, state, cursor_step: int, prune: bool = True) -> None:
        """One checkpoint save with a ``ckpt_save`` control event (so that a
        trace shows the restore points beside the faults), then the
        retention pass (keep the newest ``keep_ckpts``) unless ``prune`` is
        off."""
        mesh = get_abstract_mesh()
        specs = None if mesh is None else checkpoint_specs(self.cfg, self.st, self.opt, self.tc,
                                                           state, mesh)
        ckpt_lib.save(self.tc.ckpt_dir, save_step, state, extra=self._ckpt_extra(cursor_step),
                      specs=specs)
        control_event("ckpt_save", step=save_step, data_cursor=cursor_step + 1)
        if prune:
            ckpt_lib.cleanup(self.tc.ckpt_dir, self.tc.keep_ckpts)

    def _restore_or_init(self):
        """``(state, start_step)``: a fresh state, or the newest checkpoint
        in ``ckpt_dir`` restored onto it (params marked for autograd again,
        as ``init_state`` marks them), with the start taken from the
        manifest's data cursor and the guard counters from its ``extra``."""
        state = init_state(self.cfg, self.st, self.opt, self.tc, self.gen, self.device)
        start = 0
        if self.tc.ckpt_dir:
            last = ckpt_lib.latest_step(self.tc.ckpt_dir)
            if last is not None:
                state, manifest = ckpt_lib.restore(self.tc.ckpt_dir, state, last,
                                                   device=self.device)
                for p in leaves(state["params"]):
                    p.requires_grad_(True)
                extra = manifest.get("extra", {})
                start = int(extra.get("data_cursor", manifest["step"]))
                saved = extra.get("guard")
                if saved:
                    self.guard_counters.update({k: int(v) for k, v in saved.items()})
                if "log" in self.hooks:
                    self.hooks["log"](f"restored checkpoint step={last} cursor={start}")
        return state, start

    def run(self, initial_state=None, start_step: Optional[int] = None):
        """Train until ``tc.steps``.  ``initial_state``/``start_step`` resume
        mid-process (skipping the checkpoint restore); otherwise the newest
        checkpoint in ``tc.ckpt_dir``, if any, is restored."""
        if initial_state is not None:
            state = initial_state
            start = start_step if start_step is not None else int(state["step"])
        else:
            state, start = self._restore_or_init()
            if start_step is not None:
                start = start_step
        tokens = self.pipeline.local_batch * self.pipeline.cfg.seq_len
        losses = []
        for step in range(start, self.tc.steps):
            if step == self.tc.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, torch.long)
                     for k, v in self.pipeline.batch_at(step).items()}
            t0 = time.perf_counter()
            if "fault" in self.hooks:
                # sits after t0 so an injected stall lands in the measured dt
                self.hooks["fault"](step)
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            obs_metrics.observe("train.step_ms", dt * 1e3)
            if tokens and dt > 0:
                obs_metrics.observe("train.tokens_per_s", tokens / dt)
            gc = self.tc.guard
            if gc is not None and bool(metrics["fault"]):
                # the step already kept the old state; decode the leaves,
                # count, and escalate after K consecutive faults
                self._on_fault(gc, step, state, metrics)
                if self.tc.ckpt_dir and (step + 1) % self.tc.ckpt_every == 0:
                    self._save(step + 1, state, step)
                continue
            self._consecutive_faults = 0
            self.step_times.append(dt)
            self.tokens_per_s.append(tokens / dt)
            losses.append(loss)
            if "metrics" in self.hooks:
                self.hooks["metrics"](step, loss)
            if len(self.step_times) >= 8:
                med = float(np.median(self.step_times[-32:]))
                if dt > self.tc.straggler_factor * med:
                    control_event("straggler", step=step, dt_ms=dt * 1e3, median_ms=med * 1e3)
                    if "straggler" in self.hooks:
                        self.hooks["straggler"](step, dt, med)
            if self.tc.ckpt_dir and (step + 1) % self.tc.ckpt_every == 0:
                self._save(step + 1, state, step)
            if "log" in self.hooks and step % self.tc.log_every == 0:
                self.hooks["log"](f"step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        if self.tc.ckpt_dir:
            self._save(self.tc.steps, state, self.tc.steps - 1, prune=False)
        return state, losses

    def _on_fault(self, gc: GuardConfig, step: int, state, metrics) -> None:
        """Host side of a faulted step: per-leaf provenance, counters, the
        ``numerics_fault`` hook, and ``NumericsFault`` once ``rewind_after``
        consecutive steps faulted (``launch/elastic.py::ElasticCoordinator``
        rewinds to a checkpoint)."""
        if self.guard_leaves is None:
            self.guard_leaves = guard_leaf_names(gc, state)
        faults = guard_faults(gc, metrics["guard"].cpu().numpy(), self.guard_leaves)
        if not faults:  # a norm-only trip (grad_norm > max_grad_norm)
            faults = ({"leaf": "grad_norm", "kind": "norm",
                       "value": float(metrics["grad_norm"])},)
        self.guard_counters["faults"] += 1
        self._consecutive_faults += 1
        obs_metrics.inc("train.guard.faults")
        control_event("numerics_fault", step=step, consecutive=self._consecutive_faults,
                      leaves=[f["leaf"] for f in faults[:4]])
        if "numerics_fault" in self.hooks:
            self.hooks["numerics_fault"](step, faults, self._consecutive_faults)
        if self._consecutive_faults >= gc.rewind_after:
            raise NumericsFault(step, faults, self._consecutive_faults)
        self.guard_counters["skips"] += 1
        self.skipped_steps.append(step)
        obs_metrics.inc("train.guard.skips")
        control_event("skip_step", step=step)
        if "log" in self.hooks:
            self.hooks["log"](f"step {step} numerics fault -> skipped "
                              f"({self._consecutive_faults} consecutive): "
                              + ", ".join(f"{f['leaf']}[{f['kind']}]" for f in faults[:4]))
