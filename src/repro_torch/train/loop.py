"""Training loop: step builder, gradient accumulation, gradient compression,
numeric-fault injection and a straggler watchdog (port of the JAX package's
``train/loop.py``).

``make_train_step`` builds the step:
  loss (compute dtype) -> gradients of the float32 master weights ->
  [bf16 exchange + float32 error feedback] -> optimizer update.
PyTorch runs it eagerly; the update lands in place (the reference donates
its state to ``jit``).  Gradient accumulation loops over microbatches and
sums their gradients in float32; remat is the model config's
(``models/layers.py::stack_layers``).  ``TrainLoop.run`` records per-step
wall times and tokens per second and flags straggler steps (> k x median)
through a hook.

Under an ambient mesh (``core.compat.set_mesh``) ``make_train_step``
builds the step as one partitioned program instead
(``partitioned_train_step``): the functional step ``(params, opt_state,
step, batch) -> (params', opt_state', loss, grad_norm)``, its inputs
annotated at entry (params by their declared specs, the optimizer state by
``opt_state_specs``, the batch on "data") and the gradient taken inside it,
runs through ``spmd_partition(..., optimize=False)``: capture, completion
and the plan on the first call, the plan alone on every later one.  The
step writes the results back into the state's tensors, so callers see the
same in-place contract.

Not ported yet, and refused where asked for: numerics guards
(``TrainConfig.guard``: ``core/plan.py``'s GuardConfig and the skip/rewind
epilogue, ROADMAP A9), checkpoint/restart (``TrainConfig.ckpt_dir``:
``train/checkpoint.py``, ROADMAP A14) and the ``obs`` metrics and control
events (ROADMAP A15).  The dense family trains; Mamba2's waits for a
backward of the SSD kernel (ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, Strategy
from ..core.compat import get_abstract_mesh
from ..core.device import resolve_device
from ..core.tree import leaves, leaves_with_paths, tree_from_paths, tree_map
from ..models import api
from ..models.layers import annotate_spec, annotate_tree, tree_init, tree_shapes, tree_specs
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
    guard: Optional[Any] = None  # numerics sentinels (ROADMAP A9)
    numeric_fault: Optional[NumericFaultSpec] = None


def _require_trainable(cfg: ModelConfig, tc: TrainConfig):
    if tc.guard is not None:
        raise NotImplementedError(
            "TrainConfig.guard needs core/plan.py's GuardConfig and the skip/rewind "
            "epilogue, which are not ported yet (ROADMAP A9)")
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: training the {cfg.family!r} family needs a backward of its "
            "kernel, which is not ported yet (ROADMAP A8)")


def value_and_grad(cfg: ModelConfig, st: Strategy, params, batch, grad_accum: int = 1):
    """(loss, grads) of ``api.loss_fn``: with ``grad_accum`` > 1 the batch is
    split into that many microbatches along its first dim, whose losses and
    float32 gradients are summed in order and divided by their count."""
    pairs = leaves_with_paths(params)
    flat = [leaf for _, leaf in pairs]

    def one(mb):
        loss = api.loss_fn(cfg, st, params, mb)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(flat, grads)]

    if grad_accum <= 1:
        loss, grads = one(batch)
    else:
        B = batch["tokens"].shape[0]
        if B % grad_accum:
            raise ValueError(f"batch {B} is not a multiple of grad_accum {grad_accum}")
        mbs = {k: v.reshape((grad_accum, B // grad_accum) + v.shape[1:]) for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=flat[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in flat]
        for i in range(grad_accum):
            l, g = one({k: v[i] for k, v in mbs.items()})
            loss = loss + l
            grads = [a + b for a, b in zip(grads, g)]
        inv = 1.0 / grad_accum
        loss, grads = loss * inv, [g * inv for g in grads]
    return loss, tree_from_paths((path, g) for (path, _), g in zip(pairs, grads))


def _in_window(step: int, at: int, width: int) -> bool:
    return at <= step < at + width


def make_train_step(cfg: ModelConfig, st: Strategy, opt: Optimizer, tc: TrainConfig):
    """Returns step(state, batch) -> (state, metrics); state = {"params",
    "opt", "step"[, "ef"]}, updated in place.  Under an ambient mesh, the
    partitioned step (``partitioned_train_step``)."""
    _require_trainable(cfg, tc)
    mesh = get_abstract_mesh()
    if mesh is not None:
        return partitioned_train_step(cfg, st, opt, tc, mesh)

    def step_fn(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        loss, grads = value_and_grad(cfg, st, params, batch, tc.grad_accum)
        nf = tc.numeric_fault
        if nf is not None and nf.nan_at_step >= 0 and _in_window(step, nf.nan_at_step, nf.steps):
            loss = loss * float("nan")
            grads = tree_map(lambda g: g * float("nan"), grads)
        if (nf is not None and nf.grad_spike_at_step >= 0
                and _in_window(step, nf.grad_spike_at_step, nf.steps)):
            grads = tree_map(lambda g: g * nf.spike_factor, grads)
        if tc.compress_grads:
            # half-precision gradient exchange with error feedback: quantize
            # to bf16, remember the residual in float32
            grads = tree_map(torch.add, grads, state["ef"])
            q = tree_map(lambda g: g.to(torch.bfloat16), grads)
            with torch.no_grad():
                tree_map(lambda ef, g, qq: ef.copy_(g - qq.float()), state["ef"], grads, q)
            grads = tree_map(lambda qq: qq.float(), q)
        opt.update(grads, opt_state, params, step)
        gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g in leaves(grads):  # the reference's leaf order
            gnorm = gnorm + g.float().square().sum()
        state["step"] = step + 1
        return state, {"loss": loss, "grad_norm": torch.sqrt(gnorm)}

    return step_fn


def sharded_value_and_grad(cfg: ModelConfig, st: Strategy, mesh):
    """The program ``(params, batch) -> (loss, grads)`` of the partitioned
    step: params annotated at entry by their declared specs filtered to
    ``mesh``, tokens and labels on ("data",), the gradient taken with
    autograd inside the program."""
    decls = api.param_tree(cfg, st)

    def program(params, batch):
        params = annotate_tree(decls, params, mesh)
        batch = {k: annotate_spec(v, ("data",), mesh) for k, v in batch.items()}
        live = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            return value_and_grad(cfg, st, live, batch)

    return program


def _refuse_unpartitioned(cfg: ModelConfig, tc: TrainConfig):
    why = []
    if cfg.remat != "none":
        why.append(f"remat {cfg.remat!r} (torch.utils.checkpoint inside a captured gradient; "
                   "ROADMAP A6, remat under the partitioned step)")
    if tc.grad_accum > 1:
        why.append(f"grad_accum {tc.grad_accum} (its microbatch loop is the scan of ROADMAP A9)")
    if tc.compress_grads:
        why.append("compress_grads (ROADMAP A6, the partitioned step's gradient exchange)")
    if tc.numeric_fault is not None:
        why.append("numeric_fault (ROADMAP A6, the partitioned step's fault window)")
    if why:
        raise NotImplementedError("the partitioned train step does not cover " + "; ".join(why))


def partitioned_train_step(cfg: ModelConfig, st: Strategy, opt: Optimizer, tc: TrainConfig,
                           mesh):
    """The train step as one SPMD program on ``mesh`` (the simulated mesh
    of ``core/mesh_runtime.py``), through the port's partitioner.

    The program takes (params, opt_state, step, batch) at global shapes,
    annotates them at entry (params by ``tree_specs``, the state by
    ``opt_state_specs``, tokens and labels on ("data",), as the reference's
    ``launch/elastic.py::state_partition_specs`` places them), takes the
    loss's gradient with autograd inside the program (attention's through
    the flash operators) and applies ``opt.apply``; it returns (params',
    opt_state', loss, grad_norm).  ``spmd_partition(..., optimize=False)``
    captures, completes and plans it on the first call, on the device the
    params are on; every later call runs the plan.  The step writes the
    results into ``state``'s tensors.  The runner is ``step.runner``."""
    from ..core.partitioner import spmd_partition

    _refuse_unpartitioned(cfg, tc)
    decls = api.param_tree(cfg, st)
    pspecs = tree_specs(decls)
    ospecs = opt_state_specs(opt, pspecs, tree_shapes(decls, cfg.param_dtype))

    grad_program = sharded_value_and_grad(cfg, st, mesh)

    def program(params, opt_state, step, batch):
        opt_state = tree_map(lambda t, spec: annotate_spec(t, spec, mesh), opt_state, ospecs)
        loss, grads = grad_program(params, batch)
        with torch.no_grad():
            new_params, new_opt = opt.apply(grads, opt_state, params, step)
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
            for g in leaves(grads):  # the reference's leaf order
                gnorm = gnorm + g.float().square().sum()
        return new_params, new_opt, loss, torch.sqrt(gnorm)

    runners = {}

    def step_fn(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        dev = leaves(params)[0].device
        runner = runners.get(dev)
        if runner is None:
            runner = runners[dev] = spmd_partition(program, mesh, optimize=False,
                                                   device=str(dev))
            step_fn.runner = runner
        with torch.no_grad():
            new_params, new_opt, loss, gnorm = runner(
                tree_map(torch.Tensor.detach, params), opt_state,
                torch.tensor(step, dtype=torch.int64), batch)
            tree_map(lambda p, n: p.copy_(n), params, new_params)
            tree_map(lambda s, n: s.copy_(n), opt_state, new_opt)
        state["step"] = step + 1
        return state, {"loss": loss, "grad_norm": gnorm}

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


class TrainLoop:
    """Drives training with a straggler watchdog.  ``step_times`` (seconds)
    and ``tokens_per_s`` hold each finished step's wall time (host clock
    around the step, ending when its loss reaches the host) and
    throughput."""

    def __init__(self, cfg, st, opt, tc: TrainConfig, pipeline, gen=None, step_fn=None,
                 hooks=None, device="cuda"):
        if tc.ckpt_dir:
            raise NotImplementedError(
                "TrainConfig.ckpt_dir needs train/checkpoint.py, which is not ported yet "
                "(ROADMAP A14)")
        self.cfg, self.st, self.opt, self.tc = cfg, st, opt, tc
        self.pipeline = pipeline
        self.hooks = hooks or {}
        self.device = resolve_device(device)
        self.step_fn = step_fn or make_train_step(cfg, st, opt, tc)
        self.gen = gen if gen is not None else torch.Generator(self.device).manual_seed(0)
        self.step_times = []
        self.tokens_per_s = []

    def swap_plan(self, step_fn) -> None:
        """Replace the step function without restarting the process (the
        elastic-recovery path after a mesh change)."""
        self.step_fn = step_fn
        self.step_times = []  # old timings are not comparable post-reshard

    def run(self, initial_state=None, start_step: Optional[int] = None):
        """Train until ``tc.steps``.  ``initial_state``/``start_step`` resume
        mid-process."""
        if initial_state is not None:
            state = initial_state
            start = start_step if start_step is not None else int(state["step"])
        else:
            state = init_state(self.cfg, self.st, self.opt, self.tc, self.gen, self.device)
            start = start_step if start_step is not None else 0
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
            self.step_times.append(dt)
            self.tokens_per_s.append(tokens / dt)
            losses.append(loss)
            if "metrics" in self.hooks:
                self.hooks["metrics"](step, loss)
            if len(self.step_times) >= 8:
                med = float(np.median(self.step_times[-32:]))
                if dt > self.tc.straggler_factor * med and "straggler" in self.hooks:
                    self.hooks["straggler"](step, dt, med)
            if "log" in self.hooks and step % self.tc.log_every == 0:
                self.hooks["log"](f"step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
        return state, losses
