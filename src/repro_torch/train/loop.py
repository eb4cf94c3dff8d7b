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
events (ROADMAP A15).  The dense family and Mamba2 train (attention's and
the SSD's gradients are kernels on the card: ``kernels/ops.py``); the
families with no model yet raise (ROADMAP A12).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig, Strategy
from ..core.compat import get_abstract_mesh, set_mesh
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
    api.family_module(cfg)  # the families with no model yet raise, naming their item


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
        loss, grads = _with_faults(tc.numeric_fault, torch.tensor(step, device=loss.device),
                                   loss, grads)
        if tc.compress_grads:
            grads, new_ef = _compressed(grads, state["ef"])
            with torch.no_grad():
                tree_map(torch.Tensor.copy_, state["ef"], new_ef)
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
    autograd inside the program.  The program sets ``mesh`` as the ambient
    mesh while it runs, so that the model's own annotations
    (``Strategy.constrain``) apply wherever the step is called from."""
    with set_mesh(mesh):
        decls = api.param_tree(cfg, st)

    def program(params, batch):
        with set_mesh(mesh):
            params = annotate_tree(decls, params, mesh)
            batch = {k: annotate_spec(v, ("data",), mesh) for k, v in batch.items()}
            live = tree_map(lambda p: p.detach().requires_grad_(), params)
            with torch.enable_grad():
                return value_and_grad(cfg, st, live, batch)

    return program


def _refuse_unpartitioned(cfg: ModelConfig, tc: TrainConfig):
    if tc.grad_accum > 1:
        raise NotImplementedError(
            f"the partitioned train step does not cover grad_accum {tc.grad_accum} (its "
            "microbatch loop is the scan of ROADMAP A9)")


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
                           mesh):
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
    (``_compressed``) where ``tc`` asks for them, and applies
    ``opt.apply``; it returns (params', opt_state', loss, grad_norm[,
    ef']).  ``spmd_partition(..., optimize=False)`` captures, completes and
    plans it on the first call, on the device the params are on; every
    later call runs the plan.  The step writes the results into
    ``state``'s tensors.  The runner is ``step.runner``."""
    from ..core.partitioner import spmd_partition

    _refuse_unpartitioned(cfg, tc)
    with set_mesh(mesh):
        decls = api.param_tree(cfg, st)
    pspecs = tree_specs(decls)
    ospecs = opt_state_specs(opt, pspecs, tree_shapes(decls, cfg.param_dtype))

    grad_program = sharded_value_and_grad(cfg, st, mesh)

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
            gnorm = torch.zeros((), dtype=torch.float32, device=loss.device)
            for g in leaves(grads):  # the reference's leaf order
                gnorm = gnorm + g.float().square().sum()
        return (new_params, new_opt, loss, torch.sqrt(gnorm)) + new_ef

    runners = {}

    def step_fn(state, batch):
        params, opt_state, step = state["params"], state["opt"], state["step"]
        dev = leaves(params)[0].device
        runner = runners.get(dev)
        if runner is None:
            runner = runners[dev] = spmd_partition(program, mesh, optimize=False,
                                                   device=str(dev))
            step_fn.runner = runner
        ef = (state["ef"],) if tc.compress_grads else ()
        with torch.no_grad():
            new_params, new_opt, loss, gnorm, *new_ef = runner(
                tree_map(torch.Tensor.detach, params), opt_state,
                torch.tensor(step, dtype=torch.int64), batch, *ef)
            tree_map(lambda p, n: p.copy_(n), params, new_params)
            tree_map(lambda s, n: s.copy_(n), opt_state, new_opt)
            if ef:
                tree_map(lambda s, n: s.copy_(n), state["ef"], new_ef[0])
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
