"""The repo-wide numeric tolerance policy (a copy of the JAX package's
``repro.core.compat.TOLERANCES``, plus the classes the port's comparisons need).

Tests name a comparison class instead of hand-picking an rtol:

========== ============== =================================================
kind        rtol / atol    when
========== ============== =================================================
exact       0 / 0          same reduction order — must be bit-identical
f32         1e-6 / 1e-6    elementwise or unsharded-contraction f32: no
                           reduction reorder, only fusion differences
f32_dot     1e-5 / 1e-5    one contraction whose reduction order differs
ulp         2e-5 / 1e-8    gradients through sharded einsums
f32_chain   1e-4 / 1e-5    multi-op chains (MLP towers, layer stacks):
                           reorders compound per layer
coarse      1e-3 / 1e-3    bf16-compute paths or deep mixed chains
loss_curve  5e-2 / 0       training-loss trajectories across recoveries
bf16_round  2e-2 / 2e-2    bf16 values that may differ by one rounding of
                           the working dtype (2^-8 relative) at a few
                           points: another framework's matmul or
                           elementwise kernels land on the other side of a
                           bf16 rounding boundary, and the flipped ulp
                           propagates a short way
bf16_chain  2e-2 / 8e-2    bf16 logits of a whole layer stack: XLA compiles
                           the stack as one program and rounds some
                           intermediates differently from PyTorch's
                           op-by-op kernels; the flipped ulps grow through
                           the layers and the unembedding, to about two
                           ulps (2^-5 each) at logits of magnitude 4 to 8
bf16_grad   5e-2 / 0       float32 gradients of a bf16 layer stack, in norm
                           per leaf, between rounding schedules: the flash
                           backward's formulas round P and dS to bf16
                           (``flash_attention_bwd_ref``, as the kernel),
                           and a partitioned product rounds each device's
                           partial sum to bf16 before the psum (as XLA's
                           SPMD partitioner does); a few ulps (2^-8 each)
========== ============== =================================================

Tightening a class is always safe; loosening one (or adding an ad-hoc rtol
in a test) needs a comment explaining which new reduction reorder justifies
it.  ``bf16_round`` and ``bf16_chain`` are the port's additions: the JAX
classes were set for one framework against itself, while the port's tests
compare XLA's CPU kernels with PyTorch's on bf16 data, where one-ulp
rounding flips are expected.  ``bf16_grad`` is the port's too: the
partitioned training step's bf16 gradients, each leaf held in norm (its
atol is 0), and the first update those gradients make, held in norm over
all its leaves of two or more dims joined.  Each psum over "data" of the
CPU test config's bf16 gradient program, dropped alone, puts the loss or
a gradient leaf outside its limit
(``tests/test_torch_sharded_train.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib

import numpy as np
import torch
from torch.utils._pytree import tree_unflatten

# kind -> (rtol, atol); see module docstring for the policy table
TOLERANCES = {
    "exact": (0.0, 0.0),
    "f32": (1e-6, 1e-6),
    "f32_dot": (1e-5, 1e-5),
    "ulp": (2e-5, 1e-8),
    "f32_chain": (1e-4, 1e-5),
    "coarse": (1e-3, 1e-3),
    "loss_curve": (5e-2, 0.0),
    "bf16_round": (2e-2, 2e-2),
    "bf16_chain": (2e-2, 8e-2),
    "bf16_grad": (5e-2, 0.0),
}


def assert_close(got, want, kind: str = "f32", **kwargs):
    """``np.testing.assert_allclose`` under the named tolerance class.

    Arrays are compared in float32.  Extra kwargs pass through
    (``err_msg``, ...); overriding ``rtol``/``atol`` directly is
    deliberately not supported — change the class or the policy.
    """
    if kind not in TOLERANCES:
        raise KeyError(
            f"unknown tolerance class {kind!r}; one of {sorted(TOLERANCES)}")
    if "rtol" in kwargs or "atol" in kwargs:
        raise TypeError("assert_close takes a tolerance class, not rtol/atol")
    rtol, atol = TOLERANCES[kind]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=rtol, atol=atol, **kwargs)


def _f32(x):
    if hasattr(x, "detach"):  # torch tensor: numpy has no bfloat16
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------------
# The ambient mesh: the counterpart of ``jax.set_mesh`` / ``get_abstract_mesh``
# ---------------------------------------------------------------------------------
#
# ``Strategy`` (``configs/base.py``) reads it: under ``set_mesh(mesh)`` its
# specs drop the axes the mesh lacks, ``constrain`` annotates and
# ``axis_size`` multiplies the mesh's axis sizes.  With no mesh all three
# behave as the unsharded program needs.

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` (a ``core.sharding.Mesh``) the ambient mesh inside the
    block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def get_abstract_mesh():
    """The ambient mesh, or None outside ``set_mesh``."""
    return _MESH.get()


# ---------------------------------------------------------------------------------
# Capture: the counterpart of ``jax.make_jaxpr``
# ---------------------------------------------------------------------------------
#
# ``make_fx`` records the function as an aten graph: placeholders
# are its invars, the output node's (flattened) arguments its outvars, tensor
# constants ``get_attr`` nodes, and Python scalars in node arguments its
# Literals.  Tracing runs on fake tensors, so capture costs no device work.
# An in-place operator is refused: the graph must be functional, as a jaxpr
# is.  A gradient taken inside the program (``torch.autograd.grad``) is
# recorded with it; the model's backward is out of place, since attention
# under capture is the flash operator pair, whose gradient is an operator
# too (``kernels/ops.py``).


class Captured:
    """A captured program: the graph, its invars and outvars, and the pytree
    structure of its outputs."""

    def __init__(self, gm: torch.fx.GraphModule):
        self.gm = gm
        self.graph = gm.graph
        for n in self.graph.nodes:
            schema = getattr(n.target, "_schema", None)
            if n.op == "call_function" and schema is not None and schema.is_mutable:
                raise NotImplementedError(
                    f"capture: {n.target} writes into its operand; the partitioner takes "
                    "functional programs (a jaxpr has no mutation): write it out of place")
        self.invars = [n for n in self.graph.nodes if n.op == "placeholder"]
        out = next(n for n in self.graph.nodes if n.op == "output")
        outs = out.args[0]
        info = getattr(self.graph._codegen, "pytree_info", None)
        self.out_spec = info.out_spec if info is not None else None
        if self.out_spec is None and not isinstance(outs, (list, tuple)):
            outs = [outs]
            self.single = True
        else:
            self.single = False
        self.outvars = list(outs)

    def constant(self, node):
        """The tensor a ``get_attr`` node holds."""
        obj = self.gm
        for part in node.target.split("."):
            obj = getattr(obj, part)
        return obj

    def unflatten(self, outs):
        if self.out_spec is not None:
            return tree_unflatten(list(outs), self.out_spec)
        return outs[0] if self.single else tuple(outs)

    def digest(self) -> str:
        """Content digest: the graph's code, its outputs' structure and its
        constants' bytes (the counterpart of hashing the jaxpr and its
        consts)."""
        h = hashlib.sha256(self.gm.code.encode())
        h.update(str(self.out_spec).encode())  # the outputs' structure
        for n in self.graph.nodes:
            if n.op == "get_attr":
                c = self.constant(n).detach().cpu().contiguous()
                h.update(f"{n.target}:{c.dtype}:{tuple(c.shape)}".encode())
                h.update(c.view(-1).view(torch.uint8).numpy().tobytes())
        return h.hexdigest()


def capture(fn, *args) -> Captured:
    """Record ``fn(*args)`` as an aten graph (``make_fx`` on fake tensors)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    return Captured(make_fx(fn, tracing_mode="fake")(*args))
