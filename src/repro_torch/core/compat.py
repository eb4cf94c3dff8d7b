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
========== ============== =================================================

Tightening a class is always safe; loosening one (or adding an ad-hoc rtol
in a test) needs a comment explaining which new reduction reorder justifies
it.  ``bf16_round`` and ``bf16_chain`` are the port's additions: the JAX
classes were set for one framework against itself, while the port's tests
compare XLA's CPU kernels with PyTorch's on bf16 data, where one-ulp
rounding flips are expected.
"""
from __future__ import annotations

import numpy as np

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
