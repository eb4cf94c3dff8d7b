"""User-facing sharding annotation (paper §3.6, TF's ``XlaSharding`` analogue).

``annotate(x, sharding)`` is semantically an identity whose attribute carries a
``Sharding``.  It is the custom operator ``repro_torch::annotate`` so that:

* it survives capture (``make_fx``) as one node of the aten graph, where the
  propagation pass (propagation.py) reads it as a seed;
* its gradient is the same annotation — the paper defines the gradient of
  XlaSharding to be itself, so backward graphs are annotated automatically;
* its output never aliases its input (it returns a copy), as a functional
  graph requires;
* it vmaps: a batched annotation inserts an unsharded, unspecified dim at
  the vmapped position (what lets the §3.3 pipeline vmap a layer that
  annotates its activations).

A ``Sharding`` cannot be an operator argument, so the node carries the mesh
(shape, device order, and its axis names joined by ",") and the dims mapping
as ``"<rank>:"`` followed by each dim's axes joined by "+", dims separated
by "|"; :func:`decode` turns a node's arguments back into a ``Sharding``.

``unspecified_dims`` implements the paper's *partial specification* (§3.5): those
dims may still be refined by propagation.
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .sharding import Mesh, Sharding, mesh_split


@torch.library.custom_op("repro_torch::annotate", mutates_args=())
def _annotate(x: torch.Tensor, mesh_shape: List[int], axis_names: str,
              devices: List[int], dims_mapping: str,
              unspecified_dims: List[int]) -> torch.Tensor:
    return x.clone()


@_annotate.register_fake
def _(x, mesh_shape, axis_names, devices, dims_mapping, unspecified_dims):
    return torch.empty_like(x)


def _setup(ctx, inputs, output):
    ctx.spec = inputs[1:]


def _backward(ctx, grad):
    return (_annotate(grad, *ctx.spec),) + (None,) * len(ctx.spec)


_annotate.register_autograd(_backward, setup_context=_setup)


def _batch_rule(info, in_dims, x, mesh_shape, axis_names, devices, dims_mapping,
                unspecified_dims):
    """The reference's ``_batch_rule``: a vmapped annotation inserts an
    unsharded dim at the vmapped position and marks it unspecified, so that
    completion may give it the stage axis (the §3.3 pipeline vmaps one
    stage body over the stage dim)."""
    d = in_dims[0]
    if d is None:
        return _annotate(x, mesh_shape, axis_names, devices, dims_mapping,
                         unspecified_dims), None
    rank, entries = dims_mapping.split(":", 1)
    dims = entries.split("|")[: int(rank)] if int(rank) else []
    dims.insert(d, "")
    shifted = [u + 1 if u >= d else u for u in unspecified_dims] + [d]
    return _annotate(x, mesh_shape, axis_names, devices, f"{int(rank) + 1}:" + "|".join(dims),
                     shifted), d


torch.library.register_vmap("repro_torch::annotate", _batch_rule)

# the node target that capture records for an annotation
ANNOTATE_OP = torch.ops.repro_torch.annotate.default


def encode(sharding: Sharding, unspecified_dims: Sequence[int] = ()) -> tuple:
    m = sharding.mesh
    if any(c in a for a in m.axis_names for c in ",+|:"):
        raise ValueError(f"mesh axis names may not hold ',', '+', '|' or ':': {m.axis_names}")
    dims = f"{sharding.rank}:" + "|".join("+".join(axes) for axes in sharding.dims_mapping)
    return ([int(s) for s in m.shape], ",".join(m.axis_names),
            [int(d) for d in m.devices.flat], dims, [int(d) for d in unspecified_dims])


@functools.lru_cache(maxsize=64)
def _mesh(shape: Tuple[int, ...], names: Tuple[str, ...], devices: Tuple[int, ...]) -> Mesh:
    return Mesh(np.array(devices).reshape(shape), names)


def decode(mesh_shape, axis_names, devices, dims_mapping, unspecified_dims
           ) -> Tuple[Sharding, Tuple[int, ...]]:
    mesh = _mesh(tuple(mesh_shape), tuple(axis_names.split(",")), tuple(devices))
    rank, entries = dims_mapping.split(":", 1)
    dm = tuple(tuple(e.split("+")) if e else () for e in entries.split("|"))[: int(rank)]
    return Sharding(mesh, dm), tuple(unspecified_dims)


def annotate(x: torch.Tensor, sharding: Sharding, unspecified_dims: Sequence[int] = ()):
    """Annotate ``x`` with a GSPMD sharding.  Identity on the value."""
    if sharding.rank != x.ndim:
        raise ValueError(f"annotate: {sharding} on a tensor of shape {tuple(x.shape)}")
    return _annotate(x, *encode(sharding, unspecified_dims))


def mesh_split_annotate(x, mesh, dims_mapping, unspecified_dims: Sequence[int] = ()):
    """The paper's ``mesh_split(tensor, device_mesh, dims_mapping)`` applied to a
    live value."""
    return annotate(x, mesh_split(x.ndim, mesh, dims_mapping), unspecified_dims)
