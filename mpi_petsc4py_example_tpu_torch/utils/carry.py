"""Carry a problem from the JAX package into the port as plain values.

This system runs no model, so its "weights" are the problem data: the
operator's geometry and the right-hand side (and initial guess). The JAX side
hands them over as plain values, never as JAX objects:

* the geometry is the tuple ``StencilPoisson3D.program_key()`` returns,
  ``("stencil3d", nx, ny, nz, ndev)``;
* the vectors are numpy arrays from ``Vec.to_numpy()``;
* the preconditioner's configuration is the tuple ``PC.program_key()``
  returns, ``(type,)`` or ``("mg", smoother)``.

The grid is parametric, so the port's communicator may have another shard
count than the JAX mesh had (``ndev``), as long as it divides ``nz``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vec import Vec
from ..models.stencil import StencilPoisson3D
from ..parallel.mesh import DeviceComm


def from_numpy_state(comm: DeviceComm, geometry, b, x0=None,
                     dtype=torch.float64):
    """Build the port's ``(StencilPoisson3D, b Vec, x Vec)`` for the problem
    the JAX side described; ``x`` is ``x0`` or zeros."""
    kind, nx, ny, nz, _ndev = geometry
    if kind != "stencil3d":
        raise ValueError(f"cannot carry operator kind {kind!r}; only "
                         "'stencil3d' is ported")
    op = StencilPoisson3D(comm, int(nx), int(ny), int(nz), dtype=dtype)
    n = op.shape[0]
    b = np.asarray(b)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    bv = Vec.from_global(comm, b, dtype=dtype, layout=op.layout)
    if x0 is None:
        xv = op.get_vecs()[0]
    else:
        x0 = np.asarray(x0)
        if x0.shape != (n,):
            raise ValueError(f"x0 must have shape ({n},), got {x0.shape}")
        xv = Vec.from_global(comm, x0, dtype=dtype, layout=op.layout)
    return op, bv, xv


def configure_pc(pc, key):
    """Set the port's ``pc`` to the configuration the JAX side's
    ``PC.program_key()`` describes: ``(type,)``, or ``("mg", smoother)``
    for the V-cycle with its smoother. Returns ``pc``."""
    kind = str(key[0])
    pc.set_type(kind)
    if kind == "mg":
        if len(key) != 2:
            raise ValueError(f"an mg configuration is ('mg', smoother), "
                             f"got {key!r}")
        pc.mg_smoother = str(key[1])
    elif len(key) != 1:
        raise ValueError(f"cannot carry PC configuration {key!r}")
    return pc
