"""Carry a problem from the JAX package into the port as plain values.

This system runs no model, so its "weights" are the problem data: the
operator's geometry and the right-hand side (and initial guess). The JAX side
hands them over as plain values, never as JAX objects:

* a stencil's geometry is the tuple ``StencilPoisson3D.program_key()``
  returns, ``("stencil3d", nx, ny, nz, ndev)``;
* an assembled matrix is its global host CSR triple ``Mat.host_csr`` with
  ``Mat.shape``, as numpy;
* the vectors are numpy arrays from ``Vec.to_numpy()``;
* the preconditioner's configuration is the tuple ``PC.program_key()``
  returns, ``(type,)`` (none, jacobi, bjacobi, sor, ssor, ilu, icc, lu,
  cholesky), ``("asm", overlap)``, ``("mg", smoother)`` or ``("gamg", sizes,
  shapes)``; the tunables that key does not hold (``sor_omega``,
  ``factor_fill``, ``bjacobi_blocks``, ``setup_device``, ``gamg_threshold``,
  ``gamg_coarse_size``, ``gamg_max_levels``) travel as keyword values.

The grid and the CSR do not depend on the shard count, so the port's
communicator may have another shard count than the JAX mesh had (a stencil's
``ndev`` only has to divide ``nz``). On a ``ProcessComm`` every process is
handed the same host arrays and places only its own rows, the JAX ``_put``
model.

A ``dtype`` of ``torch.bfloat16`` builds the port's bfloat16 problem. The JAX
package's bfloat16 arrays (``ml_dtypes``, which the port does not import)
are read through float32, which holds them exactly; fp64 values are rounded
by torch's cast, as ``ml_dtypes`` rounds them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mat import Mat
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
    return (op,) + _vectors(comm, op, b, x0, dtype)


def _host(a) -> np.ndarray:
    """``a`` as a numpy array of a native dtype: an ``ml_dtypes`` array
    (numpy kind 'V') through float32, exactly."""
    a = np.asarray(a)
    return a if a.dtype.kind in "biufc" else a.astype(np.float32)


def _vectors(comm, op, b, x0, dtype):
    n = op.shape[0]
    b = _host(b)
    if b.shape != (n,):
        raise ValueError(f"b must have shape ({n},), got {b.shape}")
    bv = Vec.from_global(comm, b, dtype=dtype, layout=op.layout)
    if x0 is None:
        return bv, op.get_vecs()[0]
    x0 = _host(x0)
    if x0.shape != (n,):
        raise ValueError(f"x0 must have shape ({n},), got {x0.shape}")
    return bv, Vec.from_global(comm, x0, dtype=dtype, layout=op.layout)


def from_host_csr(comm: DeviceComm, shape, csr, b, x0=None,
                  dtype=torch.float64):
    """Build the port's ``(Mat, b Vec, x Vec)`` for an assembled problem the
    JAX side described by ``Mat.shape`` and ``Mat.host_csr``
    ``(indptr, indices, data)``; ``x`` is ``x0`` or zeros."""
    indptr, indices, data = (_host(a) for a in csr)
    mat = Mat.from_csr(comm, tuple(int(s) for s in shape),
                       (indptr, indices, data), dtype=dtype)
    return (mat,) + _vectors(comm, mat, b, x0, dtype)


def configure_pc(pc, key, **tunables):
    """Set the port's ``pc`` to the configuration the JAX side's
    ``PC.program_key()`` describes, with ``tunables`` (any of
    ``sor_omega``, ``factor_fill``, ``bjacobi_blocks``, ``setup_device``,
    and gamg's ``gamg_threshold``, ``gamg_coarse_size``,
    ``gamg_max_levels``) set on it. A gamg key, ``("gamg", sizes,
    shapes)``, describes the hierarchy its set-up builds; the tunables
    decide that hierarchy, so a gamg PC set up on the same operator gives
    the same key. Returns ``pc``."""
    kind = str(key[0])
    pc.set_type(kind)
    if kind == "gamg":
        if len(key) != 3:
            raise ValueError(f"a gamg configuration is ('gamg', sizes, "
                             f"shapes), got {key!r}")
    elif kind in ("mg", "asm"):
        if len(key) != 2:
            raise ValueError(f"an {kind} configuration is ({kind!r}, value), "
                             f"got {key!r}")
        if kind == "mg":
            pc.mg_smoother = str(key[1])
        else:
            pc.asm_overlap = int(key[1])
    elif len(key) != 1:
        raise ValueError(f"cannot carry PC configuration {key!r}")
    for name, value in tunables.items():
        if name not in _TUNABLES:
            raise ValueError(f"cannot carry PC tunable {name!r}; carried: "
                             f"{_TUNABLES}")
        setattr(pc, name, value)
    return pc


_TUNABLES = ("sor_omega", "factor_fill", "bjacobi_blocks", "setup_device",
             "gamg_threshold", "gamg_coarse_size", "gamg_max_levels")
