"""Algorithm-based fault tolerance (ABFT) for the operator and PC applies.

The port's counterpart of ``mpi_petsc4py_example_tpu/resilience/abft.py``.
Silent data corruption (a flipped bit in an SpMV result, a corrupted
reduction, a mis-scaled preconditioner apply) produces no crash and no NaN;
the guarded loops (``solvers/cg_plans.py``) catch it with:

* the column checksum ``c = A^T 1``, computed once on the host, independent
  of the device apply: ``<1, A x> = <c, x>`` verifies every apply, its two
  sides summed into the reduction the loop already makes;
* the PC checksum ``c_M = M^T 1`` for the kinds whose operator form is known
  at set-up (none, jacobi; :func:`pc_checksum` returns None otherwise);
* a dtype-aware threshold: the detector fires on
  ``|<1, y> - <c, x>| > tol * eps * (sum|y| + sum|c x|)``, ``tol`` being
  ``-ksp_abft_tol`` (default 256) and ``eps`` the storage dtype's.

This module also applies the silent fault kinds of ``resilience/faults.py``
(``bitflip``, ``scale``) to a site's output: :func:`apply_silent_fault`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.dtypes import is_low_precision, real_eps

#: default ``-ksp_abft_tol`` multiplier: threshold = tol * eps * scale
DEFAULT_ABFT_TOL = 256.0

# the exponent bit a bitflip toggles, by element width (JAX ``abft.py:48``)
_FLIP = {2: (torch.int16, 1 << 13), 4: (torch.int32, 1 << 29),
         8: (torch.int64, 1 << 61)}


def _bitflip(y: torch.Tensor) -> torch.Tensor:
    """Flip a high exponent bit of element 0 of every shard's block of the
    shard-stacked ``y`` (the JAX package flips element 0 of each device's
    local output). A zero word becomes 1.0, as in JAX (the flip of 0.0 is a
    denormal, and the init residual's ``A x0`` of a zero guess is all
    zeros); complex elements become ``-3 y`` (1.0 for a zero)."""
    out = y.clone(memory_format=torch.contiguous_format)
    flat = out.view(out.shape[0], -1)
    v = flat[:, 0].clone()
    if v.is_complex():
        hit = torch.where(v == 0, torch.ones_like(v), v * -3.0)
    else:
        idt, bit = _FLIP[v.element_size()]
        flipped = (v.view(idt) ^ bit).view(v.dtype)
        hit = torch.where(v == 0, torch.ones_like(v), flipped)
    flat[:, 0] = hit
    return out


def apply_silent_fault(fault, y: torch.Tensor) -> torch.Tensor:
    """``y`` corrupted by the silent ``fault`` that hit its site (a
    :class:`..resilience.faults.Fault` or None): ``bitflip`` flips one
    exponent bit per shard, ``scale`` multiplies by ``1 + mag``."""
    if fault is None:
        return y
    if fault.kind == "bitflip":
        return _bitflip(y)
    if fault.kind == "scale":
        return y * (1.0 + fault.mag)
    return y


def corrupt_psum(fault, total: torch.Tensor, parts) -> torch.Tensor:
    """The ``comm.psum`` fault at one reduction: ``corrupt`` poisons the sum
    with NaN (JAX ``faulted_psum``); ``drop`` elides the reduction. The
    port's reduced scalars are one value for every shard, so a dropped
    reduction is modelled as every shard keeping the first local shard's
    partial (in JAX each shard keeps its own)."""
    if fault is None:
        return total
    if fault.kind == "drop":
        return parts[0]
    return total * float("nan")


# ---------------------------------------------------------------------------
# column checksums, per operator format
# ---------------------------------------------------------------------------

def column_checksum(operator) -> np.ndarray:
    """The ABFT column checksum ``c = A^T 1`` (global, on the host), cached
    on the operator and keyed by its mutation counter (``Mat._state``).

    Computed from the host CSR when the Mat keeps one, from the fetched ELL
    arrays otherwise, analytically for the matrix-free stencil
    (``column_checksum_host``), never from a device apply."""
    state = getattr(operator, "_state", 0)
    cached = getattr(operator, "_abft_checksum", None)
    if cached is not None and cached[0] == state:
        return cached[1]
    c = _compute_checksum(operator)
    try:
        operator._abft_checksum = (state, c)
    except AttributeError:
        pass
    return c


def _acc_dtype(values, operator) -> np.dtype:
    """The host dtype a checksum accumulates in: the values' own, fp64 for
    sub-32-bit storage (whose host CSR the port keeps as fp32; the finished
    sum is rounded to storage once)."""
    if is_low_precision(operator.dtype):
        return np.dtype(np.float64)
    return np.asarray(values).dtype


def _compute_checksum(operator) -> np.ndarray:
    own = getattr(operator, "column_checksum_host", None)
    if own is not None:
        return np.asarray(own())
    n = operator.shape[1]
    host_csr = getattr(operator, "host_csr", None)
    if host_csr is not None:
        _indptr, indices, data = host_csr
        c = np.zeros(n, dtype=_acc_dtype(data, operator))
        np.add.at(c, np.asarray(indices),
                  np.asarray(data).astype(c.dtype, copy=False))
        return c
    cols = operator.comm.host_fetch(operator.ell_cols)[: operator.shape[0]]
    vals = operator.comm.host_fetch(operator.ell_vals)[: operator.shape[0]]
    c = np.zeros(n, dtype=_acc_dtype(vals, operator))
    # padding slots are (col 0, val 0.0): they add exactly zero
    np.add.at(c, cols.ravel(), vals.ravel().astype(c.dtype, copy=False))
    return c


def pc_checksum(pc, mat) -> np.ndarray | None:
    """``c_M = M^T 1`` for the PC kinds whose operator form is known on the
    host at set-up (none: ones; jacobi: ``1/d``, from the diagonal the set-up
    uses), else None: the PC channel is then left to the drift gate and the
    sentinels."""
    n = mat.shape[0]
    kind = getattr(pc, "kind", None)
    if kind == "none":
        return np.ones(n)
    if kind == "jacobi":
        pmat = pc._mat if pc._mat is not None else mat
        d = np.asarray(pmat.diagonal())
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(d != 0, 1.0 / d, 0.0)
    return None


def checksum_tolerance_dtype(dtype) -> float:
    """Machine epsilon of the real scalar of the STORAGE ``dtype``: the unit
    ``-ksp_abft_tol`` scales (a bf16 apply's benign error is bf16-sized,
    however wide the reduction that sums it)."""
    return real_eps(dtype)
