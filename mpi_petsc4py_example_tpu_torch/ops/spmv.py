"""Sparse matrix-vector products on the ELL and DIA layouts, and the host
conversions that build them.

The port's counterpart of ``mpi_petsc4py_example_tpu/ops/spmv.py``. The JAX
package computes these products with ``jnp`` gathers and shifted slices,
outside any Pallas kernel, and so does the port with torch index and slice
ops (a hand-written SpMV kernel is later work).

* ELL (row-padded): every row stores ``K = max nnz/row`` (column, value)
  slots, the padding ``(0, 0.0)``; the product is a gather, a multiply and a
  row sum.
* DIA (banded matrices): the occupied diagonals' values; the product is a sum
  of shifted contiguous slices, with no gather.

The host conversions give arrays equal to the JAX package's (the same ``K``,
the same offsets, the same zero padding). On the device the port keeps DIA
values diagonal-major, ``(D, rows)``, the transpose of the host layout, so
that each diagonal is one contiguous stream; the batched products take and
return column blocks as ``(k, rows)``, again the transpose of the JAX
``(rows, k)``.

Storage is fp32, fp64 or bfloat16 (the mixed-precision plan's storage): a
bfloat16 product accumulates every tap or diagonal in fp32 and rounds once at
the end, as the JAX package's do (``accum_dtype``, ``:25-35``). Other storage
raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

_STORAGE = (torch.float32, torch.float64, torch.bfloat16)


def accum_dtype(dtype):
    """The accumulation dtype of a product in ``dtype`` storage: fp32 for
    bfloat16, None for fp32/fp64 (they accumulate natively). Other storage
    raises ``NotImplementedError``: the port takes bfloat16 (the
    mixed-precision plan's storage), float32 and float64."""
    if dtype not in _STORAGE:
        raise NotImplementedError(
            f"{dtype} storage is not ported: the port's SpMV and PC applies "
            "take float32/float64 and bfloat16, the mixed-precision plan's "
            "storage")
    return torch.float32 if dtype == torch.bfloat16 else None


def widened_einsum(spec, a, b):
    """``torch.einsum(spec, a, b)`` with :func:`accum_dtype`'s discipline:
    bfloat16 operands contract in fp32 and the result is rounded once to the
    first operand's dtype (JAX ``widened_einsum``, ``:38-49``); the one
    contraction the SpMV and the PC factor applies share."""
    acc = accum_dtype(a.dtype)
    if acc is None:
        return torch.einsum(spec, a, b)
    return torch.einsum(spec, a.to(acc), b.to(acc)).to(a.dtype)


def csr_to_ell(indptr, indices, data, ncols_pad_to: int | None = None):
    """Host CSR -> ELL ``(cols, vals)`` of shape ``(nrows, K)``; padding slots
    hold column 0 and value 0.0."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    data = np.asarray(data)
    nrows = len(indptr) - 1
    counts = indptr[1:] - indptr[:-1]
    K = int(counts.max()) if nrows else 0
    K = max(K, 1)
    if ncols_pad_to is not None:
        K = max(K, ncols_pad_to)
    cols = np.zeros((nrows, K), dtype=np.int32)
    vals = np.zeros((nrows, K), dtype=data.dtype)
    if len(data):
        rows = np.repeat(np.arange(nrows), counts)
        pos = np.arange(len(data)) - np.repeat(indptr[:-1], counts)
        cols[rows, pos] = indices
        vals[rows, pos] = data
    return cols, vals


def ell_spmv_local(cols, vals, x_full):
    """``y[i] = sum_k vals[i, k] * x_full[cols[i, k]]`` for the rows of
    ``cols``/``vals`` ``(rows, K)``; ``x_full`` is the whole input vector."""
    g = torch.index_select(x_full, 0, cols.reshape(-1)).view(cols.shape)
    return widened_einsum("rk,rk->r", vals, g)


def ell_spmv_local_many(cols, vals, x_full_many):
    """Batched ELL product: ``Y[j, i] = sum_k vals[i, k] * X[j, cols[i, k]]``
    for a ``(k, n)`` column block ``X``; returns ``(k, rows)``. One gather
    serves every column."""
    g = torch.index_select(x_full_many, 1, cols.reshape(-1)).view(
        (x_full_many.shape[0],) + tuple(cols.shape))
    return widened_einsum("rk,jrk->jr", vals, g)


def dia_rows(dia, offsets, xp, start: int, lrows: int):
    """``sum_d dia[d] * xp[..., start + offsets[d] : ... + lrows]``: the
    shifted-slice sum every DIA product reduces to. ``xp`` carries the rows
    on its last axis with enough zero padding that every slice is in range;
    ``dia[d]`` broadcasts against a slice. Under bfloat16 the sum runs in an
    fp32 buffer (each product exact, each add rounded to fp32) and is
    rounded once to bfloat16 at the end (JAX ``dia_spmv_local``, ``:167``)."""
    acc = accum_dtype(dia.dtype)
    y = None
    for d, off in enumerate(offsets):
        s = start + int(off)
        seg = xp[..., s:s + lrows]
        if y is None:
            y = (dia[d] if acc is None else dia[d].to(acc)) * seg
        else:
            y.addcmul_(dia[d], seg)
    return y if acc is None else y.to(dia.dtype)


def dia_spmv_local(dia, offsets, x_full, row_offset, halo):
    """``y[i] = sum_d dia[d, i] * x_full[row_offset + i + offsets[d]]`` for
    the ``lrows`` rows of ``dia (D, lrows)``; ``halo`` (the largest
    |offset|) zero-pads ``x_full`` so every slice is in range."""
    xp = torch.nn.functional.pad(x_full, (halo, halo))
    return dia_rows(dia, offsets, xp, row_offset + halo, dia.shape[1])


def dia_spmv_local_many(dia, offsets, x_full_many, row_offset, halo):
    """Batched :func:`dia_spmv_local` on a ``(k, n)`` column block; returns
    ``(k, lrows)``."""
    xp = torch.nn.functional.pad(x_full_many, (halo, halo))
    return dia_rows(dia[:, None, :], offsets, xp, row_offset + halo,
                    dia.shape[1])


def csr_find_diagonals(indptr, indices, max_diags: int = 32):
    """Offsets of the occupied diagonals (sorted), or None past
    ``max_diags``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices)
    nrows = len(indptr) - 1
    counts = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(nrows), counts)
    offsets = np.unique(np.asarray(indices, dtype=np.int64) - rows)
    if len(offsets) > max_diags:
        return None
    return offsets


def csr_to_dia(indptr, indices, data, n, offsets):
    """CSR -> DIA on the host: ``dia[i, d] = A[i, i + offsets[d]]``, shape
    ``(n, D)`` (the JAX package's layout)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    data = np.asarray(data)
    counts = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(n), counts)
    offs = indices - rows
    # offsets are sorted and cover every entry's diagonal, so searchsorted
    # is the offset -> slot map
    offsets = np.asarray(offsets, dtype=np.int64)
    dcol = np.searchsorted(offsets, offs)
    dia = np.zeros((n, len(offsets)), dtype=data.dtype)
    dia[rows, dcol] = data
    return dia


def csr_diag(indptr, indices, data, n):
    """The diagonal of a global host CSR triple."""
    indptr = np.asarray(indptr, dtype=np.int64)
    diag = np.zeros(n, dtype=np.asarray(data).dtype)
    counts = indptr[1:] - indptr[:-1]
    rows = np.repeat(np.arange(n), counts)
    hit = np.asarray(indices) == rows
    diag[rows[hit]] = np.asarray(data)[hit]
    return diag
