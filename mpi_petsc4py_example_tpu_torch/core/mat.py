"""Distributed sparse matrix (AIJ): row-sharded ELL, and DIA for banded
matrices, on the communicator's device.

The port's counterpart of ``mpi_petsc4py_example_tpu/core/mat.py`` (``Mat``,
``coo_to_csr``). The reference constructs it from *(comm, global shape,
local rebased CSR with global column indices)*; the constructors here accept
that, a whole global CSR, per-rank blocks, or a scipy matrix.

Storage: the ELL arrays ``(n_pad, K)`` (``ops/spmv.py``) with rows padded to
the communicator's uniform layout, padding rows empty; a banded square matrix
with at most ``max(2K, 8)`` occupied diagonals also gets its DIA values,
``(D, n_pad)``, and the products take the DIA route. The host CSR is kept for
the factor PCs (bjacobi, lu) and the queries.

:meth:`Mat.local_spmv` is the product the Krylov loops run on shard-stacked
``(local_shards, lsize)`` tensors, through the three routes of the JAX
package: banded DIA with a ``halo``-row exchange between
neighbouring shards, gathered DIA, and ELL (gathered input, one gather of
``x``). :meth:`Mat.local_spmv_t` is the transpose product (JAX
``mat.py:552``): on the banded DIA route each shard accumulates its rows'
contributions over the ``±halo`` column window and ships the two spills to
its neighbours; on the gathered DIA route and on ELL each shard adds its
rows' products into a full-length partial (ELL by
``index_put_(accumulate=True)``, which sums in a fixed order on either
device) and the partials are summed in shard order, as the JAX ``psum``. A
null space (``core/nullspace.py``) rides on the Mat and the solve program
projects with it.

Storage is fp32, fp64, complex64, complex128 or bfloat16. A complex Mat
keeps PETSc's complex-build conventions: :meth:`mult_transpose` is the
plain transpose ``A^T``, never the adjoint, and :meth:`scale` takes a
complex factor. A bfloat16 Mat rounds the CSR values to
bfloat16 once, with torch's cast, when it is built (the JAX package's
``np.asarray(data, dtype=bfloat16)``, ``mat.py:100-115``); its host CSR then
holds those rounded values as fp32, which is exact, so the PCs set up from
the operator's own values, as in the JAX package.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.spmv import (accum_dtype, csr_diag, csr_find_diagonals,
                        csr_to_dia, csr_to_ell, dia_rows, dia_spmv_local,
                        dia_spmv_local_many, ell_spmv_local,
                        ell_spmv_local_many, index_put_acc_)
from ..parallel.mesh import DeviceComm, numpy_dtype, torch_dtype
from ..parallel.partition import RowLayout, concat_csr_blocks
from .vec import Vec

_CSR_ERRORS = {-1: "indptr[0] != 0", -2: "indptr not monotone",
               -3: "indptr[-1] != nnz", -4: "column index out of range"}


def csr_validate(indptr, indices, ncols: int) -> int:
    """0 if the CSR triple is well formed, else the JAX package's negative
    error code (``utils/native.py`` ``csr_validate``)."""
    if indptr[0] != 0:
        return -1
    if (np.diff(indptr) < 0).any():
        return -2
    if indptr[-1] != len(indices):
        return -3
    if len(indices) and (indices.min() < 0 or indices.max() >= ncols):
        return -4
    return 0


class Mat:
    """Row-sharded distributed sparse matrix (AIJ)."""

    def __init__(self, comm: DeviceComm, shape, ell_cols, ell_vals,
                 host_csr=None, layout: RowLayout | None = None):
        self.comm = comm
        self.shape = (int(shape[0]), int(shape[1]))
        self.layout = layout or RowLayout(self.shape[0], comm.size)
        self.ell_cols = ell_cols          # (n_pad, K) int32
        self.ell_vals = ell_vals          # (n_pad, K)
        self.host_csr = host_csr          # (indptr, indices, data) or None
        self._assembled = False
        # bumped by every in-place mutation, so PC set-ups keyed on this Mat
        # rebuild
        self._state = 0
        self.dia_vals = None              # (D, n_pad), the DIA route's values
        self.dia_offsets: tuple[int, ...] = ()
        self.assembly_breakdown: dict = {}
        self.nullspace = None             # core.nullspace.NullSpace or None

    # ---- constructors ------------------------------------------------------
    @classmethod
    def create_aij(cls, comm, size, csr, dtype=torch.float64) -> "Mat":
        """The reference contract: global ``size`` and the caller's local
        rebased CSR, which in one process is the whole matrix; per-rank
        blocks go through :meth:`from_local_blocks`."""
        nrows = size[0]
        local_rows = len(csr[0]) - 1
        if local_rows == nrows:
            return cls.from_csr(comm, size, csr, dtype=dtype)
        raise ValueError(
            f"local CSR has {local_rows} rows but global shape is {size}; "
            "assemble per-rank blocks with Mat.from_local_blocks")

    @classmethod
    def from_csr(cls, comm, size, csr, dtype=torch.float64) -> "Mat":
        """Build from a global host CSR triple: validate, convert to ELL,
        detect and convert DIA, then place every device array. The parts of
        the time land in ``assembly_breakdown`` (the placement is synced
        before its stamp)."""
        dt = torch_dtype(dtype)
        accum_dtype(dt)
        nrows, ncols = int(size[0]), int(size[1])
        t0 = time.perf_counter()
        indptr = np.asarray(csr[0], dtype=np.int64)
        indices = np.asarray(csr[1], dtype=np.int32)
        data = _storage_values(csr[2], dt)
        if len(indptr) != nrows + 1:
            raise ValueError(f"malformed CSR: {len(indptr) - 1} rows for "
                             f"shape {(nrows, ncols)}")
        err = csr_validate(indptr, indices, ncols)
        if err != 0:
            raise ValueError(f"malformed CSR: {_CSR_ERRORS[err]}")
        t1 = time.perf_counter()
        cols, vals = csr_to_ell(indptr, indices, data)
        K = cols.shape[1]
        t2 = time.perf_counter()
        # banded square matrices also get DIA: the same storage order as
        # ELL, and a product of shifted slices with no gather
        offsets, dia = None, None
        if nrows == ncols:
            offsets = csr_find_diagonals(indptr, indices,
                                         max_diags=max(2 * K, 8))
            # an all-zero matrix (no stored diagonal) stays on ELL
            if offsets is not None and 0 < len(offsets) <= max(2 * K, 8):
                dia = csr_to_dia(indptr, indices, data, nrows, offsets)
            else:
                offsets = None
        t3 = time.perf_counter()
        ell_cols = comm.put_rows(cols)
        ell_vals = comm.put_rows(vals, dt)
        # DIA goes to the card diagonal-major, transposed on the host
        dia_t = (None if dia is None else torch.tensor(
            comm.local_rows(dia).T, dtype=dt, device=comm.device))
        if comm.device.type == "cuda":
            torch.cuda.synchronize(comm.device)
        t4 = time.perf_counter()
        m = cls(comm, (nrows, ncols), ell_cols, ell_vals,
                host_csr=(indptr, indices, data))
        if dia_t is not None:
            m.dia_vals = dia_t
            m.dia_offsets = tuple(int(o) for o in offsets)
        m._assembled = True
        m.assembly_breakdown = {
            "validate_s": round(t1 - t0, 4),
            "ell_convert_s": round(t2 - t1, 4),
            "dia_convert_s": round(t3 - t2, 4),
            "device_put_s": round(t4 - t3, 4),
        }
        return m

    @classmethod
    def from_local_blocks(cls, comm, size, blocks,
                          dtype=torch.float64) -> "Mat":
        """Build from per-rank local CSR blocks, in rank order."""
        return cls.from_csr(comm, size, concat_csr_blocks(blocks),
                            dtype=dtype)

    @classmethod
    def from_scipy(cls, comm, A, dtype=torch.float64) -> "Mat":
        t0 = time.perf_counter()
        A = A.tocsr()
        tocsr = time.perf_counter() - t0
        m = cls.from_csr(comm, A.shape, (A.indptr, A.indices, A.data),
                         dtype=dtype)
        # the format conversion is part of what a caller times as assembly
        m.assembly_breakdown = {"tocsr_s": round(tocsr, 4),
                                **m.assembly_breakdown}
        return m

    def astype(self, dtype) -> "Mat":
        """The same values in another storage dtype, converted once from the
        host CSR (JAX ``mat.py:158``); the null space rides along. Like the
        JAX package, and unlike ``ndarray.astype``, the same dtype returns
        ``self``: use :meth:`duplicate` for an independent copy."""
        dt = torch_dtype(dtype)
        if dt == self.dtype:
            return self
        if self.host_csr is not None:
            m = Mat.from_csr(self.comm, self.shape, self.host_csr, dtype=dt)
        else:
            m = Mat.from_scipy(self.comm, self.to_scipy(), dtype=dt)
        if self.nullspace is not None:
            m.set_nullspace(self.nullspace)
        return m

    # ---- PETSc-Mat-shaped API ----------------------------------------------
    def set_up(self):
        return self

    def assemble(self):
        self._assembled = True
        return self

    assembly_begin = assemble
    assembly_end = assemble

    @property
    def assembled(self) -> bool:
        return self._assembled

    @property
    def dtype(self) -> torch.dtype:
        return self.ell_vals.dtype

    @property
    def n_pad(self) -> int:
        return self.ell_cols.shape[0]

    @property
    def K(self) -> int:
        """ELL width: the most nonzeros in a row."""
        return self.ell_cols.shape[1]

    def get_vecs(self) -> tuple[Vec, Vec]:
        """A compatibly laid out ``(x, b)`` pair (``a.getVecs()``)."""
        mk = lambda: Vec(self.comm, self.shape[0], dtype=self.dtype,
                         layout=self.layout)
        return mk(), mk()

    # ---- null space (PETSc MatSetNullSpace) --------------------------------
    def set_nullspace(self, nullspace):
        """Attach a :class:`..core.nullspace.NullSpace`: KSP then projects
        the right-hand side and every operator and PC output onto its
        complement (compatible singular systems)."""
        self.nullspace = nullspace
        return self

    setNullSpace = set_nullspace

    def get_nullspace(self):
        return self.nullspace

    getNullSpace = get_nullspace

    # ---- assembled-matrix algebra ------------------------------------------
    def _replace_from_scipy(self, S):
        """Rebuild this Mat's storage in place from a scipy matrix."""
        S = S.tocsr()
        rebuilt = Mat.from_csr(self.comm, S.shape,
                               (S.indptr, S.indices, S.data),
                               dtype=self.dtype)
        self.shape = rebuilt.shape
        self.layout = rebuilt.layout
        self.ell_cols = rebuilt.ell_cols
        self.ell_vals = rebuilt.ell_vals
        self.host_csr = rebuilt.host_csr
        self.dia_vals = rebuilt.dia_vals
        self.dia_offsets = rebuilt.dia_offsets
        self._assembled = True
        self._state += 1
        return self

    def norm(self, norm_type: str = "frobenius") -> float:
        """Matrix norm: 'frobenius' (PETSc's default), '1' or 'inf'."""
        import scipy.sparse.linalg as spla
        S = self.to_scipy()
        t = str(norm_type).lower()
        if t in ("frobenius", "fro"):
            return float(spla.norm(S, "fro"))
        if t in ("1", "one"):
            return float(np.abs(S).sum(axis=0).max())
        if t in ("inf", "infinity"):
            return float(np.abs(S).sum(axis=1).max())
        raise ValueError(f"unknown norm type {norm_type!r}")

    def transpose(self) -> "Mat":
        """A new assembled Mat holding A^T."""
        return Mat.from_scipy(self.comm, self.to_scipy().T.tocsr(),
                              dtype=self.dtype)

    def duplicate(self, copy_values: bool = True) -> "Mat":
        S = self.to_scipy().copy()
        if not copy_values:
            S.data[:] = 0.0
        return Mat.from_scipy(self.comm, S, dtype=self.dtype)

    def copy(self) -> "Mat":
        return self.duplicate(copy_values=True)

    def axpy(self, alpha: float, X: "Mat") -> "Mat":
        """Y <- Y + alpha X (PETSc MatAXPY; rebuilds the device layout)."""
        if X.shape != self.shape:
            raise ValueError(f"axpy shape mismatch: {self.shape} vs {X.shape}")
        return self._replace_from_scipy(
            self.to_scipy() + float(alpha) * X.to_scipy())

    def scale(self, alpha) -> "Mat":
        """A <- alpha A, on the device arrays and the host CSR in place;
        ``alpha`` is first cast to the storage scalar (JAX
        ``self.dtype.type(alpha)``), so a complex Mat takes a complex
        factor."""
        alpha = numpy_dtype(self.dtype).type(alpha)
        self.ell_vals = self.ell_vals * alpha.item()
        if self.dia_vals is not None:
            self.dia_vals = self.dia_vals * alpha.item()
        if self.host_csr is not None:
            ip, ix, dv = self.host_csr
            self.host_csr = (ip, ix, _storage_values(dv * alpha, self.dtype))
        self._state += 1
        return self

    def shift(self, alpha: float) -> "Mat":
        """A <- A + alpha I (PETSc MatShift)."""
        import scipy.sparse as sp
        return self._replace_from_scipy(
            self.to_scipy() + float(alpha) * sp.eye(self.shape[0],
                                                    format="csr"))

    def zero_rows(self, rows, diag: float = 1.0, b: Vec | None = None,
                  x: Vec | None = None) -> "Mat":
        """PETSc MatZeroRows: zero the given global rows, put ``diag`` on
        their diagonal and, given ``x`` and ``b``, set
        ``b[rows] = diag * x[rows]``."""
        rows = np.asarray(rows, dtype=np.int64)
        S = self.to_scipy().tolil()
        S[rows, :] = 0.0
        if diag != 0.0:
            S[rows, rows] = diag
        self._replace_from_scipy(S.tocsr())
        if b is not None and x is not None:
            bh = b.to_numpy()
            bh[rows] = diag * x.to_numpy()[rows]
            b.set_global(bh)
        return self

    zeroRows = zero_rows

    def get_row(self, i: int):
        """``(cols, vals)`` of global row ``i`` (PETSc MatGetRow)."""
        S = self.to_scipy()
        s, e = int(S.indptr[i]), int(S.indptr[i + 1])
        return np.asarray(S.indices[s:e]), np.asarray(S.data[s:e])

    getRow = get_row

    def get_info(self) -> dict:
        """nnz and device-memory summary (PETSc MatGetInfo)."""
        if self.host_csr is not None:
            nnz = int(self.host_csr[0][-1])
        else:
            vals = self.comm.host_fetch(self.ell_vals)[: self.shape[0]]
            nnz = int((vals != 0).sum())
        return {
            "nnz": nnz,
            "ell_width": self.K,
            "dia_diagonals": len(self.dia_offsets),
            "rows_per_device": self.comm.local_size(self.shape[0]),
            "memory_device_bytes": int(
                self.ell_vals.numel() * self.ell_vals.element_size()
                + self.ell_cols.numel() * self.ell_cols.element_size()),
        }

    getInfo = get_info

    # ---- operator application ----------------------------------------------
    def mult_padded(self, x_padded: torch.Tensor) -> torch.Tensor:
        """``A x`` on the padded flat data of a Vec (this process's rows
        on a process comm, through :meth:`local_spmv`)."""
        comm = self.comm
        if comm.multiprocess:
            return self.local_spmv(comm)(
                x_padded.view(comm.local_shards, -1)).reshape(-1)
        if self.dia_vals is not None:
            return dia_spmv_local(self.dia_vals, self.dia_offsets, x_padded,
                                  0, self._halo())
        return ell_spmv_local(self.ell_cols, self.ell_vals, x_padded)

    def mult(self, x: Vec, y: Vec | None = None) -> Vec:
        ypad = self.mult_padded(x.data)
        if y is None:
            return Vec(self.comm, self.shape[0], data=ypad, layout=self.layout)
        y.data = ypad
        return y

    def mult_transpose(self, x: Vec, y: Vec | None = None) -> Vec:
        """``y = A^T x`` (PETSc MatMultTranspose) through
        :meth:`local_spmv_t`."""
        comm = self.comm
        ypad = self.local_spmv_t(comm)(
            x.data.view(comm.local_shards, -1)).reshape(-1)
        if y is None:
            return Vec(comm, self.shape[0], data=ypad, layout=self.layout)
        y.data = ypad
        return y

    multTranspose = mult_transpose

    def diagonal(self) -> np.ndarray:
        """The global diagonal on the host (PC jacobi's input)."""
        if self.host_csr is not None:
            return csr_diag(*self.host_csr, self.shape[0])
        cols = self.comm.host_fetch(self.ell_cols)[: self.shape[0]]
        vals = self.comm.host_fetch(self.ell_vals)[: self.shape[0]]
        gidx = np.arange(self.shape[0])[:, None]
        return np.where(cols == gidx, vals, 0.0).sum(axis=1)

    def to_scipy(self):
        import scipy.sparse as sp
        if self.host_csr is not None:
            indptr, indices, data = self.host_csr
            return sp.csr_matrix((data, indices, indptr), shape=self.shape)
        cols = self.comm.host_fetch(self.ell_cols)[: self.shape[0]]
        vals = self.comm.host_fetch(self.ell_vals)[: self.shape[0]]
        rows = np.repeat(np.arange(self.shape[0]), cols.shape[1])
        mask = vals.ravel() != 0
        return sp.csr_matrix(
            (vals.ravel()[mask], (rows[mask], cols.ravel()[mask])),
            shape=self.shape)

    # ---- the products the Krylov loops run ---------------------------------
    def _halo(self) -> int:
        return max(abs(o) for o in self.dia_offsets) if self.dia_offsets \
            else 0

    def spmv_route(self, comm: DeviceComm) -> str:
        """Which product :meth:`local_spmv` runs on ``comm``: 'dia-banded'
        (every occupied diagonal reaches at most the neighbouring shard, so
        only ``halo`` boundary rows move each way), 'dia-gathered' or
        'ell'."""
        if self.dia_vals is None:
            return "ell"
        halo = self._halo()
        if comm.size > 1 and 0 < halo <= comm.local_size(self.shape[0]):
            return "dia-banded"
        return "dia-gathered"

    def _halo_extend(self, comm: DeviceComm, x, halo: int):
        """``x (size, ..., lsize)`` with the ``halo`` last rows of the shard
        below prepended and the ``halo`` first rows of the shard above
        appended: one open-chain shift each way, zeros at the global ends
        (the JAX ``ppermute`` pair of ``mat.py:459-469``)."""
        return torch.cat([comm.shift_open(x[..., -halo:], 1), x,
                          comm.shift_open(x[..., :halo], -1)], dim=-1)

    def local_spmv(self, comm: DeviceComm):
        """``spmv(x (local_shards, lsize)) -> A x``, one of three routes
        (see :meth:`spmv_route`), on this process's rows."""
        size, lsize = comm.local_shards, comm.local_size(self.shape[0])
        row0 = comm.local_row_range(self.shape[0])[0]
        route = self.spmv_route(comm)
        if route == "dia-banded":
            offsets, halo = self.dia_offsets, self._halo()
            dia = self.dia_vals.view(len(offsets), size, lsize)

            def spmv(x):
                ext = self._halo_extend(comm, x, halo)
                return dia_rows(dia, offsets, ext, halo, lsize)
            return spmv
        if route == "dia-gathered":
            offsets, halo = self.dia_offsets, self._halo()

            def spmv(x):
                return dia_spmv_local(self.dia_vals, offsets,
                                      comm.all_gather(x), row0,
                                      halo).view(size, lsize)
            return spmv

        def spmv(x):
            return ell_spmv_local(self.ell_cols, self.ell_vals,
                                  comm.all_gather(x)).view(size, lsize)
        return spmv

    def local_spmv_many(self, comm: DeviceComm):
        """Batched ``spmv(X (local_shards, k, lsize)) -> A X``, the routes
        of :meth:`local_spmv`: one exchange or one gather for all ``k``
        columns."""
        size, lsize = comm.local_shards, comm.local_size(self.shape[0])
        row0 = comm.local_row_range(self.shape[0])[0]
        route = self.spmv_route(comm)

        def full(X):                     # (L, k, lsize) -> (k, n_pad)
            G = comm.gather_shards(X)
            return G.transpose(0, 1).reshape(X.shape[1], -1)

        def back(Y):                     # (k, L * lsize) -> (L, k, lsize)
            return Y.view(Y.shape[0], size, lsize).transpose(0, 1)

        if route == "dia-banded":
            offsets, halo = self.dia_offsets, self._halo()
            dia = self.dia_vals.view(len(offsets), size, 1, lsize)

            def spmv(X):
                ext = self._halo_extend(comm, X, halo)
                return dia_rows(dia, offsets, ext, halo, lsize)
            return spmv
        if route == "dia-gathered":
            offsets, halo = self.dia_offsets, self._halo()

            def spmv(X):
                return back(dia_spmv_local_many(self.dia_vals, offsets,
                                                full(X), row0, halo))
            return spmv

        def spmv(X):
            return back(ell_spmv_local_many(self.ell_cols, self.ell_vals,
                                            full(X)))
        return spmv

    def local_spmv_t(self, comm: DeviceComm):
        """``spmv_t(x (local_shards, lsize)) -> A^T x`` on this process's
        rows (JAX ``mat.py:552``), square operators only. Each route sums
        the JAX package's products in a fixed order:

        * DIA, purely diagonal: the product is local;
        * DIA, banded (every diagonal reaches at most the neighbouring
          shard): each shard adds ``dia[d] * x`` into its ``±halo`` window,
          diagonal by diagonal, and the two spills go to the neighbouring
          shards (one open-chain shift each way, zeros at the global ends);
        * DIA, gathered: each shard's window, placed at its rows in a
          full-length partial;
        * ELL: each shard's scatter-add of ``vals * x`` into the columns of
          a full-length partial, in row order (``index_put_`` with
          ``accumulate=True``, deterministic on the CPU and on CUDA; on
          complex values over ``view_as_real``, ``ops.spmv.index_put_acc_``).

        The full-length partials of the last two are summed over the shards
        in global shard order (``comm.psum``: never ``all_reduce``), as the
        JAX ``psum`` of each shard's buffer, and each process keeps its
        rows.
        """
        if self.shape[0] != self.shape[1]:
            raise ValueError(
                "local_spmv_t supports square operators only (output is "
                f"row-partitioned like the input); shape={self.shape}")
        shards, lsize = comm.local_shards, comm.local_size(self.shape[0])
        n_pad = comm.size * lsize
        start, stop = comm.local_row_range(self.shape[0])
        if self.dia_vals is None:
            vals = self.ell_vals
            # shard s scatters into the s-th partial: one index_put_
            cols = (self.ell_cols.view(shards, -1).long()
                    + n_pad * torch.arange(shards, device=vals.device)[:, None]
                    ).reshape(-1)

            def spmv_t(x):
                contrib = (vals * x.reshape(-1, 1)).reshape(-1)
                parts = torch.zeros(shards * n_pad, dtype=vals.dtype,
                                    device=vals.device)
                index_put_acc_(parts, (cols,), contrib)
                y = comm.psum(list(parts.view(shards, n_pad)))
                return y[start:stop].view(shards, lsize)
            return spmv_t
        offsets, halo = self.dia_offsets, self._halo()
        acc = accum_dtype(self.dtype) or self.dtype
        dia = self.dia_vals.view(len(offsets), shards, lsize)

        def window(x):
            """``(local_shards, lsize + 2 halo)``: each diagonal's products
            added at its offset, diagonal by diagonal."""
            win = torch.zeros((shards, lsize + 2 * halo), dtype=acc,
                              device=x.device)
            for d, off in enumerate(offsets):
                s = halo + int(off)
                win[:, s:s + lsize].addcmul_(dia[d].to(acc), x.to(acc))
            return win

        if halo == 0:
            return lambda x: (dia[0] * x)
        if comm.size > 1 and halo <= lsize:
            def spmv_t(x):
                win = window(x)
                y = win[:, halo:halo + lsize].clone()
                # shard i's right spill belongs to shard i + 1, its left
                # spill to shard i - 1
                y[:, :halo] += comm.shift_open(win[:, halo + lsize:], 1)
                y[:, lsize - halo:] += comm.shift_open(win[:, :halo], -1)
                return y.to(self.dtype)
            return spmv_t
        row0 = comm.shard_offset * lsize

        def spmv_t(x):
            win = window(x)
            parts = torch.zeros((shards, n_pad + 2 * halo), dtype=acc,
                                device=x.device)
            for i in range(shards):
                r0 = row0 + i * lsize
                parts[i, r0:r0 + lsize + 2 * halo] = win[i]
            y = comm.psum(list(parts))[halo + start:halo + stop]
            return y.to(self.dtype).view(shards, lsize)
        return spmv_t

    def program_key(self):
        if self.dia_vals is not None:
            return ("dia", self.dia_offsets)
        return ("ell",)

    def __repr__(self):
        return (f"Mat(shape={self.shape}, K={self.K}, "
                f"devices={self.comm.size}, dtype={self.dtype})")


def _storage_values(data, dtype: torch.dtype) -> np.ndarray:
    """The CSR values as stored in ``dtype``, on the host: a numpy array of
    ``dtype``, or for bfloat16 the values rounded once by torch's cast and
    held as fp32 (an fp64 value rounds through fp32, as ``ml_dtypes`` rounds
    it)."""
    if dtype != torch.bfloat16:
        return np.asarray(data, dtype=numpy_dtype(dtype))
    return torch.tensor(np.asarray(data), dtype=dtype).float().numpy()


def coo_to_csr(shape, rows, cols, vals, mode: str = "insert"):
    """COO triplets -> host CSR triple with PETSc's MatSetValues duplicate
    semantics: ``'insert'`` (INSERT_VALUES, the last write to a slot wins)
    or ``'add'`` (ADD_VALUES, duplicates sum). Out-of-range indices raise."""
    import scipy.sparse as sp
    nrows, ncols = int(shape[0]), int(shape[1])
    rows = np.asarray(rows, dtype=np.int64).ravel()
    cols = np.asarray(cols, dtype=np.int64).ravel()
    vals = np.asarray(vals).ravel()
    if not (rows.shape == cols.shape == vals.shape):
        raise ValueError(
            f"coo_to_csr: rows/cols/vals lengths differ "
            f"({rows.shape}, {cols.shape}, {vals.shape})")
    if len(rows) and (rows.min() < 0 or rows.max() >= nrows
                      or cols.min() < 0 or cols.max() >= ncols):
        raise ValueError(
            f"coo_to_csr: index out of range for shape {(nrows, ncols)}")
    if mode == "add":
        A = sp.coo_matrix((vals, (rows, cols)), shape=(nrows, ncols)).tocsr()
        return A.indptr, A.indices, A.data
    if mode != "insert":
        raise ValueError(f"coo_to_csr: unknown mode {mode!r}")
    # keep the last occurrence of each (i, j): np.unique on the reversed
    # keys returns the first occurrence in reversed order
    flat = rows * np.int64(ncols) + cols
    _, first_rev = np.unique(flat[::-1], return_index=True)
    keep = len(flat) - 1 - first_rev
    A = sp.coo_matrix((vals[keep], (rows[keep], cols[keep])),
                      shape=(nrows, ncols)).tocsr()
    return A.indptr, A.indices, A.data
