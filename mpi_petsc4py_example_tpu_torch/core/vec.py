"""Distributed vector: one padded tensor on the communicator's device.

The port's counterpart of ``mpi_petsc4py_example_tpu/core/vec.py`` (``Vec``).
Storage is a flat tensor of length ``comm.padded_size(n)``, whose view
``(comm.size, comm.local_size(n))`` is the shard axis; the user-visible
ownership ranges live in a :class:`RowLayout`. The BLAS-1 methods update
``data`` in place where JAX rebinds a new array. A bfloat16 Vec travels to
and from the host as float32, and its reductions accumulate in the fp32
reduce channel (``utils/dtypes.py``).

Every reduction (``norm``, ``dot``, ``sum``, ``mean``) is a per-shard
partial summed by :meth:`DeviceComm.psum` in shard order, so it gives the
same bits on every run; ``min``/``max`` look at the logical entries only,
never the zero padding.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import DeviceComm, torch_dtype
from ..parallel.partition import RowLayout
from ..utils.dtypes import reduce_dtype


class Vec:
    """Row-sharded distributed vector of logical length ``n``."""

    def __init__(self, comm: DeviceComm, n: int,
                 data: torch.Tensor | None = None, dtype=torch.float64,
                 layout: RowLayout | None = None):
        self.comm = comm
        self.n = int(n)
        self.layout = layout or RowLayout(self.n, comm.size)
        if data is None:
            data = torch.zeros(comm.padded_size(self.n),
                               dtype=torch_dtype(dtype), device=comm.device)
        elif data.shape != (comm.padded_size(self.n),):
            raise ValueError(f"Vec data must have shape "
                             f"({comm.padded_size(self.n)},), got "
                             f"{tuple(data.shape)}")
        self.data = data

    @classmethod
    def from_global(cls, comm: DeviceComm, arr, dtype=None,
                    layout: RowLayout | None = None) -> "Vec":
        arr = np.asarray(arr)
        return cls(comm, arr.shape[0], data=comm.put_rows(arr, dtype),
                   layout=layout)

    def duplicate(self) -> "Vec":
        """A zero Vec of the same layout (PETSc VecDuplicate)."""
        return Vec(self.comm, self.n, data=torch.zeros_like(self.data),
                   layout=self.layout)

    def copy(self) -> "Vec":
        return Vec(self.comm, self.n, data=self.data.clone(),
                   layout=self.layout)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def set_global(self, arr):
        """Place a host array in this Vec's dtype (a bfloat16 Vec rounds it
        with torch's cast)."""
        self.data = self.comm.put_rows(np.asarray(arr), self.data.dtype)

    def to_numpy(self) -> np.ndarray:
        """Gather to host, dropping padding (bfloat16 as float32)."""
        return self.comm.host_fetch(self.data)[: self.n]

    def _reduce_view(self) -> torch.Tensor:
        """``data`` in the reduce dtype (a copy for bfloat16 only), viewed
        shard-stacked as ``(size, local_size)``."""
        return self.data.to(reduce_dtype(self.data.dtype)).view(
            self.comm.size, -1)

    def _psum(self, fn) -> float:
        """``fn`` of each shard's block, summed in shard order."""
        v = self._reduce_view()
        return float(self.comm.psum([fn(v[i]) for i in range(v.shape[0])]))

    # ---- PETSc-shaped local views -------------------------------------------
    def set_array(self, local, rank: int = 0):
        """Set rank ``rank``'s block of the user-visible layout (the
        reference's ``b.setArray``); the whole vector when the layout has one
        rank."""
        local = np.asarray(local)
        rs, re = self.layout.range(rank)
        if local.shape[0] == self.n and rs == 0 and re == self.n:
            self.set_global(local)
            return self
        if local.shape[0] != re - rs:
            raise ValueError(
                f"local block for rank {rank} must have length {re - rs}, "
                f"got {local.shape[0]}")
        host = self.to_numpy()
        host[rs:re] = local
        self.set_global(host)
        return self

    def local_array(self, rank: int = 0) -> np.ndarray:
        """Rank ``rank``'s block (the reference's ``x.array``)."""
        rs, re = self.layout.range(rank)
        return self.to_numpy()[rs:re]

    @property
    def array(self) -> np.ndarray:
        return self.local_array(0)

    # ---- vector arithmetic ---------------------------------------------------
    def zero(self):
        self.data.zero_()
        return self

    def norm(self, norm_type: str = "2") -> float:
        """Vector norm: '2' (PETSc NORM_2, the default), '1' or 'inf'. The
        padding entries are zero, so the padded shards give the exact
        value."""
        t = str(norm_type).lower()
        if t in ("2", "fro", "frobenius"):
            return math.sqrt(self._psum(lambda u: torch.dot(u, u)))
        if t in ("1", "one"):
            return self._psum(lambda u: u.abs().sum())
        if t in ("inf", "infinity"):
            return float(self._reduce_view().abs().max())
        raise ValueError(f"unknown norm type {norm_type!r}")

    def dot(self, other: "Vec") -> float:
        """PETSc VecDot(self, other) for real vectors."""
        w = other._reduce_view()
        v = self._reduce_view()
        return float(self.comm.psum([torch.dot(v[i], w[i])
                                     for i in range(v.shape[0])]))

    def sum(self) -> float:
        return self._psum(torch.sum)

    def mean(self) -> float:
        return self.sum() / self.n

    def min(self) -> tuple[int, float]:
        """``(index, value)`` of the smallest logical entry (petsc4py's
        ``vec.min()``)."""
        v = self.data[: self.n]
        i = int(torch.argmin(v))
        return i, float(v[i])

    def max(self) -> tuple[int, float]:
        """``(index, value)`` of the largest logical entry."""
        v = self.data[: self.n]
        i = int(torch.argmax(v))
        return i, float(v[i])

    def axpy(self, alpha: float, other: "Vec"):
        """self += alpha * other."""
        self.data.add_(other.data, alpha=alpha)
        return self

    def aypx(self, alpha: float, other: "Vec"):
        """self = alpha * self + other."""
        self.data.mul_(alpha).add_(other.data)
        return self

    def axpby(self, alpha: float, beta: float, x: "Vec"):
        """self = alpha * x + beta * self (PETSc VecAXPBY)."""
        self.data.mul_(beta).add_(x.data, alpha=alpha)
        return self

    def waxpy(self, alpha: float, x: "Vec", y: "Vec"):
        """self = alpha * x + y (PETSc VecWAXPY)."""
        torch.add(y.data, x.data, alpha=alpha, out=self.data)
        return self

    def scale(self, alpha: float):
        self.data.mul_(alpha)
        return self

    def shift(self, alpha: float):
        """self += alpha on the logical entries (the padding stays zero)."""
        self.data[: self.n] += alpha
        return self

    def pointwise_mult(self, a: "Vec", b: "Vec"):
        torch.mul(a.data, b.data, out=self.data)
        return self

    def pointwise_divide(self, a: "Vec", b: "Vec"):
        """self = a / b elementwise, 0 where b is 0 (the padding stays
        zero)."""
        self.data = _safe_div(a.data, b.data)
        return self

    def reciprocal(self):
        """self = 1 / self on the nonzero entries (PETSc VecReciprocal;
        exact zeros and the padding stay zero)."""
        self.data = _safe_div(torch.ones_like(self.data), self.data)
        return self

    def normalize(self) -> float:
        """Scale to unit 2-norm; returns the norm before."""
        nrm = self.norm()
        if nrm != 0:
            self.scale(1.0 / nrm)
        return nrm

    def set_value(self, i: int, v: float):
        """Point insert by global index."""
        self.data[int(i)] = v
        return self

    setValue = set_value

    def set(self, alpha: float):
        """self[:] = alpha on the logical entries (PETSc VecSet)."""
        self.data.zero_()
        self.data[: self.n] = alpha
        return self

    def __len__(self):
        return self.n


def _safe_div(num, den):
    """``num / den``, and 0 where ``den`` is 0."""
    zero = den == 0
    return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den)).to(
        num.dtype)
