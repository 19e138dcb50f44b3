"""Matrix-free 7-point 3D Poisson operator over z-slab shards.

The port's counterpart of ``mpi_petsc4py_example_tpu/models/stencil.py``
(``StencilPoisson3D``). No matrix is stored: each shard owns ``lz = nz/size``
contiguous z-planes, needs only its two neighbouring planes (the halo), and
applies the stencil with the kernels of :mod:`..ops.stencil`.

The local closures work on shard-stacked tensors: a grid-shaped carry is
``(size, lz, ny, nx)`` and a flat one ``(size, lz*ny*nx)``, both views of the
same memory as a :class:`Vec`'s padded data. The batched (``_many``) closures
take a block of ``k`` columns, ``(size, k, lz, ny, nx)`` grid-shaped or
``(size, k, lz*ny*nx)`` flat: each shard's part is the contiguous
``(k, lz, ny, nx)`` operand of the ``_many`` kernels.

With ``dtype=torch.bfloat16`` (the mixed-precision plan's storage) the slabs
and halo planes stay bfloat16 and the fused dots carry their fp32 partials
(the kernels' reduce dtype) through the shard sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.vec import Vec
from ..ops.stencil import (stencil3d_apply, stencil3d_apply_many,
                           stencil3d_apply_many_plain, stencil3d_apply_plain,
                           stencil3d_dot, stencil3d_dot_many,
                           stencil3d_dot_many_plain, stencil3d_dot_plain)
from ..parallel.mesh import DeviceComm, torch_dtype
from ..parallel.partition import RowLayout


def make_plane_exchange(comm: DeviceComm):
    """Boundary z-plane halo exchange along the slab ring.

    ``exchange(u (size, lz, ny, nx)) -> (halo_lo, halo_hi)``, each
    ``(size, ny, nx)``: shard ``i`` gets plane ``lz-1`` of shard ``i-1`` below
    and plane ``0`` of shard ``i+1`` above (one ring shift each way), with zero
    planes at the global Dirichlet boundaries. With one shard both halos are
    boundaries, so both are zero planes, kept from call to call.
    """
    zeros = {}

    def exchange(u):
        if comm.size == 1:
            key = (u.shape[2:], u.dtype, u.device)
            if key not in zeros:
                zeros[key] = torch.zeros((1,) + tuple(u.shape[2:]),
                                         dtype=u.dtype, device=u.device)
            return zeros[key], zeros[key]
        halo_lo = comm.shift(u[:, -1], 1)    # plane z-1 from the shard below
        halo_hi = comm.shift(u[:, 0], -1)    # plane z+lz from the shard above
        halo_lo[0].zero_()
        halo_hi[-1].zero_()
        return halo_lo, halo_hi

    return exchange


def exchange_many(comm: DeviceComm, U):
    """The batched halo exchange (the JAX ``_exchange_many``): for a block
    ``U (size, k, lz, ny, nx)`` the boundary-plane blocks ``(size, k, ny,
    nx)`` each way, one ring shift each, zero at the global Dirichlet ends.
    With one shard both halos are boundaries: returns ``(None, None)``,
    which the ``_many`` kernels take as zero planes, so no zero block of
    another width can be handed to them."""
    if comm.size == 1:
        return None, None
    halo_lo = comm.shift(U[:, :, -1], 1)     # plane z-1 of each column
    halo_hi = comm.shift(U[:, :, 0], -1)     # plane z+lz of each column
    halo_lo[0].zero_()
    halo_hi[-1].zero_()
    return halo_lo, halo_hi


class StencilPoisson3D:
    """7-point 3D Poisson (Dirichlet) as a matrix-free sharded operator.

    Grid ordering is x-fastest (``index = x + nx*(y + ny*z)``) and the rows
    are sharded in contiguous z-slabs: requires ``nz % comm.size == 0``.
    Matches :func:`..models.poisson.poisson3d_csr` exactly.

    ``force_plain`` is a test switch: when True, every apply (the batched
    ones too) goes through the plain PyTorch versions even on the card, so
    one run can hold the kernel path against the plain one.
    """

    # uniform diagonal: CG's Jacobi apply collapses to z = r/6 and its
    # <r, z> to ||r||^2/6 (see solvers/krylov.cg_stencil_kernel)
    uniform_diagonal = 6.0

    def __init__(self, comm: DeviceComm, nx: int, ny: int | None = None,
                 nz: int | None = None, dtype=torch.float64):
        self.comm = comm
        self.nx, self.ny = nx, ny or nx
        self.nz = nz or nx
        if self.nz % comm.size != 0:
            raise ValueError(
                f"stencil operator needs nz ({self.nz}) divisible by the "
                f"device count ({comm.size})")
        n = self.nx * self.ny * self.nz
        self.shape = (n, n)
        self._dtype = torch_dtype(dtype)
        self.layout = RowLayout(n, comm.size)
        self.lz = self.nz // comm.size   # local z-planes per shard
        self.force_plain = False

    @property
    def dtype(self) -> torch.dtype:
        return self._dtype

    def program_key(self):
        return ("stencil3d", self.nx, self.ny, self.nz, self.comm.size)

    @property
    def grid3d(self):
        """The local slab shape ``(lz, ny, nx)`` the CG fast path carries."""
        return (self.lz, self.ny, self.nx)

    # the plain stencil body (the counterpart of _stencil7_jnp)
    _stencil7 = staticmethod(stencil3d_apply_plain)

    def _grid(self, v):
        return v.reshape((self.comm.size,) + self.grid3d)

    def local_apply_grid3(self, comm: DeviceComm):
        """Grid-shaped apply ``u (size, lz, ny, nx) -> A u``."""
        exchange = make_plane_exchange(comm)
        plain = self.force_plain

        def body(u, lo, hi, y):
            if plain:
                y.copy_(stencil3d_apply_plain(u, lo, hi))
            else:
                stencil3d_apply(u, lo, hi, out=y)

        run = comm.shard_map(body)

        def apply3(u):
            halo_lo, halo_hi = exchange(u)
            y = torch.empty_like(u)
            run(u, halo_lo, halo_hi, y)
            return y

        return apply3

    def local_spmv(self, comm: DeviceComm):
        """Flat apply ``x (size, lz*ny*nx) -> A x``: the grid apply behind
        two reshapes (views, no copies)."""
        apply3 = self.local_apply_grid3(comm)

        def spmv(x):
            return apply3(self._grid(x)).reshape(x.shape)

        return spmv

    def local_matvec_dot(self, comm: DeviceComm):
        """Fused ``u (size, lz, ny, nx) -> (A u, psum <u, A u>)`` for the CG
        fast path, grid-shaped in and out: one kernel pass per shard."""
        exchange = make_plane_exchange(comm)
        plain = self.force_plain

        def body(u, lo, hi, y):
            if plain:
                yp, d = stencil3d_dot_plain(u, lo, hi)
                y.copy_(yp)
                return d
            return stencil3d_dot(u, lo, hi, out=y)[1]

        run = comm.shard_map(body)

        def matvec_dot(u):
            halo_lo, halo_hi = exchange(u)
            y = torch.empty_like(u)
            parts = run(u, halo_lo, halo_hi, y)
            return y, comm.psum(parts)

        return matvec_dot

    def _many_pass(self, comm: DeviceComm, U, dot: bool):
        """One batched kernel pass per shard over ``U (size, k, lz, ny, nx)``:
        ``A U``, and with ``dot`` the psum of the per-column ``<u_j, A u_j>``
        partials, shape ``(k,)``."""
        halo_lo, halo_hi = exchange_many(comm, U)
        Y = torch.empty_like(U)
        parts = []
        for i in range(comm.size):
            lo, hi = ((None, None) if halo_lo is None
                      else (halo_lo[i], halo_hi[i]))
            if self.force_plain:
                plain = stencil3d_dot_many_plain if dot \
                    else stencil3d_apply_many_plain
                res = plain(U[i], lo, hi)
                Y[i].copy_(res[0] if dot else res)
                parts.append(res[1] if dot else None)
            elif dot:
                parts.append(stencil3d_dot_many(U[i], lo, hi, out=Y[i])[1])
            else:
                stencil3d_apply_many(U[i], lo, hi, out=Y[i])
        return (Y, comm.psum(parts)) if dot else Y

    def local_spmv_many(self, comm: DeviceComm):
        """Batched flat apply ``X (size, k, lz*ny*nx) -> A X``: one
        ``stencil7_apply_many`` launch per shard for all ``k`` columns."""
        def spmv(X):
            U = X.reshape((comm.size, X.shape[1]) + self.grid3d)
            return self._many_pass(comm, U, dot=False).reshape(X.shape)

        return spmv

    def local_matvec_dot_many(self, comm: DeviceComm):
        """Fused batched ``U (size, k, lz, ny, nx) -> (A U, psum <u_j, A
        u_j>)`` for the batched CG fast path: one ``stencil7_dot_many``
        launch per shard; the dots are ``(k,)``."""
        return lambda U: self._many_pass(comm, U, dot=True)

    # ---- Mat-compatible conveniences ----------------------------------------
    def get_vecs(self) -> tuple[Vec, Vec]:
        mk = lambda: Vec(self.comm, self.shape[0], dtype=self._dtype,
                         layout=self.layout)
        return mk(), mk()

    def diagonal(self) -> np.ndarray:
        return np.full(self.shape[0], self.uniform_diagonal)

    def mult(self, x: Vec, y: Vec | None = None) -> Vec:
        """``y = A x``."""
        data = self.local_spmv(self.comm)(
            x.data.view(self.comm.size, -1)).reshape(-1)
        if y is None:
            return Vec(self.comm, self.shape[0], data=data, layout=self.layout)
        y.data = data
        return y

    def __repr__(self):
        return (f"StencilPoisson3D({self.nx}x{self.ny}x{self.nz}, "
                f"devices={self.comm.size}, dtype={self._dtype})")
