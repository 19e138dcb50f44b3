"""Matrix-free 7-point 3D Poisson operator over z-slab shards.

The port's counterpart of ``mpi_petsc4py_example_tpu/models/stencil.py``
(``StencilPoisson3D``). No matrix is stored: each shard owns ``lz = nz/size``
contiguous z-planes, needs only its two neighbouring planes (the halo), and
applies the stencil with the kernels of :mod:`..ops.stencil`.

The local closures work on shard-stacked tensors of this process's
``L = comm.local_shards`` shards: a grid-shaped carry is ``(L, lz, ny, nx)``
and a flat one ``(L, lz*ny*nx)``, both views of the same memory as a
:class:`Vec`'s padded data. The batched (``_many``) closures take a block of
``k`` columns, ``(L, k, lz, ny, nx)`` grid-shaped or ``(L, k, lz*ny*nx)``
flat: each shard's part is the contiguous ``(k, lz, ny, nx)`` operand of the
``_many`` kernels. The Dirichlet ends of the halo exchange are the global
first and last shards (``DeviceComm.shift_open``).

With ``dtype=torch.bfloat16`` (the mixed-precision plan's storage) the slabs
and halo planes stay bfloat16 and the fused dots carry their fp32 partials
(the kernels' reduce dtype) through the shard sum.

A complex operator raises, naming ROADMAP.md Queue A item 5.8: no stencil
kernel (nor its plain version) takes complex, and the TPU route never ran
one (the JAX package's jnp body does take complex). Complex operators are
assembled ``Mat``s.
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

    ``exchange(u (L, lz, ny, nx)) -> (halo_lo, halo_hi)``, each
    ``(L, ny, nx)``: shard ``i`` gets plane ``lz-1`` of shard ``i-1`` below
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
        # plane z-1 from the shard below, plane z+lz from the shard above
        return comm.shift_open(u[:, -1], 1), comm.shift_open(u[:, 0], -1)

    return exchange


def exchange_many(comm: DeviceComm, U):
    """The batched halo exchange (the JAX ``_exchange_many``): for a block
    ``U (L, k, lz, ny, nx)`` the boundary-plane blocks ``(L, k, ny,
    nx)`` each way, one ring shift each, zero at the global Dirichlet ends.
    With one shard both halos are boundaries: returns ``(None, None)``,
    which the ``_many`` kernels take as zero planes, so no zero block of
    another width can be handed to them."""
    if comm.size == 1:
        return None, None
    # planes z-1 and z+lz of each column
    return comm.shift_open(U[:, :, -1], 1), comm.shift_open(U[:, :, 0], -1)


def check_stencil_dtype(dtype: torch.dtype) -> None:
    """Raise ``NotImplementedError`` for a complex stencil: the kernels and
    their plain versions take f32/f64/bf16, and the complex stencil is
    ROADMAP.md Queue A item 5.8."""
    if dtype.is_complex:
        raise NotImplementedError(
            f"StencilPoisson3D in {dtype} is not ported "
            "(ROADMAP.md Queue A item 5.8): no stencil kernel takes complex "
            "values; assemble the operator as a Mat (Mat.from_scipy) instead")


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
        check_stencil_dtype(self._dtype)
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
        return v.reshape((self.comm.local_shards,) + self.grid3d)

    def local_apply_grid3(self, comm: DeviceComm):
        """Grid-shaped apply ``u (L, lz, ny, nx) -> A u``."""
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
        """Flat apply ``x (L, lz*ny*nx) -> A x``: the grid apply behind
        two reshapes (views, no copies)."""
        apply3 = self.local_apply_grid3(comm)

        def spmv(x):
            return apply3(self._grid(x)).reshape(x.shape)

        return spmv

    def local_matvec_dot(self, comm: DeviceComm):
        """Fused ``u (L, lz, ny, nx) -> (A u, psum <u, A u>)`` for the CG
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
        """One batched kernel pass per shard over ``U (L, k, lz, ny, nx)``:
        ``A U``, and with ``dot`` the psum of the per-column ``<u_j, A u_j>``
        partials, shape ``(k,)``."""
        halo_lo, halo_hi = exchange_many(comm, U)
        Y = torch.empty_like(U)
        parts = []
        for i in range(comm.local_shards):
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
        """Batched flat apply ``X (L, k, lz*ny*nx) -> A X``: one
        ``stencil7_apply_many`` launch per shard for all ``k`` columns."""
        def spmv(X):
            U = X.reshape((comm.local_shards, X.shape[1]) + self.grid3d)
            return self._many_pass(comm, U, dot=False).reshape(X.shape)

        return spmv

    def local_matvec_dot_many(self, comm: DeviceComm):
        """Fused batched ``U (L, k, lz, ny, nx) -> (A U, psum <u_j, A
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

    def with_comm(self, comm: DeviceComm) -> "StencilPoisson3D":
        """The same operator on another communicator: the matrix-free
        elastic-rebuild hook (JAX ``stencil.py:291``; ``resilience/
        elastic.py``). ``nz`` must divide the new shard count."""
        return StencilPoisson3D(comm, self.nx, self.ny, self.nz,
                                dtype=self._dtype)

    def assemble(self):
        """Nothing to assemble: matrix-free (JAX ``stencil.py:332``)."""
        return self

    @property
    def assembled(self) -> bool:
        return True

    @staticmethod
    def _boundary_counts(n: int) -> np.ndarray:
        """Per index along one axis, the neighbours missing there: 1 at each
        end (2 when the axis has one point), 0 inside."""
        c = np.zeros(n)
        c[0] += 1.0
        c[n - 1] += 1.0
        return c

    def column_checksum_host(self) -> np.ndarray:
        """ABFT column checksum ``c = A^T 1`` (``resilience/abft.py``): the
        stencil is symmetric, so ``c = A 1 = 6 - (neighbours present)``,
        the integers 0-3, zero inside and positive on the six boundary
        shells (JAX ``stencil.py:309-320``). Built from three 1-D boundary
        counts, not from meshgrids: the same values, exact in every storage
        dtype."""
        cz, cy, cx = (self._boundary_counts(k)
                      for k in (self.nz, self.ny, self.nx))
        return (cz[:, None, None] + cy[None, :, None]
                + cx[None, None, :]).reshape(-1)

    def checksum_boundary(self, comm: DeviceComm) -> list:
        """Per local shard, the flat local indices of the boundary points,
        each listed once per boundary shell it lies on (corners and edges
        repeat): the sum of ``u`` over them is each shard's partial of
        ``<c, u>`` with the column checksum (:meth:`column_checksum_host`;
        ``c`` is zero inside), and the sum of ``|u|`` over them that of
        ``sum |c u|``. The global first and last z-planes belong to the
        first and last shards; every shard has its y and x faces. About
        ``2 lz (nx + ny) + nx ny`` indices a shard: the guarded stencil CG
        reads only these, not the whole grid."""
        lz, ny, nx = self.grid3d
        z = np.arange(lz)[:, None, None]
        y = np.arange(ny)[None, :, None]
        x = np.arange(nx)[None, None, :]
        ends = lambda k: np.array([0, k - 1])
        yf = (z * ny + ends(ny)[None, :, None]) * nx + x
        xf = (z * ny + y) * nx + ends(nx)[None, None, :]
        plane = (y * nx + x)[0]
        out = []
        for i in range(comm.local_shards):
            g = comm.shard_offset + i
            parts = [yf.ravel(), xf.ravel()]
            if g == 0:
                parts.append(plane.ravel())
            if g == comm.size - 1:
                parts.append(plane.ravel() + (lz - 1) * ny * nx)
            out.append(torch.from_numpy(np.concatenate(parts)).to(
                comm.device))
        return out

    def mult(self, x: Vec, y: Vec | None = None) -> Vec:
        """``y = A x``."""
        data = self.local_spmv(self.comm)(
            x.data.view(self.comm.local_shards, -1)).reshape(-1)
        if y is None:
            return Vec(self.comm, self.shape[0], data=data, layout=self.layout)
        y.data = data
        return y

    def __repr__(self):
        return (f"StencilPoisson3D({self.nx}x{self.ny}x{self.nz}, "
                f"devices={self.comm.size}, dtype={self._dtype})")
