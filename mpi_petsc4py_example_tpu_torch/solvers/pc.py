"""Preconditioners: PC ``none``, ``jacobi``, ``bjacobi``, ``lu``, ``cholesky``
and ``mg``.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/pc.py`` (``PC``,
``:67``). On a uniform-diagonal stencil operator the CG fast path never calls
:meth:`PC.local_apply` for jacobi: the Jacobi apply collapses to a scalar
there (see ``krylov.cg_stencil_kernel``); PC ``mg`` enters it grid-shaped
through :meth:`PC.local_apply_grid3d`.

The factor PCs work on an assembled :class:`..core.mat.Mat` and set up on the
host in fp64, as the JAX package does off a TPU:

* ``bjacobi``: the explicit inverses of the diagonal blocks, one block per
  shard, or more past the dense cap (``-pc_bjacobi_blocks``); the apply is
  one batched matrix product (``torch.bmm``).
* ``lu`` / ``cholesky`` (the reference's MUMPS slot): the mode is decided as
  the JAX package decides it. ``dense`` ships the padded explicit inverse and
  applies it as one matrix product; ``hostlu`` (irreducible sparsity past the
  dense cap) factors with scipy's SuperLU and applies on the host under KSP
  preonly. The cyclic-reduction modes ``crtri``/``crband`` come with the
  next slice and raise ``NotImplementedError`` here.

``-pc_setup_device``: ``auto`` resolves to the host (the JAX package inverts
on the device only on a TPU); ``1`` raises until the port's on-device
inversion lands.

On a bfloat16 operator (the mixed-precision plan's storage) jacobi stores its
inverse diagonal in bfloat16, and bjacobi/lu store their factors in bfloat16
and contract in fp32 (``ops.spmv.widened_einsum``), as the JAX package does
(``pc.py:474-483``, ``:618-632``). PC ``mg`` raises there: the JAX package
runs its V-cycle at bfloat16 through jnp, and the port's V-cycle kernels take
float32/float64 only (``ROADMAP.md`` Queue A item 5).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.spmv import widened_einsum
from ..parallel.mesh import numpy_dtype, torch_dtype
from ..utils.dtypes import is_low_precision, real_eps
from .mg import make_vcycle, make_vcycle3d

PC_TYPES = ("none", "jacobi", "bjacobi", "lu", "cholesky", "mg")

_DENSE_CAP = 16384         # host O(n^3) factorization bound (JAX pc.py:737)
_AUTO_BLOCK_TARGET = 2048  # bjacobi auto-split block size
_BCR_ELEM_CAP = 3 * 10 ** 8
_BCR_MAX_BW = 512
_NEXT_SLICE = ("the port's next slice (solvers/tridiag.py, with the "
               "eigensolver)")


class PC:
    """Preconditioner object, petsc4py-``PC``-shaped."""

    def __init__(self, comm=None):
        self.comm = comm
        self._type = "none"
        self._factor_solver_type = "tpu-dense"
        self._mat = None
        self._arrays = ()
        self._built_for = None
        self._factor_mode = "dense"   # lu/cholesky: 'dense' | 'hostlu'
        self._hostlu = None           # (SuperLU factor, fp64 csc) in hostlu
        # -pc_mg_smooth_type: 'chebyshev' (the Chebyshev-root omega schedule)
        # or 'jacobi' (fixed omega = 2/3); checked when the cycle is built
        self.mg_smoother = "chebyshev"
        self.bjacobi_blocks = 0       # -pc_bjacobi_blocks (0: one per shard,
                                      # auto-split past the dense cap)
        self.setup_device = "auto"    # -pc_setup_device: 'auto' | '1' | '0'
        self.setup_mode = None        # 'host' once a factor PC is set up

    def set_type(self, pc_type: str):
        pc_type = str(pc_type).lower()
        if pc_type not in PC_TYPES:
            raise ValueError(f"unknown PC type {pc_type!r}; available: "
                             f"{PC_TYPES}")
        if pc_type != self._type:
            self._type = pc_type
            self._built_for = None
        return self

    setType = set_type

    def get_type(self) -> str:
        return self._type

    getType = get_type

    def set_factor_solver_type(self, name: str):
        """Accepts the reference's factor package names ('mumps',
        'superlu', ...): all map to the lu modes above; recorded only."""
        self._factor_solver_type = str(name)
        return self

    setFactorSolverType = set_factor_solver_type

    def set_operators(self, mat):
        if mat is not self._mat:
            self._mat = mat
            self._built_for = None
        return self

    @property
    def kind(self) -> str:
        """The apply the solve program builds: the type, with lu/cholesky in
        host-LU mode as ``'hostlu'`` and cholesky otherwise as ``'lu'``."""
        t = self._type
        if t in ("lu", "cholesky") and self._factor_mode == "hostlu":
            return "hostlu"
        if t == "cholesky":
            return "lu"
        return t

    def program_key(self) -> tuple:
        """The PC configuration as plain values, as the JAX ``PC.program_key``
        gives it: ``(kind,)``, or ``("mg", smoother)``."""
        if self._type == "mg":
            return ("mg", self.mg_smoother)
        return (self.kind,)

    # ---- set-up ---------------------------------------------------------------
    def set_up(self, mat=None):
        """Build the PC's device data for its operator (rebuilt when the
        type, a tunable or the operator's mutation counter changed)."""
        if mat is not None:
            self.set_operators(mat)
        mat = self._mat
        if mat is None:
            raise RuntimeError("PC.set_up: no operator set")
        key = (mat, getattr(mat, "_state", 0), self._type,
               self.bjacobi_blocks, self.setup_device, self.mg_smoother)
        if self._built_for == key:
            return self
        self._hostlu = None
        self.setup_mode = None
        t = self._type
        # jacobi's inverse diagonal is made when an apply first needs it:
        # the stencil fast path never does
        if t == "bjacobi":
            self._arrays = _build_bjacobi(mat, self.bjacobi_blocks,
                                          self.setup_device)
            self.setup_mode = "host"
        elif t in ("lu", "cholesky"):
            if t == "cholesky":
                _require_symmetric(mat)
            mode = lu_mode(mat)
            if mode in ("crtri", "crband"):
                raise NotImplementedError(
                    f"PC {t!r} would take the cyclic-reduction mode {mode!r} "
                    f"for this operator (n = {mat.shape[0]} > {_DENSE_CAP}); "
                    f"that mode comes with {_NEXT_SLICE}")
            self._factor_mode = mode
            if mode == "hostlu":
                self._arrays = ()
                self._hostlu = _build_host_splu(mat, t)
            else:
                self._arrays = _build_dense_lu(mat, self.setup_device)
            self.setup_mode = "host"
        else:
            self._arrays = ()
        self._built_for = key
        return self

    setUp = set_up

    def _jacobi_inverse(self):
        """The shard-stacked inverse diagonal ``(size, lsize)`` of the
        operator (0 where the diagonal is 0), made once per set-up."""
        if not self._arrays:
            self._arrays = (self._inv_diag(self._mat),)
        return self._arrays[0]

    def _inv_diag(self, mat):
        comm = mat.comm
        diag = mat.diagonal()
        if is_low_precision(mat.dtype):
            # the JAX package divides in the diagonal's own bfloat16
            # arithmetic (an fp32 quotient, rounded once): so does this
            diag = diag.astype(np.float32)
        inv = np.where(diag != 0, 1.0 / np.where(diag == 0, 1.0, diag), 0.0)
        return comm.put_rows(inv, mat.dtype).view(comm.size, -1)

    def _mg_operator(self):
        """The operator the V-cycle is built for; raises ``ValueError`` when
        it is not a structured stencil operator (JAX ``pc.py:341-345``)."""
        op = self._mat
        if op is None:
            raise RuntimeError("PC mg: no operator set")
        if not all(hasattr(op, a) for a in ("nx", "ny", "nz")):
            raise ValueError(
                "PC 'mg' is the geometric multigrid V-cycle for "
                "structured stencil operators (models.StencilPoisson3D)")
        if is_low_precision(op.dtype):
            raise NotImplementedError(
                f"PC 'mg' on {op.dtype} storage is not ported: the V-cycle "
                "kernels take float32/float64 (ROADMAP.md Queue A item 5 "
                "brings the bfloat16 V-cycle); use pc 'jacobi', or f32 "
                "inner precision")
        return op

    # ---- the applies the Krylov loops run -------------------------------------
    def local_apply(self, comm, n: int):
        """``z = M r`` on shard-stacked ``(size, lsize)`` tensors."""
        if self._type == "mg":
            op = self._mg_operator()
            return make_vcycle(op.nz, op.ny, op.nx, comm=comm,
                               smoother=self.mg_smoother,
                               plain=getattr(op, "force_plain", False))
        if self._type == "none":
            return lambda r: r
        k = self.set_up().kind
        if k == "hostlu":
            raise ValueError(
                "PC 'lu'/'cholesky' is in host sparse-LU mode (irreducible "
                "sparsity past the dense cap); the factor applies on the "
                "host, which an iterative loop cannot call per iteration: "
                "use KSP 'preonly', or an iterative KSP with pc "
                "'bjacobi'/'jacobi'")
        if k == "jacobi":
            inv_d = self._jacobi_inverse()
            return lambda r: r * inv_d
        if k == "bjacobi":
            binv = self._arrays[0]          # (size * nb, bs, bs)
            nblk, bs = binv.shape[0], binv.shape[1]

            def apply(r):
                return widened_einsum("bij,bj->bi", binv,
                                      r.reshape(nblk, bs)).view(r.shape)
            return apply
        minv = self._arrays[0]              # lu: (n_pad, n_pad), replicated

        def apply(r):
            return widened_einsum("ij,j->i", minv,
                                  comm.all_gather(r)).view(r.shape)
        return apply

    def local_apply_many(self, comm, n: int):
        """Batched ``Z = M R`` on ``(size, k, lsize)`` blocks (JAX
        ``pc.py:601``), or None when the kind has no batched apply (mg,
        hostlu: ``KSP.solve_many`` then solves column by column)."""
        if self._type == "none":
            return lambda R: R
        if self._type == "mg":
            return None
        k = self.set_up().kind
        if k == "hostlu":
            return None
        if k == "jacobi":
            inv_d = self._jacobi_inverse()[:, None, :]
            return lambda R: R * inv_d
        size, lsize = comm.size, comm.local_size(n)
        if k == "bjacobi":
            binv = self._arrays[0]
            nb, bs = binv.shape[0] // size, binv.shape[1]

            def apply(R):
                cols = R.shape[1]
                Rb = R.reshape(size, cols, nb, bs).permute(0, 2, 3, 1)
                Z = widened_einsum("bij,bjc->bic", binv,
                                   Rb.reshape(size * nb, bs, cols))
                return Z.view(size, nb, bs, cols).permute(0, 3, 1, 2) \
                    .reshape(R.shape)
            return apply
        minv = self._arrays[0]

        def apply(R):
            cols = R.shape[1]
            Rf = R.transpose(1, 2).reshape(-1, cols)     # (n_pad, k)
            Z = widened_einsum("ij,jc->ic", minv, Rf)
            return Z.view(size, lsize, cols).transpose(1, 2).contiguous()
        return apply

    def local_apply_grid3d(self, comm):
        """Grid-shaped apply ``z = M3(r)`` on ``(size, lz, ny, nx)`` tensors
        for the stencil-CG fast path, or None (JAX ``pc.py:641-657``). Only
        ``mg`` has one: the V-cycle; the diagonal kinds collapse to scalars
        there instead. The operator's ``force_plain`` switch sends the
        cycle's passes to their plain versions too."""
        if self._type != "mg":
            return None
        op = self._mg_operator()
        return make_vcycle3d(op.nz, op.ny, op.nx, comm=comm,
                             smoother=self.mg_smoother,
                             plain=getattr(op, "force_plain", False))

    def __repr__(self):
        return (f"PC(type={self._type!r}, "
                f"factor={self._factor_solver_type!r})")


# ---- set-up helpers (the host paths of the JAX package's builders) ----------

def _require_assembled(mat, pc_name: str):
    if not hasattr(mat, "to_scipy"):
        raise ValueError(
            f"PC {pc_name!r} factorizes the assembled matrix; matrix-free "
            f"operators ({type(mat).__name__}) work with pc "
            "'none'/'jacobi'/'mg' instead")


def _require_symmetric(mat):
    """PC cholesky needs a symmetric operator (JAX ``pc.py:271-286``), to a
    tolerance that scales with the operator's dtype."""
    _require_assembled(mat, "cholesky")
    S = mat.to_scipy()
    D = (S - S.T).tocsr()
    scale = abs(S).max() or 1.0
    rel = max(1e-10, 100 * real_eps(mat.dtype))
    if D.nnz and abs(D).max() > rel * scale:
        raise ValueError("PC 'cholesky' needs a symmetric (Hermitian) "
                         "operator — use pc 'lu' for unsymmetric matrices")


def _want_device_setup(setup_device) -> bool:
    """Resolve ``-pc_setup_device``: 'auto' and '0' mean the host (the JAX
    package inverts on the device only on a TPU); '1' is not ported."""
    s = str(setup_device).lower()
    if s in ("0", "false", "host", "no", "auto"):
        return False
    if s in ("1", "true", "device", "yes"):
        raise NotImplementedError(
            "-pc_setup_device 1: the on-device block/dense inversion is not "
            "ported yet (a later slice); use 'auto' or '0'")
    raise ValueError(
        f"-pc_setup_device {setup_device!r}: expected 'auto', '0' or '1'")


def _per_device_inverse(A, n, lsize, ndev, block_inv, host_dt=np.float64):
    """``(ndev, lsize, lsize)`` stack of ``block_inv`` of the diagonal
    blocks of the host CSR ``A``; padding rows get identity, so padded
    vector slots pass through unchanged."""
    inv = np.zeros((ndev, lsize, lsize), dtype=host_dt)
    for d in range(ndev):
        rs, re = d * lsize, min((d + 1) * lsize, n)
        inv[d] = np.eye(lsize)
        if rs < n:
            m = re - rs
            inv[d, :m, :m] = block_inv(A[rs:re, rs:re])
    return inv


def _bjacobi_block_count(lsize: int, ndev: int, blocks: int) -> int:
    """Blocks per shard for PC bjacobi. ``blocks`` is PETSc's total count
    (``-pc_bjacobi_blocks``; 0: one per shard, auto-split past the dense
    cap into blocks near ``_AUTO_BLOCK_TARGET`` rows that tile the shard
    evenly)."""
    if blocks < 0:
        blocks = 0
    if blocks:
        if blocks % ndev:
            raise ValueError(
                f"-pc_bjacobi_blocks {blocks} must be a multiple of the "
                f"device count {ndev}")
        nb = blocks // ndev
        if lsize % nb:
            raise ValueError(
                f"-pc_bjacobi_blocks: {nb} blocks/device must divide the "
                f"local row count {lsize}")
        return nb
    if lsize <= _DENSE_CAP:
        return 1
    nb = -(-lsize // _AUTO_BLOCK_TARGET)
    while lsize % nb and lsize // nb > _AUTO_BLOCK_TARGET // 8:
        nb += 1
    if lsize % nb:
        raise ValueError(
            f"PC 'bjacobi' cannot auto-split {lsize} local rows into even "
            "dense blocks — set -pc_bjacobi_blocks explicitly or use pc "
            "'jacobi'")
    return nb


def _dense_diag_blocks(A, n: int, bs: int, nblocks: int, dt) -> np.ndarray:
    """``(nblocks, bs, bs)`` dense diagonal blocks of the host CSR ``A``;
    padding rows get identity."""
    return _per_device_inverse(A, n, bs, nblocks, lambda B: B.toarray(),
                               host_dt=dt)


def _ship_blocks(comm, blocks: np.ndarray, dtype):
    """The block stack on the device in the operator's dtype (shard ``i``
    owns blocks ``i * nb`` to ``(i + 1) * nb - 1``; bfloat16 rounded from
    the host values through fp32, as ``ml_dtypes`` rounds them)."""
    return (torch.tensor(blocks.astype(numpy_dtype(dtype)),
                         dtype=torch_dtype(dtype), device=comm.device),)


def _build_bjacobi(mat, blocks: int = 0, setup_device: str = "auto"):
    """Inverses of the diagonal blocks, fp64 LAPACK on the host (the host
    path of JAX ``_build_bjacobi``, ``pc.py:798``, ``:865-880``)."""
    import scipy.linalg
    _require_assembled(mat, "bjacobi")
    _want_device_setup(setup_device)
    comm = mat.comm
    n = mat.shape[0]
    lsize = comm.local_size(n)
    nb = _bjacobi_block_count(lsize, comm.size, int(blocks))
    if lsize // nb > _DENSE_CAP:
        raise ValueError(
            f"PC 'bjacobi' blocks are dense ({lsize // nb}x{lsize // nb}); "
            "too large — raise -pc_bjacobi_blocks, use more devices, or pc "
            "'jacobi'")
    inv = _per_device_inverse(
        mat.to_scipy().tocsr(), n, lsize // nb, comm.size * nb,
        lambda B: scipy.linalg.inv(B.toarray().astype(np.float64)))
    return _ship_blocks(comm, inv, mat.dtype)


def _bcr_elements(n: int, b: int) -> int:
    """Elements the block cyclic-reduction factor stores for (n, band b)."""
    N = -(-n // b)
    S = max(1, int(np.ceil(np.log2(N)))) if N > 1 else 1
    return (2 * S + 1) * N * b * b


def _bcr_fits(n: int, b: int) -> bool:
    return 1 < b <= _BCR_MAX_BW and _bcr_elements(n, b) <= _BCR_ELEM_CAP


def _rcm_bandwidth(mat):
    """Reverse Cuthill-McKee ordering of ``mat``, the bandwidth it achieves
    and the permuted matrix (JAX ``pc.py:1177``)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    A = mat.to_scipy().tocsr()
    perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=False),
                      dtype=np.int64)
    Ap = A[perm][:, perm].tocsr()
    coo = Ap.tocoo()
    bw = int(np.max(np.abs(coo.row - coo.col))) if coo.nnz else 0
    return perm, bw, Ap


def lu_mode(mat) -> str:
    """The factorization PC lu/cholesky takes for ``mat``, decided as the
    JAX package decides it (``pc.py:287-327``): ``'dense'`` up to the dense
    cap; past it ``'crtri'`` for a tridiagonal DIA matrix, ``'crband'`` for
    a band (as stored, or after RCM) that fits the block cyclic-reduction
    caps, else ``'hostlu'``."""
    _require_assembled(mat, "lu")
    offs = set(getattr(mat, "dia_offsets", ()) or ())
    bw = max((abs(int(o)) for o in offs), default=0)
    n = mat.shape[0]
    if n <= _DENSE_CAP:
        return "dense"
    if offs and offs <= {-1, 0, 1}:
        return "crtri"
    if offs and 1 < bw and _bcr_fits(n, bw):
        return "crband"
    _, bw_rcm, _ = _rcm_bandwidth(mat)
    return "crband" if _bcr_fits(n, max(bw_rcm, 2)) else "hostlu"


def _build_host_splu(mat, pc_type: str):
    """Host sparse LU (scipy SuperLU, fp64), the MUMPS slot's
    irreducible-sparsity mode; applied by ``KSP._solve_hostlu``."""
    from scipy.sparse.linalg import splu
    _require_assembled(mat, pc_type)
    A64 = mat.to_scipy().astype(np.float64).tocsc()
    return splu(A64), A64


def dense_inverse_padded(comm, M, dtype, too_large: str):
    """The explicit inverse of the host sparse matrix ``M``, made on the host
    in fp64, zero-padded to the communicator's padded size, on the device in
    ``dtype``: what PC lu (dense) and the factoring ST transformations apply
    as one matrix product, replicated. Past ``_DENSE_CAP`` rows it raises
    ``ValueError(too_large)``."""
    import scipy.linalg
    n = M.shape[0]
    if n > _DENSE_CAP:
        raise ValueError(too_large)
    n_pad = comm.padded_size(n)
    inv_pad = np.zeros((n_pad, n_pad), dtype=np.float64)
    inv_pad[:n, :n] = scipy.linalg.inv(M.toarray().astype(np.float64))
    return _ship_blocks(comm, inv_pad, dtype)[0]


def _build_dense_lu(mat, setup_device: str = "auto"):
    """The padded explicit inverse of the whole operator, factored on the
    host in fp64 (the host path of JAX ``_build_dense_lu``, ``:1330-1338``);
    the device applies it as one matrix product, replicated."""
    _require_assembled(mat, "lu")
    _want_device_setup(setup_device)
    return (dense_inverse_padded(
        mat.comm, mat.to_scipy(), mat.dtype,
        f"PC 'lu' densifies general operators; n={mat.shape[0]} is too "
        "large"),)
