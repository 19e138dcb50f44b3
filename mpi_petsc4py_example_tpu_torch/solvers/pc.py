"""Preconditioners: PC ``none``, ``jacobi``, ``bjacobi``, ``sor``, ``ssor``,
``ilu``, ``icc``, ``asm``, ``lu``, ``cholesky``, ``mg``, ``shell`` and
``composite``.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/pc.py`` (``PC``,
``:67``). On a uniform-diagonal stencil operator the CG fast path never calls
:meth:`PC.local_apply` for jacobi: the Jacobi apply collapses to a scalar
there (see ``krylov.cg_stencil_kernel``); PC ``mg`` enters it grid-shaped
through :meth:`PC.local_apply_grid3d`.

The factor PCs work on an assembled :class:`..core.mat.Mat`:

* ``bjacobi``: the explicit inverses of the diagonal blocks, one block per
  shard, or more past the dense cap (``-pc_bjacobi_blocks``); the apply is
  one batched matrix product (``torch.bmm``).
* ``sor``/``ssor`` (``-pc_sor_omega``), ``ilu``/``icc`` (``-pc_factor_fill``;
  ``icc`` is the same incomplete LU, as in the JAX package): per-shard dense
  blocks made by host block algebra, applied as bjacobi is.
* ``asm`` (``-pc_asm_overlap``): restricted additive Schwarz; each shard
  inverts its rows widened by the overlap, takes its two halos from its
  neighbours (``comm.shift``) and keeps the owned interior.
* ``lu`` / ``cholesky`` (the reference's MUMPS slot): the mode is decided as
  the JAX package decides it. ``dense`` ships the padded explicit inverse and
  applies it as one matrix product; past the dense cap ``crtri`` (a
  tridiagonal) and ``crband`` (a band as stored, or after a reverse
  Cuthill-McKee permutation) solve by parallel cyclic reduction
  (``solvers/tridiag.py``) on the gathered vector; ``hostlu`` (irreducible
  sparsity) factors with scipy's SuperLU and applies on the host under KSP
  preonly.

``-pc_setup_device`` ('auto' | '1' | '0') places the set-up of bjacobi, dense
lu and crband: '1' on the communicator's device, '0' on the host in fp64,
'auto' on the device when it is CUDA and the operator is fp32 or fp64 (see
:func:`_want_device_setup`). The device inverses are ``torch.linalg.inv_ex``
plus two Newton steps behind the JAX package's quality gate; a gate or probe
that fails sends the set-up to the host, ``setup_mode`` says which ran, and
an exception on the device propagates.

The user PCs: ``shell`` applies a torch callable on the whole vector
(``set_shell_apply``; lifted like a ``ShellMat``'s ``mult``), ``composite``
combines child PCs, additive (``z = sum_i M_i r``) or multiplicative (``z <-
z + M_i (r - A z)`` over the PC operator's product). :meth:`PC.local_apply_transpose`
is PETSc's PCApplyTranspose, the shadow preconditioner of KSP bicg.

On a bfloat16 operator (the mixed-precision plan's storage) jacobi stores its
inverse diagonal in bfloat16, and the block and lu factors are stored in
bfloat16 and contract in fp32 (``ops.spmv.widened_einsum``), as the JAX
package does (``pc.py:474-483``, ``:618-632``). PC ``mg`` raises there: the
JAX package runs its V-cycle at bfloat16 through jnp, and the port's V-cycle
kernels take float32/float64 only (``ROADMAP.md`` Queue A item 5).
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.spmv import widened_einsum
from ..parallel.mesh import full_vector_local_apply, numpy_dtype, torch_dtype
from ..utils.dtypes import host_dtype, is_low_precision, real_eps
from .mg import make_vcycle, make_vcycle3d
from .tridiag import (banded_to_blocks, bpcr_apply, bpcr_setup,
                      bpcr_setup_device_csr, pcr_apply, pcr_setup,
                      polished_inverse)

PC_TYPES = ("none", "jacobi", "bjacobi", "lu", "cholesky", "mg",
            "sor", "ssor", "ilu", "icc", "asm", "shell", "composite")
# the JAX package's other types, and the ROADMAP.md Queue A item each awaits
_UNPORTED = {"gamg": 7, "amg": 7}
_COMPOSITE_TYPES = ("additive", "multiplicative")
# shell applies are numbered, so two PCs with different functions never
# share a program key (as ShellMat's are)
_shell_uid = itertools.count(1)
# the kinds whose applies are per-shard dense blocks, as bjacobi's
_BLOCK_TYPES = ("sor", "ssor", "ilu", "icc")

_DENSE_CAP = 16384         # host O(n^3) factorization bound (JAX pc.py:737)
_AUTO_BLOCK_TARGET = 2048  # bjacobi auto-split block size
_CR_CAP = 1 << 23          # replicated (S, n) PCR sweep arrays
# block cyclic reduction stores (2S+1)·N·b² elements, replicated: the caps
# bound that footprint (JAX pc.py:429-453)
_BCR_ELEM_CAP = 3 * 10 ** 8
_BCR_MAX_BW = 512
_DEVICE_INV_GATE = 1e-2    # post-polish max|I - B X| acceptance bound


class PC:
    """Preconditioner object, petsc4py-``PC``-shaped."""

    def __init__(self, comm=None):
        self.comm = comm
        self._type = "none"
        self._factor_solver_type = "tpu-dense"
        self._mat = None
        self._arrays = ()
        self._built_for = None
        # lu/cholesky: 'dense' | 'crtri' | 'crband' | 'hostlu'
        self._factor_mode = "dense"
        self._hostlu = None           # (SuperLU factor, fp64 csc) in hostlu
        # -pc_mg_smooth_type: 'chebyshev' (the Chebyshev-root omega schedule)
        # or 'jacobi' (fixed omega = 2/3); checked when the cycle is built
        self.mg_smoother = "chebyshev"
        self.bjacobi_blocks = 0       # -pc_bjacobi_blocks (0: one per shard,
                                      # auto-split past the dense cap)
        self.sor_omega = 1.0          # -pc_sor_omega (PETSc default 1)
        self.asm_overlap = 1          # -pc_asm_overlap (PETSc default 1)
        self.factor_fill = 10.0       # -pc_factor_fill (spilu fill_factor)
        self.setup_device = "auto"    # -pc_setup_device: 'auto' | '1' | '0'
        self.setup_mode = None        # 'device' | 'host' once a factor PC
                                      # is set up
        self.setup_breakdown = None   # device set-up: extract_s, invert_s
        # PC shell: the user's apply (and transpose) on the whole vector
        self._shell_apply = None
        self._shell_apply_t = None
        self._shell_uid = 0
        # PC composite: the children and how they combine
        self.composite_type = "additive"   # PETSc's PC_COMPOSITE_ADDITIVE
        self._sub_pcs: list[PC] = []

    def set_type(self, pc_type: str):
        pc_type = str(pc_type).lower()
        if pc_type in _UNPORTED:
            raise NotImplementedError(
                f"PC {pc_type!r} is not ported yet (ROADMAP.md Queue A item "
                f"{_UNPORTED[pc_type]})")
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

    # ---- PC shell ---------------------------------------------------------------
    def set_shell_apply(self, fn):
        """PCShellSetApply: ``z = fn(r)`` on the whole global residual, a
        tensor on the communicator's device."""
        self._shell_apply = fn
        self._shell_uid = next(_shell_uid)
        self._built_for = None
        return self

    setShellApply = set_shell_apply

    def set_shell_apply_transpose(self, fn):
        """PCShellSetApplyTranspose: ``z = fn(r)`` for ``M^T`` (KSP bicg with
        a shell PC)."""
        self._shell_apply_t = fn
        self._shell_uid = next(_shell_uid)
        self._built_for = None
        return self

    setShellApplyTranspose = set_shell_apply_transpose

    # ---- PC composite -----------------------------------------------------------
    def set_composite_type(self, ctype: str):
        """'additive' (``z = sum_i M_i r``) or 'multiplicative' (each child
        corrects the residual of the sum so far, through the operator)."""
        ctype = str(ctype).lower()
        if ctype not in _COMPOSITE_TYPES:
            raise ValueError(f"unknown composite type {ctype!r}; "
                             f"available: {_COMPOSITE_TYPES}")
        if ctype != self.composite_type:
            self.composite_type = ctype
            self._built_for = None
        return self

    setCompositeType = set_composite_type

    def set_composite_pcs(self, *types):
        """Replace the children with new PCs of the given types
        (PCCompositeAddPCType, once per type)."""
        if len(types) == 1 and isinstance(types[0], (list, tuple)):
            types = tuple(types[0])
        self._sub_pcs = []
        for t in types:
            self.add_composite_pc(t)
        return self

    setCompositePCs = set_composite_pcs

    def add_composite_pc(self, pc_type: str) -> "PC":
        child = PC(self.comm)
        child.set_type(pc_type)
        self._sub_pcs.append(child)
        self._built_for = None
        return child

    addCompositePC = add_composite_pc

    def get_composite_pc(self, i: int) -> "PC":
        """Child ``i``; tune its options before ``set_up``."""
        return self._sub_pcs[i]

    getCompositePC = get_composite_pc

    def set_operators(self, mat):
        if mat is not self._mat:
            self._mat = mat
            self._built_for = None
        return self

    @property
    def kind(self) -> str:
        """The apply the solve program builds: the type, with lu/cholesky as
        their factor mode (``'lu'`` for dense, ``'crtri'``, ``'crband'``,
        ``'hostlu'``) and sor/ssor/ilu/icc as ``'bjacobi'``, whose apply
        they share."""
        t = self._type
        if t in ("lu", "cholesky"):
            return "lu" if self._factor_mode == "dense" else self._factor_mode
        if t in _BLOCK_TYPES:
            return "bjacobi"
        return t

    def program_key(self) -> tuple:
        """The PC configuration as plain values, as the JAX ``PC.program_key``
        gives it: ``(kind,)``, ``("asm", overlap)``, ``("crtri", S)``,
        ``("crband", arrays, S, N, b)`` or ``("mg", smoother)``."""
        k = self.kind
        if k == "asm":
            return ("asm", int(self.asm_overlap))
        if k == "crtri":
            return ("crtri", int(self._arrays[0].shape[0]))
        if k == "crband":
            return ("crband", len(self._arrays)) + tuple(
                int(s) for s in self._arrays[0].shape[:3])
        if k == "mg":
            return ("mg", self.mg_smoother)
        if k == "shell":
            return ("shell", self._shell_uid)
        if k == "composite":
            # the multiplicative apply runs the operator's product
            mat_key = (self._mat.program_key()
                       if (self.composite_type == "multiplicative"
                           and self._mat is not None) else ())
            return (("composite", self.composite_type, mat_key)
                    + tuple(c.program_key() for c in self._sub_pcs))
        return (k,)

    def _tunables_key(self) -> tuple:
        """Every setting the built PC depends on, recursively through the
        composite children: the rebuild part of the set-up key."""
        return (self._type, self.bjacobi_blocks, self.sor_omega,
                self.asm_overlap, self.factor_fill, self.setup_device,
                self.mg_smoother, self._shell_uid, self.composite_type,
                tuple(c._tunables_key() for c in self._sub_pcs))

    # ---- set-up ---------------------------------------------------------------
    def set_up(self, mat=None):
        """Build the PC's device data for its operator (rebuilt when the
        type, a tunable or the operator's mutation counter changed)."""
        if mat is not None:
            self.set_operators(mat)
        mat = self._mat
        if mat is None:
            raise RuntimeError("PC.set_up: no operator set")
        key = (mat, getattr(mat, "_state", 0), self._tunables_key())
        if self._built_for == key:
            return self
        self._hostlu = None
        self.setup_mode = None
        self.setup_breakdown = None
        t = self._type
        # jacobi's inverse diagonal is made when an apply first needs it:
        # the stencil fast path never does
        self._arrays = ()
        if t == "bjacobi":
            self._arrays, self.setup_mode, self.setup_breakdown = \
                _build_bjacobi(mat, self.bjacobi_blocks, self.setup_device)
        elif t in ("sor", "ssor"):
            self._arrays = _build_block_ssor(mat, self.sor_omega)
        elif t in ("ilu", "icc"):
            self._arrays = _build_block_ilu(mat, self.factor_fill)
        elif t == "asm":
            self._arrays = _build_asm(mat, self.asm_overlap)
        elif t in ("lu", "cholesky"):
            self._set_up_factor(mat, t)
        elif t == "shell":
            if self._shell_apply is None:
                raise RuntimeError(
                    "PC 'shell' has no apply function — call "
                    "set_shell_apply(fn) first")
        elif t == "composite":
            if not self._sub_pcs:
                raise RuntimeError(
                    "PC 'composite' has no children — call "
                    "set_composite_pcs('jacobi', 'sor', ...) first")
            for child in self._sub_pcs:
                child.set_up(mat)
        self._built_for = key
        return self

    setUp = set_up

    def _set_up_factor(self, mat, t):
        """PC lu/cholesky: decide the mode (JAX ``pc.py:287-327``) and
        build it. The RCM ordering that decided ``crband`` is reused."""
        if t == "cholesky":
            _require_symmetric(mat)
        mode, bw, perm, A_perm = _lu_plan(mat)
        self._factor_mode = mode
        self.setup_mode = "host"
        if mode == "dense":
            self._arrays, self.setup_mode, self.setup_breakdown = \
                _build_dense_lu(mat, self.setup_device)
        elif mode == "crtri":
            self._arrays = _build_tridiag_cr(mat)
        elif mode == "crband":
            self._arrays, self.setup_mode, self.setup_breakdown = \
                _build_banded_bcr(mat, bw, perm, A_perm, self.setup_device)
        else:
            self._hostlu = _build_host_splu(mat, t)

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
        if k == "asm":
            return self._asm_apply(comm, n)
        if k in ("crtri", "crband"):
            return self._cr_apply(comm, n)
        if k == "shell":
            return full_vector_local_apply(self._shell_apply, comm, n)
        if k == "composite":
            return self._composite_apply(comm, n)
        minv = self._arrays[0]              # lu: (n_pad, n_pad), replicated

        def apply(r):
            return widened_einsum("ij,j->i", minv,
                                  comm.all_gather(r)).view(r.shape)
        return apply

    def _composite_apply(self, comm, n):
        """PC composite (JAX ``pc.py:562-590``): additive sums the
        children's applies; multiplicative runs them in turn, each on the
        residual ``r - A z`` of the sum so far (the first on ``r``)."""
        subs = [c.local_apply(comm, n) for c in self._sub_pcs]
        if self.composite_type == "additive":
            def apply(r):
                z = torch.zeros_like(r)
                for ap in subs:
                    z = z + ap(r)
                return z
            return apply
        spmv = self._mat.local_spmv(comm)

        def apply(r):
            z = None
            for ap in subs:
                z = ap(r) if z is None else z + ap(r - spmv(z))
            return z
        return apply

    def local_apply_transpose(self, comm, n: int):
        """``z = M^T r`` on shard-stacked tensors (PETSc's PCApplyTranspose,
        the shadow preconditioner of KSP bicg; JAX ``pc.py:659``), or None
        when the kind has none. The diagonal kinds and the V-cycle are
        symmetric and reuse the forward apply, as does cholesky's
        cyclic-reduction solve; bjacobi and its block kinds and dense lu
        transpose their explicit inverses; composite additive sums its
        children's transposes; shell takes ``set_shell_apply_transpose``'s
        function. asm, lu's cyclic-reduction modes and composite
        multiplicative have none."""
        if self._type not in ("none", "mg"):
            self.set_up()
        k = self.kind
        if k in ("none", "jacobi", "mg"):
            return self.local_apply(comm, n)
        if k in ("crtri", "crband") and self._type == "cholesky":
            return self.local_apply(comm, n)
        if k == "bjacobi":
            binv = self._arrays[0]
            nblk, bs = binv.shape[0], binv.shape[1]

            def apply_t(r):
                return widened_einsum("bij,bi->bj", binv,
                                      r.reshape(nblk, bs)).view(r.shape)
            return apply_t
        if k == "lu":
            minv = self._arrays[0]

            def apply_t(r):
                return widened_einsum("ji,j->i", minv,
                                      comm.all_gather(r)).view(r.shape)
            return apply_t
        if k == "shell":
            if self._shell_apply_t is None:
                return None
            return full_vector_local_apply(self._shell_apply_t, comm, n)
        if k == "composite" and self.composite_type == "additive":
            subs = [c.local_apply_transpose(comm, n) for c in self._sub_pcs]
            if any(ap is None for ap in subs):
                return None

            def apply_t(r):
                z = torch.zeros_like(r)
                for ap in subs:
                    z = z + ap(r)
                return z
            return apply_t
        return None

    def _asm_apply(self, comm, n):
        """Restricted additive Schwarz (JAX ``pc.py:485-507``): shard ``i``
        receives the last ``ov`` rows of shard ``i - 1`` and the first ``ov``
        of shard ``i + 1``, applies its window inverse and keeps its owned
        rows. The wrapped halos at the ends meet identity-padded window
        slots, so they never reach an owned row."""
        ov = int(self.asm_overlap)
        winv = self._arrays[0]              # (size, lsize + 2 ov, ...)
        lsize = comm.local_size(n)

        def apply(r):
            if ov:
                r = torch.cat([comm.shift(r[:, lsize - ov:], 1), r,
                               comm.shift(r[:, :ov], -1)], dim=1)
            z = widened_einsum("bij,bj->bi", winv, r)
            return z[:, ov:ov + lsize].contiguous()
        return apply

    def _cr_apply(self, comm, n):
        """The cyclic-reduction solve (JAX ``pc.py:516-552``) on the gathered
        vector: its first ``n`` rows, permuted when RCM reordered the
        operator (``P A P^T y = P r``, ``x = P^T y``), zero-padded back to
        the shard layout."""
        arrs = self._arrays
        n_pad = comm.padded_size(n)
        if self.kind == "crtri":
            def solve(d):
                return pcr_apply(d, *arrs)
        else:
            nb = arrs[2].shape[0] * arrs[2].shape[1]
            perm, iperm = arrs[3:] if len(arrs) == 5 else (None, None)

            def solve(d):
                if perm is not None:
                    d = d[perm]
                if nb > n:          # the identity-padded tail block's rows
                    d = F.pad(d, (0, nb - n))
                x = bpcr_apply(d, *arrs[:3])[:n]
                return x if iperm is None else x[iperm]

        def apply(r):
            x = solve(comm.all_gather(r)[:n])
            if n_pad > n:           # padding slots pass through as zero
                x = F.pad(x, (0, n_pad - n))
            return x.view(r.shape)
        return apply

    def local_apply_many(self, comm, n: int):
        """Batched ``Z = M R`` on ``(size, k, lsize)`` blocks (JAX
        ``pc.py:601``), or None when the kind has no batched apply (mg, asm,
        crtri, crband, hostlu: ``KSP.solve_many`` then solves column by
        column)."""
        if self._type == "none":
            return lambda R: R
        if self._type == "mg":
            return None
        k = self.set_up().kind
        if k not in ("jacobi", "bjacobi", "lu"):
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


# ---- set-up helpers ------------------------------------------------------------

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


def _want_device_setup(device, dtype, setup_device, f64_ok: bool = False
                       ) -> bool:
    """Resolve ``-pc_setup_device`` for a communicator on ``device`` (a
    ``torch.device``) and an operator of ``dtype`` (JAX ``pc.py:883-908``,
    with CUDA in the TPU's place): '0' is the host, '1' the device program
    on either device; 'auto' is the device on CUDA for float32, or float64
    when the caller passes ``f64_ok`` (bjacobi, dense lu and block PCR all
    do: CUDA has a native fp64 LU), and the host otherwise (on the CPU the
    device program would be host LAPACK again; bfloat16 has no LU)."""
    s = str(setup_device).lower()
    if s in ("0", "false", "host", "no"):
        return False
    if s in ("1", "true", "device", "yes"):
        return True
    if s != "auto":
        raise ValueError(
            f"-pc_setup_device {setup_device!r}: expected 'auto', '0' or '1'")
    if torch.device(device).type != "cuda":
        return False
    dt = torch_dtype(dtype)
    return dt == torch.float32 or (f64_ok and dt == torch.float64)


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


def _to_device(comm, arr: np.ndarray, dtype) -> torch.Tensor:
    """A host array on the device in the operator's dtype (bfloat16 rounded
    from the host values through fp32, as ``ml_dtypes`` rounds them)."""
    return torch.tensor(arr.astype(numpy_dtype(dtype)),
                        dtype=torch_dtype(dtype), device=comm.device)


def _synced(device):
    """``time.perf_counter()`` once the device's queued work is done."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _build_bjacobi(mat, blocks: int = 0, setup_device: str = "auto"):
    """Inverses of the diagonal blocks (JAX ``_build_bjacobi``,
    ``pc.py:798``), as ``(arrays, setup_mode, setup_breakdown)``. On the
    device (:func:`_want_device_setup`) the blocks are cut from the
    device-resident ELL (:func:`_ell_diag_blocks`) and inverted there
    (:func:`_device_inverse`); otherwise, or when the quality gate rejects
    that inverse, fp64 LAPACK on the host inverts them, from the already
    extracted stack in the second case."""
    import scipy.linalg
    _require_assembled(mat, "bjacobi")
    comm = mat.comm
    n = mat.shape[0]
    lsize = comm.local_size(n)
    nb = _bjacobi_block_count(lsize, comm.size, int(blocks))
    bs = lsize // nb
    if bs > _DENSE_CAP:
        raise ValueError(
            f"PC 'bjacobi' blocks are dense ({bs}x{bs}); too large — raise "
            "-pc_bjacobi_blocks, use more devices, or pc 'jacobi'")
    host_dt = host_dtype(mat.dtype)
    if _want_device_setup(comm.device, mat.dtype, setup_device, f64_ok=True):
        t0 = time.perf_counter()
        blk = _ell_diag_blocks(mat.ell_cols, mat.ell_vals, bs, n)
        t1 = _synced(comm.device)
        inv = _device_inverse(blk)
        if inv is not None:
            return (inv,), "device", _breakdown(t0, t1, comm.device)
        inv = np.stack([scipy.linalg.inv(b.astype(host_dt))
                        for b in comm.host_fetch(blk)])
    else:
        inv = _per_device_inverse(
            mat.to_scipy().tocsr(), n, bs, comm.size * nb,
            lambda B: scipy.linalg.inv(B.toarray().astype(host_dt)))
    return (_to_device(comm, inv, mat.dtype),), "host", None


def _breakdown(t0, t1, device) -> dict:
    """A device set-up's ``setup_breakdown``: ``extract_s`` (the operator's
    blocks made, ``t0`` to ``t1``) and ``invert_s`` (``t1`` to now, once
    the device is done)."""
    return {"extract_s": round(t1 - t0, 4),
            "invert_s": round(_synced(device) - t1, 4)}


def _inv_polish(B: torch.Tensor):
    """Batched inverse (``torch.linalg.inv_ex``) plus two Newton steps
    (:func:`..tridiag.polished_inverse`), and the quality ``max|I - B X|``
    as a 0-d tensor: inf when any entry is not finite, as when a block was
    singular (JAX ``_inv_polish``, ``pc.py:936``). The products run in the
    operand's dtype; TF32 must be off for fp32 operands. The JAX package's
    f32-seeded variant (``_inv_polish_seeded``) works around XLA:TPU's
    missing fp64 LU and has no counterpart here."""
    if is_low_precision(B.dtype):
        raise TypeError(
            f"-pc_setup_device 1: no device inverse for {B.dtype} blocks "
            "(LU needs float32/float64); use -pc_setup_device 0")
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device)
    X = polished_inverse(B, eye)
    q = (eye - B @ X).abs().max()
    return X, torch.where(torch.isfinite(X).all(), q,
                          torch.full_like(q, float("inf")))


def _device_inverse(B: torch.Tensor):
    """The inverse of the block stack or matrix ``B`` on its device (JAX
    ``_run_device_inverse``, ``pc.py:985``), or ``None`` when the gate
    ``max|I - B X| <= _DEVICE_INV_GATE`` fails (a singular or, for the apply
    dtype, too ill-conditioned block); one host read of the quality scalar.
    Exceptions propagate."""
    X, q = _inv_polish(B)
    q = float(q)
    if not np.isfinite(q) or q > _DEVICE_INV_GATE:
        return None
    return X


def _ell_diag_blocks(cols, vals, bs: int, n: int) -> torch.Tensor:
    """``(n_pad, K)`` ELL -> ``(n_pad / bs, bs, bs)`` dense diagonal-block
    stack on the ELL's device (JAX ``pc.py:1355``). Off-block entries add
    into a dump block that is dropped; ELL padding slots hold 0, so their
    adds change nothing; padding rows get identity diagonals."""
    n_pad, K = cols.shape
    M = n_pad // bs
    dev = cols.device
    r = torch.arange(n_pad, device=dev)[:, None].expand(n_pad, K)
    blk = r // bs
    cc = cols.long() - blk * bs
    inside = (cc >= 0) & (cc < bs) & (r < n)
    blk_s = torch.where(inside, blk, M)
    X = torch.zeros((M + 1, bs, bs), dtype=vals.dtype, device=dev)
    X.index_put_((blk_s.reshape(-1), (r % bs).reshape(-1),
                  torch.where(inside, cc, 0).reshape(-1)),
                 torch.where(inside, vals, 0).reshape(-1), accumulate=True)
    X = X[:M]
    i = torch.arange(n, n_pad, device=dev)
    X[i // bs, i % bs, i % bs] = 1
    return X


def _densify_ell(cols, vals, n: int) -> torch.Tensor:
    """``(n_pad, K)`` ELL -> ``(n_pad, n_pad)`` dense with identity pad rows
    (JAX ``pc.py:1342``): ELL padding slots add 0."""
    n_pad, K = cols.shape
    dev = cols.device
    X = torch.zeros((n_pad, n_pad), dtype=vals.dtype, device=dev)
    rows = torch.arange(n_pad, device=dev)[:, None].expand(n_pad, K)
    X.index_put_((rows.reshape(-1), cols.long().reshape(-1)),
                 vals.reshape(-1), accumulate=True)
    i = torch.arange(n, n_pad, device=dev)
    X[i, i] = 1
    return X


def _mask_pad(X: torch.Tensor, n: int) -> torch.Tensor:
    """Zero the pad block of a padded inverse, in place (the host
    convention: padded slots never feed back into real rows)."""
    X[n:] = 0
    X[:, n:] = 0
    return X


def _device_inverse_dense(Ad: torch.Tensor, n: int):
    """The whole padded operator's inverse on its device (JAX
    ``pc.py:1392``), pad block zeroed, or ``None`` when the gate fails."""
    X = _device_inverse(Ad)
    return None if X is None else _mask_pad(X, n)


def _local_dense_blocks(mat, pc_name: str):
    """Host CSR, ``n`` and the shard's row count for the block PCs, with the
    dense-block cap (JAX ``pc.py:1022``)."""
    _require_assembled(mat, pc_name)
    n = mat.shape[0]
    lsize = mat.comm.local_size(n)
    if lsize > _DENSE_CAP:
        raise ValueError(
            f"PC {pc_name!r} local blocks are dense ({lsize}x{lsize}); too "
            "large — use more devices or pc 'jacobi'/'mg'")
    return mat.to_scipy().tocsr(), n, lsize


def _build_block_ssor(mat, omega: float):
    """Per-shard block SSOR, ``M = (D/w + L) (D/w)^-1 (D/w + U) w / (2 - w)``
    inverted on the host in fp64 (JAX ``pc.py:1042``): PETSc's parallel
    PCSOR, processor-local sweeps applied exactly."""
    import scipy.linalg
    if not 0.0 < omega < 2.0:
        raise ValueError(f"SOR omega must be in (0, 2), got {omega}")
    A, n, lsize = _local_dense_blocks(mat, "sor")
    host_dt = host_dtype(mat.dtype)

    def ssor_inv(B):
        Ad = B.toarray().astype(host_dt)
        D = np.diag(Ad).copy()
        D[D == 0] = 1.0
        Dw = np.diag(D / omega)
        M = ((Dw + np.tril(Ad, -1)) @ np.diag(omega / D)
             @ (Dw + np.triu(Ad, 1)) / (2.0 - omega))
        return scipy.linalg.inv(M)

    inv = _per_device_inverse(A, n, lsize, mat.comm.size, ssor_inv,
                              host_dt=host_dt)
    return (_to_device(mat.comm, inv, mat.dtype),)


def _build_block_ilu(mat, fill: float):
    """Per-shard block ILU (scipy ``spilu``, densified to ``(LU)^-1``; JAX
    ``pc.py:1072``). PC icc takes the same incomplete LU, as in the JAX
    package."""
    import scipy.linalg
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    A, n, lsize = _local_dense_blocks(mat, "ilu")
    host_dt = host_dtype(mat.dtype)

    def ilu_inv(B):
        Ad = sp.csc_matrix(B).astype(host_dt)
        try:
            f = spla.spilu(Ad, fill_factor=fill, drop_tol=1e-5)
            return f.solve(np.eye(Ad.shape[0], dtype=host_dt))
        except RuntimeError:        # singular pivot: the exact inverse
            return scipy.linalg.inv(Ad.toarray())

    inv = _per_device_inverse(A, n, lsize, mat.comm.size, ilu_inv,
                              host_dt=host_dt)
    return (_to_device(mat.comm, inv, mat.dtype),)


def _build_asm(mat, overlap: int):
    """Restricted additive Schwarz windows (JAX ``pc.py:1097``): each shard's
    rows widened by ``overlap`` on each side, inverted on the host in fp64;
    window rows outside the matrix are identity."""
    import scipy.linalg
    ov = int(overlap)
    if ov < 0:
        raise ValueError(f"asm overlap must be >= 0, got {overlap}")
    A, n, lsize = _local_dense_blocks(mat, "asm")
    if ov > lsize:
        raise ValueError(
            f"asm overlap {ov} exceeds the local block size {lsize} "
            "(halo exchange is single-neighbor)")
    ndev = mat.comm.size
    w = lsize + 2 * ov
    host_dt = host_dtype(mat.dtype)
    inv = np.zeros((ndev, w, w), dtype=host_dt)
    for d in range(ndev):
        rs = d * lsize - ov
        block = np.eye(w, dtype=host_dt)
        lo, hi = max(rs, 0), min(rs + w, n)
        if lo < hi:
            block[lo - rs:hi - rs, lo - rs:hi - rs] = \
                A[lo:hi, lo:hi].toarray()
        inv[d] = scipy.linalg.inv(block)
    return (_to_device(mat.comm, inv, mat.dtype),)


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


def _lu_plan(mat):
    """``(mode, bandwidth, perm, A_perm)`` for PC lu/cholesky, decided as the
    JAX package decides it (``pc.py:287-327``): ``'dense'`` up to the dense
    cap; past it ``'crtri'`` for a tridiagonal DIA matrix, ``'crband'`` for
    a band (as stored, or after RCM, whose ``perm`` and permuted matrix come
    along) that fits the block cyclic-reduction caps, else ``'hostlu'``."""
    _require_assembled(mat, "lu")
    offs = set(getattr(mat, "dia_offsets", ()) or ())
    bw = max((abs(int(o)) for o in offs), default=0)
    n = mat.shape[0]
    if n <= _DENSE_CAP:
        return "dense", 0, None, None
    if offs and offs <= {-1, 0, 1}:
        return "crtri", 1, None, None
    if offs and 1 < bw and _bcr_fits(n, bw):
        return "crband", bw, None, None
    perm, bw_rcm, A_perm = _rcm_bandwidth(mat)
    if _bcr_fits(n, max(bw_rcm, 2)):
        return "crband", max(bw_rcm, 2), perm, A_perm
    return "hostlu", 0, None, None


def lu_mode(mat) -> str:
    """The factorization mode PC lu/cholesky takes for ``mat``:
    ``'dense'``, ``'crtri'``, ``'crband'`` or ``'hostlu'``."""
    return _lu_plan(mat)[0]


def _build_host_splu(mat, pc_type: str):
    """Host sparse LU (scipy SuperLU, fp64), the MUMPS slot's
    irreducible-sparsity mode; applied by ``KSP._solve_hostlu``."""
    from scipy.sparse.linalg import splu
    _require_assembled(mat, pc_type)
    A64 = mat.to_scipy().astype(np.float64).tocsc()
    return splu(A64), A64


def _build_tridiag_cr(mat):
    """PCR factor of a tridiagonal operator (JAX ``pc.py:1248``): host fp64
    set-up (:func:`..tridiag.pcr_setup`, with its probes), the ``(S, n)``
    sweep arrays and the reduced diagonal on the device in the operator's
    dtype."""
    n = mat.shape[0]
    if n > _CR_CAP:
        raise ValueError(
            f"PC 'lu' (cyclic reduction) replicates ceil(log2 n) sweep "
            f"arrays; n={n} exceeds the {_CR_CAP} cap — use an iterative "
            "KSP with pc 'jacobi' instead")
    A = mat.to_scipy().tocsr()
    host_dt = host_dtype(mat.dtype)
    a = np.concatenate([[0.0], np.asarray(A.diagonal(-1))]).astype(host_dt)
    b = np.asarray(A.diagonal(0), dtype=host_dt)
    c = np.concatenate([np.asarray(A.diagonal(1)), [0.0]]).astype(host_dt)
    return tuple(_to_device(mat.comm, arr, mat.dtype)
                 for arr in pcr_setup(a, b, c, apply_dtype=mat.dtype))


def _build_banded_bcr(mat, bw: int, perm=None, A_perm=None,
                      setup_device: str = "auto"):
    """Block-PCR factor of a band of half-width ``bw`` (JAX ``pc.py:1196``)
    as ``(arrays, setup_mode, setup_breakdown)``: on the device
    (:func:`..tridiag.bpcr_setup_device_csr`) when :func:`_want_device_setup`
    says so and its probes pass, else on the host in fp64. With an RCM
    ``perm`` the factor is of ``A_perm = A[perm][:, perm]`` and the
    permutation and its inverse trail the three arrays."""
    comm = mat.comm
    A = A_perm if perm is not None else mat.to_scipy().tocsr()
    dt = mat.dtype
    out, mode, timings = None, "host", None
    if _want_device_setup(comm.device, dt, setup_device, f64_ok=True):
        timings = {}
        out = bpcr_setup_device_csr(A, bw, comm, dt, timings=timings)
    if out is None:
        timings = None
        out = tuple(_to_device(comm, arr, dt)
                    for arr in bpcr_setup(*banded_to_blocks(A, bw),
                                          apply_dtype=dt))
    else:
        mode = "device"
    if perm is not None:
        out += tuple(torch.as_tensor(p, device=comm.device)
                     for p in (perm, np.argsort(perm)))
    return out, mode, timings


def dense_inverse_padded(comm, M, dtype, too_large: str):
    """The explicit inverse of the host sparse matrix ``M``, made on the host
    in fp64, zero-padded to the communicator's padded size, on the device in
    ``dtype``: what PC lu (dense, host set-up) and the factoring ST
    transformations apply as one matrix product, replicated. Past
    ``_DENSE_CAP`` rows it raises ``ValueError(too_large)``."""
    import scipy.linalg
    n = M.shape[0]
    if n > _DENSE_CAP:
        raise ValueError(too_large)
    n_pad = comm.padded_size(n)
    inv_pad = np.zeros((n_pad, n_pad), dtype=np.float64)
    inv_pad[:n, :n] = scipy.linalg.inv(M.toarray().astype(np.float64))
    return _to_device(comm, inv_pad, dtype)


def _build_dense_lu(mat, setup_device: str = "auto"):
    """The padded explicit inverse of the whole operator (JAX
    ``_build_dense_lu``, ``pc.py:1303-1338``) as ``(arrays, setup_mode,
    setup_breakdown)``: densified from the ELL and inverted on the device
    when :func:`_want_device_setup` says so and the gate passes, else
    factored on the host in fp64; applied as one matrix product,
    replicated."""
    _require_assembled(mat, "lu")
    comm = mat.comm
    n = mat.shape[0]
    if _want_device_setup(comm.device, mat.dtype, setup_device,
                          f64_ok=True):
        t0 = time.perf_counter()
        Ad = _densify_ell(mat.ell_cols, mat.ell_vals, n)
        t1 = _synced(comm.device)
        X = _device_inverse_dense(Ad, n)
        if X is not None:
            return (X,), "device", _breakdown(t0, t1, comm.device)
    return (dense_inverse_padded(
        comm, mat.to_scipy(), mat.dtype,
        f"PC 'lu' densifies general operators; n={n} is too large"),), \
        "host", None
