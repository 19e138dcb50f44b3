"""SVD: the singular value solver, the counterpart of SLEPc's SVD object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/svd.py``. As
SLEPc's default ``cross`` method does, it solves the Hermitian eigenproblem
of the cross product: ``A^H A`` (or ``A A^H`` when that is the smaller) is
assembled on the host, the eigensolve runs as an :class:`~.eps.EPS` on the
device, and the triplets come back as ``sigma_i = sqrt(lambda_i)``, ``v_i``
the eigenvector and ``u_i = A v_i / sigma_i``, made on the host.

The largest values take Krylov-Schur (``largest_real``); the smallest, up
to 16 of them, take LOBPCG with a block of at least 3 (past its block cap,
Krylov-Schur ``smallest_real``). Rectangular operators of any shape ratio
and complex operators are taken; the results (``get_converged``,
``get_value``, ``get_singular_triplet``) are host-replicated, as EPS's are.
"""

from __future__ import annotations

import time

import numpy as np

from ..core.mat import Mat
from ..parallel.mesh import as_comm
from ..utils.convergence import ConvergedReason, SolveResult
from ..utils.dtypes import is_complex
from ..utils.options import global_options
from .eps import _LOBPCG_BS_CAP, EPS

SVD_WHICH = ("largest", "smallest")


class SVD:
    """Singular value solver context, slepc4py-``SVD``-shaped."""

    class Which:
        LARGEST = "largest"
        SMALLEST = "smallest"

    def __init__(self, comm=None):
        self.comm = as_comm(comm) if comm is not None else None
        self._mat: Mat | None = None
        self.nsv = 1                  # SLEPc's default
        self.ncv: int | None = None
        self.tol = 1e-8
        self.max_it = 100
        self._which = "largest"       # SLEPc's default selection
        self.result = SolveResult()
        self._sigma = np.zeros(0)
        self._U = np.zeros((0, 0))
        self._V = np.zeros((0, 0))
        self._residuals = np.zeros(0)
        self._nconv = 0

    # ---- lifecycle / configuration -----------------------------------------
    def create(self, comm=None):
        self.comm = as_comm(comm)
        return self

    def destroy(self):
        return self

    def set_operator(self, A: Mat):
        self._mat = A
        if self.comm is None:
            self.comm = A.comm
        return self

    setOperator = set_operator

    def set_dimensions(self, nsv: int | None = None, ncv: int | None = None):
        if nsv is not None:
            self.nsv = int(nsv)
        if ncv is not None:
            self.ncv = int(ncv)
        return self

    setDimensions = set_dimensions

    def set_tolerances(self, tol=None, max_it=None):
        if tol is not None:
            self.tol = float(tol)
        if max_it is not None:
            self.max_it = int(max_it)
        return self

    setTolerances = set_tolerances

    def set_which_singular_triplets(self, which: str):
        which = str(which).lower()
        if which not in SVD_WHICH:
            raise ValueError(f"unknown which {which!r}; available: "
                             f"{SVD_WHICH}")
        self._which = which
        return self

    setWhichSingularTriplets = set_which_singular_triplets

    def set_from_options(self):
        """``-svd_nsv``, ``-svd_ncv``, ``-svd_tol``, ``-svd_max_it`` and
        ``-svd_which``."""
        opt = global_options()
        self.nsv = opt.get_int("svd_nsv", self.nsv)
        ncv = opt.get_int("svd_ncv", 0)
        if ncv:
            self.ncv = ncv
        self.tol = opt.get_real("svd_tol", self.tol)
        self.max_it = opt.get_int("svd_max_it", self.max_it)
        w = opt.get_string("svd_which")
        if w:
            self.set_which_singular_triplets(w)
        return self

    setFromOptions = set_from_options

    # ---- solve --------------------------------------------------------------
    def solve(self):
        """The cross-product eigensolve: EPS on ``A^H A`` (or ``A A^H`` when
        that is smaller), ``sigma = sqrt(lambda)``, the other side's vectors
        from ``A``. Each triplet's residual is taken on the side opposite the
        constructed vector (the constructed side is exact by construction),
        relative in sigma, absolute once sigma is numerically zero."""
        mat = self._mat
        if mat is None:
            raise RuntimeError("SVD.solve: no operator set")
        A = mat.to_scipy().tocsr()
        m, n = A.shape
        cplx = is_complex(mat.dtype)
        AH = A.conj().T if cplx else A.T     # the Hermitian adjoint
        use_left = m < n              # the smaller cross product
        C = (A @ AH if use_left else AH @ A).tocsr()
        t0 = time.perf_counter()

        eps = EPS().create(self.comm)
        eps.set_operators(Mat.from_scipy(self.comm, C, dtype=mat.dtype))
        eps.set_problem_type("hep")
        k = min(self.nsv, C.shape[0])
        # relative accuracy carries over: d(sigma)/sigma = d(lambda)/(2
        # lambda), so the eigensolver's tolerance is the singular values'
        eps.set_tolerances(tol=self.tol, max_it=self.max_it)
        if self._which == "largest":
            eps.set_dimensions(nev=k, ncv=self.ncv)
            eps.set_which_eigenpairs("largest_real")
        elif k <= _LOBPCG_BS_CAP:
            # lobpcg, with a block of at least 3: one vector converges
            # poorly on the squared spectrum (the extra pairs are dropped)
            eps.set_type("lobpcg")
            eps.set_dimensions(nev=min(max(k, 3), C.shape[0]), ncv=self.ncv)
            eps.set_which_eigenpairs("smallest_real")
        else:
            eps.set_dimensions(nev=k, ncv=self.ncv)
            eps.set_which_eigenpairs("smallest_real")
        eps.solve()

        nconv = min(eps.get_converged(), k)
        zero = np.finfo(np.float64).tiny ** 0.5
        sig, W, other, res = [], [], [], []
        for i in range(nconv):
            s = float(np.sqrt(max(eps.get_eigenvalue(i).real, 0.0)))
            w = eps._eigenvectors[i]              # an eigenvector of C
            if not cplx:
                w = np.real(w)
            w = w / (np.linalg.norm(w) or 1.0)
            if s > zero:
                o = (AH @ w if use_left else A @ w) / s
            else:                                  # a zero singular value
                o = np.zeros(n if use_left else m, dtype=w.dtype)
            sig.append(s)
            W.append(w)
            other.append(o)
            u, v = (w, o) if use_left else (o, w)
            r_abs = float(np.linalg.norm(A @ v - s * u) if use_left
                          else np.linalg.norm(AH @ u - s * v))
            res.append(r_abs / s if s > zero else r_abs)
        order = np.argsort(np.asarray(sig))
        if self._which == "largest":
            order = order[::-1]
        self._sigma = np.asarray(sig)[order]
        W = np.asarray(W)[order] if W else None
        other = np.asarray(other)[order] if other else None
        if use_left:
            self._U = W if W is not None else np.zeros((0, m))
            self._V = other if other is not None else np.zeros((0, n))
        else:
            self._V = W if W is not None else np.zeros((0, n))
            self._U = other if other is not None else np.zeros((0, m))
        self._residuals = np.asarray(res)[order] if res else np.zeros(0)
        self._nconv = int(nconv)
        self.result = SolveResult(
            eps.get_iteration_number(),
            float(self._residuals[0]) if len(self._residuals) else 0.0,
            (ConvergedReason.CONVERGED_RTOL if nconv >= k
             else ConvergedReason.DIVERGED_MAX_IT),
            time.perf_counter() - t0, eps.result.host_syncs)
        return self

    # ---- results (slepc4py-shaped, host-replicated) --------------------------
    def get_converged(self) -> int:
        return self._nconv

    getConverged = get_converged

    def get_value(self, i: int) -> float:
        return float(self._sigma[i])

    getValue = get_value

    def get_singular_triplet(self, i: int, U=None, V=None) -> float:
        """Fill ``U``/``V`` (Vec) with the i-th singular vectors and return
        sigma_i; host-replicated, no collective call."""
        if U is not None:
            U.set_global(self._U[i])
        if V is not None:
            V.set_global(self._V[i])
        return float(self._sigma[i])

    getSingularTriplet = get_singular_triplet

    def get_iteration_number(self) -> int:
        return self.result.iterations

    getIterationNumber = get_iteration_number

    def __repr__(self):
        return (f"SVD(nsv={self.nsv}, which={self._which!r}, "
                f"tol={self.tol})")
