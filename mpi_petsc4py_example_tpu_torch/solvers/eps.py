"""EPS: the eigensolver, the counterpart of SLEPc's EPS object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/eps.py``
(``EPS``, ``:854``), the parts its types ``krylovschur``, ``lanczos`` and
``lapack`` use. The reference drives it as ``EPS().create``,
``setOperators``, ``setProblemType(HEP)``, ``setFromOptions``, ``solve``,
``getConverged``, ``getEigenpair(i, vr, vi)`` (``petsc_funcs.py:13-20``,
``test2.py:88-96``); SLEPc's defaults, Krylov-Schur with nev 1 and the
largest magnitude, are the defaults here.

Types (``set_type`` / ``-eps_type``):

* ``krylovschur``: thick-restart Arnoldi/Lanczos (Krylov-Schur), the JAX
  host loop (``_solve_krylovschur``, ``:1293``, from ``:1347``). The
  factorization steps ``k..ncv-1`` run on the device as CGS2 steps on a
  shard-stacked basis ``(local_shards, ncv+1, lsize)`` with no host read
  inside; the projected matrix ``H``, whose entries are reductions and so
  the same on every process, comes to the host once per restart for the
  small eigenproblem and the restart decision (numpy, on every process),
  and the basis is compressed to the kept Ritz/Schur directions on the
  device. The JAX
  package's fused whole-solve HEP program (``:383``) is not ported: the port
  runs this loop at every size, one host read per restart and one to
  extract the eigenvectors.
* ``lanczos``: the Hermitian alias of the same loop (its full CGS2
  reorthogonalization makes the factorization a reliable Lanczos process);
  it raises on a non-Hermitian problem.
* ``lapack``: SLEPc's EPSLAPACK, the whole dense problem solved on the host,
  the small-n oracle.

``arnoldi``, ``power``, ``subspace``, ``lobpcg`` and ``gd`` are not ported
yet: ``set_type`` raises ``NotImplementedError`` for them, and so does
constructing an :class:`SVD` (ROADMAP.md Queue A item 7).

Complex operators (complex64/complex128) follow SLEPc's complex build, as
the JAX package does: the factorization's projections conjugate the basis,
the projected matrix ``H`` is complex (Hermitian for HEP/GHEP, solved by
``eigh``; NHEP restarts on the complex, triangular Schur form, which has no
2 x 2 blocks), the Ritz vectors are complex, ``get_eigenpair`` fills ``vr``
with the whole complex vector and zeroes ``vi``, and ``compute_error``
applies the operator to the complex vector.

Spectral transformations (:mod:`.st`) and generalized Hermitian problems ``A
x = lambda B x`` run on the transformed operator, with every inner product
of the factorization in the B-inner product for GHEP, and the Ritz values
mapped back.

On a communicator of several processes (``ProcessComm``) every process
runs the solve on its shards (SPMD) and takes the same decisions from the
same ``H``; the Ritz vectors are gathered once at the end. Extraction is
host-replicated: ``get_eigenpair`` reads stored host arrays and makes no
collective call, so a driver may call it on one rank only, as the reference
``test2.py`` does. ``compute_error`` is collective: the operator's product
and one ``psum`` of the residual's local rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.vec import Vec
from ..parallel.mesh import numpy_dtype
from ..utils.dtypes import host_dtype, is_complex
from ..resilience import faults as _faults
from ..utils.convergence import SolveResult
from ..utils.errors import wrap_device_errors
from ..utils.options import global_options
from ..utils.profiling import record_event, record_sync
from ..telemetry import spans as _telemetry
from .krylov import _cgs2_step, _pmatdot, shardwise_matmul
from .mg import _tf32_allowed
from .st import ST

DEFAULT_TOL = 1e-8        # SLEPc's EPS default
DEFAULT_MAX_RESTARTS = 100

EPS_TYPES = ("krylovschur", "lanczos", "lapack")
# the JAX package's other types, for a later slice of the port
UNPORTED_TYPES = ("arnoldi", "power", "subspace", "lobpcg", "gd")


class EPSProblemType:
    HEP = "hep"       # Hermitian
    NHEP = "nhep"     # non-Hermitian
    GHEP = "ghep"     # generalized Hermitian, B SPD


class EPSWhich:
    LARGEST_MAGNITUDE = "largest_magnitude"
    SMALLEST_MAGNITUDE = "smallest_magnitude"
    LARGEST_REAL = "largest_real"
    SMALLEST_REAL = "smallest_real"
    TARGET_MAGNITUDE = "target_magnitude"
    TARGET_REAL = "target_real"


class EPSType:
    KRYLOVSCHUR = "krylovschur"
    ARNOLDI = "arnoldi"
    LANCZOS = "lanczos"
    POWER = "power"
    SUBSPACE = "subspace"
    LOBPCG = "lobpcg"
    LAPACK = "lapack"
    GD = "gd"


def _inner_products(comm, inner):
    """``(pmatdot, pnorm)`` of the factorization: the Euclidean products,
    or with ``inner`` (GHEP's B) the B-inner products ``V (B w)`` and
    ``sqrt(<u, B u>)``, one reduction over the shards each."""
    pmatdot = _pmatdot(comm)
    b_apply = inner.local_spmv(comm) if inner is not None else None
    size = comm.local_shards

    def pnorm(u):
        bu = b_apply(u) if b_apply is not None else u
        return torch.sqrt(comm.psum([torch.vdot(u[i], bu[i]).real
                                     for i in range(size)]))

    if b_apply is None:
        return pmatdot, pnorm
    return (lambda V, w: pmatdot(V, b_apply(w))), pnorm


def _facto_steps(spmv, pmatdot, pnorm, V, H, k, ncv):
    """The CGS2 Arnoldi/Lanczos continuation (the JAX ``_facto_steps``,
    ``:123``): normalize ``V[:, k]``, then run steps ``k..ncv-1`` on the
    basis ``V (local_shards, ncv+1, lsize)`` and ``H (ncv+1, ncv)`` in
    place (``H`` the same on every process: its entries are reductions), on
    the device, with no host read.

    Step ``j`` projects against the ``j+1`` rows already built and no more:
    the JAX program projects against all ``ncv+1`` rows, whose rows past
    ``j`` are zero and add exact zeros, so only the summation order of the
    products can differ, while the rows read per step fall from ``ncv+1`` to
    ``j+1``."""
    nrm = pnorm(V[:, k])
    V[:, k] /= torch.where(nrm == 0, 1.0, nrm)
    for j in range(k, ncv):
        h, b, vnext = _cgs2_step(V[:, :j + 1], spmv(V[:, j]), pmatdot,
                                 pnorm)
        H[:j + 1, j] = h
        H[j + 1, j] = b
        V[:, j + 1] = vnext


class EPS:
    """Eigensolver context, slepc4py-``EPS``-shaped."""

    ProblemType = EPSProblemType
    Which = EPSWhich
    Type = EPSType

    # the dense host solve of 'lapack': O(n^2) storage, O(n^3) work
    _LAPACK_CAP = 16384

    def __init__(self, comm=None):
        self.comm = None
        self._mat = None
        self._bmat = None
        self._type = "krylovschur"     # SLEPc's default
        self._problem_type = EPSProblemType.NHEP
        self._which = EPSWhich.LARGEST_MAGNITUDE
        self._target: float | None = None
        self.st = ST()
        self.nev = 1                  # SLEPc's default
        self.ncv: int | None = None   # auto: max(2 nev, nev + 15), capped at n
        self.tol = DEFAULT_TOL
        self.max_it = DEFAULT_MAX_RESTARTS
        self._monitors: list = []      # EPSMonitorSet callbacks
        self._monitor_flag = False     # -eps_monitor's printer
        self.result = SolveResult()
        self._eigenvalues = np.zeros(0)
        self._eigenvectors = np.zeros((0, 0))
        self._residuals = np.zeros(0)
        self._nconv = 0
        self._its = 0
        self._op_cache = None
        if comm is not None:
            self.create(comm)

    # ---- lifecycle / configuration -----------------------------------------
    def create(self, comm=None):
        self.comm = comm
        return self

    def destroy(self):
        return self

    def set_type(self, eps_type: str):
        eps_type = str(eps_type).lower()
        if eps_type in UNPORTED_TYPES:
            raise NotImplementedError(
                f"EPS {eps_type!r} is not ported yet (ROADMAP.md Queue A "
                f"item 7); the port has {EPS_TYPES}")
        if eps_type not in EPS_TYPES:
            raise ValueError(f"unknown EPS type {eps_type!r}; "
                             f"available: {EPS_TYPES}")
        self._type = eps_type
        return self

    setType = set_type

    def get_type(self) -> str:
        return self._type

    getType = get_type

    def set_operators(self, A, B=None):
        self._mat = A
        self._bmat = B
        if B is not None:
            self._problem_type = EPSProblemType.GHEP
        if self.comm is None:
            self.create(A.comm)
        return self

    setOperators = set_operators

    def set_problem_type(self, ptype):
        ptype = str(ptype).lower()
        if ptype not in (EPSProblemType.HEP, EPSProblemType.NHEP,
                         EPSProblemType.GHEP):
            raise ValueError(f"unsupported problem type {ptype!r}")
        self._problem_type = ptype
        return self

    setProblemType = set_problem_type

    def set_which_eigenpairs(self, which: str):
        self._which = str(which).lower()
        return self

    setWhichEigenpairs = set_which_eigenpairs

    def set_target(self, target: float):
        """Target value of the ``target_*`` selections; with ST ``sinvert``
        or ``cayley`` and no shift set it is also the shift (SLEPc's
        convention)."""
        self._target = float(target)
        return self

    setTarget = set_target

    def get_st(self) -> ST:
        return self.st

    getST = get_st

    def set_dimensions(self, nev: int | None = None, ncv: int | None = None):
        if nev is not None:
            self.nev = int(nev)
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

    def set_from_options(self):
        """``-eps_type``, ``-eps_nev``, ``-eps_ncv``, ``-eps_tol``,
        ``-eps_max_it``, ``-eps_hermitian``, ``-eps_which``,
        ``-eps_target``, ``-eps_monitor`` and the ST options (the
        reference's ``E.setFromOptions()``, ``petsc_funcs.py:17``)."""
        opt = global_options()
        eps_type = opt.get_string("eps_type")
        if eps_type:
            self.set_type(eps_type)
        self.nev = opt.get_int("eps_nev", self.nev)
        ncv = opt.get_int("eps_ncv", None)
        if ncv is not None:
            self.ncv = ncv
        self.tol = opt.get_real("eps_tol", self.tol)
        self.max_it = opt.get_int("eps_max_it", self.max_it)
        if opt.get_bool("eps_hermitian", False):
            self._problem_type = EPSProblemType.HEP
        which = opt.get_string("eps_which")
        if which:
            self._which = which
        target = opt.get_real("eps_target", None)
        if target is not None:
            self.set_target(target)
        self._monitor_flag = opt.get_bool("eps_monitor", self._monitor_flag)
        self.st.set_from_options()
        return self

    setFromOptions = set_from_options

    # ---- monitors (EPSMonitorSet / -eps_monitor) -----------------------------
    def set_monitor(self, fn):
        """Register ``fn(eps, its, nconv, eig, errest)``, slepc4py's
        ``EPS.setMonitor`` signature: the mapped-back eigenvalue
        approximations and their relative error estimates, most wanted
        first, once per restart."""
        if fn is not None:          # setMonitor(None) is a no-op (slepc4py)
            self._monitors.append(fn)
        return self

    setMonitor = set_monitor

    def cancel_monitor(self):
        """EPSMonitorCancel: removes every monitor, ``-eps_monitor``'s
        printer included."""
        self._monitors = []
        self._monitor_flag = False
        return self

    cancelMonitor = cancel_monitor

    def _monitored(self) -> bool:
        return bool(self._monitors) or self._monitor_flag

    def _emit_monitor(self, its, nconv, lam, errest):
        """One monitoring event: SLEPc's ``-eps_monitor`` line when the flag
        is set, then the callbacks."""
        lam = np.atleast_1d(np.asarray(lam))
        errest = np.atleast_1d(np.asarray(errest))
        if self._monitor_flag:
            if int(nconv) < len(lam):
                j = int(nconv)
                err = float(errest[j]) if j < len(errest) else 0.0
                print(f"{int(its):3d} EPS nconv={int(nconv)} first "
                      f"unconverged value (error) {lam[j]} ({err:.8e})")
            else:   # every reported pair converged
                print(f"{int(its):3d} EPS nconv={int(nconv)} "
                      "(all requested pairs converged)")
        for fn in self._monitors:
            fn(self, int(its), int(nconv), lam, errest)

    # ---- selection ----------------------------------------------------------
    def _effective_ncv(self, n: int) -> int:
        if self.ncv is not None:
            return min(self.ncv, n)
        return min(n, max(2 * self.nev, self.nev + 15))

    def _metric(self, lam: np.ndarray) -> np.ndarray:
        """Bigger is more wanted (the sort and the Schur selection)."""
        w = self._which
        if w == EPSWhich.LARGEST_MAGNITUDE:
            return np.abs(lam)
        if w == EPSWhich.SMALLEST_MAGNITUDE:
            return -np.abs(lam)
        if w == EPSWhich.LARGEST_REAL:
            return np.real(lam)
        if w == EPSWhich.SMALLEST_REAL:
            return -np.real(lam)
        tau = 0.0 if self._target is None else self._target
        if w == EPSWhich.TARGET_MAGNITUDE:
            return -np.abs(lam - tau)
        if w == EPSWhich.TARGET_REAL:
            return -np.abs(np.real(lam) - tau)
        raise ValueError(f"unknown which {self._which!r}")

    def _select(self, lam: np.ndarray) -> np.ndarray:
        finite = np.where(np.isfinite(lam), self._metric(lam), -np.inf)
        return np.argsort(-finite, kind="stable")

    # ---- solve --------------------------------------------------------------
    @wrap_device_errors("EPSSolve")
    def solve(self):
        mat = self._mat
        if mat is None:
            raise RuntimeError("EPS.solve: no operators set")
        _faults.check("eps.solve")    # an injectable pre-solve failure
        if self._bmat is not None and \
                self._problem_type != EPSProblemType.GHEP:
            raise ValueError("two operators were set; problem type must be "
                             "'ghep' (B must be SPD)")
        if self._problem_type == EPSProblemType.GHEP and self._bmat is None:
            raise ValueError("problem type 'ghep' needs operators (A, B)")
        # SLEPc's convention: a target with sinvert/cayley is the shift
        if (self._target is not None
                and self.st.get_type() in ("sinvert", "cayley")
                and self.st.sigma == 0.0):
            self.st.set_shift(self._target)
        t0 = time.perf_counter()
        with _telemetry.span("eps.solve", eps_type=self._type,
                             problem=str(self._problem_type),
                             nev=int(self.nev), n=int(mat.shape[0]),
                             devices=int(getattr(mat.comm, "size", 0)
                                         or 0)) as sp:
            if self._type == "lapack":
                self._solve_lapack()
                syncs = 0
            else:
                if self._type == "lanczos" and self._problem_type not in (
                        EPSProblemType.HEP, EPSProblemType.GHEP):
                    raise ValueError("EPS 'lanczos' needs a Hermitian "
                                     "problem type (hep/ghep)")
                syncs = self._solve_krylovschur()
            wall = time.perf_counter() - t0
            self.result = SolveResult(
                self._its,
                float(self._residuals[0]) if len(self._residuals) else 0.0,
                # nev > n cannot fail: min(nev, n) pairs exist at all
                2 if self._nconv >= min(self.nev, mat.shape[0]) else -3,
                wall, syncs)
            sp.set_attrs(iterations=int(self._its), nconv=int(self._nconv),
                         reason=self.result.reason)
        record_event(
            f"EPSSolve({self._type},{self._problem_type},nev={self.nev})",
            mat.shape[0], self._its, wall, self.result.reason)
        return self

    # ---- lapack (the dense host solve, SLEPc's EPSLAPACK) -------------------
    def _solve_lapack(self):
        """The whole dense problem on the host (eigh, eig or the generalized
        eigh), ``nev`` pairs chosen by ``which``/``target`` or, under
        sinvert/cayley, by the transformed magnitude; every pair exact."""
        import scipy.linalg as sla
        mat = self._mat
        n = mat.shape[0]
        if n > self._LAPACK_CAP:
            raise ValueError(
                f"EPS 'lapack' solves the full dense problem on host "
                f"(O(n^3)); n={n} exceeds the {self._LAPACK_CAP} cap: "
                "use krylovschur")
        if not hasattr(mat, "to_scipy") or (
                self._problem_type == EPSProblemType.GHEP
                and not hasattr(self._bmat, "to_scipy")):
            raise ValueError("EPS 'lapack' needs assembled matrices (Mat)")
        host_dt = host_dtype(mat.dtype)
        A = mat.to_scipy().toarray().astype(host_dt)
        if self._problem_type == EPSProblemType.GHEP:
            B = self._bmat.to_scipy().toarray().astype(host_dt)
            lam, V = sla.eigh(A, B)
        elif self._problem_type == EPSProblemType.HEP:
            lam, V = np.linalg.eigh((A + A.conj().T) / 2.0)
        else:
            lam, V = np.linalg.eig(A)
        if self.st.get_type() == "sinvert":
            # the pairs closest to sigma, as the iterative types' sinvert
            # Krylov space holds them
            order = np.argsort(np.abs(lam - self.st.sigma), kind="stable")
        elif self.st.get_type() == "cayley":
            # by |theta| = |lam + nu|/|lam - sigma|, descending (a pair at
            # lam = -nu has theta 0: the least magnified, not the nearest)
            nu = self.st.get_antishift()
            dist = np.abs(lam - self.st.sigma)
            theta_mag = np.where(dist == 0, np.inf,
                                 np.abs(lam + nu) / np.where(dist == 0, 1.0,
                                                             dist))
            order = np.argsort(-theta_mag, kind="stable")
        else:
            order = self._select(lam)
        count = min(self.nev, n)
        take = order[:count]
        vecs = V[:, take].T
        nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
        nrm[nrm == 0] = 1.0
        vecs = vecs / nrm
        if self._problem_type == EPSProblemType.GHEP:
            R = A @ vecs.T - B @ vecs.T * lam[take][None, :]
        else:
            R = A @ vecs.T - vecs.T * lam[take][None, :]
        rel = (np.linalg.norm(R, axis=0)
               / np.maximum(np.abs(lam[take]), np.finfo(float).tiny))
        self._store(lam[take], vecs, rel, count, 1)

    # ---- shared pieces ------------------------------------------------------
    def _setup_operator(self):
        """``(comm, op, inner, hermitian)``, the built ST operator cached
        while ``(A, B, st)`` stay the same: sinvert and GHEP make a dense
        inverse on the host, which a repeated solve must not remake."""
        comm = self._mat.comm
        hermitian = self._problem_type in (EPSProblemType.HEP,
                                           EPSProblemType.GHEP)
        key = (self._mat, getattr(self._mat, "_state", 0), self._bmat,
               getattr(self._bmat, "_state", 0), self.st.get_type(),
               self.st.sigma, self.st.get_antishift()
               if self.st.get_type() == "cayley" else None)
        cached = self._op_cache
        if cached is not None and cached[0] == key:
            return comm, cached[1], cached[2], hermitian
        op, inner = self.st.build_operator(self._mat, self._bmat)
        self._op_cache = (key, op, inner)
        return comm, op, inner, hermitian

    def _rayleigh_ritz(self, Hh: np.ndarray, ncv: int, nev: int,
                       hermitian: bool):
        """The projected eigenproblem, the selection and the convergence
        test: ``(beta, lam_t, S, order, rel, nconv)``, with the Ritz residual
        ``|beta| |e_m^T y|`` (valid after a thick restart too, by the
        Krylov-Schur relation ``T V = V H + beta v e_m^T``)."""
        Hm = Hh[:ncv, :ncv]
        beta = float(np.real(Hh[ncv, ncv - 1]))
        if hermitian:
            Hm = (Hm + Hm.conj().T) / 2.0
            lam_t, S = np.linalg.eigh(Hm)
        else:
            lam_t, S = np.linalg.eig(Hm)
        order = self._select(self.st.back_transform(lam_t))
        res = np.abs(beta) * np.abs(S[ncv - 1, order])
        denom = np.maximum(np.abs(lam_t[order]), 1e-300)
        rel = res / denom
        nconv = 0
        while nconv < min(nev, len(rel)) and rel[nconv] <= self.tol:
            nconv += 1
        return beta, lam_t, S, order, rel, nconv

    def _start_vector(self, comm, n, dtype):
        """The JAX package's start vector: ``default_rng(20240901)`` over the
        padded size, the padding zeroed."""
        rng = np.random.default_rng(20240901)
        npad = comm.padded_size(n)
        v0 = rng.standard_normal(npad)
        v0[n:] = 0.0        # padding never enters the Krylov space
        return v0.astype(dtype)

    def _store(self, lam, vecs, rel, nconv, its):
        self._eigenvalues = np.asarray(lam)
        self._eigenvectors = np.asarray(vecs)
        self._residuals = np.asarray(rel, dtype=float)
        self._nconv = int(nconv)
        self._its = int(its)

    # ---- krylovschur (thick restart) ----------------------------------------
    def _solve_krylovschur(self) -> int:
        """The thick-restart loop; returns its count of host reads (one per
        restart, one for the eigenvectors)."""
        import scipy.linalg
        comm, op, inner, hermitian = self._setup_operator()
        n = op.shape[0]
        ncv = self._effective_ncv(n)
        nev = min(self.nev, ncv)
        k_keep = int(min(max(nev, ncv // 2), ncv - 1))
        dtype = op.dtype
        np_dtype = numpy_dtype(dtype)
        size = comm.local_shards
        if (comm.device.type == "cuda" and dtype == torch.float32
                and _tf32_allowed()):
            raise RuntimeError(
                "EPS needs full-precision fp32 matmuls on CUDA for its "
                "projections; TF32 is enabled (set "
                "torch.backends.cuda.matmul.fp32_precision = 'ieee', or "
                "torch.set_float32_matmul_precision('highest'))")
        spmv = op.local_spmv(comm)
        pmatdot, pnorm = _inner_products(comm, inner)
        v0 = comm.put_rows(self._start_vector(comm, n, np_dtype))
        V = v0.new_zeros((size, ncv + 1, v0.numel() // size))
        V[:, 0] = v0.view(size, -1)
        H = v0.new_zeros((ncv + 1, ncv))
        k, syncs = 0, 0

        for restarts in range(1, self.max_it + 1):
            _facto_steps(spmv, pmatdot, pnorm, V, H, k, ncv)
            # the one host read per restart: the small projected matrix (the
            # basis stays on the device)
            Hh = H.cpu().numpy().astype(host_dtype(dtype))
            syncs += 1
            record_sync("EPS H fetch/restart")
            beta, lam_t, S, order, rel, nconv = self._rayleigh_ritz(
                Hh, ncv, nev, hermitian)
            if self._monitored():
                self._emit_monitor(restarts, nconv,
                                   self.st.back_transform(lam_t[order]),
                                   rel)
            if nconv >= nev or ncv >= n or restarts == self.max_it:
                break

            # ---- thick restart: keep k wanted Ritz/Schur directions --------
            k = k_keep
            if hermitian:
                take = order[:k]
                T_new = np.diag(lam_t[take])
                b_new = beta * S[ncv - 1, take]
                S_keep = S[:, take]
            else:
                Hm = Hh[:ncv, :ncv]
                thresh = np.sort(self._metric(
                    self.st.back_transform(lam_t)))[::-1][k - 1]

                def want(re, im):
                    lam = self.st.back_transform(np.asarray(re + 1j * im))
                    return bool(self._metric(lam) >= thresh - 1e-12)

                # the Schur form, wanted eigenvalues first (the JAX
                # _ordered_schur, :2048): real, where LAPACK keeps 2x2
                # blocks whole, so sdim may differ from k by one; complex
                # (triangular) for a complex H
                if np.iscomplexobj(Hm):
                    T, Z, sdim = scipy.linalg.schur(
                        Hm, output="complex",
                        sort=lambda lam: want(lam.real, lam.imag))
                else:
                    T, Z, sdim = scipy.linalg.schur(Hm, output="real",
                                                    sort=want)
                k = int(min(max(sdim, 1), ncv - 1))
                # never cut through a 2x2 (complex-pair) block: T[k, k-1] != 0
                # couples rows k-1 and k, and cutting there would break the
                # Krylov-Schur relation
                if 0 < k < ncv and T[k, k - 1] != 0.0:
                    k = k - 1 if k > 1 else min(k + 1, ncv - 1)
                k = int(min(max(k, 1), ncv - 1))
                T_new = T[:k, :k]
                b_new = beta * Z[ncv - 1, :k]
                S_keep = Z[:, :k]

            H_prefill = np.zeros((ncv + 1, ncv), dtype=np_dtype)
            H_prefill[:k, :k] = T_new
            H_prefill[k, :k] = b_new
            H = torch.tensor(H_prefill, device=comm.device)
            # the compression, on the device: the kept directions, then the
            # residual vector as row k; rows past k are written by the steps
            # before any step reads them
            S_dev = torch.tensor(np.ascontiguousarray(S_keep.T),
                                 dtype=dtype, device=comm.device)
            V_new = torch.empty_like(V)
            V_new[:, :k] = shardwise_matmul(S_dev, V[:, :ncv])
            V_new[:, k] = V[:, ncv]
            V = V_new

        count = max(nev, 1)
        lam, vecs = self._extract(comm, V, S, lam_t, order, n, count)
        syncs += 1
        record_sync("EPS basis fetch/solve")
        self._store(lam, vecs, rel[:count], nconv, restarts)
        return syncs

    def _extract(self, comm, V, S, lam_t, order, n, count):
        """The ``count`` most wanted Ritz vectors ``(count, n)``, normalized,
        made on the device from this process's shards of the basis and
        gathered in one ``gather_shards`` (every process gets them all), and
        their mapped-back eigenvalues."""
        ncv = S.shape[0]
        take = order[:count]
        St = S[:, take].T
        # a complex basis takes the complex coefficients; a real one their
        # real and imaginary parts apart (complex pairs of NHEP)
        parts = ([St] if V.is_complex() else
                 [St.real] + ([St.imag] if np.iscomplexobj(St) else []))
        coef = torch.tensor(np.ascontiguousarray(np.concatenate(parts)),
                            dtype=V.dtype, device=V.device)
        # (local_shards, rows, lsize), then (size, rows, lsize)
        Y = comm.gather_shards(shardwise_matmul(coef, V[:, :ncv]))
        Y = Y.transpose(0, 1).reshape(coef.shape[0], -1)  # (rows, n_pad)
        Yh = Y.cpu().numpy().astype(host_dtype(V.dtype))[:, :n]
        vecs = Yh[:count] + (1j * Yh[count:] if len(parts) == 2 else 0.0)
        nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
        nrm[nrm == 0] = 1.0
        return self.st.back_transform(lam_t[take]), vecs / nrm

    # ---- results (slepc4py-shaped, host-replicated) --------------------------
    def get_converged(self) -> int:
        return self._nconv

    getConverged = get_converged

    def get_iteration_number(self) -> int:
        return self.result.iterations

    getIterationNumber = get_iteration_number

    def get_dimensions(self):
        """``(nev, ncv)``, slepc4py's getDimensions, ``ncv`` resolved from
        the automatic rule when unset."""
        if self._mat is not None:     # the size the solver actually uses
            return (self.nev, self._effective_ncv(self._mat.shape[0]))
        if self.ncv is not None:
            return (self.nev, self.ncv)
        return (self.nev, max(2 * self.nev, self.nev + 15))

    getDimensions = get_dimensions

    def get_tolerances(self):
        """``(tol, max_it)``, slepc4py's getTolerances."""
        return (self.tol, self.max_it)

    getTolerances = get_tolerances

    def get_eigenvalue(self, i: int):
        return complex(self._eigenvalues[i])

    getEigenvalue = get_eigenvalue

    def get_eigenpair(self, i: int, vr: Vec | None = None,
                      vi: Vec | None = None):
        """Fill ``vr``/``vi`` with the real and imaginary parts of the i-th
        eigenvector and return its eigenvalue; a complex ``vr`` takes the
        whole complex eigenvector and ``vi`` is zeroed (slepc4py's
        complex build, JAX ``eps.py:1975``). Host-replicated: no
        collective call, so one rank alone may call it."""
        vec = self._eigenvectors[i]
        if vr is not None and is_complex(vr.dtype):
            vr.set_global(vec)
            if vi is not None:
                vi.set_global(np.zeros_like(vec))
            return complex(self._eigenvalues[i])
        if vr is not None:
            vr.set_global(np.real(vec))
        if vi is not None:
            vi.set_global(np.imag(vec))
        return complex(self._eigenvalues[i])

    getEigenpair = get_eigenpair

    def get_error_estimate(self, i: int) -> float:
        return float(self._residuals[i])

    getErrorEstimate = get_error_estimate

    def compute_error(self, i: int, error_type: str = "relative") -> float:
        """EPSComputeError: the true residual ``||A v - lambda v||`` (``||A v
        - lambda B v||`` for GHEP) of the i-th pair, with the stored
        operators; ``'relative'`` (SLEPc's default) divides by
        ``|lambda|``. Collective on a communicator of several processes:
        each product runs on this process's rows, and the squared norm of
        the residual's rows is summed over the shards in shard order (one
        ``psum``), in fp64 (complex128 for a complex operator, applied to
        the complex vector itself)."""
        lam = complex(self._eigenvalues[i])
        vec = np.asarray(self._eigenvectors[i])
        A = self._mat
        if A is None:
            raise RuntimeError("compute_error: no operators set")
        comm = A.comm
        shards = comm.local_shards

        wide = torch.complex128 if A.dtype.is_complex else torch.float64

        def rows(v):
            """This process's shards of the host vector ``v``, fp64."""
            return torch.tensor(comm.local_rows(v), dtype=wide,
                                device=comm.device).view(shards, -1)

        def apply(op, v):
            vv = Vec.from_global(comm, v, dtype=op.dtype)
            return op.mult(vv).data.view(shards, -1).to(wide)

        if A.dtype.is_complex:
            Av = apply(A, vec)
            Bv = apply(self._bmat, vec) if self._bmat is not None \
                else rows(vec)
            r = Av - lam * Bv
            sq = comm.psum([torch.vdot(r[s], r[s]).real
                            for s in range(shards)])
            return self._error(float(torch.sqrt(sq)), lam, error_type)

        # real operators: the real and imaginary parts apart (complex pairs
        # arise for NHEP only)
        vr, vi = np.real(vec), np.imag(vec)
        complex_pair = bool(np.any(vi))
        Avr = apply(A, vr)
        Avi = apply(A, vi) if complex_pair else torch.zeros_like(Avr)
        if self._bmat is not None:
            Bvr = apply(self._bmat, vr)
            Bvi = (apply(self._bmat, vi) if complex_pair
                   else torch.zeros_like(Bvr))
        else:
            Bvr, Bvi = rows(vr), rows(vi)
        # r = A v - lambda B v, its real and imaginary parts
        rr = Avr - (lam.real * Bvr - lam.imag * Bvi)
        ri = Avi - (lam.real * Bvi + lam.imag * Bvr)
        sq = comm.psum([torch.dot(rr[s], rr[s]) + torch.dot(ri[s], ri[s])
                        for s in range(shards)])
        return self._error(float(torch.sqrt(sq)), lam, error_type)

    @staticmethod
    def _error(err, lam, error_type):
        t = str(error_type).lower()
        if t in ("relative", "eps_error_relative"):
            return err / max(abs(lam), np.finfo(np.float64).tiny)
        if t in ("absolute", "eps_error_absolute"):
            return err
        raise ValueError(f"unknown error type {error_type!r}")

    computeError = compute_error

    def __repr__(self):
        return (f"EPS(type={self._type!r}, problem={self._problem_type!r}, "
                f"nev={self.nev}, which={self._which!r}, tol={self.tol})")


class SVD:
    """SLEPc's SVD object, not ported yet (ROADMAP.md Queue A item 7, real
    and complex alike): constructing one raises ``NotImplementedError``."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SVD is not ported yet (ROADMAP.md Queue A item 7); the JAX "
            "package's SVD, complex included, has no counterpart in the port")
