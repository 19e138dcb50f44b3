"""EPS: the eigensolver, the counterpart of SLEPc's EPS object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/eps.py``
(``EPS``, ``:854``), all eight of its types. The reference drives it as
``EPS().create``, ``setOperators``, ``setProblemType(HEP)``,
``setFromOptions``, ``solve``, ``getConverged``, ``getEigenpair(i, vr,
vi)`` (``petsc_funcs.py:13-20``, ``test2.py:88-96``); SLEPc's defaults,
Krylov-Schur with nev 1 and the largest magnitude, are the defaults here.

Types (``set_type`` / ``-eps_type``):

* ``krylovschur``: thick-restart Arnoldi/Lanczos (Krylov-Schur), the JAX
  host loop (``_solve_krylovschur``, ``:1293``, from ``:1347``). The
  factorization steps ``k..ncv-1`` run on the device as CGS2 steps on a
  shard-stacked basis ``(local_shards, ncv+1, lsize)`` with no host read
  inside; the projected matrix ``H``, whose entries are reductions and so
  the same on every process, comes to the host once per restart for the
  small eigenproblem and the restart decision (numpy, on every process),
  and the basis is compressed to the kept Ritz/Schur directions on the
  device. The JAX package's fused whole-solve HEP program (``:383``) is not
  ported: the port runs this loop at every size, one host read per restart
  and one to extract the eigenvectors.
* ``lanczos``: the Hermitian alias of the same loop (its full CGS2
  reorthogonalization makes the factorization a reliable Lanczos process);
  it raises on a non-Hermitian problem.
* ``arnoldi``: explicitly restarted Arnoldi (``_solve_arnoldi_explicit``,
  ``:1423``): each restart factorizes afresh from the sum of the wanted
  Ritz directions, made on the device.
* ``power``: power iteration in chunks of 8 normalized steps on the device,
  one host read a chunk (``_solve_power``, ``:1469``).
* ``subspace``: subspace iteration (``_solve_subspace``, ``:1509``).
* ``lobpcg``: Knyazev's LOBPCG for the extreme pairs of a Hermitian or
  generalized Hermitian problem (``_solve_lobpcg``, ``:1602``).
* ``gd``: block generalized Davidson, Hermitian problems (``_solve_gd``,
  ``:1778``), its basis ``V``, ``A V`` and Ritz blocks on the device and
  the projected matrix brought to the host each outer iteration.
* ``lapack``: SLEPc's EPSLAPACK, the whole dense problem solved on the host,
  the small-n oracle.

Two routes, as in the JAX package. ``lobpcg`` and Hermitian ``subspace``
take the device route, the JAX package's fused loop programs
(``_build_lobpcg_loop_program``, ``:708``; ``_build_subspace_loop_program``,
``:587``) run as eager loops: the ``(local_shards, rows, lsize)`` blocks stay
on the device, and only the small Gram and projected matrices (reductions,
the same on every process) come to the host, where numpy's ``eigh`` solves
them; every such read counts in ``result.host_syncs``. The route is taken
unless a monitor is set or ``TPU_SOLVE_EPS_FUSED`` is ``0``/``false``, at
every size (the JAX package's ``n >= 4096`` threshold off the CPU guards a
TPU compile-cache load the port does not have). Otherwise they take the
host route, the JAX host loops (``:1559``, ``:1677``), whose blocks live on
the host and go through the device for each operator application.

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
mapped back; ``lobpcg`` takes ``B`` itself, through its block products.

On a communicator of several processes (``ProcessComm``) every process
runs the solve on its shards (SPMD) and takes the same decisions from the
same reduced matrices (each one ``psum`` in shard order); the Ritz vectors
are gathered once at the end. Extraction is host-replicated:
``get_eigenpair`` reads stored host arrays and makes no collective call, so
a driver may call it on one rank only, as the reference ``test2.py`` does.
``compute_error`` is collective: the operator's product and one ``psum`` of
the residual's local rows.

Singular values are :mod:`.svd`'s, an EPS on the cross product.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core.vec import Vec
from ..parallel.mesh import numpy_dtype
from ..utils.dtypes import host_dtype, is_complex
from ..resilience import faults as _faults
from ..utils.convergence import SolveResult
from ..utils.errors import wrap_device_errors
from ..utils.options import env_value, global_options
from ..utils.profiling import record_event, record_sync
from ..telemetry import spans as _telemetry
from .krylov import _cgs2_step, _pmatdot, shardwise_matmul
from .mg import _tf32_allowed
from .st import ST

DEFAULT_TOL = 1e-8        # SLEPc's EPS default
DEFAULT_MAX_RESTARTS = 100

EPS_TYPES = ("krylovschur", "lanczos", "lapack", "arnoldi", "power",
             "subspace", "lobpcg", "gd")

# the JAX package's caps (eps.py:1516, :1635, :1810) and their messages,
# kept as the user-visible contract although torch unrolls nothing: past
# them the JAX package raises, so the port does
_SUBSPACE_NCV_CAP = 32
_LOBPCG_BS_CAP = 16
_GD_BS_CAP = 16
POWER_STEPS = 8        # normalized power steps a chunk, one host read each


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


# ---- the block pieces of lobpcg, subspace and gd ------------------------------
# A block of ``rows`` vectors lives shard-stacked as ``(local_shards, rows,
# lsize)``, the layout of the Krylov-Schur basis and the ``(L, k, lsize)``
# operand of the batched products.

def _block_apply(op, comm):
    """``apply(Y (local_shards, rows, lsize)) -> op Y``: the operator's
    batched product where it has one (the stencil's ``local_spmv_many``, one
    ``stencil7_apply_many`` launch per shard; ``Mat``'s batched ELL/DIA
    product), else its ``local_spmv`` row by row (ST operators, shells).
    The JAX package applies one SpMV a row (``_build_block_mult_program``,
    ``:564``)."""
    many = getattr(op, "local_spmv_many", None)
    if many is not None:
        return many(comm)
    spmv = op.local_spmv(comm)

    def apply(Y):
        return torch.stack([spmv(Y[:, j]) for j in range(Y.shape[1])], dim=1)
    return apply


def _put_block(comm, M, dtype):
    """Host rows ``(rows, n)`` -> this process's device block ``(L, rows,
    lsize)`` in ``dtype``, the padding zero."""
    return comm.put_cols(np.ascontiguousarray(np.asarray(M).T), dtype=dtype)


def _fetch_block(comm, Y, n):
    """Device block -> the host rows ``(rows, n)`` on every process."""
    return comm.fetch_cols(Y, n).T


def _dev(a, dtype, device):
    """A small host array (a coefficient matrix) on the device."""
    return torch.tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _prow_dots(comm, Y, Z):
    """Per row ``psum sum_k conj(Y_rk) Z_rk``, shape ``(rows,)``."""
    return comm.psum([(Y[i].conj() * Z[i]).sum(dim=-1)
                      for i in range(comm.local_shards)])


def _prow_norms(comm, Y):
    return torch.sqrt(_prow_dots(comm, Y, Y).real)


def _pgram(comm, Y, Z):
    """``psum Y_i^* Z_i^T``, shape ``(rows_Y, rows_Z)``: the projected
    matrix with the projector rows conjugated (JAX ``B.conj() @ AS.T``)."""
    return comm.psum([Y[i].conj() @ Z[i].T for i in range(comm.local_shards)])


def _read(*tensors):
    """One device-to-host read of several small tensors: numpy arrays, the
    real ones real, in the host's fp64 precision."""
    dt = functools.reduce(torch.promote_types, [t.dtype for t in tensors])
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        a = flat[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
        out.append(a.astype(np.complex128) if t.is_complex()
                   else np.real(a).astype(np.float64))
    return out


def _unit_rows(vecs):
    """The rows of ``vecs`` scaled to unit norm (zero rows kept)."""
    nrm = np.linalg.norm(vecs, axis=1, keepdims=True)
    nrm[nrm == 0] = 1.0
    return vecs / nrm


def _lead(flags) -> int:
    """The count of leading True flags (the contiguous convergence count)."""
    return int(np.cumprod(np.asarray(flags, dtype=np.int64)).sum())


def _orth_factor(G, tiny):
    """One pass of the JAX ``_sym_orth`` (``:343``) on the host: from the
    Gram matrix ``G = Y Y^H`` the factor ``M = diag(w^-1/2) V^H`` of its
    eigendecomposition, the near-null directions (``w <= 1e-12 w_max``)
    masked to zero rows, and the kept-direction mask."""
    G = (G + G.conj().T) / 2.0
    w, V = np.linalg.eigh(G)
    g = w > max(w[-1], tiny) * 1e-12
    inv = np.where(g, 1.0 / np.sqrt(np.where(g, w, 1.0)), 0.0)
    return inv[:, None] * V.conj().T, g


class _Reads:
    """The host reads of one solve: each one counted, and recorded under
    its kind (``utils/profiling.record_sync``)."""

    def __init__(self):
        self.count = 0

    def __call__(self, kind, *tensors):
        self.count += 1
        record_sync(kind)
        return _read(*tensors)


def _sym_orth(comm, Y, tiny, reads, kind, passes=2, extra=(),
              stop=None):
    """The JAX ``_sym_orth`` (``:343``) on a device block: normalize the
    rows first, then ``passes`` symmetric (eigh-based) orthonormalizations,
    each from the psum'd Gram matrix read on the host. Returns ``(B, good,
    K, extra_h)``: ``good`` the first pass's kept directions, ``K`` the host
    transform with ``B = K Y``, ``extra_h`` the host values of the small
    tensors ``extra``, which ride the first read. When ``stop(extra_h)`` is
    true after that read, returns ``(None, None, None, extra_h)`` at once."""
    dt = Y.dtype
    inv0 = 1.0 / torch.clamp(_prow_norms(comm, Y), min=tiny)
    Y = Y * inv0[:, None].to(dt)
    K, good = None, None
    for p in range(passes):
        G = _pgram(comm, Y, Y).conj()
        if p == 0:
            *extra_h, inv0_h, G_h = reads(kind, *extra, inv0, G)
            if stop is not None and stop(extra_h):
                return None, None, None, extra_h
            K = np.diag(inv0_h)
        else:
            G_h, = reads(kind, G)
        M, g = _orth_factor(G_h, tiny)
        Y = shardwise_matmul(_dev(M, dt, Y.device), Y)
        K = M @ K
        good = g if good is None else good
    return Y, good, K, extra_h


def _lobpcg_seed(op, n: int, m: int, dtype):
    """The LOBPCG start block (orthonormal rows from ``default_rng
    (20240901)``) and the Jacobi diagonal's inverse, both routes' start (the
    JAX ``_lobpcg_seed``, ``:688``, the same arrays)."""
    hdt = host_dtype(dtype)
    rng = np.random.default_rng(20240901)
    X0 = rng.standard_normal((m, n)).astype(hdt)
    if is_complex(dtype):
        X0 = X0 + 1j * rng.standard_normal((m, n))
    X0 = np.linalg.qr(X0.T)[0].T
    try:
        diag = np.asarray(op.diagonal(), dtype=hdt)
        dinv = np.where(np.abs(diag) > 0,
                        1.0 / np.where(diag == 0, 1.0, diag),
                        1.0).astype(hdt)
    except (ValueError, AttributeError):
        dinv = np.ones(n, dtype=hdt)
    return X0, dinv


def _lobpcg_coefficients(Ag, Bg, sign, m, tiny, big):
    """The 3m x 3m projected pencil of the device route (JAX ``:784-800``):
    whitened by ``Bg``'s eigendecomposition, the masked directions pushed
    to ``+big``, and the ``m`` wanted Ritz coefficients ``C`` (``Bg``-
    orthonormal columns)."""
    Ag = (Ag + Ag.conj().T) / 2.0
    Bg = (Bg + Bg.conj().T) / 2.0
    wb, Vb = np.linalg.eigh(Bg)
    goodb = wb > max(wb[-1], tiny) * 1e-12
    ib = np.where(goodb, 1.0 / np.sqrt(np.where(goodb, wb, 1.0)), 0.0)
    T = Vb * ib[None, :]
    Ag2 = T.conj().T @ (sign * Ag) @ T
    Ag2 = (Ag2 + Ag2.conj().T) / 2.0
    Ag2 = Ag2 + np.diag(np.where(goodb, 0.0, big))
    _, C2 = np.linalg.eigh(Ag2)
    return T @ C2[:, :m]


def _reseed_block(comm, shape, it, dtype, mask):
    """The refill of ``_sym_orth``-masked subspace rows: standard normals
    from a CPU ``torch.Generator`` seeded by ``(7, iteration, global shard
    index)``, the same on ``DeviceComm`` and ``ProcessComm`` and on any
    device, the padding rows zeroed. (The JAX package folds the iteration
    and the shard index into ``PRNGKey(7)``, ``:627``; those bits are
    ``jax.random``'s.)"""
    real = torch.empty((), dtype=dtype).real.dtype
    parts = []
    for i in range(comm.local_shards):
        seed = np.random.SeedSequence(
            [7, int(it), comm.shard_offset + i]).generate_state(1)[0]
        g = torch.Generator().manual_seed(int(seed))
        parts.append(torch.randn(shape, generator=g, dtype=real))
    return torch.stack(parts).to(device=mask.device, dtype=dtype) * mask


def _check_tf32(comm, dtype):
    """The eigensolvers' projections need full-precision fp32 products on
    CUDA (real and complex fp32 alike)."""
    if (comm.device.type == "cuda"
            and dtype in (torch.float32, torch.complex64)
            and _tf32_allowed()):
        raise RuntimeError(
            "EPS needs full-precision fp32 matmuls on CUDA for its "
            "projections; TF32 is enabled (set "
            "torch.backends.cuda.matmul.fp32_precision = 'ieee', or "
            "torch.set_float32_matmul_precision('highest'))")


def _device_route(monitored: bool) -> bool:
    """Whether lobpcg and Hermitian subspace take the device route: unless
    monitored (a monitor needs the host loops' per-iteration point) or
    ``TPU_SOLVE_EPS_FUSED`` is ``0``/``false``. The JAX package's
    ``_want_fused`` (``:485``) also takes it on the CPU at every size, and
    elsewhere from n = 4096; the port takes it at every size."""
    if (env_value("eps_fused") or "") in ("0", "false"):
        return False
    return not monitored


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
        self.gd_blocksize = 0         # -eps_gd_blocksize (0: nev)
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
        ``-eps_target``, ``-eps_gd_blocksize``, ``-eps_monitor`` and the ST
        options (the reference's ``E.setFromOptions()``,
        ``petsc_funcs.py:17``)."""
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
        self.gd_blocksize = opt.get_int("eps_gd_blocksize",
                                        self.gd_blocksize)
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
            elif self._type in ("power", "subspace", "lobpcg", "gd",
                                "arnoldi"):
                syncs = getattr(self, f"_solve_{self._type}")()
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
        vecs = _unit_rows(V[:, take].T)
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
        _check_tf32(comm, dtype)
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
        return self.st.back_transform(lam_t[take]), _unit_rows(vecs)

    # ---- the restrictions of the other types --------------------------------
    def _dominant_only(self, solver: str):
        """power and subspace converge to the dominant (transformed)
        subspace: any other selection, or a transform under which dominance
        no longer means wanted (a nonzero shift), would return wrong pairs
        (JAX ``:1220``; SLEPc's EPSPOWER errors the same way)."""
        ok = (self._which == EPSWhich.LARGEST_MAGNITUDE
              and self.st.is_identity()) or (
            self._which == EPSWhich.TARGET_MAGNITUDE
            and self.st.get_type() == "sinvert")
        if not ok:
            raise ValueError(
                f"EPS {solver!r} computes dominant eigenpairs only — use "
                f"which='largest_magnitude' with no spectral transform, or "
                f"'target_magnitude' with ST 'sinvert' (got "
                f"which={self._which!r}, st={self.st.get_type()!r} "
                f"shift={self.st.sigma}); krylovschur supports all "
                "selections")

    def _extreme_only(self, solver: str):
        """lobpcg and gd compute extreme eigenvalues, with no spectral
        transform (JAX ``:1623-1630``, ``:1799-1806``)."""
        if self._which not in (EPSWhich.SMALLEST_REAL, EPSWhich.LARGEST_REAL):
            raise ValueError(
                f"EPS {solver!r} computes extreme eigenvalues — set "
                "which='smallest_real' or 'largest_real' (got "
                f"{self._which!r}); krylovschur supports all selections")
        if not self.st.is_identity():
            raise ValueError(f"EPS {solver!r} supports no spectral transform "
                             "— use krylovschur with ST 'sinvert'")

    def _block_rows(self, comm, op, n):
        """``apply_rows(M (rows, n) host) -> op M`` on the host, through the
        device: one batched product of all the rows and one host read
        (the host routes' block product; JAX pads each call to the block
        size, ``_apply_blocked``, ``:835``, and zero rows add nothing).
        Returns ``(apply_rows, reads)``, ``reads()`` the reads made."""
        apply = _block_apply(op, comm)
        count = [0]

        def apply_rows(M):
            count[0] += 1
            record_sync(f"EPS {self._type} fetch/block-mult")
            return _fetch_block(comm, apply(_put_block(comm, M, op.dtype)), n)
        return apply_rows, (lambda: count[0])

    # ---- explicitly restarted arnoldi ----------------------------------------
    def _solve_arnoldi(self) -> int:
        """Explicitly restarted Arnoldi (the JAX ``_solve_arnoldi_explicit``,
        ``:1423``): every restart a fresh ncv-step factorization from the
        sum of the wanted Ritz directions, formed on the device from the
        basis; one host read of ``H`` a restart and one for the
        eigenvectors."""
        comm, op, inner, hermitian = self._setup_operator()
        n = op.shape[0]
        ncv = self._effective_ncv(n)
        nev = min(self.nev, ncv)
        dtype = op.dtype
        size = comm.local_shards
        _check_tf32(comm, dtype)
        spmv = op.local_spmv(comm)
        pmatdot, pnorm = _inner_products(comm, inner)
        v0 = comm.put_rows(self._start_vector(comm, n, numpy_dtype(dtype)))
        V = v0.new_zeros((size, ncv + 1, v0.numel() // size))
        V[:, 0] = v0.view(size, -1)
        syncs = 0
        for restarts in range(1, self.max_it + 1):
            H = V.new_zeros((ncv + 1, ncv))
            _facto_steps(spmv, pmatdot, pnorm, V, H, 0, ncv)
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
            # the restart vector: the wanted Ritz directions summed (a real
            # operator takes the real part of complex-pair columns)
            comb = S[:, order[:nev]].sum(axis=1)
            w = comb if is_complex(dtype) else comb.real
            start = shardwise_matmul(_dev(w[None, :], dtype, V.device),
                                     V[:, :ncv])
            V = torch.zeros_like(V)
            V[:, 0] = start[:, 0]

        count = max(nev, 1)
        lam, vecs = self._extract(comm, V, S, lam_t, order, n, count)
        syncs += 1
        record_sync("EPS basis fetch/solve")
        self._store(lam, vecs, rel[:count], nconv, restarts)
        return syncs

    # ---- power iteration ----------------------------------------------------
    def _solve_power(self) -> int:
        """Power iteration (JAX ``_solve_power``, ``:1469``, with
        ``_build_power_program``, ``:526``): chunks of ``POWER_STEPS``
        normalized steps on the device, then the Rayleigh quotient (complex
        for a complex operator) and the residual norm, read on the host
        once a chunk; one more read for the eigenvector."""
        self._dominant_only("power")
        comm, op, inner, hermitian = self._setup_operator()
        if inner is not None:
            raise ValueError("EPS 'power' supports standard problems only "
                             "(use krylovschur for GHEP)")
        n = op.shape[0]
        dtype = op.dtype
        size = comm.local_shards
        spmv = op.local_spmv(comm)

        def pnorm(u):
            return torch.sqrt(comm.psum([torch.vdot(u[i], u[i]).real
                                         for i in range(size)]))

        v = comm.put_rows(self._start_vector(comm, n, numpy_dtype(dtype)))
        v = v.view(size, -1)
        theta, rel, its, syncs = 0.0, np.inf, 0, 0
        for chunk in range(1, self.max_it + 1):
            v = v / pnorm(v)
            for _ in range(POWER_STEPS):
                w = spmv(v)
                v = w / pnorm(w)
            w = spmv(v)
            th = comm.psum([torch.vdot(v[i], w[i]) for i in range(size)])
            th_h, res_h = _read(th, pnorm(w - th * v))
            syncs += 1
            record_sync("EPS power fetch/chunk")
            theta = complex(th_h) if is_complex(dtype) else float(th_h)
            rel = float(res_h) / max(abs(theta), 1e-300)
            its = chunk * POWER_STEPS
            if self._monitored():
                self._emit_monitor(
                    its, 1 if rel <= self.tol else 0,
                    self.st.back_transform(np.asarray([theta])), [rel])
            if rel <= self.tol:
                break

        lam = self.st.back_transform(np.asarray([theta]))
        vec = comm.host_fetch(v.reshape(-1))[:n]
        syncs += 1
        record_sync("EPS basis fetch/solve")
        self._store(lam, _unit_rows(vec[None, :]), [rel],
                    1 if rel <= self.tol else 0, its)
        return syncs

    # ---- subspace iteration --------------------------------------------------
    def _solve_subspace(self) -> int:
        """Subspace iteration (JAX ``_solve_subspace``, ``:1509``): the
        device route for a Hermitian problem, else the host loop."""
        self._dominant_only("subspace")
        comm, op, inner, hermitian = self._setup_operator()
        if inner is not None:
            raise ValueError("EPS 'subspace' supports standard problems only "
                             "(use krylovschur for GHEP)")
        n = op.shape[0]
        if (self.ncv is not None and self.ncv > _SUBSPACE_NCV_CAP) or \
                self.nev > _SUBSPACE_NCV_CAP:
            raise ValueError(
                f"EPS 'subspace' caps ncv at {_SUBSPACE_NCV_CAP} (the block "
                "operator applications are unrolled into one program) — "
                "use krylovschur for larger subspaces")
        ncv = min(self._effective_ncv(n), _SUBSPACE_NCV_CAP)
        nev = min(self.nev, ncv)
        dtype = op.dtype
        _check_tf32(comm, dtype)
        rng = np.random.default_rng(20240901)
        Y = rng.standard_normal((ncv, comm.padded_size(n))).astype(
            numpy_dtype(dtype))
        Y[:, n:] = 0.0
        if hermitian and _device_route(self._monitored()):
            return self._subspace_device(comm, op, Y, ncv, nev, n)
        return self._subspace_host(comm, op, Y, ncv, nev, n, hermitian)

    def _subspace_device(self, comm, op, Y0, ncv, nev, n) -> int:
        """The device route (JAX ``_build_subspace_loop_program``, ``:587``)
        as an eager loop: each iteration orthonormalizes the block with
        ``_sym_orth`` (two host reads of its Gram matrices), refills rows it
        masked (one more read), applies the operator to the block, reads
        the ncv x ncv projected matrix, forms the Ritz rows on the device
        and reads their residual norms: 4 reads an iteration (5 with a
        refill), one for the eigenvectors."""
        dtype = op.dtype
        tiny = float(np.finfo(numpy_dtype(dtype)).tiny)
        apply = _block_apply(op, comm)
        reads = _Reads()
        kind = "EPS subspace fetch/iteration"
        dev = functools.partial(_dev, dtype=dtype, device=comm.device)
        Y = _put_block(comm, Y0, dtype)
        mask = comm.put_rows(np.ones(n), dtype=dtype).view(
            comm.local_shards, 1, -1)
        X = torch.zeros_like(Y)
        lam_o, rel = np.zeros(ncv), np.full(ncv, np.inf)
        it, nconv = 0, 0
        while nconv < nev and it < self.max_it:
            Q, good, _, _ = _sym_orth(comm, Y, tiny, reads, kind)
            if not good.all():
                # a masked row is a zero row, and a zero row's power step
                # stays zero: refill it with a random direction
                # orthogonalized against the kept rows (JAX :617-638)
                Z = _reseed_block(comm, tuple(Q.shape[1:]), it, dtype, mask)
                G = comm.psum([Z[i] @ Q[i].conj().T
                               for i in range(comm.local_shards)])
                Z = Z - shardwise_matmul(G, Q)
                Z = Z * (1.0 / torch.clamp(_prow_norms(comm, Z), min=tiny)
                         )[:, None].to(dtype)
                keep = torch.tensor(good, device=Q.device)[:, None]
                Q = _sym_orth(comm, torch.where(keep, Q, Z), tiny, reads,
                              kind, passes=1)[0]
            W = apply(Q)
            Hm, = reads(kind, _pgram(comm, Q, W))
            lam, S = np.linalg.eigh((Hm + Hm.conj().T) / 2.0)
            order = self._select(self.st.back_transform(lam))
            St = dev(S[:, order].T)
            X = shardwise_matmul(St, Q)                # Ritz rows
            lam_o = lam[order]
            R = shardwise_matmul(St, W) - dev(lam_o)[:, None] * X
            rn, = reads(kind, _prow_norms(comm, R))
            rel = rn / np.maximum(np.abs(lam_o), tiny)
            nconv = _lead(rel[:nev] <= self.tol)
            Y = W                                      # the power step
            it += 1

        count = max(nev, 1)
        vecs = _fetch_block(comm, X[:, :count], n)
        record_sync("EPS basis fetch/solve")
        self._store(self.st.back_transform(lam_o[:count]), _unit_rows(vecs),
                    rel[:count], nconv, it)
        return reads.count + 1

    def _subspace_host(self, comm, op, Y, ncv, nev, n, hermitian) -> int:
        """The host loop (JAX ``:1559-1599``): Householder QR, the projected
        problem and the Ritz rows on the host, the block product through the
        device, one read an iteration."""
        apply_rows, reads = self._block_rows(comm, op, n)
        for it in range(1, self.max_it + 1):
            Q = np.linalg.qr(Y[:, :n].T)[0].T       # (ncv, n) orthonormal rows
            W = apply_rows(Q)
            # Hm[i,j] = <q_i, A q_j> (conjugate on the projector row)
            Hm = Q.conj() @ W.T
            if hermitian:
                lam_t, S = np.linalg.eigh((Hm + Hm.conj().T) / 2.0)
            else:
                lam_t, S = np.linalg.eig(Hm)
            order = self._select(self.st.back_transform(lam_t))
            X = S[:, order].T @ Q                     # Ritz rows (ncv, n)
            R = S[:, order].T @ W - lam_t[order][:, None] * X
            rel = (np.linalg.norm(R, axis=1)
                   / np.maximum(np.abs(lam_t[order]), 1e-300))
            nconv = _lead(rel[:nev] <= self.tol)
            if self._monitored():
                self._emit_monitor(it, nconv,
                                   self.st.back_transform(lam_t[order]),
                                   rel)
            if nconv >= nev or it == self.max_it:
                break
            # the power step Y <- A Q (a real operator drops the imaginary
            # parts complex-pair arithmetic can bring in)
            Y = np.zeros_like(Y)
            Y[:, :n] = W if np.iscomplexobj(Y) else np.real(W)

        count = max(nev, 1)
        self._store(self.st.back_transform(lam_t[order[:count]]),
                    _unit_rows(X[:count]), rel[:count], nconv, it)
        return reads()

    # ---- LOBPCG --------------------------------------------------------------
    def _solve_lobpcg(self) -> int:
        """Locally Optimal Block Preconditioned CG (Knyazev 2001; SLEPc's
        EPSLOBPCG; JAX ``_solve_lobpcg``, ``:1602``): the extreme pairs of a
        Hermitian or generalized Hermitian pencil, each iteration a
        Rayleigh-Ritz over the 3m rows ``[X; T R; P]`` (iterates,
        Jacobi-preconditioned residuals, search directions). ``which`` is
        smallest_real or largest_real, with no spectral transform."""
        if self._problem_type not in (EPSProblemType.HEP,
                                      EPSProblemType.GHEP):
            raise ValueError("EPS 'lobpcg' needs a Hermitian problem type "
                             "(hep/ghep)")
        self._extreme_only("lobpcg")
        comm, op, bop = self._mat.comm, self._mat, self._bmat
        n = op.shape[0]
        m = min(max(self.nev, 1), _LOBPCG_BS_CAP, n)
        if self.nev > _LOBPCG_BS_CAP:
            raise ValueError(
                f"EPS 'lobpcg' caps the block size at {_LOBPCG_BS_CAP} — "
                "use krylovschur for more pairs")
        _check_tf32(comm, op.dtype)
        sign = -1.0 if self._which == EPSWhich.LARGEST_REAL else 1.0
        if _device_route(self._monitored()):
            return self._lobpcg_device(comm, op, bop, m, n, sign)
        return self._lobpcg_host(comm, op, bop, m, n, sign)

    def _lobpcg_device(self, comm, op, bop, m, n, sign) -> int:
        """The device route (JAX ``_build_lobpcg_loop_program``, ``:708``) as
        an eager loop. Each iteration evaluates the block ``X`` on the device
        (Rayleigh quotients, residuals) and reads its values with the first
        ``_sym_orth`` Gram matrix of ``[X; T R; P]``; unless ``X`` converged
        or the iteration cap is reached, a second Gram read and one read of
        the 3m x 3m pencil follow, whose whitened ``eigh`` gives the new
        ``X`` and, by Knyazev's coefficient split, the new ``P``. Host reads:
        ``3 its - 2`` (1 when the start block converged), and one for the
        eigenvectors."""
        dtype = op.dtype
        fi = np.finfo(numpy_dtype(dtype))
        tiny = float(fi.tiny)
        # the masked directions' push-out: it must dominate every Ritz value
        # and, as in the JAX program, survive squaring at 32 bits
        big = 1e30 if fi.bits >= 64 else 1e12
        nev_m = min(self.nev, m)
        X0, dinv = _lobpcg_seed(op, n, m, dtype)
        X = _put_block(comm, X0, dtype)
        dinv = comm.put_rows(dinv, dtype=dtype).view(comm.local_shards, 1, -1)
        apply_a = _block_apply(op, comm)
        apply_b = _block_apply(bop, comm) if bop is not None else None
        AX = apply_a(X)
        BX = apply_b(X) if apply_b is not None else X
        P = torch.zeros_like(X)
        reads = _Reads()
        kind = "EPS lobpcg fetch/iteration"
        dev = functools.partial(_dev, dtype=dtype, device=X.device)
        its, nconv, theta_h, rel_h = 0, 0, None, None
        while True:
            num = _prow_dots(comm, X, AX).real
            den = _prow_dots(comm, X, BX).real
            theta = num / torch.where(den == 0, 1.0, den)
            R = AX - theta[:, None].to(dtype) * BX
            rel = _prow_norms(comm, R) / torch.clamp(theta.abs(), min=tiny)
            S0 = torch.cat([X, R * dinv, P], dim=1)       # (L, 3m, lsize)

            def done(h, its=its):
                nonlocal nconv, theta_h, rel_h
                theta_h, rel_h = h
                ordm = np.argsort(sign * theta_h, kind="stable")
                nconv = _lead(rel_h[ordm][:nev_m] <= self.tol)
                return nconv >= nev_m or its + 1 >= self.max_it

            B, _, K, _ = _sym_orth(comm, S0, tiny, reads, kind,
                                   extra=(theta, rel), stop=done)
            if its > 0 or (nconv < nev_m and self.max_it > 0):
                its += 1   # the JAX loop's body; none if X0 converged
            if B is None:
                break
            AS = apply_a(B)
            BS = apply_b(B) if apply_b is not None else B
            Ag, Bg = reads(kind, _pgram(comm, B, AS), _pgram(comm, B, BS))
            C = _lobpcg_coefficients(Ag, Bg, sign, m, tiny, big)
            # the new search directions: the part of the new X built from
            # the W and P rows (Xn = C^T B = C^T K S0, so D = K^T C holds
            # Xn's coefficients over [X; W; P])
            D = K.T @ C
            Ct = dev(C.T)
            X = shardwise_matmul(Ct, B)
            AX = shardwise_matmul(Ct, AS)
            BX = shardwise_matmul(Ct, BS) if apply_b is not None else X
            P = shardwise_matmul(dev(D[m:].T), S0[:, m:])

        # the block just evaluated: its pairs are the ones that passed
        Xh = _fetch_block(comm, X, n)
        record_sync("EPS basis fetch/solve")
        order = np.argsort(sign * theta_h, kind="stable")
        take = order[:max(nev_m, 1)]
        self._store(theta_h[take], _unit_rows(Xh[take]), rel_h[take], nconv,
                    its)
        return reads.count + 1

    def _lobpcg_host(self, comm, op, bop, m, n, sign) -> int:
        """The host loop (JAX ``:1677-1775``): the blocks on the host, the
        projected pencil by ``scipy.linalg.eigh``, a pivoted QR dropping
        near-dependent trial rows, the block products through the device
        (one read each: ``its (1 + [B])``)."""
        import scipy.linalg
        hdt = host_dtype(op.dtype)
        A_rows, a_reads = self._block_rows(comm, op, n)

        def A_apply(M):
            return A_rows(M).astype(hdt)

        if bop is not None:
            B_rows, b_reads = self._block_rows(comm, bop, n)

            def B_apply(M):
                return B_rows(M).astype(hdt)
        else:
            b_reads = lambda: 0

            def B_apply(M):
                return M

        X, dinv_h = _lobpcg_seed(op, n, m, op.dtype)
        Pdir = np.zeros((0, n), dtype=hdt)
        theta = np.zeros(m)
        rel = np.full(m, np.inf)
        nconv = 0

        def rr_basis(S):
            """Drop near-dependent rows (rank-revealing QR), orthonormalize."""
            Q, R, _ = scipy.linalg.qr(S.T, mode="economic", pivoting=True)
            d = np.abs(np.diag(R))
            return Q[:, d > max(d[0], 1e-300) * 1e-12].T

        it = 0
        AX = BX = None
        for it in range(1, self.max_it + 1):
            if AX is None:        # later iterations reuse C^T (A S), C^T (B S)
                AX = A_apply(X)
                BX = B_apply(X)
            theta = np.real(np.sum(X.conj() * AX, axis=1)
                            / np.sum(X.conj() * BX, axis=1))
            R = AX - theta[:, None] * BX
            rel = (np.linalg.norm(R, axis=1)
                   / np.maximum(np.abs(theta), 1e-300))
            order0 = np.argsort(sign * theta, kind="stable")
            nconv = _lead(rel[order0[:min(self.nev, m)]] <= self.tol)
            if self._monitored():
                self._emit_monitor(it, nconv, theta[order0], rel[order0])
            if nconv >= min(self.nev, m) or it == self.max_it:
                break
            W = R * dinv_h[None, :]
            S = rr_basis(np.vstack([X, W, Pdir]) if len(Pdir)
                         else np.vstack([X, W]))
            AS = A_apply(S)
            BS = B_apply(S) if bop is not None else S
            Ag = S.conj() @ AS.T
            Bg = S.conj() @ BS.T
            _, C = scipy.linalg.eigh(sign * (Ag + Ag.conj().T) / 2.0,
                                     (Bg + Bg.conj().T) / 2.0)
            C = C[:, :m]                      # the m best, wanted direction
            Xn = C.T @ S
            # new search directions: the part of Xn outside span(X)
            Pdir = Xn - (Xn @ X.conj().T) @ X
            Pdir = Pdir[np.linalg.norm(Pdir, axis=1) > 1e-12]
            # Xn's rows are the B-orthonormal Ritz vectors; A Xn and B Xn
            # come from the basis images
            X = Xn
            AX = C.T @ AS
            BX = (C.T @ BS) if bop is not None else Xn

        order = np.argsort(sign * theta, kind="stable")
        take = order[:max(min(self.nev, m), 1)]
        self._store(theta[take], _unit_rows(X[take]), rel[take], nconv, it)
        return a_reads() + b_reads()

    # ---- gd (block generalized Davidson, SLEPc's EPSGD) ----------------------
    def _solve_gd(self) -> int:
        """Block generalized Davidson (JAX ``_solve_gd``, ``:1778``),
        Hermitian problems: a Rayleigh-Ritz over the growing basis ``V``,
        expanded by the Davidson-corrected residuals ``(D - theta)^-1 r`` of
        the ``m`` current Ritz pairs (``D`` the diagonal, its denominators
        held off zero), thick-restarted to the Ritz block when ``V`` reaches
        ncv. ``V``, ``A V``, the Ritz block and the corrections stay on the
        device; each outer iteration reads the projected matrix ``V^H A V``,
        the residual norms and the corrections' norms (the last iteration
        the first two), and one read brings the eigenvectors: ``3 its``
        reads. Rows that vanish in the two-pass projection against ``V`` are
        reseeded from ``default_rng(20240901)``, as in the JAX package;
        the corrections are then orthonormalized by Gram-Schmidt on the
        device (the JAX package's Householder QR, up to the rows' signs)."""
        import scipy.linalg
        if self._problem_type != EPSProblemType.HEP:
            raise ValueError("EPS 'gd' supports problem type 'hep' — use "
                             "lobpcg for GHEP, krylovschur for NHEP")
        self._extreme_only("gd")
        comm, op = self._mat.comm, self._mat
        n = op.shape[0]
        if self.nev > _GD_BS_CAP:
            raise ValueError(
                f"EPS 'gd' caps the block size at {_GD_BS_CAP} — use "
                "krylovschur for more pairs")
        if self.gd_blocksize > _GD_BS_CAP:
            raise ValueError(
                f"-eps_gd_blocksize {self.gd_blocksize} exceeds the "
                f"{_GD_BS_CAP} cap (block spmvs are statically unrolled)")
        # -eps_gd_blocksize widens the expansion block past nev (never below
        # it: the first nev Ritz pairs are the convergence targets)
        m = min(max(self.gd_blocksize, self.nev, 1), n)
        if self.ncv is not None and min(self.ncv, n) <= m < n:
            raise ValueError(
                f"EPS 'gd': ncv ({self.ncv}) must exceed the expansion "
                f"block size ({m}) — raise -eps_ncv or shrink "
                "-eps_gd_blocksize/nev")
        mmax = min(n, max(self._effective_ncv(n), m + 1))
        sign = -1.0 if self._which == EPSWhich.LARGEST_REAL else 1.0
        dtype = op.dtype
        hdt = host_dtype(dtype)
        size = comm.local_shards
        _check_tf32(comm, dtype)
        apply = _block_apply(op, comm)
        reads = _Reads()
        kind = "EPS gd fetch/iteration"
        _, pnorm = _inner_products(comm, None)
        pmatdot = _pmatdot(comm)
        dev = functools.partial(_dev, dtype=dtype, device=comm.device)
        rng = np.random.default_rng(20240901)
        X0, _ = _lobpcg_seed(op, n, m, dtype)
        try:
            diag = np.asarray(op.diagonal(), dtype=hdt)
        except (ValueError, AttributeError):
            diag = np.zeros(n, dtype=hdt)
        diag = comm.put_rows(diag, dtype=dtype).view(size, 1, -1)
        V0 = _put_block(comm, X0, dtype)
        Vb = V0.new_zeros((size, mmax, V0.shape[-1]))   # the basis, k rows
        Wb = torch.zeros_like(Vb)                        # A V
        Vb[:, :m] = V0
        Wb[:, :m] = apply(V0)
        k = m
        theta, rel = np.zeros(m), np.full(m, np.inf)
        X = V0
        nconv, it = 0, 0
        for it in range(1, self.max_it + 1):
            V, W = Vb[:, :k], Wb[:, :k]
            H, = reads(kind, _pgram(comm, V, W))
            mu, S = scipy.linalg.eigh(sign * (H + H.conj().T) / 2.0)
            # the first m of eigh(sign H), ascending: the m most wanted
            theta = np.real(sign * mu[:m])
            St = dev(S[:, :m].T)
            X = shardwise_matmul(St, V)                   # Ritz rows
            AX = shardwise_matmul(St, W)
            R = AX - dev(theta)[:, None] * X
            rnorm, = reads(kind, _prow_norms(comm, R))
            rel = rnorm / np.maximum(np.abs(theta), 1e-300)
            nconv = _lead(rel[:min(self.nev, m)] <= self.tol)
            if self._monitored():
                self._emit_monitor(it, nconv, theta, rel)
            if nconv >= min(self.nev, m) or it == self.max_it:
                break
            if k + 1 > mmax:
                # thick restart to the Ritz block (orthonormal rows)
                Vb[:, :m], Wb[:, :m] = X, AX
                k = m
            t_rows = min(m, mmax - k, n - k)
            if t_rows <= 0:
                break                      # the basis spans the whole space
            # Davidson's diagonal correction (D - theta_i)^-1 r_i, its
            # denominators held at a floor of 1e-3 max(|theta_i|, 1)
            floor = dev(1e-3 * np.maximum(np.abs(theta), 1.0))[:, None]
            denom = diag - dev(theta)[:, None]
            denom = torch.where(denom.abs() < floor.real,
                                torch.where(denom.real >= 0, floor, -floor),
                                denom)
            T = (R / denom)[:, :t_rows]
            V = Vb[:, :k]

            def project(T):
                """Two passes of ``T - (T V^H) V``."""
                for _ in range(2):
                    T = T - shardwise_matmul(
                        comm.psum([T[i] @ V[i].conj().T
                                   for i in range(size)]), V)
                return T

            T = project(T)
            nrm, = reads(kind, _prow_norms(comm, T))
            good = nrm > 1e-10
            if not good.all():
                # reseed the vanished rows instead of losing them
                fresh = rng.standard_normal((int(np.sum(~good)), n))
                if is_complex(dtype):
                    fresh = fresh + 1j * rng.standard_normal(fresh.shape)
                T[:, torch.from_numpy(~good).to(T.device)] = _put_block(
                    comm, fresh, dtype)
                T = project(T)
            # orthonormal rows spanning T's leading rows, in order
            for j in range(t_rows):
                if j == 0:
                    nr = pnorm(T[:, 0])
                    T[:, 0] = T[:, 0] / torch.where(nr == 0, 1.0, nr)
                else:
                    T[:, j] = _cgs2_step(T[:, :j], T[:, j], pmatdot,
                                         pnorm)[2]
            Vb[:, k:k + t_rows] = T
            Wb[:, k:k + t_rows] = apply(T)
            k += t_rows

        count = max(min(self.nev, m), 1)
        vecs = _fetch_block(comm, X[:, :count], n)
        record_sync("EPS basis fetch/solve")
        self._store(theta[:count], _unit_rows(vecs), rel[:count], nconv, it)
        return reads.count + 1

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

