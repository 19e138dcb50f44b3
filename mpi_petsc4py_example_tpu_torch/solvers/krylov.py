"""Krylov kernels and the construction of the solve program.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/krylov.py``:
``cg_kernel`` (``:188``), ``cg_stencil_kernel`` (``:220``), ``bcgs_kernel``
(``:533``), ``gmres_kernel`` (``:732``) with ``_hessenberg_lstsq``
(``:671``) and ``_cgs2_step`` (``:716``), ``fgmres_kernel`` (``:1165``),
``preonly_kernel`` (``:790``), the transpose types ``lsqr_kernel``
(``:1415``), ``bicg_kernel`` (``:1471``) and ``cgne_kernel`` (``:1589``), and
``build_ksp_program`` (``:2091``) with the stencil-CG fast path, the general
route, the null-space projection (``:2320-2335``, ``:2524-2538``) and the
true-residual epilogue (``_true_res_tail``, ``:2551``), without the guard;
and for ``KSP.solve_many`` ``cg_kernel_many`` (``:2662``),
``cg_stencil_kernel_many`` (``:2689``), ``batched_pc_supported``
(``:2741``) and ``build_ksp_program_many`` (``:2748``) with the
true-residual epilogue, without the guard and the pipelined/s-step plans.

The JAX loops are ``lax.while_loop``s on the device; here they are eager
PyTorch driven by the host, with the scalars on the device and one small
host read where the loop decides whether to go on: once per iteration for
CG, BiCGStab, BiCG, CGNE and LSQR (LSQR reads once more for its true
residual), once per restart cycle for GMRES and FGMRES, once per refinement
step for preonly. Every program returns the count of its host reads. A
monitor receives the residual norms those reads bring, in order, so
monitoring adds no read: the JAX package records the same values in its
in-program history buffer and replays them after the solve.

Both builders take the precision plan from the operator's dtype (JAX
``:2177-2186``, ``:2796-2798``): under bfloat16 storage the reductions lift
their operands to fp32 (``:2341-2346``) and the CG loops run the mixed plan;
KSP types without a mixed-precision body raise, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.convergence import ConvergedReason as CR
from . import cg_plans as _plans
from .cg_plans import _dmax, _reason, _tol

KSP_TYPES = ("cg", "gmres", "fgmres", "bcgs", "preonly", "lsqr", "bicg",
             "cgne")
# the JAX package's other types (krylov.py:1999-2025): ROADMAP.md Queue A
# item 5 brings them
UNPORTED_TYPES = ("pipecg", "sstep", "cgs", "tfqmr", "cr", "minres",
                  "chebyshev", "richardson", "gcr", "symmlq", "fcg",
                  "lgmres", "bcgsl", "fbcgs", "fbcgsr")
# the types that need the transpose product A^T v (operator.local_spmv_t)
_NEEDS_TRANSPOSE = ("lsqr", "bicg", "cgne")
# the types whose recurrence carries the natural norm sqrt <r, M r>
NATURAL_TYPES = ("cg",)


def check_ksp_type(ksp_type: str) -> str:
    """``ksp_type`` if the port runs it; ``NotImplementedError`` naming
    Queue A item 5 for the JAX package's other types, ``ValueError`` for a
    type neither package has."""
    if ksp_type in UNPORTED_TYPES:
        raise NotImplementedError(
            f"KSP {ksp_type!r} is not ported yet (ROADMAP.md Queue A item "
            f"5); available: {list(KSP_TYPES)}")
    if ksp_type not in KSP_TYPES:
        raise ValueError(f"unknown KSP type {ksp_type!r}; available: "
                         f"{list(KSP_TYPES)}")
    return ksp_type


def cg_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
              prec=None, monitor=None, natural=False):
    """Preconditioned conjugate gradients (KSPCG) on the general route."""
    return _plans.classic_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        A=A, M=M, pdot=pdot, pnorm=pnorm, prec=prec, monitor=monitor,
        natural=natural)


def cg_stencil_kernel(Adot, inv_diag, pdot, pnorm, b, x0, rtol, atol, maxit,
                      dtol=None, grid3d=None, M3=None, prec=None,
                      monitor=None):
    """CG fast path for uniform-diagonal stencil operators with PC none,
    jacobi or mg: the same recurrence as :func:`cg_kernel`, with the SpMV and
    ``<p, Ap>`` in one fused kernel pass (``Adot``) and the Jacobi apply a
    scalar multiply, or, with ``M3`` (the grid-shaped V-cycle of PC mg),
    ``z = M3(r)`` and ``rz = <r, z>``. The carries are grid-shaped:
    ``b``/``x0`` are shard-stacked ``(size, lsize)`` and are viewed as
    ``(size,) + grid3d``."""
    flat = b.shape
    if grid3d is not None:
        b = b.reshape((flat[0],) + tuple(grid3d))
        x0 = x0.reshape(b.shape)
    x, *rest = _plans.classic_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        Adot=Adot, inv_diag=inv_diag, M3=M3, pdot=pdot, pnorm=pnorm,
        prec=prec, monitor=monitor)
    return (x.reshape(flat), *rest)


def cg_kernel_many(A, M, pdot, pnorm, B, X0, rtol, atol, maxit, dtol=None,
                   prec=None, monitor=None):
    """Batched preconditioned CG on the general route: ``k`` independent
    recurrences in lockstep over a ``(size, k, lsize)`` block, each
    column's arithmetic that of :func:`cg_kernel`, with per-column masked
    convergence. ``pdot``/``pnorm`` reduce per column to ``(k,)``; the JAX
    package stacks ``<R, Z>`` and ``<R, R>`` into one psum (``pduo``), which
    on the port's fixed-order shard sum is the same two reductions."""
    return _plans.classic_cg_loop(
        b=B, x0=X0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        A=A, M=M, pdot=pdot, pnorm=pnorm, bp=_plans.ManyBatch("cols"),
        prec=prec, monitor=monitor)


def cg_stencil_kernel_many(Adot, inv_diag, pdot, pnorm, B, X0, rtol, atol,
                           maxit, dtol=None, grid3d=None, prec=None,
                           monitor=None):
    """Batched twin of :func:`cg_stencil_kernel`: the block ``(size, k,
    lsize)`` is viewed as the slabs ``(size, k) + grid3d`` (no copy), the
    SpMV and the per-column ``<p_j, A p_j>`` run in one fused pass per shard
    (``Adot``, the ``stencil7_dot_many`` kernel on the card) and the Jacobi
    apply collapses to the scalar ``inv_diag``."""
    flat = B.shape
    shape = tuple(flat[:2]) + tuple(grid3d)
    x, *rest = _plans.classic_cg_loop(
        b=B.reshape(shape), x0=X0.reshape(shape), rtol=rtol, atol=atol,
        maxit=maxit, dtol=dtol, Adot=Adot, inv_diag=inv_diag, pdot=pdot,
        pnorm=pnorm, bp=_plans.ManyBatch("slabs"), prec=prec,
        monitor=monitor)
    return (x.reshape(flat), *rest)


def _scalars(*ts) -> list:
    """One host read of several device scalars."""
    return torch.stack([t.reshape(()).to(ts[0].dtype) for t in ts]).tolist()


def _nz(d):
    """``d`` with its zeros replaced by 1 (a guarded divisor)."""
    return torch.where(d == 0, 1.0, d)


def _mon(monitor, it, rn):
    if monitor is not None:
        monitor(it, rn)


def bcgs_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                monitor=None):
    """Right-preconditioned BiCGStab (KSPBCGS): the JAX body, with the loop
    condition's ``(rn, brk)`` read once per iteration."""
    _, tol = _tol(pnorm, b, rtol, atol)
    x = x0
    r = b - A(x0)
    rhat = r
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h = _scalars(rnorm, tol, dmax)
    atol_h = torch.tensor(atol, dtype=b.dtype).item()
    syncs = 1
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = one
    it, brk = 0, False
    _mon(monitor, 0, rn)
    while rn > tol_h and rn < dmax_h and it < maxit and not brk:
        rho_new = pdot(rhat, r)
        brk_t = (rho_new == 0) | (omega == 0)
        beta = torch.where(brk_t, 0.0, (rho_new / _nz(rho))
                           * (alpha / _nz(omega)))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        rv = pdot(rhat, v)
        brk_t = brk_t | (rv == 0)
        alpha = torch.where(brk_t, 0.0, rho_new / _nz(rv))
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        tt = pdot(t, t)
        omega = torch.where(tt == 0, 0.0, pdot(t, s) / _nz(tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        it += 1
        rn, brk_h = _scalars(pnorm(r), brk_t)
        syncs += 1
        brk = brk_h != 0
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def _hessenberg_lstsq(H, beta):
    """``min ||beta e1 - H y||`` for the upper-Hessenberg ``H`` of shape
    ``(m+1, m)``, by Givens rotations and back substitution: the JAX
    function's arithmetic in numpy, in ``H``'s dtype, on the host. Returns
    ``(y, |g[m]|)``."""
    H = np.array(H)
    m = H.shape[1]
    one, zero = H.dtype.type(1), H.dtype.type(0)
    g = np.zeros(m + 1, H.dtype)
    g[0] = beta
    for j in range(m):
        a, bb = H[j, j], H[j + 1, j]
        aa = abs(a)
        r = np.sqrt(aa * aa + abs(bb) ** 2)
        safe = one if r == 0 else r
        sgn = one if aa == 0 else a / aa
        c = one if r == 0 else aa / safe
        s = zero if r == 0 else sgn * bb / safe
        rj, rj1 = H[j].copy(), H[j + 1].copy()
        H[j], H[j + 1] = c * rj + s * rj1, -s * rj + c * rj1
        gj, gj1 = g[j], g[j + 1]
        g[j], g[j + 1] = c * gj + s * gj1, -s * gj + c * gj1
    y = np.zeros(m, H.dtype)
    for i in range(m - 1, -1, -1):
        rii = H[i, i]
        # entries of y below i are still zero: the row product is the tail
        s = g[i] - H[i, :m] @ y
        y[i] = zero if rii == 0 else s / rii
    return y, abs(g[m])


def _cgs2_step(V, w, pmatdot, pnorm):
    """One CGS2 orthogonalization step: project ``w`` against the basis
    ``V (size, m+1, lsize)`` twice (classical Gram-Schmidt, re-applied).
    Rows of ``V`` past the current column are zero. Returns ``(h, hnorm,
    v_next)``."""
    h1 = pmatdot(V, w)
    w = w - torch.matmul(h1, V)
    h2 = pmatdot(V, w)
    w = w - torch.matmul(h2, V)
    hnorm = pnorm(w)
    return h1 + h2, hnorm, w / torch.where(hnorm == 0, 1.0, hnorm)


def _restarted_cycles(cycle, update, b, x0, r, rn_t, tol, dmax, atol,
                      maxit, m, monitor, pnorm):
    """The restart loop GMRES and FGMRES share, from ``x0``, with one host
    read per cycle. ``cycle(r, beta)`` builds a cycle's basis from the residual it
    starts at (returning its Hessenberg matrix last), ``update(x, y,
    basis)`` applies the least-squares correction and returns ``(x, r)``
    with the new residual. To read the host once per cycle, the cycle after
    a restart is built before the read that decides whether it runs: the
    residual norm of the new iterate and the next cycle's Hessenberg matrix
    come in one read, and the last cycle built is thrown away when the
    solve stops (one cycle of extra work per solve). The residual a cycle
    starts from is the one the previous cycle ended with (the JAX body
    recomputes the same value). ``pnorm`` is the program's norm."""
    atol_h = torch.tensor(atol, dtype=b.dtype).item()

    def read(scalars, H):
        """The cycle's one host read: the scalars and, when another cycle
        was built, its Hessenberg matrix."""
        flat = torch.cat([t.reshape(1).to(b.dtype) for t in scalars]
                         + ([H.reshape(-1)] if H is not None else []))
        h = flat.cpu().numpy()
        ns = len(scalars)
        return ([float(v) for v in h[:ns]],
                h[ns:].reshape(m + 1, m) if H is not None else None)

    x, k = x0, 0
    basis = cycle(r, rn_t) if maxit > 0 else None
    (rn, tol_h, dmax_h), H_h = read([rn_t, tol, dmax],
                                    basis[-1] if basis else None)
    syncs = 1
    _mon(monitor, 0, rn)
    while rn > tol_h and rn < dmax_h and k < maxit:
        y, _ = _hessenberg_lstsq(H_h, H_h.dtype.type(rn))
        x, r = update(x, torch.from_numpy(y).to(b.device), basis)
        k += m
        rn_t = pnorm(r)
        basis = cycle(r, rn_t) if k < maxit else None
        (rn,), H_h = read([rn_t], basis[-1] if basis else None)
        syncs += 1
        _mon(monitor, k, rn)
    return x, k, rn, _reason(rn, tol_h, atol_h, False, dmax_h), syncs


def gmres_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, restart=30,
                 pmatdot=None, dtol=None, monitor=None):
    """Left-preconditioned restarted GMRES (KSPGMRES), monitored in the
    preconditioned residual norm, CGS2 Arnoldi, the small least-squares
    problem by Givens rotations on the host once per cycle
    (:func:`_restarted_cycles`)."""
    m = restart
    size = b.shape[0]
    tol = torch.clamp_min(rtol * pnorm(M(b)), atol)
    r = M(b - A(x0))
    rn_t = pnorm(r)

    def cycle(r, beta):
        V = b.new_zeros((size, m + 1) + tuple(b.shape[1:]))
        V[:, 0] = r / torch.where(beta == 0, 1.0, beta)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            h, hnorm, vnext = _cgs2_step(V, M(A(V[:, j])), pmatdot, pnorm)
            H[:, j] = h
            H[j + 1, j] = hnorm
            V[:, j + 1] = vnext
        return V, H

    def update(x, y, basis):
        x = x + torch.matmul(y, basis[0][:, :m])
        return x, M(b - A(x))

    return _restarted_cycles(cycle, update, b, x0, r, rn_t, tol,
                             _dmax(rn_t, dtol), atol, maxit, m, monitor,
                             pnorm)


def fgmres_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, restart=30,
                  pmatdot=None, dtol=None, monitor=None):
    """Flexible (right-preconditioned) restarted GMRES (KSPFGMRES): the
    preconditioned basis ``Z[j] = M(V[j])`` is stored, so ``M`` may change
    between applications (a composite or an iterative PC), and the
    unpreconditioned residual norm is monitored (JAX ``:1165``). The cycle
    machinery is GMRES's, with one host read per cycle."""
    m = restart
    size = b.shape[0]
    tol = torch.clamp_min(rtol * pnorm(b), atol)
    r = b - A(x0)
    rn_t = pnorm(r)

    def cycle(r, beta):
        V = b.new_zeros((size, m + 1) + tuple(b.shape[1:]))
        Z = b.new_zeros((size, m) + tuple(b.shape[1:]))
        V[:, 0] = r / torch.where(beta == 0, 1.0, beta)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            z = M(V[:, j])
            Z[:, j] = z
            h, hnorm, vnext = _cgs2_step(V, A(z), pmatdot, pnorm)
            H[:, j] = h
            H[j + 1, j] = hnorm
            V[:, j + 1] = vnext
        return Z, H

    def update(x, y, basis):
        x = x + torch.matmul(y, basis[0])
        return x, b - A(x)

    return _restarted_cycles(cycle, update, b, x0, r, rn_t, tol,
                             _dmax(rn_t, dtol), atol, maxit, m, monitor,
                             pnorm)


def preonly_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                   refine=False):
    """Apply the preconditioner once (KSPPREONLY). With ``refine`` (set for
    the direct-factor PC kinds only) iterative refinement follows while the
    true residual keeps halving, at most 20 steps, a step that does not
    improve being discarded: one host read per step."""
    x = M(b)
    if x is b:                       # PC none returns its input
        x = b.clone()
    r = b - A(x)
    rn = pnorm(r).item()
    syncs = 1
    go, k = refine and rn > 0, 0
    while go:
        x2 = x + M(r)
        r2 = b - A(x2)
        rn2 = pnorm(r2).item()
        syncs += 1
        go = rn2 < 0.5 * rn and k + 1 < 20
        if rn2 < rn:
            x, r, rn = x2, r2, rn2
        k += 1
    return x, 1, rn, CR.CONVERGED_ITS, syncs


def lsqr_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, At=None,
                dtol=None, monitor=None):
    """LSQR (Paige and Saunders; KSPLSQR) by Golub-Kahan bidiagonalization
    (JAX ``:1415``): ``min ||b - A x||``, for unsymmetric and inconsistent
    systems. Needs the transpose product ``At``; the PC is not used, as in
    PETSc's default KSPLSQR. The loop runs on the estimate ``phibar`` (read
    once per iteration, and monitored); the result's norm is the true
    residual, one more read at the end."""
    _, tol = _tol(pnorm, b, rtol, atol)

    def normalize(v):
        nv = pnorm(v)
        return v / torch.where(nv == 0, 1.0, nv), nv

    u, beta = normalize(b - A(x0))
    v, alfa = normalize(At(u))
    w = v
    dmax = _dmax(beta, dtol)
    x, rhobar, phibar = x0, alfa, beta
    ph, tol_h, dmax_h = _scalars(phibar, tol, dmax)
    atol_h = torch.tensor(atol, dtype=b.dtype).item()
    syncs = 1
    it, brk = 0, False
    _mon(monitor, 0, ph)
    while ph > tol_h and ph < dmax_h and it < maxit and not brk:
        u, beta = normalize(A(v) - alfa * u)
        v, alfa_new = normalize(At(u) - beta * v)
        rho = torch.sqrt(rhobar ** 2 + beta ** 2)
        brk_t = rho == 0
        safe_rho = _nz(rho)
        c = rhobar / safe_rho
        s = beta / safe_rho
        theta = s * alfa_new
        rhobar = -c * alfa_new
        phi = c * phibar
        phibar = s * phibar
        x = x + (phi / safe_rho) * w
        w = v - (theta / safe_rho) * w
        alfa = alfa_new
        it += 1
        ph, brk_h = _scalars(phibar, brk_t)
        syncs += 1
        brk = brk_h != 0
        _mon(monitor, it, ph)
    rn_true = pnorm(b - A(x)).item()
    return (x, it, rn_true, _reason(ph, tol_h, atol_h, brk, dmax_h),
            syncs + 1)


def bicg_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, At=None,
                Mt=None, dtol=None, monitor=None):
    """Biconjugate gradients (KSPBICG; JAX ``:1471``): dual recurrences on
    ``A`` and ``A^T``, the shadow one preconditioned with ``Mt`` (PETSc's
    PCApplyTranspose; ``M`` when None). One read of ``(rn, brk)`` per
    iteration."""
    if Mt is None:
        Mt = M
    _, tol = _tol(pnorm, b, rtol, atol)
    r = b - A(x0)
    rt = r
    p = M(r)
    pt = Mt(rt)
    rho = pdot(rt, p)
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h = _scalars(rnorm, tol, dmax)
    atol_h = torch.tensor(atol, dtype=b.dtype).item()
    syncs = 1
    x = x0
    it, brk = 0, False
    _mon(monitor, 0, rn)
    while rn > tol_h and rn < dmax_h and it < maxit and not brk:
        q = A(p)
        qt = At(pt)
        pq = pdot(pt, q)
        brk_t = (pq == 0) | (rho == 0)
        alpha = torch.where(brk_t, 0.0, rho / _nz(pq))
        x = x + alpha * p
        r = r - alpha * q
        rt = rt - alpha * qt
        z = M(r)
        zt = Mt(rt)
        rho_new = pdot(rt, z)
        beta = torch.where(rho == 0, 0.0, rho_new / _nz(rho))
        p = z + beta * p
        pt = zt + beta * pt
        rho = rho_new
        it += 1
        rn, brk_h = _scalars(pnorm(r), brk_t)
        syncs += 1
        brk = brk_h != 0
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def cgne_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, At=None,
                dtol=None, monitor=None):
    """CG on the normal equations ``A^T A x = A^T b`` (KSPCGNE; JAX
    ``:1589``): the PC applies to the normal-equations residual, and the
    loop tests ``||b - A x||``. One read of ``(rn, brk)`` per iteration."""
    _, tol = _tol(pnorm, b, rtol, atol)
    r = b - A(x0)
    s = At(r)
    p = M(s)
    gamma = pdot(s, p)
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h = _scalars(rnorm, tol, dmax)
    atol_h = torch.tensor(atol, dtype=b.dtype).item()
    syncs = 1
    x = x0
    it, brk = 0, False
    _mon(monitor, 0, rn)
    while rn > tol_h and rn < dmax_h and it < maxit and not brk:
        q = A(p)
        qq = pdot(q, q)
        brk_t = qq == 0
        alpha = torch.where(brk_t, 0.0, gamma / _nz(qq))
        x = x + alpha * p
        r = r - alpha * q
        s = At(r)
        z = M(s)
        gamma_new = pdot(s, z)
        beta = torch.where(gamma == 0, 0.0, gamma_new / _nz(gamma))
        p = z + beta * p
        gamma = gamma_new
        it += 1
        rn, brk_h = _scalars(pnorm(r), brk_t)
        syncs += 1
        brk = brk_h != 0
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def stencil_cg_eligible(ksp_type, pc, operator, many=False,
                        nullspace=None, natural=False) -> bool:
    """The CG fast-path gate of the JAX ``build_ksp_program`` (``:2264``;
    ``many``: of ``build_ksp_program_many``, ``:2823-2831``): CG with no
    null space and the default norm, PC none/jacobi/mg (batched:
    none/jacobi), an operator with the fused matvec-dot and a uniform
    diagonal, and a Jacobi or mg PC built from that same operator. A
    monitor does not leave the fast path."""
    kinds = ("none", "jacobi") if many else ("none", "jacobi", "mg")
    dot = "local_matvec_dot_many" if many else "local_matvec_dot"
    return (ksp_type == "cg"
            and nullspace is None and not natural
            and pc.get_type() in kinds
            and hasattr(operator, dot)
            and hasattr(operator, "grid3d")
            and getattr(operator, "uniform_diagonal", None) is not None
            and (pc.get_type() == "none" or pc._mat is operator))


def make_projector(comm, basis, prec):
    """``project(v (size, lsize)) -> v - Q^T (Q v)`` for the orthonormal
    null-space basis ``basis (k, n_pad)`` (JAX ``krylov.py:2527-2532``):
    one batched product gives every shard's ``(k,)`` partial of ``Q v``,
    summed in shard order, and one product takes the component out. A
    mixed plan projects in its reduce dtype and rounds back to storage."""
    size = comm.size
    k = basis.shape[0]
    Q = prec.up(basis).view(k, size, -1)
    Qs = Q.transpose(0, 1).contiguous()            # (size, k, lsize)

    def project(v):
        vu = prec.up(v)
        parts = torch.bmm(Qs, vu.reshape(size, -1, 1))[..., 0]
        c = comm.psum(list(parts))                 # (k,)
        out = vu - torch.einsum("k,ksl->sl", c, Q).view(v.shape)
        return out.to(v.dtype) if prec.mixed else out

    return project


def build_ksp_program(comm, ksp_type, pc, operator, restart=30,
                      true_res=False, nullspace=None, monitor=None,
                      natural=False):
    """The solve program for one configuration:
    ``prog(b, x0, rtol, atol, dtol, maxit) -> (x, it, rnorm, reason,
    host_syncs)`` on flat padded data tensors.

    CG with PC none/jacobi/mg on a stencil operator takes the fused fast
    path; everything else (a :class:`..core.mat.Mat` or
    :class:`..core.shell.ShellMat`, the other types, a null space, the
    natural norm) the general route of ``operator.local_spmv`` and
    ``pc.local_apply``. lsqr, bicg and cgne also take
    ``operator.local_spmv_t`` (bicg ``pc.local_apply_transpose`` too), and
    raise ``ValueError`` where the operator or PC has none.

    ``nullspace`` is the ``(k, n_pad)`` orthonormal basis of the operator's
    null space, or None: the program then projects ``b`` and ``x0`` and the
    outputs of ``A`` and ``M``, and for the transpose types the inputs of
    ``A^T`` and ``M^T`` (the adjoint of ``v -> P A v`` is ``w -> A^T P w``;
    JAX ``:2486-2509``). ``monitor(it, rn)`` receives every residual norm
    the loop reads, in order. With ``true_res`` the program ends with the
    JAX epilogue: one more product and two reductions give the raw
    ``||b - A x||`` and ``||b||``, appended to the result as floats (one
    more host read)."""
    check_ksp_type(ksp_type)
    size = comm.size
    n = operator.shape[0]
    prec = _precision(ksp_type, operator)
    up = prec.up

    def pdot(u, v):
        return comm.psum([torch.dot(up(u[i]).reshape(-1),
                                    up(v[i]).reshape(-1))
                          for i in range(size)])

    def pnorm(u):
        return torch.sqrt(pdot(u, u))

    natural = natural and ksp_type in NATURAL_TYPES
    plan = {"prec": prec} if prec.mixed else {}
    mon = {"monitor": monitor} if monitor is not None else {}
    spmv = operator.local_spmv(comm)
    project = (make_projector(comm, nullspace, prec)
               if nullspace is not None else None)
    if stencil_cg_eligible(ksp_type, pc, operator, nullspace=nullspace,
                           natural=natural):
        matvec_dot = operator.local_matvec_dot(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)
        # PC mg composes the V-cycle grid-shaped (None for none/jacobi)
        pc_apply3 = pc.local_apply_grid3d(comm)

        def prog(b, x0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel(
                matvec_dot, inv_diag, pdot, pnorm, b, x0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d, M3=pc_apply3, **plan,
                **mon)
    else:
        pc_apply = pc.local_apply(comm, n)
        A, M = spmv, pc_apply
        if project is not None:
            A = lambda v: project(spmv(v))
            M = lambda r: project(pc_apply(r))
        kernel, kw = {
            "cg": (cg_kernel, dict(plan, natural=natural)),
            "bcgs": (bcgs_kernel, {}),
            "gmres": (gmres_kernel, {"restart": restart,
                                     "pmatdot": _pmatdot(comm)}),
            "fgmres": (fgmres_kernel, {"restart": restart,
                                       "pmatdot": _pmatdot(comm)}),
            "lsqr": (lsqr_kernel, {}),
            "bicg": (bicg_kernel, {}),
            "cgne": (cgne_kernel, {}),
            # refinement is for the direct factorizations only
            "preonly": (preonly_kernel,
                        {"refine": pc.kind in ("lu", "crtri", "crband")}),
        }[ksp_type]
        if ksp_type != "preonly":       # preonly records no history
            kw = dict(kw, **mon)
        if ksp_type in _NEEDS_TRANSPOSE:
            kw.update(_transpose_applies(comm, ksp_type, pc, operator,
                                         project))

        def prog(b, x0, rtol, atol, dtol, maxit):
            if project is not None:
                b, x0 = project(b), project(x0)
            return kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit,
                          dtol=dtol, **kw)

    def run(b, x0, rtol, atol, dtol, maxit):
        b, x0 = b.view(size, -1), x0.view(size, -1)
        x, it, rnorm, reason, syncs = prog(b, x0, rtol, atol, dtol, maxit)
        out = (x.reshape(-1), it, rnorm, reason, syncs)
        if true_res:
            # the true residual of the returned iterate against the raw b
            trn, bn = _scalars(pnorm(b - spmv(x)), pnorm(b))
            out = out[:4] + (syncs + 1, trn, bn)
        return out

    return run


def _transpose_applies(comm, ksp_type, pc, operator, project) -> dict:
    """``At`` (and for bicg ``Mt``) for a transpose type, each projecting
    its input when there is a null space."""
    if not hasattr(operator, "local_spmv_t"):
        raise ValueError(
            f"KSP {ksp_type!r} needs the transpose product; operator "
            f"{type(operator).__name__} provides no local_spmv_t")
    spmv_t = operator.local_spmv_t(comm)
    proj = project if project is not None else (lambda v: v)
    kw = {"At": lambda v: spmv_t(proj(v))}
    if ksp_type == "bicg":
        pc_apply_t = pc.local_apply_transpose(comm, operator.shape[0])
        if pc_apply_t is None:
            raise ValueError(
                f"KSP 'bicg' needs a preconditioner with a transpose apply "
                f"(PCApplyTranspose); pc {pc.get_type()!r} provides none — "
                "supported: none/jacobi, the block kinds (bjacobi/sor/ssor/"
                "ilu/icc), lu/cholesky (dense mode; the large-n tridiagonal "
                "cyclic-reduction mode has no transpose), composite-additive "
                "of those, and shell with set_shell_apply_transpose; or use "
                "bcgs/gmres for general preconditioning")
        kw["Mt"] = lambda r: pc_apply_t(proj(r))
    return kw


def _precision(ksp_type, operator):
    """The operator's precision plan; raises ``ValueError`` for a mixed plan
    under a KSP type without a mixed-precision body (JAX
    ``krylov.py:2177-2185``: the port's cg and the loop-free preonly take
    one)."""
    prec = _plans.precision_plan(operator.dtype)
    if prec.mixed and ksp_type not in ("cg", "preonly"):
        raise ValueError(
            f"sub-f32 storage ({prec.key()[0]}) solves are assembled by the "
            f"mixed-precision CG plans; KSP {ksp_type!r} has no "
            "precision-plan body — use cg (typically under RefinedKSP fp64 "
            "refinement), or f32 storage. The JAX package has none for it "
            "either; its pipecg/sstep/richardson bodies come with ROADMAP.md "
            "Queue A item 5")
    return prec


def _pmatdot(comm):
    """``V (size, m+1, lsize), w (size, lsize) -> psum V_i w_i``: the
    whole-basis projection of CGS2, one reduction."""
    def pmatdot(V, w):
        return comm.psum([torch.mv(V[i], w[i]) for i in range(comm.size)])
    return pmatdot


def batched_pc_supported(pc) -> bool:
    """Whether this PC kind has a batched apply (the ``KSP.solve_many``
    routing test; the others fall back to per-column sequential solves).
    An lu PC's kind (its factor mode) is known once it is set up, as
    ``KSP.solve_many`` does first."""
    return pc.kind in ("none", "jacobi", "bjacobi", "lu")


def build_ksp_program_many(comm, ksp_type, pc, operator, true_res=False,
                           monitor=None):
    """The batched solve program:
    ``prog(B, X0, rtol, atol, dtol, maxit) -> (X, iters, rnorms, reasons,
    host_syncs)`` on ``(size, k, lsize)`` blocks, with per-column lists.

    Both routes of the JAX builder: the stencil fast path (CG, PC
    none/jacobi built on the system operator) and the general route
    (``local_spmv_many`` + ``PC.local_apply_many``), which the stencil takes
    when the PC's operator is not the system operator. The reductions are
    one ``torch.dot`` per column and shard, exactly the single-RHS ``pdot``
    of each column, summed over the shards in shard order.

    With ``true_res`` the program ends with the JAX epilogue for every
    column (``:2920-2935``): one batched product ``A X`` (on the stencil one
    ``stencil7_apply_many`` launch per shard) and the per-column
    ``||b_j - A x_j||`` and ``||b_j||``, appended as two lists (one more
    host read). ``monitor(j, it, rn)`` receives each column's residual
    norms as the loop reads them."""
    if ksp_type != "cg":
        raise ValueError(f"KSP {ksp_type!r} has no batched program; "
                         "KSP.solve_many solves its columns one by one")
    size = comm.size
    prec = _precision(ksp_type, operator)
    up = prec.up

    def pdot(U, V):
        return comm.psum([
            torch.stack([torch.dot(up(U[i, j]).reshape(-1),
                                   up(V[i, j]).reshape(-1))
                         for j in range(U.shape[1])])
            for i in range(size)])

    def pnorm(U):
        return torch.sqrt(pdot(U, U))

    plan = {"prec": prec} if prec.mixed else {}
    spmv = operator.local_spmv_many(comm)
    if stencil_cg_eligible(ksp_type, pc, operator, many=True):
        matvec_dot = operator.local_matvec_dot_many(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)

        def prog(B, X0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel_many(
                matvec_dot, inv_diag, pdot, pnorm, B, X0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d, monitor=monitor, **plan)
    else:
        pc_apply = pc.local_apply_many(comm, operator.shape[0])
        if pc_apply is None:
            raise ValueError(f"pc {pc.get_type()!r} has no batched apply; "
                             "KSP.solve_many solves its columns one by one")

        def prog(B, X0, rtol, atol, dtol, maxit):
            return cg_kernel_many(spmv, pc_apply, pdot, pnorm, B, X0, rtol,
                                  atol, maxit, dtol=dtol, monitor=monitor,
                                  **plan)
    if not true_res:
        return prog

    def run(B, X0, rtol, atol, dtol, maxit):
        X, iters, rnorms, reasons, syncs = prog(B, X0, rtol, atol, dtol,
                                                maxit)
        trn, bn = torch.stack([pnorm(B - spmv(X)), pnorm(B)]).tolist()
        return X, iters, rnorms, reasons, syncs + 1, trn, bn

    return run
