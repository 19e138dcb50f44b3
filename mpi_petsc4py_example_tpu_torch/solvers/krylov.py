"""Krylov kernels and the construction of the solve program.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/krylov.py``:
every kernel of its ``KSP_KERNELS`` (``:1999-2025``), namely ``cg_kernel``
(``:188``), ``cg_stencil_kernel`` (``:220``), ``bcgs_kernel`` (``:533``, also
``fbcgs``), ``fbcgsr_kernel`` (``:582``), ``gmres_kernel`` (``:732``) with
``_hessenberg_lstsq`` (``:671``) and ``_cgs2_step`` (``:716``),
``preonly_kernel`` (``:790``), ``richardson_kernel`` (``:840``),
``minres_kernel`` (``:868``), ``chebyshev_kernel`` (``:946``), the pipelined
and s-step kernels (``:1004-1162``, on ``cg_plans``), ``fgmres_kernel``
(``:1165``), ``cgs_kernel`` (``:1221``), ``tfqmr_kernel`` (``:1280``),
``cr_kernel`` (``:1356``), the transpose types ``lsqr_kernel`` (``:1415``),
``bicg_kernel`` (``:1471``) and ``cgne_kernel`` (``:1589``), ``gcr_kernel``
(``:1532``), ``symmlq_kernel`` (``:1637``), ``fcg_kernel`` (``:1746``),
``lgmres_kernel`` (``:1820``) and ``bcgsl_kernel`` (``:1891``); and
``build_ksp_program`` (``:2091``) with the stencil-CG and pipelined-CG fast
paths, the general route, the null-space projection (``:2320-2335``,
``:2524-2538``) and the true-residual epilogue (``_true_res_tail``,
``:2551``); and for ``KSP.solve_many``
``cg_kernel_many`` (``:2662``), ``cg_stencil_kernel_many`` (``:2689``), the
batched pipelined and s-step kernels, ``batched_pc_supported`` (``:2741``)
and ``build_ksp_program_many`` (``:2748``) with the true-residual epilogue.
The guard's bundles and programs (``GUARDED_TYPES``, ``_make_guard``,
``_make_pipe_guard``, ``_make_sstep_guard``, ``:265-540``, the program
wiring ``:2332-2446``, ``:2870-2914``) are :func:`build_guarded_program` at
the end of the module.

The JAX loops are ``lax.while_loop``s on the device; here they are eager
PyTorch driven by the host, with the scalars on the device and one small
host read where the loop decides whether to go on: once per iteration for
most types, once per restart cycle for GMRES, FGMRES and LGMRES, once per
outer step of ``ell`` iterations for BiCGStab(ell), once per block for
s-step CG, once per refinement step for preonly. The types whose result
reports the exact final ``||b - A x||`` (cgs, tfqmr, minres, symmlq,
bcgsl, fbcgsr, pipecg, sstep; LSQR) read once more after the loop, where the
JAX program returns it with its one result fetch. Every program returns the
count of its host reads. A monitor receives the residual norms those reads
bring, in order, so monitoring adds no read: the JAX package records the
same values in its in-program history buffer and replays them after the
solve.

Both builders take the precision plan from the operator's dtype (JAX
``:2177-2186``, ``:2796-2798``): under bfloat16 storage the reductions lift
their operands to fp32 (``:2341-2346``) and the CG-family loops run the
mixed plan; richardson's body needs none; the other types raise, as in the
JAX package.

Every type runs on complex64/complex128 operators with the JAX package's
complex arithmetic (``:2083-2085``): the reductions are Hermitian inner
products (``torch.vdot`` per shard, conjugating the first operand), the
Arnoldi projections conjugate the basis, GMRES's Givens rotations are
complex, BiCG's shadow recurrence takes the conjugated coefficients, the
transpose types run on the adjoint ``A^H v = conj(A^T conj(v))`` (and
``M^H``), and the norms, tolerances and reason tests stay real. On real
tensors each of these is the real operation, bit for bit.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from ..resilience import abft as _abft
from ..resilience import faults as _faults
from ..utils.convergence import ConvergedReason as CR
from ..utils.dtypes import real_dtype
from . import cg_plans as _plans
from .cg_plans import _dmax, _re, _reason, _tol

# the JAX package's KSP_KERNELS (krylov.py:1999-2025), every one ported
KSP_TYPES = ("cg", "pipecg", "sstep", "bcgs", "gmres", "fgmres", "cgs",
             "tfqmr", "cr", "lsqr", "minres", "chebyshev", "preonly",
             "richardson", "bicg", "gcr", "cgne", "symmlq", "fcg", "lgmres",
             "bcgsl", "fbcgs", "fbcgsr")
# the types that need the transpose product A^T v (operator.local_spmv_t)
_NEEDS_TRANSPOSE = ("lsqr", "bicg", "cgne")
# the types whose recurrence carries the natural norm: cg/fcg sqrt <r, M r>,
# cr sqrt <r~, A r~> of its preconditioned residual (JAX :2035)
NATURAL_TYPES = ("cg", "fcg", "cr")
# the types with a body for sub-f32 storage (JAX :2179): the plan-built CG
# family and the loop-free preonly/richardson bodies
MIXED_TYPES = ("cg", "pipecg", "sstep", "preonly", "richardson")
# the types that keep a basis of restart vectors
_RESTARTED = ("gmres", "fgmres", "gcr", "fcg", "lgmres")


def check_ksp_type(ksp_type: str) -> str:
    """``ksp_type`` if it is one of the JAX package's types; ``ValueError``
    for a type neither package has."""
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



def pipecg_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, fused=None,
                  dtol=None, prec=None, monitor=None):
    """Pipelined single-reduction CG (Ghysels and Vanroose; KSPPIPECG; JAX
    ``:1004``) on the general route: ``fused(r, u, w)`` reduces ``<r, u>``,
    ``<w, u>`` and ``||r||^2`` in one ``psum``, and the next applies do not
    depend on it (:func:`cg_plans.pipelined_cg_loop`)."""
    return _plans.pipelined_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol, A=A, M=M,
        pnorm=pnorm, fused=fused, monitor=monitor, prec=prec)


def pipecg_stencil_kernel(A3, inv_diag, pnorm, fused, b, x0, rtol, atol,
                          maxit, dtol=None, grid3d=None, prec=None,
                          monitor=None):
    """The pipelined-CG fast path for uniform-diagonal stencil operators
    with PC none/jacobi (JAX ``:1049``): grid-shaped carries, the plain
    grid apply ``A3`` (``StencilPoisson3D.local_apply_grid3``, the
    ``stencil7_apply`` kernel on the card) and the Jacobi apply ``m = w
    inv_diag``, still one reduction an iteration (the fused matvec-dot is
    not used: its dot would be a second)."""
    flat = b.shape
    if grid3d is not None:
        b = b.reshape((flat[0],) + tuple(grid3d))
        x0 = x0.reshape(b.shape)
    if prec is not None and prec.mixed:
        M = lambda r: (prec.up(r) * inv_diag).to(prec.storage)
    else:
        M = lambda r: r * inv_diag
    x, *rest = _plans.pipelined_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol, A=A3, M=M,
        pnorm=pnorm, fused=fused, monitor=monitor, prec=prec)
    return (x.reshape(flat), *rest)


def pipecg_kernel_many(A, M, pdot, pnorm, B, X0, rtol, atol, maxit,
                       fused=None, dtol=None, prec=None, monitor=None):
    """Batched pipelined CG (JAX ``:1075``): ``k`` lockstep recurrences on a
    ``(size, k, lsize)`` block, every column's three dots in the one
    reduction of the iteration."""
    return _plans.pipelined_cg_loop(
        b=B, x0=X0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol, A=A, M=M,
        pnorm=pnorm, fused=fused, bp=_plans.ManyBatch("cols"),
        monitor=monitor, prec=prec)


def sstep_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, s=4,
                 gram=None, combine=None, dtol=None, prec=None,
                 monitor=None):
    """s-step communication-avoiding CG (JAX ``:1102``): ``s`` iterations a
    block around one Gram reduction (:func:`cg_plans.sstep_cg_loop`)."""
    return _plans.sstep_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol, s=s,
        gram=gram, combine=combine, A=A, M=M, pnorm=pnorm, monitor=monitor,
        prec=prec)


def sstep_kernel_many(A, M, pdot, pnorm, B, X0, rtol, atol, maxit, s=4,
                      gram=None, combine=None, dtol=None, prec=None,
                      monitor=None):
    """Batched s-step CG (JAX ``:1138``): per-column bases and
    coefficients, every column's Gram block in the one reduction of the
    block."""
    return _plans.sstep_cg_loop(
        b=B, x0=X0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol, s=s,
        gram=gram, combine=combine, A=A, M=M, pnorm=pnorm,
        bp=_plans.ManyBatch("cols"), monitor=monitor, prec=prec)


def _scalars(*ts) -> list:
    """One host read of several device scalars."""
    return torch.stack([t.reshape(()).to(ts[0].dtype) for t in ts]).tolist()


def _atol_h(atol, dtype) -> float:
    """``atol`` as the loop compares it: rounded to the real scalar of
    ``dtype`` (a complex operator's tolerances are real)."""
    return torch.tensor(atol, dtype=real_dtype(dtype)).item()


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
    atol_h = _atol_h(atol, b.dtype)
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


def _open(rnorm, tol, dmax, atol, monitor, *flags):
    """The set-up read of a loop: ``(rn, tol, dmax, atol)`` on the host (and
    the given device flags as bools), with the iteration-0 monitor call."""
    vals = _scalars(rnorm, tol, dmax, *flags)
    atol_h = _atol_h(atol, rnorm.dtype)
    _mon(monitor, 0, vals[0])
    return vals[:3] + [atol_h] + [v != 0 for v in vals[3:]]


def _live_h(rn, tol_h, dmax_h, it, maxit, brk):
    return rn > tol_h and rn < dmax_h and it < maxit and not brk


def _step_read(rn_t, brk_t):
    """The one host read of an iteration: ``(rn, brk)``."""
    rn, brk = _scalars(rn_t, brk_t)
    return rn, brk != 0


def fbcgsr_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                  monitor=None, preduce=None):
    """Flexible BiCGStab with its reductions merged (KSPFBCGSR; JAX
    ``:582``): one reduction for ``<r^, v>`` and one fused reduction,
    ``preduce([(t, s), (t, t), (r^, t), (s, s)])`` (one ``psum`` of a
    stacked partial per shard), for the rest; the next rho and ``||r||``
    come from scalar identities. One read of ``(rn, brk)`` per iteration;
    the result reports the exact final ``||b - A x||`` (one more read)
    and the reason is judged on the norm the loop tested."""
    _, tol = _tol(pnorm, b, rtol, atol)
    r = b - A(x0)
    rhat = r
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h = _open(rnorm, tol, dmax, atol, monitor)
    syncs = 1
    one = torch.ones((), dtype=b.dtype, device=b.device)
    eps = torch.finfo(real_dtype(b.dtype)).eps
    x, p, v = x0, torch.zeros_like(b), torch.zeros_like(b)
    # rho_cur = (r^, r0) = ||r0||^2, real, typed as the operator's scalar
    rho, rho_cur, alpha, omega = one, (rnorm * rnorm).to(b.dtype), one, one
    it, brk = 0, False
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        brk_t = (rho_cur == 0) | (omega == 0)
        beta = torch.where(brk_t, 0.0, (rho_cur / _nz(rho))
                           * (alpha / _nz(omega)))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        rv = pdot(rhat, v)                            # reduction phase 1
        brk_t = brk_t | (rv == 0)
        alpha = torch.where(brk_t, 0.0, rho_cur / _nz(rv))
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        # reduction phase 2: the remaining dots in one fused psum
        ts, tt, rt, ss = preduce([(t, s), (t, t), (rhat, t), (s, s)])
        omega = torch.where(tt == 0, 0.0, ts / _nz(tt))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        # ||s - omega t||^2 = (s,s) - 2 Re(conj(omega) (t,s)) + |omega|^2
        # (t,t) with the Hermitian inner product (JAX :643-648)
        rn2 = (_re(ss) - 2 * _re(omega.conj() * ts)
               + omega.abs() ** 2 * _re(tt))
        rn_t = torch.sqrt(torch.maximum(rn2, eps * _re(ss)))
        rho, rho_cur = rho_cur, (rho_cur - alpha * rv) - omega * rt
        it += 1
        rn, brk = _step_read(rn_t, brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    rn_true = pnorm(b - A(x)).item()
    return (x, it, rn_true, _reason(rn, tol_h, atol_h, brk, dmax_h),
            syncs + 1)


def richardson_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit,
                      dtol=None, monitor=None):
    """Preconditioned Richardson iteration (KSPRICHARDSON; JAX ``:840``,
    whose ``scale`` no caller sets), ``x += M r`` with the true residual
    each step. Its body needs no
    precision plan: under bfloat16 storage the update rounds to storage and
    only the norms lift to fp32, as in the JAX package. One read per
    iteration."""
    _, tol = _tol(pnorm, b, rtol, atol)
    r = b - A(x0)
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h = _open(rnorm, tol, dmax, atol, monitor)
    syncs, x, it = 1, x0, 0
    while _live_h(rn, tol_h, dmax_h, it, maxit, False):
        x = x + M(r)
        r = b - A(x)
        it += 1
        rn = pnorm(r).item()
        syncs += 1
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, False, dmax_h), syncs


def cgs_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
               monitor=None):
    """Conjugate Gradient Squared (KSPCGS; JAX ``:1221``),
    right-preconditioned: the correction solves ``(A M) y = r0`` and ``x =
    x0 + M y`` once at the end, so the monitored residual is the true one.
    One read per iteration, one more for the final ``||b - A x||``."""
    _, tol = _tol(pnorm, b, rtol, atol)
    op = lambda v: A(M(v))
    r = b - A(x0)
    rtilde = r
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h = _open(rnorm, tol, dmax, atol, monitor)
    syncs = 1
    y = p = q = torch.zeros_like(b)
    rho = torch.ones((), dtype=b.dtype, device=b.device)
    it, brk = 0, False
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        rho_new = pdot(rtilde, r)
        brk_t = rho_new == 0
        beta = torch.where(brk_t, 0.0, rho_new / _nz(rho))
        u = r + beta * q
        p = u + beta * (q + beta * p)
        v = op(p)
        sigma = pdot(rtilde, v)
        brk_t = brk_t | (sigma == 0)
        alpha = torch.where(brk_t, 0.0, rho_new / _nz(sigma))
        q = u - alpha * v
        uq = u + q
        y = y + alpha * uq
        r = r - alpha * op(uq)
        rho = rho_new
        it += 1
        rn, brk = _step_read(pnorm(r), brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    x = x0 + M(y)
    rn_true = pnorm(b - A(x)).item()
    return (x, it, rn_true, _reason(rn, tol_h, atol_h, brk, dmax_h),
            syncs + 1)


def tfqmr_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                 monitor=None):
    """Transpose-free QMR (Freund; KSPTFQMR; JAX ``:1280``),
    right-preconditioned on ``(A M) y = r0``: the loop monitors the
    quasi-residual bound ``tau sqrt(2k+1)``, read once per (double)
    iteration; the exact residual is read once after the loop."""
    _, tol = _tol(pnorm, b, rtol, atol)
    op = lambda v: A(M(v))
    r0 = b - A(x0)
    rstar = r0
    tau = pnorm(r0)
    dmax = _dmax(tau, dtol)
    rn, tol_h, dmax_h, atol_h = _open(tau, tol, dmax, atol, monitor)
    syncs = 1
    u1 = op(r0)
    y, w, y1, v = torch.zeros_like(b), r0, r0, u1
    d = torch.zeros_like(b)
    theta = torch.zeros((), dtype=tau.dtype, device=b.device)
    eta = torch.zeros((), dtype=b.dtype, device=b.device)
    rho = pdot(rstar, r0)
    it, brk = 0, False

    def half(yj, uj, alpha, w, d, theta, tau, eta, y):
        w = w - alpha * uj
        d = yj + (theta ** 2 * eta / _nz(alpha)) * d
        theta = pnorm(w) / _nz(tau)
        c2 = 1.0 / (1.0 + theta * theta)
        tau = tau * theta * torch.sqrt(c2)
        eta = c2 * alpha
        return w, d, theta, tau, eta, y + eta * d

    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        sigma = pdot(rstar, v)
        brk_t = sigma == 0
        alpha = torch.where(brk_t, 0.0, rho / _nz(sigma))
        y2 = y1 - alpha * v
        u2 = op(y2)
        w, d, theta, tau, eta, y = half(y1, u1, alpha, w, d, theta, tau,
                                        eta, y)
        w, d, theta, tau, eta, y = half(y2, u2, alpha, w, d, theta, tau,
                                        eta, y)
        rho_new = pdot(rstar, w)
        brk_t = brk_t | (rho == 0)
        beta = rho_new / _nz(rho)
        y1 = w + beta * y2
        u1 = op(y1)
        v = u1 + beta * (u2 + beta * v)
        rho = rho_new
        it += 1
        # the quasi-residual bound after 2 it half-steps
        rn, brk = _step_read(tau * math.sqrt(2.0 * it + 1.0), brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    x = x0 + M(y)
    rn_true = pnorm(b - A(x)).item()
    return (x, it, rn_true, _reason(rn, tol_h, atol_h, brk, dmax_h),
            syncs + 1)


def cr_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
              monitor=None, natural=False):
    """Preconditioned conjugate residuals (KSPCR; JAX ``:1356``) for
    symmetric ``A`` and SPD ``M``, monitored in the preconditioned residual
    norm, or with ``natural`` in ``sqrt <r~, A r~>`` of the preconditioned
    residual (relative to its initial value; a negative value is a
    breakdown). One read per iteration."""
    r = M(b - A(x0))
    p, w = r, A(r)
    q = w
    rho = pdot(r, w)
    if natural:
        rnorm = _plans._nat(rho)
        tol = torch.clamp_min(rtol * rnorm, atol)
        brk0 = _re(rho) < 0
    else:
        tol = torch.clamp_min(rtol * pnorm(M(b)), atol)
        rnorm = pnorm(r)
        brk0 = rnorm <= -1.0
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h, brk = _open(rnorm, tol, dmax, atol, monitor,
                                           brk0)
    syncs, x, it = 1, x0, 0
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        Mq = M(q)
        qMq = pdot(q, Mq)
        brk_t = qMq == 0
        alpha = torch.where(brk_t, 0.0, rho / _nz(qMq))
        x = x + alpha * p
        r = r - alpha * Mq
        w = A(r)
        rho_new = pdot(r, w)
        if natural:
            brk_t = brk_t | (_re(rho_new) < 0)
        beta = torch.where(rho == 0, 0.0, rho_new / _nz(rho))
        p = r + beta * p
        q = w + beta * q
        rho = rho_new
        it += 1
        rn, brk = _step_read(_plans._nat(rho) if natural else pnorm(r),
                             brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def minres_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                  monitor=None):
    """MINRES (Paige and Saunders; KSPMINRES; JAX ``:868``) for symmetric,
    possibly indefinite ``A`` with an SPD ``M``: the Lanczos scalars and the
    Givens rotations of the tridiagonal's QR stay on the device (the same
    arithmetic on every rank), and the loop reads its estimate ``|phibar|
    ||r0|| / beta1`` once per iteration. The result and its reason use the
    exact final residual (one more read)."""
    _, tol = _tol(pnorm, b, rtol, atol)
    r1 = b - A(x0)
    y = M(r1)
    # Hermitian A and SPD M: every Lanczos and rotation scalar is real,
    # carried real-typed (complex vectors, real scalars; JAX :880-884)
    beta1 = torch.sqrt(torch.clamp_min(_re(pdot(r1, y)), 0.0))
    rnorm0 = pnorm(r1)
    dmax = _dmax(rnorm0, dtol)
    scale = rnorm0 / _nz(beta1)
    rn, tol_h, dmax_h, atol_h, brk = _open(rnorm0, tol, dmax, atol, monitor,
                                           beta1 < 0)
    syncs = 1
    sc = lambda v: torch.full((), v, dtype=beta1.dtype, device=b.device)
    x, r2, w, w2 = x0, r1, torch.zeros_like(b), torch.zeros_like(b)
    beta_old, beta, dbar, epsln = sc(1.0), beta1, sc(0.0), sc(0.0)
    phibar, cs, sn = beta1, sc(-1.0), sc(0.0)
    it = 0
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        safe_b = _nz(beta)
        v = y / safe_b
        yv = A(v)
        if it > 0:
            yv = yv - (beta / _nz(beta_old)) * r1
        else:
            yv = yv - torch.zeros_like(beta) * r1
        alfa = _re(pdot(v, yv))
        yv = yv - (alfa / safe_b) * r2
        y = M(yv)
        beta_new = torch.sqrt(torch.clamp_min(_re(pdot(yv, y)), 0.0))
        # the QR of the tridiagonal by Givens rotations
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta_new
        dbar = -cs * beta_new
        gamma = torch.sqrt(gbar * gbar + beta_new * beta_new)
        gamma = torch.where(gamma == 0, 1e-30, gamma)
        cs = gbar / gamma
        sn = beta_new / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        r1, r2 = r2, yv
        beta_old, beta = beta, beta_new
        it += 1
        rn = (phibar.abs() * scale).item()
        syncs += 1
        _mon(monitor, it, rn)
    rn_true = pnorm(b - A(x)).item()
    return (x, it, rn_true, _reason(rn_true, tol_h, atol_h, brk, dmax_h),
            syncs + 1)


def symmlq_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                  monitor=None):
    """SYMMLQ (Paige and Saunders; KSPSYMMLQ; JAX ``:1637``) for symmetric
    indefinite ``A`` with an SPD ``M``: the LQ companion of MINRES, its
    plane rotations on the device, monitoring the CG-point residual
    estimate (one read per iteration) and moving to the CG point on exit.
    The result and its reason use the exact final residual (one more
    read)."""
    _, tol = _tol(pnorm, b, rtol, atol)
    r0 = b - A(x0)
    rnorm0 = pnorm(r0)
    dmax = _dmax(rnorm0, dtol)
    y = M(r0)
    # real-typed Lanczos scalars, as in minres (JAX :1650-1667)
    beta1sq = _re(pdot(r0, y))
    beta1 = torch.sqrt(torch.clamp_min(beta1sq, 0.0))
    safe_b1 = _nz(beta1)
    v = y / safe_b1
    y2 = A(v)
    alfa = _re(pdot(v, y2))
    y2 = y2 - (alfa / safe_b1) * r0
    r2 = y2
    y3 = M(r2)
    betasq = _re(pdot(r2, y3))
    beta = torch.sqrt(torch.clamp_min(betasq, 0.0))
    # the recurrence norms are M-weighted: the test runs on ||r||
    scale = rnorm0 / safe_b1
    rn, tol_h, dmax_h, atol_h, brk = _open(rnorm0, tol, dmax, atol, monitor,
                                           (beta1sq < 0) | (betasq < 0))
    syncs = 1
    sc = lambda val: torch.full((), val, dtype=beta1.dtype, device=b.device)
    x, w, r1, yk = torch.zeros_like(b), torch.zeros_like(b), r0, y3
    oldb, gbar, dbar = beta1, alfa, beta
    rhs1, rhs2, snprod, bstep = beta1, sc(0.0), sc(1.0), sc(0.0)
    it = 0
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        beta_c = beta
        safe_beta = _nz(beta_c)
        v = yk / safe_beta
        yv = A(v)
        yv = yv - (beta_c / _nz(oldb)) * r1
        alfa = _re(pdot(v, yv))
        yv = yv - (alfa / safe_beta) * r2
        r1, r2 = r2, yv
        yk = M(r2)
        oldb = beta_c
        betasq = _re(pdot(r2, yk))
        brk_t = betasq < 0
        beta = torch.sqrt(torch.clamp_min(betasq, 0.0))
        # the plane rotation of the tridiagonal's LQ factorization
        gamma = torch.sqrt(gbar ** 2 + oldb ** 2)
        gamma = torch.where(gamma == 0, 1e-30, gamma)
        cs = gbar / gamma
        sn = oldb / gamma
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        # the LQ point
        z = rhs1 / gamma
        x = x + (z * cs) * w + (z * sn) * v
        w = sn * w - cs * v
        bstep = snprod * cs * z + bstep
        snprod = snprod * sn
        rhs1 = rhs2 - delta * z
        rhs2 = -epsln * z
        # the CG-point residual estimate of the convergence test
        qrnorm = snprod * beta1
        cgnorm = qrnorm * beta / torch.where(gbar == 0, 1e-30, gbar).abs()
        it += 1
        rn, brk_n = _step_read(cgnorm * scale, brk_t)
        brk = brk or brk_n
        syncs += 1
        _mon(monitor, it, rn)
    if it > 0:
        # the LQ point moved to the CG point, plus the component along v1
        # (an initial guess that already converged comes back untouched)
        zbar = rhs1 / _nz(gbar)
        bstep = snprod * zbar + bstep
        xc = x + zbar * w
        x = x0 + (xc + (bstep / safe_b1) * y)
    else:
        x = x0 + torch.zeros_like(b)
    rn_true = pnorm(b - A(x)).item()
    return (x, it, rn_true, _reason(rn_true, tol_h, atol_h, brk, dmax_h),
            syncs + 1)


def gcr_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, restart=30,
               pmatdot=None, dtol=None, monitor=None):
    """Restarted GCR (KSPGCR; JAX ``:1532``), flexible: the pairs ``(v =
    A z, z = M r)`` are stored in ``(local_shards, restart, lsize)``
    buffers, cleared at each restart; the projection against them is one
    ``psum`` of the whole basis and one product per shard. One read per
    iteration."""
    m = restart
    _, tol = _tol(pnorm, b, rtol, atol)
    r = b - A(x0)
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h = _open(rnorm, tol, dmax, atol, monitor)
    syncs, x, it, brk = 1, x0, 0, False
    V = b.new_zeros((b.shape[0], m) + tuple(b.shape[1:]))
    Z = torch.zeros_like(V)
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        slot = it % m
        if slot == 0:                  # a restart clears the direction set
            V.zero_()
            Z.zero_()
        z = M(r)
        v = A(z)
        c = pmatdot(V, v)
        v = v - shardwise_matmul(c, V)
        z = z - shardwise_matmul(c, Z)
        nv = pnorm(v)
        brk_t = nv == 0
        v = v / _nz(nv)
        z = z / _nz(nv)
        alpha = pdot(v, r)
        x = x + alpha * z
        r = r - alpha * v
        V[:, slot] = v
        Z[:, slot] = z
        it += 1
        rn, brk = _step_read(pnorm(r), brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def fcg_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, restart=30,
               pmatdot=None, dtol=None, monitor=None, natural=False):
    """Truncated flexible CG (Notay; KSPFCG; JAX ``:1746``): each direction
    is A-orthogonalized against a sliding window of the last ``restart``
    pairs ``(p, A p)``, one ``psum`` of the window and one product per
    shard. ``natural`` monitors ``sqrt <r, M r>`` (relative to its initial
    value; a negative value is a breakdown), carrying ``z = M r`` to the
    next iteration. One read per iteration."""
    m = restart
    r = b - A(x0)
    if natural:
        z = M(r)
        rz0 = pdot(r, z)
        rnorm = _plans._nat(rz0)
        tol = torch.clamp_min(rtol * rnorm, atol)
        brk0 = _re(rz0) < 0
    else:
        z = None                      # applied at the top of each body
        _, tol = _tol(pnorm, b, rtol, atol)
        rnorm = pnorm(r)
        brk0 = rnorm <= -1.0
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h, brk = _open(rnorm, tol, dmax, atol, monitor,
                                           brk0)
    syncs, x, it = 1, x0, 0
    P = b.new_zeros((b.shape[0], m) + tuple(b.shape[1:]))
    AP = torch.zeros_like(P)
    eta = b.new_zeros(m)
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        slot = it % m
        if not natural:
            z = M(r)
        c = pmatdot(AP, z)
        coef = torch.where(eta != 0, c / _nz(eta), 0.0)
        p = z - shardwise_matmul(coef, P)
        Ap = A(p)
        pAp = pdot(p, Ap)
        brk_t = pAp == 0
        alpha = torch.where(brk_t, 0.0, pdot(p, r) / _nz(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        P[:, slot] = p
        AP[:, slot] = Ap
        eta[slot] = pAp
        if natural:
            z = M(r)
            rz = pdot(r, z)
            brk_t = brk_t | (_re(rz) < 0)
            rn_t = _plans._nat(rz)
        else:
            rn_t = pnorm(r)
        it += 1
        rn, brk = _step_read(rn_t, brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def lgmres_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, restart=30,
                  aug=2, pmatdot=None, dtol=None, monitor=None):
    """LGMRES (Baker, Jessup and Manteuffel; KSPLGMRES; JAX ``:1820``):
    GMRES(restart) whose cycle space is augmented with the ``aug`` latest
    error approximations (the normalized corrections of earlier cycles;
    zero until filled), left-preconditioned, CGS2 Arnoldi, one host read per
    cycle of ``restart + aug`` steps (:func:`_restarted_cycles`). ``aug <=
    0`` is GMRES(restart)."""
    if aug <= 0:
        return gmres_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit,
                            restart=restart, pmatdot=pmatdot, dtol=dtol,
                            monitor=monitor)
    m = restart
    s = m + aug
    size = b.shape[0]
    tol = torch.clamp_min(rtol * pnorm(M(b)), atol)
    r = M(b - A(x0))
    rn_t = pnorm(r)
    # the augmentation vectors, newest first
    Z = [b.new_zeros((size, aug) + tuple(b.shape[1:]))]

    def cycle(r, beta):
        V = b.new_zeros((size, s + 1) + tuple(b.shape[1:]))
        W = b.new_zeros((size, s) + tuple(b.shape[1:]))
        V[:, 0] = r / torch.where(beta == 0, 1.0, beta)
        H = b.new_zeros((s + 1, s))
        for j in range(s):
            W[:, j] = V[:, j] if j < m else Z[0][:, j - m]
            h, hnorm, vnext = _cgs2_step(V, M(A(W[:, j])), pmatdot, pnorm)
            H[:, j] = h
            H[j + 1, j] = hnorm
            V[:, j + 1] = vnext
        return W, H

    def update(x, y, basis):
        dx = shardwise_matmul(y, basis[0])
        x = x + dx
        ndx = pnorm(dx)
        Z[0] = torch.cat([(dx / torch.where(ndx == 0, 1.0, ndx))[:, None],
                          Z[0][:, :-1]], dim=1)
        return x, M(b - A(x))

    return _restarted_cycles(cycle, update, b, x0, r, rn_t, tol,
                             _dmax(rn_t, dtol), atol, maxit, s, monitor,
                             pnorm)


def bcgsl_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, ell=2,
                 dtol=None, monitor=None):
    """BiCGStab(ell) (Sleijpen and Fokkema; KSPBCGSL; JAX ``:1891``),
    right-preconditioned on ``(A M) y = r0``: ``ell`` BiCG steps and an
    ``ell``-degree minimal-residual update an outer iteration, the small
    ``ell x ell`` minimization in device scalars (the same arithmetic on
    every rank). One read per outer iteration (``ell`` iterations), one
    more for the final ``||b - A x||``."""
    L = int(ell)
    if L < 1:
        raise ValueError(f"-ksp_bcgsl_ell must be >= 1, got {L}")
    _, tol = _tol(pnorm, b, rtol, atol)
    op = lambda v: A(M(v))
    r0 = b - A(x0)
    rtilde = r0
    rnorm = pnorm(r0)
    dmax = _dmax(rnorm, dtol)
    rn, tol_h, dmax_h, atol_h = _open(rnorm, tol, dmax, atol, monitor)
    syncs = 1
    sc = lambda v: torch.full((), v, dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(b)
    R = [r0] + [zero] * L
    U = [zero] * (L + 1)
    y = zero
    rho0, alpha, omega = sc(1.0), sc(0.0), sc(1.0)
    rn_t = rnorm
    it, brk = 0, False
    while _live_h(rn, tol_h, dmax_h, it, maxit, brk):
        y_old, rn_old = y, rn_t
        brk_t = torch.zeros((), dtype=torch.bool, device=b.device)
        rho0 = -omega * rho0
        # ---- the BiCG part ----
        for j in range(L):
            rho1 = pdot(R[j], rtilde)
            brk_t = brk_t | (rho0 == 0)
            beta = alpha * rho1 / _nz(rho0)
            rho0 = rho1
            for i in range(j + 1):
                U[i] = R[i] - beta * U[i]
            U[j + 1] = op(U[j])
            gam = pdot(U[j + 1], rtilde)
            brk_t = brk_t | (gam == 0)
            alpha = rho0 / _nz(gam)
            for i in range(j + 1):
                R[i] = R[i] - alpha * U[i + 1]
            R[j + 1] = op(R[j])
            y = y + alpha * U[0]
        # ---- the MR part: min ||R0 - [R1..RL] g|| by modified Gram-Schmidt
        tau = [[sc(0.0)] * (L + 1) for _ in range(L + 1)]
        sigma = [sc(0.0)] * (L + 1)
        gamma_p = [sc(0.0)] * (L + 1)
        for j in range(1, L + 1):
            for i in range(1, j):
                tau[i][j] = pdot(R[j], R[i]) / _nz(sigma[i])
                R[j] = R[j] - tau[i][j] * R[i]
            sigma[j] = pdot(R[j], R[j])
            brk_t = brk_t | (sigma[j] == 0)
            gamma_p[j] = pdot(R[0], R[j]) / _nz(sigma[j])
        gamma = [sc(0.0)] * (L + 1)
        gamma_pp = [sc(0.0)] * (L + 1)
        gamma[L] = gamma_p[L]
        omega = gamma[L]
        brk_t = brk_t | (omega == 0)
        for j in range(L - 1, 0, -1):
            gamma[j] = gamma_p[j] - sum(
                (tau[j][i] * gamma[i] for i in range(j + 1, L + 1)),
                sc(0.0))
        for j in range(1, L):
            gamma_pp[j] = gamma[j + 1] + sum(
                (tau[j][i] * gamma[i + 1] for i in range(j + 1, L)),
                sc(0.0))
        # ---- the update ----
        y = y + gamma[1] * R[0]
        R[0] = R[0] - gamma_p[L] * R[L]
        U[0] = U[0] - gamma[L] * U[L]
        for j in range(1, L):
            U[0] = U[0] - gamma[j] * U[j]
            y = y + gamma_pp[j] * R[j]
            R[0] = R[0] - gamma_p[j] * R[j]
        # a breakdown freezes the iterate (the updates after it are garbage)
        y = torch.where(brk_t, y_old, y)
        rn_t = torch.where(brk_t, rn_old, pnorm(R[0]))
        it += L
        rn, brk = _step_read(rn_t, brk_t)
        syncs += 1
        _mon(monitor, it, rn)
    x = x0 + M(y)
    rn_true = pnorm(b - A(x)).item()
    reason = _reason(rn, tol_h, atol_h, brk, dmax_h)
    if reason > 0:
        # judged on the true residual: under a (near-)exact PC the first
        # BiCG step leaves R[0] at rounding noise and the recurrence meets
        # the tolerance on a wrong answer (ROADMAP.md Queue C, port-side
        # choices); the JAX kernel judges the recurrence
        reason = (CR.DIVERGED_BREAKDOWN if rn_true > tol_h
                  else _reason(rn_true, tol_h, atol_h, False, dmax_h))
    return x, it, rn_true, reason, syncs + 1


def chebyshev_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
                     monitor=None):
    """Chebyshev iteration (KSPCHEBYSHEV; JAX ``:946``) on ``M^-1 A`` with
    PETSc's default bounds ``[0.1, 1.1] lmax``, ``lmax`` from 10 power
    iterations on the device (no read); the iteration itself needs no
    reduction but the monitored ``||r||``, read once per iteration."""
    bnorm, tol = _tol(pnorm, b, rtol, atol)
    tiny = 1e-30
    v = b / torch.clamp_min(bnorm, tiny)
    for _ in range(10):
        w = M(A(v))
        v = w / torch.clamp_min(pnorm(w), tiny)
    lam_max = pdot(v, M(A(v))) / torch.clamp_min(_re(pdot(v, v)), tiny)
    emax, emin = 1.1 * lam_max, 0.1 * lam_max
    theta = (emax + emin) / 2.0
    delta = (emax - emin) / 2.0
    sigma = theta / delta
    r = b - A(x0)
    z = M(r)
    rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    rho = 1.0 / sigma
    d = z / theta
    rn, tol_h, dmax_h, atol_h = _open(rnorm, tol, dmax, atol, monitor)
    syncs, x, it = 1, x0, 0
    while _live_h(rn, tol_h, dmax_h, it, maxit, False):
        x = x + d
        r = r - A(d)
        z = M(r)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = rho_new * rho * d + (2.0 * rho_new / delta) * z
        rho = rho_new
        it += 1
        rn = pnorm(r).item()
        syncs += 1
        _mon(monitor, it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, False, dmax_h), syncs


def _hessenberg_lstsq(H, beta):
    """``min ||beta e1 - H y||`` for the upper-Hessenberg ``H`` of shape
    ``(m+1, m)``, by Givens rotations and back substitution: the JAX
    function's arithmetic in numpy, in ``H``'s dtype, on the host. The
    rotations are complex-capable (JAX ``:683-694``): ``c`` real, ``s =
    sgn(a) conj(b) / r``, applied as ``[c, s; -conj(s), c]``, the textbook
    real rotation when ``conj`` is the identity. Returns ``(y, |g[m]|)``."""
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
        s = zero if r == 0 else sgn * np.conj(bb) / safe
        sc = np.conj(s)
        rj, rj1 = H[j].copy(), H[j + 1].copy()
        H[j], H[j + 1] = c * rj + s * rj1, -sc * rj + c * rj1
        gj, gj1 = g[j], g[j + 1]
        g[j], g[j + 1] = c * gj + s * gj1, -sc * gj + c * gj1
    y = np.zeros(m, H.dtype)
    for i in range(m - 1, -1, -1):
        rii = H[i, i]
        # entries of y below i are still zero: the row product is the tail
        s = g[i] - H[i, :m] @ y
        y[i] = zero if rii == 0 else s / rii
    return y, abs(g[m])


def shardwise_matmul(a, V):
    """``a @ V[i]`` for each local shard ``i`` of ``V (local_shards, ...)``,
    one product per shard: the same shapes on any split of the shards over
    processes, so the same bits (a batched product's rounding may depend
    on its batch count)."""
    return torch.stack([torch.matmul(a, V[i]) for i in range(V.shape[0])])


def _cgs2_step(V, w, pmatdot, pnorm):
    """One CGS2 orthogonalization step: project ``w`` against the basis
    ``V (local_shards, m+1, lsize)`` twice (classical Gram-Schmidt,
    re-applied). Rows of ``V`` past the current column are zero. Returns
    ``(h, hnorm, v_next)``."""
    h1 = pmatdot(V, w)
    w = w - shardwise_matmul(h1, V)
    h2 = pmatdot(V, w)
    w = w - shardwise_matmul(h2, V)
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
    atol_h = _atol_h(atol, b.dtype)

    def read(scalars, H):
        """The cycle's one host read: the scalars and, when another cycle
        was built, its Hessenberg matrix."""
        flat = torch.cat([t.reshape(1).to(b.dtype) for t in scalars]
                         + ([H.reshape(-1)] if H is not None else []))
        h = flat.cpu().numpy()
        ns = len(scalars)
        return ([float(np.real(v)) for v in h[:ns]],
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
        x = x + shardwise_matmul(y, basis[0][:, :m])
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
        x = x + shardwise_matmul(y, basis[0])
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
    atol_h = _atol_h(atol, b.dtype)
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
    atol_h = _atol_h(atol, b.dtype)
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
        # the shadow sequence takes the conjugated coefficients (PETSc's
        # Hermitian-variant complex BiCG, JAX :1512, :1519)
        rt = rt - alpha.conj() * qt
        z = M(r)
        zt = Mt(rt)
        rho_new = pdot(rt, z)
        beta = torch.where(rho == 0, 0.0, rho_new / _nz(rho))
        p = z + beta * p
        pt = zt + beta.conj() * pt
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
    atol_h = _atol_h(atol, b.dtype)
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


# the JAX KSP_KERNELS (krylov.py:1999-2025); fbcgs is BiCGStab, already
# right-preconditioned (flexible by construction), as in the JAX package
KSP_KERNELS = {
    "cg": cg_kernel, "pipecg": pipecg_kernel, "sstep": sstep_kernel,
    "bcgs": bcgs_kernel, "gmres": gmres_kernel, "fgmres": fgmres_kernel,
    "cgs": cgs_kernel, "tfqmr": tfqmr_kernel, "cr": cr_kernel,
    "lsqr": lsqr_kernel, "minres": minres_kernel,
    "chebyshev": chebyshev_kernel, "preonly": preonly_kernel,
    "richardson": richardson_kernel, "bicg": bicg_kernel,
    "gcr": gcr_kernel, "cgne": cgne_kernel, "symmlq": symmlq_kernel,
    "fcg": fcg_kernel, "lgmres": lgmres_kernel, "bcgsl": bcgsl_kernel,
    "fbcgs": bcgs_kernel, "fbcgsr": fbcgsr_kernel,
}


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
            and _on_stencil(pc, operator))


def stencil_pipe_eligible(ksp_type, pc, operator, nullspace=None) -> bool:
    """The pipelined-CG fast-path gate (JAX ``:2289-2298``): pipecg with no
    null space, PC none/jacobi built on the operator itself, a grid apply
    and a uniform diagonal."""
    return (ksp_type == "pipecg" and nullspace is None
            and pc.get_type() in ("none", "jacobi")
            and hasattr(operator, "local_apply_grid3")
            and _on_stencil(pc, operator))


def _on_stencil(pc, operator) -> bool:
    return (hasattr(operator, "grid3d")
            and getattr(operator, "uniform_diagonal", None) is not None
            and (pc.get_type() == "none" or pc._mat is operator))


def make_projector(comm, basis, prec):
    """``project(v (local_shards, lsize)) -> v - Q^T (Q v)`` for this
    process's rows ``basis (k, local_padded)`` of the orthonormal null-space
    basis (JAX ``krylov.py:2527-2532``):
    one product per shard gives its ``(k,)`` partial of ``Q v``, summed in
    shard order, and one product per shard takes the component out (the
    same shapes on any split of the shards over processes). A mixed plan
    projects in its reduce dtype and rounds back to storage."""
    size = comm.local_shards
    k = basis.shape[0]
    Qs = prec.up(basis).view(k, size, -1).transpose(0, 1).contiguous()

    def project(v):
        vu = prec.up(v).reshape(size, -1)
        c = comm.psum([torch.mv(Qs[i], vu[i]) for i in range(size)])  # (k,)
        out = (vu - shardwise_matmul(c, Qs)).view(v.shape)
        return out.to(v.dtype) if prec.mixed else out

    return project


def shard_dots(comm, lift, cols=False):
    """``(pdot, pnorm)``: the dot of two shard-stacked tensors as one dot
    per shard of the ``lift``-ed entries (``torch.vdot``, conjugating the
    first; ``torch.dot`` bit for bit on real tensors), summed in shard
    order by ONE ``psum``, and the real norm it gives. ``cols``: per
    column of ``(size, k,
    lsize)`` blocks, each column's dot as the single-RHS one. The
    reductions of the unfused programs and of the fused one
    (``solvers/megasolve.py``), which must agree bit for bit."""
    size = comm.local_shards

    def dot(u, v):
        return torch.vdot(lift(u).reshape(-1), lift(v).reshape(-1))

    def pdot(U, V):
        if cols:
            return comm.psum([torch.stack([dot(U[i, j], V[i, j])
                                           for j in range(U.shape[1])])
                              for i in range(size)])
        return comm.psum([dot(U[i], V[i]) for i in range(size)])

    def pnorm(U):
        return torch.sqrt(_re(pdot(U, U)))

    return pdot, pnorm


def fused_dots(comm, up, cols=False):
    """``fdots(pairs) -> (len(pairs)[, k])``: the local dots of every pair
    ``(u, v)`` of shard-stacked tensors, stacked per shard and summed in ONE
    ``psum`` (JAX ``cg_plans.fuse_psum``): the one reduction of a pipelined
    CG iteration and fbcgsr's second phase. ``cols``: per column of
    ``(size, k, lsize)`` blocks, each column's dot as the single-RHS one."""
    size = comm.local_shards

    def dot(u, v):
        return torch.vdot(up(u).reshape(-1), up(v).reshape(-1))

    def fdots(pairs):
        if cols:
            parts = [torch.stack([torch.stack([dot(u[i, j], v[i, j])
                                               for j in range(u.shape[1])])
                                  for u, v in pairs])
                     for i in range(size)]
        else:
            parts = [torch.stack([dot(u[i], v[i]) for u, v in pairs])
                     for i in range(size)]
        return comm.psum(parts)

    return fdots


def gram_psum(comm, cols=False):
    """``gram(C) -> E``: the Gram matrix of the rows of ``C (size, q,
    lsize)`` (``cols``: ``(size, q, k, lsize)``, one ``(q, q)`` block per
    column, returned as ``(q, q, k)``), one product per shard and column and
    ONE ``psum`` of the stacked partials: the s-step block's reduction (JAX
    ``cg_plans.fuse_gram_psum``), ``conj(C) C^T`` for complex rows. A
    column's block is the product a
    single-RHS solve makes: a batched product may accumulate its long sums
    in another order, which the monomial basis' conditioning magnifies."""
    def gram(C):
        if cols:
            parts = [torch.stack([C[i, :, j].conj() @ C[i, :, j].T
                                  for j in range(C.shape[2])], dim=-1)
                     for i in range(C.shape[0])]
        else:
            parts = [C[i].conj() @ C[i].T for i in range(C.shape[0])]
        return comm.psum(parts)

    return gram


def _combine(coef, rows):
    """``sum_a coef[a] rows[:, a]`` per shard of ``rows (size, m, ...)``:
    one product per shard (``coef (m,)``), and for a column block
    (``coef (m, k)``, ``rows (size, m, k, L)``) one per shard and column,
    the single-RHS product."""
    c = coef.to(rows.dtype)
    if c.dim() == 1:
        return shardwise_matmul(c, rows)
    return torch.stack([torch.stack([torch.matmul(c[:, j], rows[i, :, j])
                                     for j in range(c.shape[1])])
                        for i in range(rows.shape[0])])


class _SitePsum:
    """A communicator whose ``psum`` calls are the program's reduction sites
    in order (``init``, then the loop body's in turn), each with the
    ``comm.psum`` fault of its site (``resilience/faults.py``); everything
    else is the communicator's own."""

    def __init__(self, comm, sites, init, body):
        self._comm, self._sites = comm, sites
        self._init, self._body = list(init), list(body)
        self._count = 0

    def __getattr__(self, name):
        return getattr(self._comm, name)

    def psum(self, parts):
        k = self._count
        self._count += 1
        name = (self._init[k] if k < len(self._init) else
                self._body[(k - len(self._init)) % len(self._body)])
        return _abft.corrupt_psum(self._sites.hit(name),
                                  self._comm.psum(parts), parts)


def build_ksp_program(comm, ksp_type, pc, operator, restart=30,
                      true_res=False, nullspace=None, monitor=None,
                      natural=False, aug=2, ell=2, sstep_s=4):
    """The solve program for one configuration:
    ``prog(b, x0, rtol, atol, dtol, maxit) -> (x, it, rnorm, reason,
    host_syncs)`` on flat padded data tensors.

    CG with PC none/jacobi/mg on a stencil operator takes the fused fast
    path, and pipecg with PC none/jacobi the pipelined one (the grid apply
    and the scalar Jacobi); everything else (a :class:`..core.mat.Mat` or
    :class:`..core.shell.ShellMat`, the other types, a null space, the
    natural norm) the general route of ``operator.local_spmv`` and
    ``pc.local_apply``. lsqr, bicg and cgne also take
    ``operator.local_spmv_t`` (bicg ``pc.local_apply_transpose`` too), and
    raise ``ValueError`` where the operator or PC has none. ``restart``
    parameterises gmres/fgmres/gcr/fcg/lgmres, ``aug`` lgmres, ``ell``
    bcgsl and ``sstep_s`` sstep (JAX ``:2211-2218``).

    ``nullspace`` is this process's rows ``(k, local_padded)`` of the
    orthonormal basis of the operator's null space, or None: the program
    then projects ``b`` and ``x0`` and the outputs of ``A`` and ``M``, and
    for the transpose types the inputs of
    ``A^T`` and ``M^T`` (the adjoint of ``v -> P A v`` is ``w -> A^T P w``;
    JAX ``:2486-2509``). ``monitor(it, rn)`` receives every residual norm
    the loop reads, in order. With ``true_res`` the program ends with the
    JAX epilogue: one more product and two reductions give the raw
    ``||b - A x||`` and ``||b||``, appended to the result as floats (one
    more host read)."""
    check_ksp_type(ksp_type)
    size = comm.local_shards
    n = operator.shape[0]
    prec = _precision(ksp_type, operator)
    up = prec.up
    natural = natural and ksp_type in NATURAL_TYPES
    # the trace-time faults (resilience/faults.py) of the programs that have
    # their sites: classic CG on the stencil fast path (PC none/jacobi) and
    # on the general route; any other program raises while one is live
    stencil_sites = (stencil_cg_eligible(ksp_type, pc, operator,
                                         nullspace=nullspace, natural=natural)
                     and pc.get_type() != "mg")
    sites = _faults.NO_SITES
    if _faults.trace_time_live():
        if not (stencil_sites or (ksp_type == "cg" and nullspace is None
                                  and not natural)):
            raise NotImplementedError(
                f"a trace-time fault (spmv.result/pc.apply/comm.psum) is "
                f"armed, and the port wires their sites into the cg, pipecg "
                f"and sstep programs only (guarded, and cg unguarded), not "
                f"into KSP {ksp_type!r} with pc {pc.get_type()!r}")
        sites = _faults.trace_sites(
            {"spmv.result": ["A.init", "A.body"],
             "pc.apply": [] if stencil_sites else ["M.init", "M.body"],
             "comm.psum": (["P.bn", "P.rr0", "P.rr"] if stencil_sites else
                           ["P.rz0", "P.bn", "P.rn0", "P.pAp", "P.rz",
                            "P.rn"])})
    pdot, pnorm = shard_dots(
        _SitePsum(comm, sites, ["P.bn", "P.rr0"] if stencil_sites
                  else ["P.rz0", "P.bn", "P.rn0"],
                  ["P.rr"] if stencil_sites else ["P.pAp", "P.rz", "P.rn"])
        if sites else comm, up)
    plain_pnorm = shard_dots(comm, up)[1]

    plan = {"prec": prec} if prec.mixed else {}
    mon = {"monitor": monitor} if monitor is not None else {}
    spmv = operator.local_spmv(comm)
    project = (make_projector(comm, nullspace, prec)
               if nullspace is not None else None)
    fdots = fused_dots(comm, up)

    def fused(r, u, w):
        return tuple(fdots([(r, u), (w, u), (r, r)]))

    if stencil_cg_eligible(ksp_type, pc, operator, nullspace=nullspace,
                           natural=natural):
        matvec_dot = _site_calls(sites, operator.local_matvec_dot(comm),
                                 ["A.init"], ["A.body"], pair=True)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)
        # PC mg composes the V-cycle grid-shaped (None for none/jacobi)
        pc_apply3 = pc.local_apply_grid3d(comm)

        def prog(b, x0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel(
                matvec_dot, inv_diag, pdot, pnorm, b, x0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d, M3=pc_apply3, **plan,
                **mon)
    elif stencil_pipe_eligible(ksp_type, pc, operator, nullspace):
        apply3 = operator.local_apply_grid3(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)

        def prog(b, x0, rtol, atol, dtol, maxit):
            return pipecg_stencil_kernel(
                apply3, inv_diag, pnorm, fused, b, x0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d, **plan, **mon)
    else:
        pc_apply = pc.local_apply(comm, n)
        A = _site_calls(sites, spmv, ["A.init"], ["A.body"])
        M = _site_calls(sites, pc_apply, ["M.init"], ["M.body"])
        if project is not None:
            A = lambda v: project(spmv(v))
            M = lambda r: project(pc_apply(r))
        kernel = KSP_KERNELS[ksp_type]
        kw = {}
        if ksp_type in _RESTARTED:
            kw = {"restart": restart, "pmatdot": _pmatdot(comm)}
            if ksp_type == "lgmres":
                kw["aug"] = aug
        elif ksp_type == "bcgsl":
            kw = {"ell": ell}
        elif ksp_type == "fbcgsr":
            kw = {"preduce": fdots}
        elif ksp_type == "pipecg":
            kw = dict(plan, fused=fused)
        elif ksp_type == "sstep":
            kw = dict(plan, s=max(1, int(sstep_s)), gram=gram_psum(comm),
                      combine=_combine)
        elif ksp_type == "cg":
            kw = dict(plan, natural=natural)
        elif ksp_type == "preonly":
            # refinement is for the direct factorizations only
            kw = {"refine": pc.kind in ("lu", "crtri", "crband")}
        if ksp_type in NATURAL_TYPES[1:]:
            kw["natural"] = natural
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
            trn, bn = _scalars(plain_pnorm(b - spmv(x)), plain_pnorm(b))
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
    # complex scalars need the adjoint, not the transpose (JAX
    # :2529-2544): A^H v = conj(A^T conj(v)), M^H r = conj(M^T conj(r))
    cx = operator.dtype.is_complex
    adj = ((lambda f: (lambda v: f(proj(v).conj()).conj())) if cx
           else (lambda f: (lambda v: f(proj(v)))))
    kw = {"At": adj(spmv_t)}
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
        kw["Mt"] = adj(pc_apply_t)
    return kw


def _precision(ksp_type, operator):
    """The operator's precision plan; raises ``ValueError`` for a mixed plan
    under a KSP type without a body for it (JAX ``krylov.py:2177-2185``:
    the CG family, which the plans build, and the loop-free
    preonly/richardson bodies take one)."""
    prec = _plans.precision_plan(operator.dtype)
    if prec.mixed and ksp_type not in MIXED_TYPES:
        raise ValueError(
            f"sub-f32 storage ({prec.key()[0]}) solves are assembled by the "
            f"mixed-precision CG plans; KSP {ksp_type!r} has no "
            "precision-plan body — use cg/pipecg/sstep (typically under "
            "RefinedKSP fp64 refinement), richardson, or f32 storage, as in "
            "the JAX package")
    return prec


def _pmatdot(comm):
    """``V (size, m+1, lsize), w (size, lsize) -> psum conj(V_i) w_i``:
    the whole-basis projection of CGS2, one reduction (the basis
    conjugated, JAX ``:2497-2499``), computed as ``conj(V_i conj(w_i))``:
    ``torch.mv`` resolves a conjugated operand into a copy, which for the
    basis would be ``m+1`` vectors a call, for ``w`` one. ``conj`` is the
    identity on real tensors."""
    def pmatdot(V, w):
        return comm.psum([torch.mv(V[i], w[i].conj()).conj()
                          for i in range(comm.local_shards)])
    return pmatdot


def batched_pc_supported(pc) -> bool:
    """Whether this PC kind has a batched apply (the ``KSP.solve_many``
    routing test; the others fall back to per-column sequential solves).
    An lu PC's kind (its factor mode) is known once it is set up, as
    ``KSP.solve_many`` does first."""
    return pc.kind in ("none", "jacobi", "bjacobi", "lu")


BATCHED_TYPES = ("cg", "pipecg", "sstep")


def build_ksp_program_many(comm, ksp_type, pc, operator, true_res=False,
                           monitor=None, sstep_s=4):
    """The batched solve program:
    ``prog(B, X0, rtol, atol, dtol, maxit) -> (X, iters, rnorms, reasons,
    host_syncs)`` on ``(size, k, lsize)`` blocks, with per-column lists.

    The routes of the JAX builder: the stencil fast path (CG, PC
    none/jacobi built on the system operator) and the general route
    (``local_spmv_many`` + ``PC.local_apply_many``), which the stencil takes
    when the PC's operator is not the system operator, and which pipecg and
    sstep always take (JAX ``:2916-2929``: one fused reduction an iteration
    for every column, one Gram reduction a block). The reductions are one
    ``torch.dot`` per column and shard, exactly the single-RHS ``pdot`` of
    each column, summed over the shards in shard order.

    With ``true_res`` the program ends with the JAX epilogue for every
    column (``:2920-2935``): one batched product ``A X`` (on the stencil one
    ``stencil7_apply_many`` launch per shard) and the per-column
    ``||b_j - A x_j||`` and ``||b_j||``, appended as two lists (one more
    host read). ``monitor(j, it, rn)`` receives each column's residual
    norms as the loop reads them."""
    if ksp_type not in BATCHED_TYPES:
        raise ValueError(f"KSP {ksp_type!r} has no batched program; "
                         "KSP.solve_many solves its columns one by one")
    if _faults.trace_time_live():
        raise NotImplementedError(
            "a trace-time fault (spmv.result/pc.apply/comm.psum) is armed, "
            "and the port wires their sites into the guarded batched "
            "programs only (-ksp_abft / -ksp_residual_replacement)")
    prec = _precision(ksp_type, operator)
    up = prec.up
    pdot, pnorm = shard_dots(comm, up, cols=True)

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
        if ksp_type == "pipecg":
            fdots = fused_dots(comm, up, cols=True)
            kernel = pipecg_kernel_many
            kw = {"fused": lambda R, U, W: tuple(
                fdots([(R, U), (W, U), (R, R)]))}
        elif ksp_type == "sstep":
            kernel = sstep_kernel_many
            kw = {"s": max(1, int(sstep_s)),
                  "gram": gram_psum(comm, cols=True), "combine": _combine}
        else:
            kernel, kw = cg_kernel_many, {}

        def prog(B, X0, rtol, atol, dtol, maxit):
            return kernel(spmv, pc_apply, pdot, pnorm, B, X0, rtol, atol,
                          maxit, dtol=dtol, monitor=monitor, **kw, **plan)
    if not true_res:
        return prog

    def run(B, X0, rtol, atol, dtol, maxit):
        X, iters, rnorms, reasons, syncs = prog(B, X0, rtol, atol, dtol,
                                                maxit)
        trn, bn = torch.stack([pnorm(B - spmv(X)), pnorm(B)]).tolist()
        return X, iters, rnorms, reasons, syncs + 1, trn, bn

    return run


# ---- the silent-corruption guard: bundles and programs ----------------------
#
# JAX ``krylov.py:265-540`` (``GUARDED_TYPES``, ``_make_guard``,
# ``_make_pipe_guard``, ``_make_sstep_guard``, ``cg_kernel_guarded``,
# ``cg_stencil_kernel_guarded``, the pipelined and s-step guarded kernels
# and their batched forms) and the program wiring (``:2332-2446``,
# ``:2870-2914``). The ABFT partials are torch reductions per shard, stacked
# with the dots the loop already makes into ONE ``psum`` per phase, so the
# reductions an iteration does not grow (JAX: 2 sites against 3 for the
# classic plan). The replacement's verifier always sums through a plain
# reduction: a corrupted verifier would lie about recovery.

# KSP types with a guarded loop
GUARDED_TYPES = ("cg", "pipecg", "sstep")


def _site_calls(sites, fn, init, body, pair=False):
    """``fn`` with the trace-time fault of its sites applied: call ``k``
    is site ``init[k]`` while ``k < len(init)``, then the body's sites in
    turn (one loop body of the JAX program traces each once; every
    iteration's call from a corrupted site carries the corruption).
    ``pair``: ``fn`` returns ``(y, d)`` and only ``y`` is corrupted (the
    fused kernel's dot stays clean, as in JAX). Without a hit site, ``fn``
    itself."""
    if not sites:
        return fn
    count = [0]

    def call(v):
        k = count[0]
        count[0] += 1
        name = init[k] if k < len(init) else body[(k - len(init))
                                                  % len(body)]
        fault = sites.hit(name)
        out = fn(v)
        if pair:
            return _abft.apply_silent_fault(fault, out[0]), out[1]
        return _abft.apply_silent_fault(fault, out)

    return call


def _guard_sites(ksp_type, s=4, stencil=False, cs=False):
    """A guarded program's trace-time sites in the JAX package's trace
    order (``faults.trace_sites``)."""
    if ksp_type == "sstep":
        return {"spmv.result": (["A.init"] + [f"A.p{i}" for i in range(s)]
                                + [f"A.r{i}" for i in range(s - 1)]
                                + ["A.rr", "A.final"]),
                "pc.apply": (["M.init"] + [f"M.p{i}" for i in range(s)]
                             + ["M.z"] + [f"M.r{i}" for i in range(s - 1)]
                             + ["M.rr"]),
                "comm.psum": ["P.init", "P.rn0", "P.gram"]}
    if ksp_type == "pipecg":
        return {"spmv.result": ["A.init0", "A.init1", "A.body", "A.rr",
                                "A.rr2", "A.final"],
                "pc.apply": ["M.init", "M.body", "M.rr"],
                "comm.psum": ["P.init", "P.rn0", "P.fused"]}
    if stencil:
        return {"spmv.result": ["A.init", "A.body", "A.rr"],
                "comm.psum": (["P.init", "P.p2"] if cs
                              else ["P.init", "P.init2", "P.p2"])}
    return {"spmv.result": ["A.init", "A.body", "A.rr"],
            "pc.apply": ["M.init", "M.body", "M.rr"],
            "comm.psum": ["P.init", "P.p2init", "P.p1", "P.p2"]}


class _GuardSums:
    """The per-shard partial sums a guard stacks, for one RHS (a shard's
    block ``(lsize,)`` or grid) or a column block (``(k, lsize)``, ``cols``:
    one value per column), each lifted by ``up``; ``stack(site, fn)`` sums
    ``fn(i)``'s list of partials of every local shard ``i`` in ONE
    reduction, with the ``comm.psum`` fault of ``site``."""

    def __init__(self, comm, up, cols, sdt, sites):
        self.comm, self.up, self.cols, self.sdt = comm, up, cols, sdt
        self.sites = sites

    def dot(self, u, v):
        up = self.up
        if self.cols:
            return torch.stack([torch.vdot(up(u[j]).reshape(-1),
                                           up(v[j]).reshape(-1))
                                for j in range(u.shape[0])])
        return torch.vdot(up(u).reshape(-1), up(v).reshape(-1))

    def tsum(self, u):
        u = self.up(u)
        return u.sum(-1) if self.cols else u.sum()

    def tasum(self, u):
        u = self.up(u)
        if self.cols:
            return torch.linalg.vector_norm(u, 1, dim=-1).to(u.dtype)
        return torch.linalg.vector_norm(u, 1).to(u.dtype)

    def cmul(self, c, v):
        return self.up(c) * self.up(v)

    def stack(self, site, fn, plain=False):
        parts = [torch.stack([q.to(self.sdt) for q in fn(i)])
                 for i in range(self.comm.local_shards)]
        total = self.comm.psum(parts)
        if plain or not self.sites:
            return total
        return _abft.corrupt_psum(self.sites.hit(site), total, parts)


def _bad(diff, scale, tol_eps):
    """The ABFT verdict ``|diff| > tol * eps * scale``."""
    return torch.abs(diff) > tol_eps * _re(scale)


def _make_guard(sums, cs, csM, abft_tol, rr_n, eps):
    """The classic plan's guard bundle (JAX ``_make_guard``, ``:278``) on the
    general route: ``init`` (``||b||`` with the initial apply's check),
    ``p1`` (``<p, A p>`` with the operator's), ``p2`` (``<r, z>``,
    ``||r||^2`` with the PC's), each one stacked reduction, and the plain
    verifier ``vpair``. ``cs``/``csM`` are the shard-stacked checksums or
    None."""
    te = abft_tol * eps
    calls = [0]

    def init(b, r, x0):
        if cs is None:
            s = sums.stack("P.init", lambda i: [sums.dot(b[i], b[i])])
            return torch.sqrt(torch.clamp_min(_re(s[0]), 0.0)), None

        def parts(i):
            cx = sums.cmul(cs[i], x0[i])
            return [sums.dot(b[i], b[i]), sums.tsum(r[i]), sums.tsum(b[i]),
                    sums.tsum(cx), sums.tasum(r[i]), sums.tasum(b[i]),
                    sums.tasum(cx)]
        s = sums.stack("P.init", parts)
        return (torch.sqrt(torch.clamp_min(_re(s[0]), 0.0)),
                _bad(s[1] - s[2] + s[3], _re(s[4]) + _re(s[5]) + _re(s[6]),
                     te))

    def p1(p, Ap):
        """``(<p, A p>, the operator's check sums)`` (``cg_plans._bad4``)."""
        if cs is None:
            return sums.stack("P.p1", lambda i: [sums.dot(p[i], Ap[i])])[0], \
                None

        def parts(i):
            cp = sums.cmul(cs[i], p[i])
            return [sums.dot(p[i], Ap[i]), sums.tsum(Ap[i]), sums.tsum(cp),
                    sums.tasum(Ap[i]), sums.tasum(cp)]
        s = sums.stack("P.p1", parts)
        return s[0], s[1:5]

    # PC none's checksum is all ones: <c_M, r> is then the sum of r itself
    ones = csM is not None and bool(torch.all(csM == 1))

    def p2(r, z, site=None):
        """``(<r, z>, ||r||^2, the PC's check sums)``; the first call is
        site ``P.p2init`` unless ``site`` names it (the fused program's
        pieces do: a capture runs a piece twice)."""
        if site is None:
            site = "P.p2init" if calls[0] == 0 else "P.p2"
        calls[0] += 1
        if csM is None:
            s = sums.stack(site, lambda i: [sums.dot(r[i], z[i]),
                                            sums.dot(r[i], r[i])])
            return s[0], _re(s[1]), None

        def parts(i):
            cr = r[i] if ones else sums.cmul(csM[i], r[i])
            return [sums.dot(r[i], z[i]), sums.dot(r[i], r[i]),
                    sums.tsum(z[i]), sums.tsum(cr), sums.tasum(z[i]),
                    sums.tasum(cr)]
        s = sums.stack(site, parts)
        return s[0], _re(s[1]), s[2:6]

    def vpair(rt, zt):
        s = sums.stack(None, lambda i: [sums.dot(rt[i], rt[i]),
                                        sums.dot(rt[i], zt[i])], plain=True)
        return _re(s[0]), s[1]

    def vnorm2(rt):
        return _re(sums.stack(None, lambda i: [sums.dot(rt[i], rt[i])],
                              plain=True)[0])

    def pnorm(u):
        s = sums.stack("P.rn0", lambda i: [sums.dot(u[i], u[i])])
        return torch.sqrt(torch.clamp_min(_re(s[0]), 0.0))

    return types.SimpleNamespace(init=init, p1=p1, p2=p2, vpair=vpair,
                                 vnorm2=vnorm2, pnorm=pnorm, rr_n=int(rr_n),
                                 eps=eps, abft_tol=abft_tol, te=te, cs=cs,
                                 csM=csM)


def _make_stencil_guard(sums, boundary, abft_tol, rr_n, eps):
    """The stencil fast path's guard bundle (JAX ``:2390-2430``): the fused
    kernel psums ``<p, A p>`` itself, so the operator's ABFT partials ride
    the phase-2 reduction with ``||r||^2`` (``p2_stencil``); ``<c, p>`` and
    ``sum |c p|`` read the boundary shells only (``boundary``, from
    ``StencilPoisson3D.checksum_boundary``; None: no checksum)."""
    te = abft_tol * eps
    up = sums.up

    def cdot(u, i):
        v = up(u).reshape(-1)[boundary[i]]
        return v.sum(), v.abs().sum()

    def init(b, r, x):
        """``(||b||, ||r||^2, the operator's check flag)``: the squared
        norm, as the unguarded loop takes ``<r, z> = ||r||^2 / d`` from it
        (JAX squares the norm again, one rounding apart)."""
        if boundary is None:
            bn = sums.stack("P.init", lambda i: [sums.dot(b[i], b[i])])[0]
            rn = sums.stack("P.init2", lambda i: [sums.dot(r[i], r[i])])[0]
            return (torch.sqrt(torch.clamp_min(bn, 0.0)),
                    torch.clamp_min(rn, 0.0), None)

        def parts(i):
            cx, acx = cdot(x[i], i)
            ru, bu = up(r[i]), up(b[i])
            return [sums.dot(b[i], b[i]), sums.dot(r[i], r[i]), ru.sum(),
                    bu.sum(), cx, torch.linalg.vector_norm(ru, 1),
                    torch.linalg.vector_norm(bu, 1), acx]
        s = sums.stack("P.init", parts)
        return (torch.sqrt(torch.clamp_min(s[0], 0.0)),
                torch.clamp_min(s[1], 0.0),
                _bad(s[2] - s[3] + s[4], s[5] + s[6] + s[7], te))

    def p2_stencil(r, p, Ap):
        """``(||r||^2, the operator's check sums)`` (``cg_plans._bad4``)."""
        if boundary is None:
            s = sums.stack("P.p2", lambda i: [sums.dot(r[i], r[i])])
            return torch.clamp_min(s[0], 0.0), None

        def parts(i):
            cp, acp = cdot(p[i], i)
            a = up(Ap[i])
            return [sums.dot(r[i], r[i]), a.sum(), cp,
                    torch.linalg.vector_norm(a, 1), acp]
        s = sums.stack("P.p2", parts)
        return torch.clamp_min(s[0], 0.0), s[1:5]

    def vnorm2(rt):
        return sums.stack(None, lambda i: [sums.dot(rt[i], rt[i])],
                          plain=True)[0]

    return types.SimpleNamespace(init=init, p2_stencil=p2_stencil,
                                 vnorm2=vnorm2, rr_n=int(rr_n), eps=eps,
                                 te=te)


def _make_pipe_guard(sums, cs, csM, abft_tol, rr_n, eps):
    """The pipelined plan's guard bundle (JAX ``_make_pipe_guard``,
    ``:357``): the checksum partials of a body's fresh applies ``m = M w``,
    ``n = A m`` (``chk_parts``, per shard) ride the NEXT body's one reduction
    (``fused``); ``vpair2`` verifies the true residual against the CURRENT
    recurrence residual through a plain reduction."""
    base = _make_guard(sums, cs, csM, abft_tol, rr_n, eps)
    te = abft_tol * eps
    L = sums.comm.local_shards

    def chk_parts(mv, nv, wv):
        out = []
        for i in range(L):
            q = []
            if cs is not None:
                cm = sums.cmul(cs[i], mv[i])
                q += [sums.tsum(nv[i]), sums.tsum(cm), sums.tasum(nv[i]),
                      sums.tasum(cm)]
            if csM is not None:
                cw = sums.cmul(csM[i], wv[i])
                q += [sums.tsum(mv[i]), sums.tsum(cw), sums.tasum(mv[i]),
                      sums.tasum(cw)]
            out.append(q)
        return out

    def chk_init(r0, u0, w0):
        return chk_parts(u0, w0, r0)

    def fused(r, u, w, chk):
        s = sums.stack("P.fused", lambda i: [
            sums.dot(r[i], u[i]), sums.dot(w[i], u[i]),
            sums.dot(r[i], r[i])] + chk[i])
        badA = badM = None
        i = 3
        if cs is not None:
            badA = _bad(s[i] - s[i + 1], _re(s[i + 2]) + _re(s[i + 3]), te)
            i += 4
        if csM is not None:
            badM = _bad(s[i] - s[i + 1], _re(s[i + 2]) + _re(s[i + 3]), te)
        return s[0], s[1], s[2], badA, badM

    def vpair2(rt, rc):
        s = sums.stack(None, lambda i: [sums.dot(rt[i], rt[i]),
                                        sums.dot(rc[i], rc[i])], plain=True)
        return _re(s[0]), _re(s[1])

    return types.SimpleNamespace(init=base.init, pnorm=base.pnorm,
                                 fused=fused, chk_parts=chk_parts,
                                 chk_init=chk_init, vnorm2=base.vnorm2,
                                 vpair2=vpair2, rr_n=int(rr_n), eps=eps)


def _make_sstep_guard(sums, cs, csM, abft_tol, rr_n, eps, s):
    """The s-step plan's guard bundle (JAX ``_make_sstep_guard``, ``:446``):
    ``greduce(C)`` reduces the block's Gram matrix of the rows of ``C`` and
    the column sums of the basis build's applies in ONE reduction and
    returns them to the host (numpy); the loop judges them
    (``cg_plans._sstep_guard_flags``). ``greduce(C, host=False)`` returns
    them as device tensors (the fused program's masked steps)."""
    base = _make_guard(sums, cs, csM, abft_tol, rr_n, eps)
    m = 2 * s + 1
    cols = sums.cols

    def greduce(Cup, host=True):
        shapes = []

        def parts(i):
            Ci = Cup[i]
            if cols:
                E = torch.stack([Ci[:, j].conj() @ Ci[:, j].T
                                 for j in range(Ci.shape[1])], dim=-1)
            else:
                E = Ci.conj() @ Ci.T
            Bz, Bw, r = Ci[:m], Ci[m:2 * m], Ci[2 * m]
            q = [E]
            if cs is not None:
                cB = cs[i] * Bz
                q += [Bw.sum(-1), cB.sum(-1), Bw.abs().sum(-1).to(Bw.dtype),
                      cB.abs().sum(-1).to(Bw.dtype)]
            if csM is not None:
                cW = csM[i] * Bw
                cr = csM[i] * r
                q += [Bz.sum(-1), cW.sum(-1), Bz.abs().sum(-1).to(Bz.dtype),
                      cW.abs().sum(-1).to(Bz.dtype), cr.sum(-1),
                      cr.abs().sum(-1).to(cr.dtype)]
            if i == 0:
                shapes.extend(t.shape for t in q)
            return [torch.cat([t.reshape(-1) for t in q])]
        flat = sums.stack("P.gram", parts)[0]
        if host:
            flat = flat.cpu().numpy()
        out, k = [], 0
        for shp in shapes:
            n = int(np.prod(shp))
            out.append(flat[k:k + n].reshape(shp))
            k += n
        return out[0], out[1:]

    return types.SimpleNamespace(
        init=base.init, pnorm=base.pnorm, vpair=base.vpair,
        vnorm2=base.vnorm2, greduce=greduce, rr_n=int(rr_n), eps=eps,
        abft_tol=abft_tol, cs=cs, csM=csM)


def guarded_stencil_eligible(ksp_type, pc, operator, many=False) -> bool:
    """Whether a guarded solve takes the stencil fast path: cg on one RHS
    with PC none/jacobi on a stencil operator that can read its checksum on
    the boundary shells."""
    return (not many and stencil_cg_eligible(ksp_type, pc, operator)
            and pc.get_type() in ("none", "jacobi")
            and hasattr(operator, "checksum_boundary"))


def build_guarded_program(comm, ksp_type, pc, operator, *, abft_tol, rr_n,
                          cs=None, csM=None, max_repl=3, true_res=False,
                          monitor=None, sstep_s=4, many=False):
    """The guarded solve program of a cg/pipecg/sstep KSP (JAX
    ``build_ksp_program``/``build_ksp_program_many`` with ``abft``/
    ``abft_pc``/``rr``): ``prog(b, x0, rtol, atol, dtol, maxit) -> (x, it,
    rnorm, reason, host_syncs, det, rrc, xv)`` on flat padded data (``many``:
    ``(size, k, lsize)`` blocks and per-column lists), with the true-residual
    epilogue's ``(trn, bn)`` appended under ``true_res``.

    ``cs``/``csM`` are the placed column checksums (this process's padded
    rows) or None; on the stencil fast path (cg, PC none/jacobi on a
    :class:`..models.stencil.StencilPoisson3D`, one RHS) ``cs`` is
    ``"boundary"``: the analytic checksum read on the boundary shells. A
    guarded stencil solve launches row 1 (``stencil7_dot``) once a step and
    at set-up and row 2 (``stencil7_apply``) for each replacement's ``b - A
    x``; the batched one and pipecg/sstep take the general route, row 9
    (``stencil7_apply_many``) for a column block (JAX ``:2823-2831``,
    ``:2286``)."""
    if ksp_type not in GUARDED_TYPES:
        raise ValueError(f"KSP {ksp_type!r} has no guarded loop")
    prec = _precision(ksp_type, operator)
    up = prec.up
    sdt = prec.reduce if prec.mixed else operator.dtype
    eps = _abft.checksum_tolerance_dtype(operator.dtype)
    size = comm.local_shards
    n = operator.shape[0]
    plan = {"prec": prec} if prec.mixed else {}
    s = max(1, int(sstep_s))
    # the stencil fast path keeps the scalar-Jacobi identities only: PC mg
    # under the guard takes the general route (JAX :2271-2274)
    stencil = guarded_stencil_eligible(ksp_type, pc, operator, many)
    if cs == "boundary" and not stencil:
        raise ValueError("the boundary checksum is the stencil fast path's")
    sites = _faults.trace_sites(_guard_sites(ksp_type, s, stencil,
                                             cs is not None))
    sums = _GuardSums(comm, up, many, sdt, sites)
    plain_pdot, plain_pnorm = shard_dots(comm, up, cols=many)
    if stencil:
        matvec_dot = operator.local_matvec_dot(comm)
        apply3 = operator.local_apply_grid3(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)
        boundary = (operator.checksum_boundary(comm) if cs is not None
                    else None)
        g = _make_stencil_guard(sums, boundary, abft_tol, rr_n, eps)
        g.A_rr = _site_calls(sites, apply3, ["A.rr"], ["A.rr"])
        Adot = _site_calls(sites, matvec_dot, ["A.init"], ["A.body"],
                           pair=True)
        grid = (size,) + tuple(operator.grid3d)

        def prog(b, x0, rtol, atol, dtol, maxit):
            out = _plans.guarded_cg_loop(
                b=b.reshape(grid), x0=x0.reshape(grid), rtol=rtol,
                atol=atol, maxit=maxit, g=g, dtol=dtol, Adot=Adot,
                inv_diag=inv_diag, monitor=monitor, **plan)
            return ((out[0].reshape(b.shape),) + out[1:7]
                    + (out[7].reshape(b.shape),))
        spmv = operator.local_spmv(comm)
    else:
        if many:
            spmv = operator.local_spmv_many(comm)
            pc_apply = pc.local_apply_many(comm, n)
            if pc_apply is None:
                raise ValueError(f"pc {pc.get_type()!r} has no batched "
                                 "apply; KSP.solve_many solves its columns "
                                 "one by one")
        else:
            spmv = operator.local_spmv(comm)
            pc_apply = pc.local_apply(comm, n)
        bp = _plans.ManyBatch("cols") if many else None
        if ksp_type == "cg":
            g = _make_guard(sums, cs, csM, abft_tol, rr_n, eps)
            A = _site_calls(sites, spmv, ["A.init"], ["A.body"])
            M = _site_calls(sites, pc_apply, ["M.init"], ["M.body"])
            g.A_rr = _site_calls(sites, spmv, ["A.rr"], ["A.rr"])
            g.M_rr = _site_calls(sites, pc_apply, ["M.rr"], ["M.rr"])

            def prog(b, x0, rtol, atol, dtol, maxit):
                return _plans.guarded_cg_loop(
                    b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, g=g,
                    dtol=dtol, A=A, M=M, bp=bp, monitor=monitor, **plan)
        elif ksp_type == "pipecg":
            g = _make_pipe_guard(sums, cs, csM, abft_tol, rr_n, eps)
            A = _site_calls(sites, spmv, ["A.init0", "A.init1"], ["A.body"])
            M = _site_calls(sites, pc_apply, ["M.init"], ["M.body"])
            g.A_rr = _site_calls(sites, spmv, ["A.rr"], ["A.rr"])
            g.A_rr2 = _site_calls(sites, spmv, ["A.rr2"], ["A.rr2"])
            g.M_rr = _site_calls(sites, pc_apply, ["M.rr"], ["M.rr"])
            g.A_final = _site_calls(sites, spmv, ["A.final"], ["A.final"])

            def prog(b, x0, rtol, atol, dtol, maxit):
                return _plans.guarded_pipelined_loop(
                    b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, g=g,
                    dtol=dtol, A=A, M=M, bp=bp, monitor=monitor, **plan)
        else:
            g = _make_sstep_guard(sums, cs, csM, abft_tol, rr_n, eps, s)
            A = _site_calls(sites, spmv, ["A.init"],
                            [f"A.p{i}" for i in range(s)]
                            + [f"A.r{i}" for i in range(s - 1)])
            M = _site_calls(sites, pc_apply, ["M.init"],
                            [f"M.p{i}" for i in range(s)] + ["M.z"]
                            + [f"M.r{i}" for i in range(s - 1)])
            g.A_rr = _site_calls(sites, spmv, ["A.rr"], ["A.rr"])
            g.M_rr = _site_calls(sites, pc_apply, ["M.rr"], ["M.rr"])
            g.A_final = _site_calls(sites, spmv, ["A.final"], ["A.final"])

            def prog(b, x0, rtol, atol, dtol, maxit):
                return _plans.guarded_sstep_loop(
                    b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, s=s,
                    g=g, combine=_combine, max_repl=int(max_repl), A=A,
                    M=M, dtol=dtol, bp=bp, monitor=monitor, **plan)

    def run(b, x0, rtol, atol, dtol, maxit):
        shape = (size, b.shape[1], -1) if many else (size, -1)
        b, x0 = b.view(shape), x0.view(shape)
        out = prog(b, x0, rtol, atol, dtol, maxit)
        x = out[0] if many else out[0].reshape(-1)
        xv = out[7] if many else out[7].reshape(-1)
        out = (x,) + tuple(out[1:7]) + (xv,)
        if true_res:
            # the epilogue's true residual, on the raw operator and plain
            # reductions (JAX _true_res_tail)
            xs = out[0].view(shape)
            if many:
                trn, bn = torch.stack([plain_pnorm(b - spmv(xs)),
                                       plain_pnorm(b)]).tolist()
            else:
                trn, bn = _scalars(plain_pnorm(b - spmv(xs)),
                                   plain_pnorm(b))
            out = out[:4] + (out[4] + 1,) + out[5:] + (trn, bn)
        return out

    return run
