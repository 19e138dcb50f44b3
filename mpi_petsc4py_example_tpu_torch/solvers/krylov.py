"""Krylov kernels and the construction of the solve program.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/krylov.py``:
``cg_kernel`` (``:188``), ``cg_stencil_kernel`` (``:220``), ``bcgs_kernel``
(``:533``), ``gmres_kernel`` (``:732``) with ``_hessenberg_lstsq``
(``:671``) and ``_cgs2_step`` (``:716``), ``preonly_kernel`` (``:790``) and
``build_ksp_program`` (``:2091``) with the stencil-CG fast path, the general
route and the true-residual epilogue (``_true_res_tail``, ``:2551``), without
the guard, monitors and null spaces; and for ``KSP.solve_many``
``cg_kernel_many`` (``:2662``), ``cg_stencil_kernel_many`` (``:2689``),
``batched_pc_supported`` (``:2741``) and ``build_ksp_program_many``
(``:2748``) without the guard, the true-residual epilogue and the
pipelined/s-step plans.

The JAX loops are ``lax.while_loop``s on the device; here they are eager
PyTorch driven by the host, with the scalars on the device and one small
host read where the loop decides whether to go on: once per iteration for CG
and BiCGStab, once per restart cycle for GMRES, once per refinement step for
preonly. Every program returns the count of its host reads.

Both builders take the precision plan from the operator's dtype (JAX
``:2177-2186``, ``:2796-2798``): under bfloat16 storage the reductions lift
their operands to fp32 (``:2341-2346``) and the CG loops run the mixed plan;
KSP types without a mixed-precision body (gmres, bcgs) raise, as in the JAX
package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.convergence import ConvergedReason as CR
from . import cg_plans as _plans
from .cg_plans import _dmax, _reason, _tol

KSP_TYPES = ("cg", "gmres", "bcgs", "preonly")

def cg_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None,
              prec=None):
    """Preconditioned conjugate gradients (KSPCG) on the general route."""
    return _plans.classic_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        A=A, M=M, pdot=pdot, pnorm=pnorm, prec=prec)


def cg_stencil_kernel(Adot, inv_diag, pdot, pnorm, b, x0, rtol, atol, maxit,
                      dtol=None, grid3d=None, M3=None, prec=None):
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
        prec=prec)
    return (x.reshape(flat), *rest)


def cg_kernel_many(A, M, pdot, pnorm, B, X0, rtol, atol, maxit, dtol=None,
                   prec=None):
    """Batched preconditioned CG on the general route: ``k`` independent
    recurrences in lockstep over a ``(size, k, lsize)`` block, each
    column's arithmetic that of :func:`cg_kernel`, with per-column masked
    convergence. ``pdot``/``pnorm`` reduce per column to ``(k,)``; the JAX
    package stacks ``<R, Z>`` and ``<R, R>`` into one psum (``pduo``), which
    on the port's fixed-order shard sum is the same two reductions."""
    return _plans.classic_cg_loop(
        b=B, x0=X0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        A=A, M=M, pdot=pdot, pnorm=pnorm, bp=_plans.ManyBatch("cols"),
        prec=prec)


def cg_stencil_kernel_many(Adot, inv_diag, pdot, pnorm, B, X0, rtol, atol,
                           maxit, dtol=None, grid3d=None, prec=None):
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
        pnorm=pnorm, bp=_plans.ManyBatch("slabs"), prec=prec)
    return (x.reshape(flat), *rest)


def _scalars(*ts) -> list:
    """One host read of several device scalars."""
    return torch.stack([t.reshape(()).to(ts[0].dtype) for t in ts]).tolist()


def _nz(d):
    """``d`` with its zeros replaced by 1 (a guarded divisor)."""
    return torch.where(d == 0, 1.0, d)


def bcgs_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None):
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


def gmres_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, restart=30,
                 pmatdot=None, dtol=None):
    """Left-preconditioned restarted GMRES (KSPGMRES), monitored in the
    preconditioned residual norm, CGS2 Arnoldi, the small least-squares
    problem by Givens rotations once per cycle.

    The Arnoldi cycle runs on the device; its Hessenberg matrix goes to the
    host for the least-squares solve. To read the host once per cycle, the
    cycle after a restart is built before the read that decides whether it
    runs: the residual norm of the new iterate and the next cycle's
    Hessenberg matrix come in one read, and the last cycle built is thrown
    away when the solve stops (one cycle of extra work per solve). The
    residual a cycle starts from is the one the previous cycle ended with
    (the JAX body recomputes the same value).
    """
    m = restart
    size = b.shape[0]
    tol = torch.clamp_min(rtol * pnorm(M(b)), atol)
    r = M(b - A(x0))
    rn_t = pnorm(r)
    dmax = _dmax(rn_t, dtol)
    atol_h = torch.tensor(atol, dtype=b.dtype).item()

    def arnoldi(r, beta):
        V = b.new_zeros((size, m + 1) + tuple(b.shape[1:]))
        V[:, 0] = r / torch.where(beta == 0, 1.0, beta)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            h, hnorm, vnext = _cgs2_step(V, M(A(V[:, j])), pmatdot, pnorm)
            H[:, j] = h
            H[j + 1, j] = hnorm
            V[:, j + 1] = vnext
        return V, H

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
    V, H = arnoldi(r, rn_t) if maxit > 0 else (None, None)
    (rn, tol_h, dmax_h), H_h = read([rn_t, tol, dmax], H)
    syncs = 1
    while rn > tol_h and rn < dmax_h and k < maxit:
        y, _ = _hessenberg_lstsq(H_h, H_h.dtype.type(rn))
        x = x + torch.matmul(torch.from_numpy(y).to(b.device), V[:, :m])
        k += m
        r = M(b - A(x))
        rn_t = pnorm(r)
        V, H = arnoldi(r, rn_t) if k < maxit else (None, None)
        (rn,), H_h = read([rn_t], H)
        syncs += 1
    return x, k, rn, _reason(rn, tol_h, atol_h, False, dmax_h), syncs


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


def stencil_cg_eligible(ksp_type, pc, operator, many=False) -> bool:
    """The CG fast-path gate of the JAX ``build_ksp_program`` (``many``:
    of ``build_ksp_program_many``, ``:2823-2831``): CG, PC none/jacobi/mg
    (batched: none/jacobi), an operator with the fused matvec-dot and a
    uniform diagonal, and a Jacobi or mg PC built from that same
    operator."""
    kinds = ("none", "jacobi") if many else ("none", "jacobi", "mg")
    dot = "local_matvec_dot_many" if many else "local_matvec_dot"
    return (ksp_type == "cg"
            and pc.get_type() in kinds
            and hasattr(operator, dot)
            and hasattr(operator, "grid3d")
            and getattr(operator, "uniform_diagonal", None) is not None
            and (pc.get_type() == "none" or pc._mat is operator))


def build_ksp_program(comm, ksp_type, pc, operator, restart=30,
                      true_res=False):
    """The solve program for one configuration:
    ``prog(b, x0, rtol, atol, dtol, maxit) -> (x, it, rnorm, reason,
    host_syncs)`` on flat padded data tensors.

    CG with PC none/jacobi/mg on a stencil operator takes the fused fast
    path; everything else (a :class:`..core.mat.Mat`, GMRES, BiCGStab,
    preonly) the general route of ``operator.local_spmv`` and
    ``pc.local_apply``. With ``true_res`` the program ends with the JAX
    epilogue: one more product and two reductions give ``||b - A x||`` and
    ``||b||``, appended to the result as floats (one more host read)."""
    if ksp_type not in KSP_TYPES:
        raise ValueError(f"unknown KSP type {ksp_type!r}; available: "
                         f"{list(KSP_TYPES)}")
    size = comm.size
    prec = _precision(ksp_type, operator)
    up = prec.up

    def pdot(u, v):
        return comm.psum([torch.dot(up(u[i]).reshape(-1),
                                    up(v[i]).reshape(-1))
                          for i in range(size)])

    def pnorm(u):
        return torch.sqrt(pdot(u, u))

    plan = {"prec": prec} if prec.mixed else {}
    spmv = operator.local_spmv(comm)
    if stencil_cg_eligible(ksp_type, pc, operator):
        matvec_dot = operator.local_matvec_dot(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)
        # PC mg composes the V-cycle grid-shaped (None for none/jacobi)
        pc_apply3 = pc.local_apply_grid3d(comm)

        def prog(b, x0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel(
                matvec_dot, inv_diag, pdot, pnorm, b, x0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d, M3=pc_apply3, **plan)
    else:
        pc_apply = pc.local_apply(comm, operator.shape[0])
        kernel, kw = {"cg": (cg_kernel, plan),
                      "bcgs": (bcgs_kernel, {}),
                      "gmres": (gmres_kernel, {"restart": restart,
                                               "pmatdot": _pmatdot(comm)}),
                      # refinement is for the direct factorizations only
                      "preonly": (preonly_kernel,
                                  {"refine": pc.kind in ("lu", "crtri",
                                                         "crband")})}[ksp_type]

        def prog(b, x0, rtol, atol, dtol, maxit):
            return kernel(spmv, pc_apply, pdot, pnorm, b, x0, rtol, atol,
                          maxit, dtol=dtol, **kw)

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


def build_ksp_program_many(comm, ksp_type, pc, operator):
    """The batched solve program:
    ``prog(B, X0, rtol, atol, dtol, maxit) -> (X, iters, rnorms, reasons,
    host_syncs)`` on ``(size, k, lsize)`` blocks, with per-column lists.

    Both routes of the JAX builder: the stencil fast path (CG, PC
    none/jacobi built on the system operator) and the general route
    (``local_spmv_many`` + ``PC.local_apply_many``), which the stencil takes
    when the PC's operator is not the system operator. The reductions are
    one ``torch.dot`` per column and shard, exactly the single-RHS ``pdot``
    of each column, summed over the shards in shard order."""
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
    if stencil_cg_eligible(ksp_type, pc, operator, many=True):
        matvec_dot = operator.local_matvec_dot_many(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)

        def prog(B, X0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel_many(
                matvec_dot, inv_diag, pdot, pnorm, B, X0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d, **plan)
        return prog
    pc_apply = pc.local_apply_many(comm, operator.shape[0])
    if pc_apply is None:
        raise ValueError(f"pc {pc.get_type()!r} has no batched apply; "
                         "KSP.solve_many solves its columns one by one")
    spmv = operator.local_spmv_many(comm)

    def prog(B, X0, rtol, atol, dtol, maxit):
        return cg_kernel_many(spmv, pc_apply, pdot, pnorm, B, X0, rtol, atol,
                              maxit, dtol=dtol, **plan)
    return prog
