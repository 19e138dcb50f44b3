"""Krylov kernels and the construction of the solve program.

The port's counterpart of the CG part of
``mpi_petsc4py_example_tpu/solvers/krylov.py``: ``cg_kernel`` (``:188``),
``cg_stencil_kernel`` (``:220``) and the stencil-CG routing of
``build_ksp_program`` (``:2264-2283``, ``:2369-2438``) without the guard; and
for ``KSP.solve_many`` ``cg_kernel_many`` (``:2662``),
``cg_stencil_kernel_many`` (``:2689``), ``batched_pc_supported`` (``:2741``)
and ``build_ksp_program_many`` (``:2748``) without the guard, the
true-residual epilogue and the pipelined/s-step plans.
"""

from __future__ import annotations

import torch

from . import cg_plans as _plans

KSP_TYPES = ("cg",)


def cg_kernel(A, M, pdot, pnorm, b, x0, rtol, atol, maxit, dtol=None):
    """Preconditioned conjugate gradients (KSPCG) on the general route."""
    return _plans.classic_cg_loop(
        b=b, x0=x0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        A=A, M=M, pdot=pdot, pnorm=pnorm)


def cg_stencil_kernel(Adot, inv_diag, pdot, pnorm, b, x0, rtol, atol, maxit,
                      dtol=None, grid3d=None, M3=None):
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
        Adot=Adot, inv_diag=inv_diag, M3=M3, pdot=pdot, pnorm=pnorm)
    return (x.reshape(flat), *rest)


def cg_kernel_many(A, M, pdot, pnorm, B, X0, rtol, atol, maxit, dtol=None):
    """Batched preconditioned CG on the general route: ``k`` independent
    recurrences in lockstep over a ``(size, k, lsize)`` block, each
    column's arithmetic that of :func:`cg_kernel`, with per-column masked
    convergence. ``pdot``/``pnorm`` reduce per column to ``(k,)``; the JAX
    package stacks ``<R, Z>`` and ``<R, R>`` into one psum (``pduo``), which
    on the port's fixed-order shard sum is the same two reductions."""
    return _plans.classic_cg_loop(
        b=B, x0=X0, rtol=rtol, atol=atol, maxit=maxit, dtol=dtol,
        A=A, M=M, pdot=pdot, pnorm=pnorm, bp=_plans.ManyBatch("cols"))


def cg_stencil_kernel_many(Adot, inv_diag, pdot, pnorm, B, X0, rtol, atol,
                           maxit, dtol=None, grid3d=None):
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
        pnorm=pnorm, bp=_plans.ManyBatch("slabs"))
    return (x.reshape(flat), *rest)


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


def build_ksp_program(comm, ksp_type, pc, operator):
    """The solve program for one configuration:
    ``prog(b, x0, rtol, atol, dtol, maxit) -> (x, it, rnorm, reason,
    host_syncs)`` on flat padded data tensors."""
    if ksp_type not in KSP_TYPES:
        raise ValueError(f"unknown KSP type {ksp_type!r}; available: "
                         f"{list(KSP_TYPES)}")
    size = comm.size

    def pdot(u, v):
        return comm.psum([torch.dot(u[i].reshape(-1), v[i].reshape(-1))
                          for i in range(size)])

    def pnorm(u):
        return torch.sqrt(pdot(u, u))

    if stencil_cg_eligible(ksp_type, pc, operator):
        matvec_dot = operator.local_matvec_dot(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)
        # PC mg composes the V-cycle grid-shaped (None for none/jacobi)
        pc_apply3 = pc.local_apply_grid3d(comm)

        def prog(b, x0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel(
                matvec_dot, inv_diag, pdot, pnorm, b.view(size, -1),
                x0.view(size, -1), rtol, atol, maxit, dtol=dtol,
                grid3d=operator.grid3d, M3=pc_apply3)
    else:
        spmv = operator.local_spmv(comm)
        n = operator.shape[0]
        pc_apply = pc.local_apply(comm, n)

        def prog(b, x0, rtol, atol, dtol, maxit):
            return cg_kernel(spmv, pc_apply, pdot, pnorm, b.view(size, -1),
                             x0.view(size, -1), rtol, atol, maxit, dtol=dtol)

    def run(b, x0, rtol, atol, dtol, maxit):
        x, *rest = prog(b, x0, rtol, atol, dtol, maxit)
        return (x.reshape(-1), *rest)

    return run


def batched_pc_supported(pc) -> bool:
    """Whether this PC kind has a batched apply (the ``KSP.solve_many``
    routing test; the others fall back to per-column sequential solves)."""
    return pc.get_type() in ("none", "jacobi")


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
    if ksp_type not in KSP_TYPES:
        raise ValueError(f"unknown KSP type {ksp_type!r}; available: "
                         f"{list(KSP_TYPES)}")
    size = comm.size

    def pdot(U, V):
        return comm.psum([
            torch.stack([torch.dot(U[i, j].reshape(-1), V[i, j].reshape(-1))
                         for j in range(U.shape[1])])
            for i in range(size)])

    def pnorm(U):
        return torch.sqrt(pdot(U, U))

    if stencil_cg_eligible(ksp_type, pc, operator, many=True):
        matvec_dot = operator.local_matvec_dot_many(comm)
        inv_diag = (1.0 if pc.get_type() == "none"
                    else 1.0 / operator.uniform_diagonal)

        def prog(B, X0, rtol, atol, dtol, maxit):
            return cg_stencil_kernel_many(
                matvec_dot, inv_diag, pdot, pnorm, B, X0, rtol, atol, maxit,
                dtol=dtol, grid3d=operator.grid3d)
        return prog
    pc_apply = pc.local_apply_many(comm, operator.shape[0])
    if pc_apply is None:
        raise ValueError(f"pc {pc.get_type()!r} has no batched apply; "
                         "KSP.solve_many solves its columns one by one")
    spmv = operator.local_spmv_many(comm)

    def prog(B, X0, rtol, atol, dtol, maxit):
        return cg_kernel_many(spmv, pc_apply, pdot, pnorm, B, X0, rtol, atol,
                              maxit, dtol=dtol)
    return prog
