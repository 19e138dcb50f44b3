"""Krylov kernels and the construction of the solve program.

The port's counterpart of the CG part of
``mpi_petsc4py_example_tpu/solvers/krylov.py``: ``cg_kernel`` (``:188``),
``cg_stencil_kernel`` (``:220``) and the stencil-CG routing of
``build_ksp_program`` (``:2264-2283``, ``:2369-2438``) without the guard.
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


def stencil_cg_eligible(ksp_type, pc, operator) -> bool:
    """The CG fast-path gate of the JAX ``build_ksp_program``: CG, PC
    none/jacobi/mg, an operator with the fused matvec-dot and a uniform
    diagonal, and a Jacobi or mg PC built from that same operator."""
    return (ksp_type == "cg"
            and pc.get_type() in ("none", "jacobi", "mg")
            and hasattr(operator, "local_matvec_dot")
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
