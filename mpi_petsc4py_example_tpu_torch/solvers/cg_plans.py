"""The classic CG recurrence, assembled from an operator plan and a PC plan.

The port's counterpart of the unguarded, single-RHS, uniform-precision part of
``mpi_petsc4py_example_tpu/solvers/cg_plans.py``: ``classic_cg_loop`` (``:326``)
with ``_dmax``/``_tol``/``_reason`` (``:108-139``). Two plan routes:

* the general route: an operator apply ``A`` and a preconditioner apply ``M``
  (``z = M r`` materialized, ``rz = <r, z>``);
* the stencil route: the fused ``Adot(p) -> (A p, <p, A p>)`` with one of two
  PC plans: the uniform inverse diagonal ``inv_diag`` (the Jacobi apply
  collapses to ``z = r * inv_diag`` and ``rz = inv_diag * ||r||^2``; no ``z``
  vector exists), or ``M3``, a grid-shaped preconditioner apply (the V-cycle
  of PC ``mg``): ``z = M3(r)``, ``rz = <r, z>`` (the JAX ``M3`` route,
  ``:374-380, :471-476``).

The JAX body runs as one ``lax.while_loop`` on the device. Here the loop is
eager PyTorch driven by the host: the scalars stay on the device, and the host
reads ONE small stacked tensor per iteration, ``(rn, pAp)``, to evaluate the
loop condition (plus one read of ``(bnorm, rnorm0, tol, dmax)`` at set-up).
``active()`` keeps the JAX semantics exactly: ``rn > tol``, ``rn < dmax``,
``it < maxit`` and no breakdown (``pAp == 0``). Because a step runs only when
``active()`` holds, the JAX body's per-step selects (a frozen step keeps its old
state rather than multiplying by a zero gate) always pick the new state here.
"""

from __future__ import annotations

import math

import torch

from ..utils.convergence import ConvergedReason as CR


def _dmax(rnorm0, dtol):
    """Divergence ceiling ``dtol * rnorm0`` (the INITIAL residual norm, as in
    PETSc's DIVERGED_DTOL test); ``dtol`` None or <= 0 disables it."""
    if dtol is None or dtol <= 0:
        return torch.full_like(rnorm0, math.inf)
    return dtol * rnorm0


def _tol(pnorm, b, rtol, atol):
    bnorm = pnorm(b)
    return bnorm, torch.clamp_min(rtol * bnorm, atol)


def _reason(rnorm, tol, atol, brk, dmax):
    """The exit code for host scalars (``cg_plans._reason`` of the JAX
    package, evaluated once after the loop)."""
    if brk:
        return CR.DIVERGED_BREAKDOWN
    if rnorm <= tol:
        return CR.CONVERGED_ATOL if rnorm <= atol else CR.CONVERGED_RTOL
    return CR.DIVERGED_DTOL if rnorm >= dmax else CR.DIVERGED_MAX_IT


def _safe_div(num, den):
    """``num / den``, and 0 where ``den == 0`` (no division by zero)."""
    zero = den == 0
    return torch.where(zero, 0.0, num / torch.where(zero, 1.0, den))


def classic_cg_loop(*, b, x0, rtol, atol, maxit, dtol=None, A=None, M=None,
                    Adot=None, inv_diag=None, M3=None, pdot=None, pnorm=None):
    """Run the classic (two-phase) CG recurrence on shard-stacked tensors.

    The operator plan is ``A`` (with ``M``) or the fused ``Adot`` (with the
    scalar ``inv_diag``, or with ``M3`` when it is given); ``pdot``/``pnorm``
    are the psum-reduced inner product and norm. ``M3`` adds device work but
    no host read: the loop still reads the host once per iteration. Returns
    ``(x, iterations, rnorm, reason, host_syncs)`` with ``rnorm`` a float;
    ``x`` is ``x0``, updated in place (the JAX program donates ``x0`` the
    same way).
    """
    stencil = Adot is not None
    x = x0
    # ---- init: initial residual + the plan's init reductions ----------------
    if stencil:
        bnorm = pnorm(b)
        r = b - Adot(x)[0]
        rr0 = pdot(r, r)
        rnorm = torch.sqrt(rr0)
        if M3 is None:
            rz = rr0 * inv_diag
            p = r * inv_diag
        else:
            p = M3(r)                # a new tensor, owned by the loop
            rz = pdot(r, p)
        tol = torch.clamp_min(rtol * bnorm, atol)
    else:
        r = b - A(x)
        p = M(r).clone()            # M may return r itself (PC none)
        rz = pdot(r, p)
        bnorm, tol = _tol(pnorm, b, rtol, atol)
        rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    # the tolerances compare in the operator's dtype, as on the device
    atol_h = torch.tensor(atol, dtype=b.dtype).item()
    rn, tol_h, dmax_h = torch.stack([rnorm, tol, dmax]).tolist()
    syncs = 1
    it, brk = 0, False

    def active():
        return rn > tol_h and rn < dmax_h and it < maxit and not brk

    while active():
        # ---- operator apply + reduction phase 1 ----
        if stencil:
            Ap, pAp = Adot(p)                  # fused matvec + dot
        else:
            Ap = A(p)
            pAp = pdot(p, Ap)
        alpha = _safe_div(rz, pAp)
        x.addcmul_(alpha, p)
        r.addcmul_(alpha, Ap, value=-1)
        # ---- PC apply + reduction phase 2 ----
        if stencil and M3 is not None:
            rr = pdot(r, r)
            z = M3(r)
            rz_new = pdot(r, z)
            rn_new = torch.sqrt(rr)
            beta = _safe_div(rz_new, rz)
            p.mul_(beta).add_(z)                      # p = z + beta p
        elif stencil:
            rr = pdot(r, r)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = _safe_div(rz_new, rz)
            p.mul_(beta).add_(r, alpha=inv_diag)      # p = r/d + beta p
        else:
            z = M(r)
            rz_new = pdot(r, z)
            rn_new = pnorm(r)
            beta = _safe_div(rz_new, rz)
            p.mul_(beta).add_(z)
        rz = rz_new
        it += 1
        # the one host read of the iteration: the loop condition's scalars
        rn, pAp_h = torch.stack([rn_new, pAp]).tolist()
        syncs += 1
        brk = brk or pAp_h == 0
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs
