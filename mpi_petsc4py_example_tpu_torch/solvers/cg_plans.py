"""The classic CG recurrence, assembled from an operator plan and a PC plan.

The port's counterpart of the unguarded, uniform-precision part of
``mpi_petsc4py_example_tpu/solvers/cg_plans.py``: ``classic_cg_loop`` (``:326``)
with ``_dmax``/``_tol``/``_reason`` (``:108-139``) and the batching plan
``ManyBatch`` (``:236-257``; one RHS needs no plan). Two plan routes:

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

With :class:`ManyBatch` the loop runs ``k`` independent recurrences in
lockstep on a block of ``k`` columns (``KSP.solve_many``). Per-column scalars
are ``(k,)`` tensors, and the continue mask is computed on the device from
them; the host reads ONE small stacked tensor per iteration (per-column
``rn``, the mask and the breakdown flags) and loops while any column is
active. A frozen column keeps its state through ``torch.where`` selects,
never through a multiply by a zero gate, so inf/NaN in one column cannot
reach another. While every column is active the selects would pick the new
state everywhere, so the updates then run in place; once a column has frozen
each update is computed into a scratch block and selected into the carry.
Either way an active column's arithmetic is the single-RHS loop's, op for op.
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


class ManyBatch:
    """``k`` lockstep recurrences on a column block: per-column ``(k,)``
    scalars, broadcast against the block by :meth:`ex`.

    ``layout='slabs'`` is the grid-shaped stencil block ``(size, k, lz, ny,
    nx)`` (``s[:, None, None, None]``); ``layout='cols'`` the flat block
    ``(size, k, lsize)`` (``s[:, None]``).
    """

    def __init__(self, layout: str = "cols"):
        if layout not in ("cols", "slabs"):
            raise ValueError(f"unknown ManyBatch layout {layout!r}")
        self._slabs = layout == "slabs"

    def ex(self, s):
        return s[:, None, None, None] if self._slabs else s[:, None]


def _live(rn, tol, dmax, it, maxit, brk):
    """The per-column continue mask (``active()``), on the device."""
    return (rn > tol) & (rn < dmax) & (it < maxit) & ~brk


def classic_cg_loop(*, b, x0, rtol, atol, maxit, dtol=None, A=None, M=None,
                    Adot=None, inv_diag=None, M3=None, pdot=None, pnorm=None,
                    bp=None):
    """Run the classic (two-phase) CG recurrence on shard-stacked tensors.

    The operator plan is ``A`` (with ``M``) or the fused ``Adot`` (with the
    scalar ``inv_diag``, or with ``M3`` when it is given); ``pdot``/``pnorm``
    are the psum-reduced inner product and norm. ``M3`` adds device work but
    no host read: the loop still reads the host once per iteration. ``bp``
    is the batching plan: None for one RHS, or :class:`ManyBatch`. Returns
    ``(x, iterations, rnorm, reason, host_syncs)``: with one RHS
    ``rnorm`` is a float, with :class:`ManyBatch` the middle three are
    per-column lists (``pdot``/``pnorm`` then return ``(k,)`` tensors and
    ``M3`` is not taken). ``x`` is ``x0``, updated in place (the JAX program
    donates ``x0`` the same way).
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
    if bp is not None:
        return _lockstep(bp, x, r, p, rz, rnorm, tol, dmax, atol_h, maxit,
                         A=A, M=M, Adot=Adot, inv_diag=inv_diag, pdot=pdot,
                         pnorm=pnorm)
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


def _lockstep(bp, x, r, p, rz, rn, tol, dmax, atol_h, maxit, *, A, M, Adot,
              inv_diag, pdot, pnorm):
    """The :class:`ManyBatch` loop of :func:`classic_cg_loop`, from the
    initialized per-column state (JAX ``classic_cg_loop`` under
    ``ManyBatch``, ``:426-503``)."""
    stencil = Adot is not None
    dt = rn.dtype
    it = torch.zeros(rn.shape, dtype=torch.int64, device=rn.device)
    brk = torch.zeros(rn.shape, dtype=torch.bool, device=rn.device)
    cont = _live(rn, tol, dmax, it, maxit, brk)
    rn_h, tol_h, dmax_h, cont_h = torch.stack(
        [rn, tol, dmax, cont.to(dt)]).tolist()
    syncs = 1
    k = len(rn_h)
    it_h, brk_h = [0] * k, [0.0] * k
    scratch = None

    while any(cont_h):
        masked = not all(cont_h)
        if masked and scratch is None:
            scratch = torch.empty_like(x)
        cm = bp.ex(cont)

        def update(dst, compute):
            # ``compute(out)`` writes the new state of every column to out
            if masked:
                torch.where(cm, compute(scratch), dst, out=dst)
            else:
                compute(dst)

        # ---- operator apply + reduction phase 1 ----
        if stencil:
            Ap, pAp = Adot(p)
        else:
            Ap = A(p)
            pAp = pdot(p, Ap)
        brk |= cont & (pAp == 0)
        al = bp.ex(_safe_div(rz, pAp))
        update(x, lambda o: torch.addcmul(x, al, p, out=o))
        update(r, lambda o: torch.addcmul(r, al, Ap, value=-1, out=o))
        # ---- PC apply + reduction phase 2 ----
        if stencil:
            rr = pdot(r, r)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = bp.ex(_safe_div(rz_new, rz))
            update(p, lambda o: torch.mul(p, beta, out=o).add_(
                r, alpha=inv_diag))
        else:
            z = M(r)
            rz_new = pdot(r, z)
            rn_new = pnorm(r)
            beta = bp.ex(_safe_div(rz_new, rz))
            update(p, lambda o: torch.mul(p, beta, out=o).add_(z))
        rz = torch.where(cont, rz_new, rz)
        rn = torch.where(cont, rn_new, rn)
        it += cont
        it_h = [i + int(c) for i, c in zip(it_h, cont_h)]
        cont = _live(rn, tol, dmax, it, maxit, brk)
        # the one host read of the iteration
        rn_h, cont_h, brk_h = torch.stack(
            [rn, cont.to(dt), brk.to(dt)]).tolist()
        syncs += 1
    reasons = [_reason(rn_h[j], tol_h[j], atol_h, brk_h[j], dmax_h[j])
               for j in range(k)]
    return x, it_h, rn_h, reasons, syncs
