"""The classic CG recurrence, assembled from an operator plan and a PC plan.

The port's counterpart of the unguarded part of
``mpi_petsc4py_example_tpu/solvers/cg_plans.py``: ``classic_cg_loop`` (``:326``)
with ``_dmax``/``_tol``/``_reason`` (``:108-139``), the batching plan
``ManyBatch`` (``:236-257``; one RHS needs no plan) and the precision plan
``PrecisionPlan``/``precision_plan``/``_stc`` (``:48-100``). Two plan
routes:

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

With a mixed :class:`PrecisionPlan` (bfloat16 storage, fp32 reduce) the
vector carries x/r/p/z stay bfloat16, the reductions lift their operands to
fp32 (the program builder's ``pdot``/``pnorm``), and alpha/beta/rz and the
norms stay fp32. Every update that mixes in an fp32 scalar is computed in
fp32 and rounded once to bfloat16 (JAX ``st_(x + al * p)``, ``:367``,
``:376``, ``:459-460``, ``:469``, ``:480``, ``:497``); eager PyTorch would
round ``al * p`` to bfloat16 before the add. Uniform plans run the loop
exactly as before.
"""

from __future__ import annotations

import math

import torch

from ..parallel.mesh import torch_dtype
from ..utils.convergence import ConvergedReason as CR
from ..utils.dtypes import reduce_dtype


class PrecisionPlan:
    """The precision axis of a plan: ``storage`` is the operator/PC/iterate
    dtype, ``reduce`` the dot-product and norm dtype. With ``storage ==
    reduce`` (fp32/fp64) both hooks are identities; the mixed plan
    (bfloat16 storage, fp32 reduce) rounds each vector update to storage
    (:meth:`store`) and lifts reduction operands (:meth:`up`)."""

    def __init__(self, storage, reduce=None):
        self.storage = torch_dtype(storage)
        self.reduce = (torch_dtype(reduce) if reduce is not None
                       else reduce_dtype(self.storage))
        self.mixed = self.reduce != self.storage

    def store(self, v):
        """``v`` in the storage dtype (identity for uniform plans)."""
        return v.to(self.storage) if self.mixed else v

    def up(self, v):
        """``v`` in the reduce dtype (identity for uniform plans)."""
        return v.to(self.reduce) if self.mixed else v

    def key(self):
        """The ``(storage, reduce)`` fingerprint, with the JAX package's
        dtype names."""
        return tuple(str(d).removeprefix("torch.")
                     for d in (self.storage, self.reduce))

    def __repr__(self):
        return "PrecisionPlan(storage={}, reduce={})".format(*self.key())


def precision_plan(storage, reduce=None) -> PrecisionPlan:
    """The precision plan for an operator's storage dtype (the reduce dtype
    defaults to ``utils.dtypes.reduce_dtype``: fp32 for bfloat16, the
    storage dtype otherwise)."""
    return PrecisionPlan(storage, reduce)


def _stc(prec):
    """The store-channel cast of a plan (identity without a mixed one)."""
    if prec is not None and prec.mixed:
        return prec.store
    return lambda v: v


def _lifted_axpy(y, a, v, out=None):
    """``out = store(up(y) + a * up(v))`` for a reduce-dtype scalar (or
    broadcast column of scalars) ``a``: the product and the sum in the
    reduce dtype, one rounding to ``y``'s storage dtype; ``out`` defaults
    to ``y`` (in place). Three passes: lift ``v``, one fp32 ``addcmul``
    reading ``y`` where it lies, round."""
    t = v.to(a.dtype, copy=True)
    torch.addcmul(y, t, a, out=t)
    return (y if out is None else out).copy_(t)


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


def _nat(rz):
    """KSP_NORM_NATURAL: ``sqrt <r, M r>``, the scalar the recurrence
    carries (JAX ``cg_plans._nat``)."""
    return torch.sqrt(torch.clamp_min(rz, 0.0))


def classic_cg_loop(*, b, x0, rtol, atol, maxit, dtol=None, A=None, M=None,
                    Adot=None, inv_diag=None, M3=None, pdot=None, pnorm=None,
                    bp=None, prec=None, monitor=None, natural=False):
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
    donates ``x0`` the same way). ``prec`` is the :class:`PrecisionPlan`
    (None: uniform); under a mixed plan ``pdot``/``pnorm`` must lift their
    operands to its reduce dtype, and ``M3`` is not taken (PC mg raises on
    bfloat16 storage).

    ``monitor`` is called on the host with each residual norm the loop
    reads anyway, in order: ``monitor(it, rn)`` for iterations ``0..it``
    with one RHS, ``monitor(j, it_j, rn_j)`` for each column that took the
    step with :class:`ManyBatch`; it adds no host read. ``natural`` (the
    general route only) monitors ``sqrt <r, M r>`` instead of ``||r||``,
    with the tolerance relative to its initial value and a negative
    ``<r, M r>`` a breakdown (JAX ``:394-403``, ``:494-500``).
    """
    stencil = Adot is not None
    mixed = prec is not None and prec.mixed
    st_ = _stc(prec)
    x = x0
    # ---- init: initial residual + the plan's init reductions ----------------
    if stencil:
        bnorm = pnorm(b)
        r = b - Adot(x)[0]
        rr0 = pdot(r, r)
        rnorm = torch.sqrt(rr0)
        if M3 is None:
            rz = rr0 * inv_diag
            p = st_(prec.up(r) * inv_diag) if mixed else r * inv_diag
        else:
            p = M3(r)                # a new tensor, owned by the loop
            rz = pdot(r, p)
        tol = torch.clamp_min(rtol * bnorm, atol)
    else:
        r = b - A(x)
        p = M(r).clone()            # M may return r itself (PC none)
        rz = pdot(r, p)
        if natural:
            rnorm = _nat(rz)
            tol = torch.clamp_min(rtol * rnorm, atol)
        else:
            bnorm, tol = _tol(pnorm, b, rtol, atol)
            rnorm = pnorm(r)
    dmax = _dmax(rnorm, dtol)
    # the tolerances compare in the norms' dtype, as on the device (the
    # operator's, or the reduce dtype under a mixed plan)
    atol_h = torch.tensor(atol, dtype=rnorm.dtype).item()
    if bp is not None:
        return _lockstep(bp, x, r, p, rz, rnorm, tol, dmax, atol_h, maxit,
                         A=A, M=M, Adot=Adot, inv_diag=inv_diag, pdot=pdot,
                         pnorm=pnorm, prec=prec if mixed else None,
                         monitor=monitor)
    rn, tol_h, dmax_h, rz_h = torch.stack(
        [rnorm, tol, dmax, rz.to(rnorm.dtype)]).tolist()
    syncs = 1
    # a negative <r, M r> leaves the natural norm undefined: breakdown
    it, brk = 0, natural and rz_h < 0
    if monitor is not None:
        monitor(0, rn)

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
        if mixed:
            _lifted_axpy(x, alpha, p)
            _lifted_axpy(r, -alpha, Ap)
        else:
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
        elif stencil and mixed:
            r32 = prec.up(r)                          # lifted once
            rr = pdot(r32, r32)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = _safe_div(rz_new, rz)
            # z = r/d, rounded to storage, then p = z + beta p
            _lifted_axpy(st_(r32.mul_(inv_diag)), beta, p, out=p)
        elif stencil:
            rr = pdot(r, r)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = _safe_div(rz_new, rz)
            p.mul_(beta).add_(r, alpha=inv_diag)      # p = r/d + beta p
        else:
            z = M(r)
            rz_new = pdot(r, z)
            rn_new = _nat(rz_new) if natural else pnorm(r)
            beta = _safe_div(rz_new, rz)
            if mixed:
                _lifted_axpy(z, beta, p, out=p)
            else:
                p.mul_(beta).add_(z)
        rz = rz_new
        it += 1
        # the one host read of the iteration: the loop condition's scalars
        rn, pAp_h, rz_h = torch.stack(
            [rn_new, pAp, rz.to(rn_new.dtype)]).tolist()
        syncs += 1
        brk = brk or pAp_h == 0 or (natural and rz_h < 0)
        if monitor is not None:
            monitor(it, rn)
    return x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs


def _lockstep(bp, x, r, p, rz, rn, tol, dmax, atol_h, maxit, *, A, M, Adot,
              inv_diag, pdot, pnorm, prec=None, monitor=None):
    """The :class:`ManyBatch` loop of :func:`classic_cg_loop`, from the
    initialized per-column state (JAX ``classic_cg_loop`` under
    ``ManyBatch``, ``:426-503``); ``prec`` is a mixed plan or None."""
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
    if monitor is not None:
        for j in range(k):
            monitor(j, 0, rn_h[j])

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
        if prec is not None:
            update(x, lambda o: _lifted_axpy(x, al, p, out=o))
            update(r, lambda o: _lifted_axpy(r, -al, Ap, out=o))
        else:
            update(x, lambda o: torch.addcmul(x, al, p, out=o))
            update(r, lambda o: torch.addcmul(r, al, Ap, value=-1, out=o))
        # ---- PC apply + reduction phase 2 ----
        if stencil:
            r32 = r if prec is None else prec.up(r)   # lifted once
            rr = pdot(r32, r32)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = bp.ex(_safe_div(rz_new, rz))
            if prec is not None:              # z = r/d, rounded
                z = prec.store(r32.mul_(inv_diag))
                update(p, lambda o: _lifted_axpy(z, beta, p, out=o))
            else:
                update(p, lambda o: torch.mul(p, beta, out=o).add_(
                    r, alpha=inv_diag))
        else:
            z = M(r)
            rz_new = pdot(r, z)
            rn_new = pnorm(r)
            beta = bp.ex(_safe_div(rz_new, rz))
            if prec is not None:
                update(p, lambda o: _lifted_axpy(z, beta, p, out=o))
            else:
                update(p, lambda o: torch.mul(p, beta, out=o).add_(z))
        rz = torch.where(cont, rz_new, rz)
        rn = torch.where(cont, rn_new, rn)
        it += cont
        stepped = cont_h
        it_h = [i + int(c) for i, c in zip(it_h, cont_h)]
        cont = _live(rn, tol, dmax, it, maxit, brk)
        # the one host read of the iteration
        rn_h, cont_h, brk_h = torch.stack(
            [rn, cont.to(dt), brk.to(dt)]).tolist()
        syncs += 1
        if monitor is not None:
            for j in range(k):
                if stepped[j]:
                    monitor(j, it_h[j], rn_h[j])
    reasons = [_reason(rn_h[j], tol_h[j], atol_h, brk_h[j], dmax_h[j])
               for j in range(k)]
    return x, it_h, rn_h, reasons, syncs
