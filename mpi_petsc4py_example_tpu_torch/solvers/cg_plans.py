"""The CG recurrences, assembled from an operator plan and a PC plan.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/cg_plans.py``:
``classic_cg_loop`` (``:326``)
with ``_dmax``/``_tol``/``_reason`` (``:108-139``), the batching plan
``ManyBatch`` (``:236-257``; one RHS needs no plan), the precision plan
``PrecisionPlan``/``precision_plan``/``_stc`` (``:48-100``), and the
single-reduction plans of the end of this module, ``pipelined_cg_loop``
(``:614``) and ``sstep_cg_loop`` (``:854``) with ``_sstep_shift``
(``:840``), each for one RHS and under ``ManyBatch``; their ``guard``
branches are the guarded loops of the second half of the module
(``guarded_cg_loop``, ``guarded_pipelined_loop``, ``guarded_sstep_loop``,
with the SDC codes and ``_det4``, ``:167-215``). The classic loop's two
plan routes:

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

Complex operators run the same loops: the reductions conjugate their first
operand (the program builder's ``pdot``), the norms, tolerances and
every converged-reason comparison stay real (:func:`_re` of a scalar the
recurrence knows is real, JAX ``jnp.real``), and the s-step Gram matrix is
``conj(C) C^T`` (JAX ``:1003-1005``). On real tensors each of these is the
identity, bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.mesh import torch_dtype
from ..utils.convergence import ConvergedReason as CR
from ..utils.dtypes import real_dtype, reduce_dtype


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


def _re(t):
    """The real part of a scalar the recurrence knows to be real (a norm's
    square, ``<r, M r>`` of a Hermitian ``M``), itself for a real tensor
    (JAX ``jnp.real``)."""
    return t.real if t.is_complex() else t


def _zero_flag(t):
    """A real tensor that is 0 exactly where ``t`` is: ``t`` itself when
    real, ``|t|`` when complex (for the host reads of breakdown tests)."""
    return t.abs() if t.is_complex() else t


def _nat(rz):
    """KSP_NORM_NATURAL: ``sqrt <r, M r>``, the scalar the recurrence
    carries (JAX ``cg_plans._nat``)."""
    return torch.sqrt(torch.clamp_min(_re(rz), 0.0))


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
    operands to its reduce dtype, and the ``M3`` route (PC mg) updates the
    bfloat16 carries as the other routes do.

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
        [rnorm, tol, dmax, _re(rz).to(rnorm.dtype)]).tolist()
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
            if mixed:                                 # rounded once
                _lifted_axpy(z, beta, p, out=p)
            else:
                p.mul_(beta).add_(z)                  # p = z + beta p
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
            [rn_new, _zero_flag(pAp).to(rn_new.dtype),
             _re(rz).to(rn_new.dtype)]).tolist()
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


def _mix_axpy(prec, c, v, a, out=None):
    """``store(c + a * v)`` (JAX ``st_(c + a * v)``) into ``out`` (a new
    tensor when None; it may be ``c`` or ``v``): with a mixed plan
    :func:`_lifted_axpy`, otherwise one ``addcmul``. ``a`` is a reduce-dtype
    scalar or a broadcast block of scalars."""
    if out is None:
        out = torch.empty_like(c)
    if prec is not None and prec.mixed:
        return _lifted_axpy(c, a, v, out=out)
    return torch.addcmul(c, v, a, out=out)


def pipelined_cg_loop(*, b, x0, rtol, atol, maxit, dtol=None, A=None, M=None,
                      pnorm=None, fused=None, bp=None, monitor=None,
                      prec=None):
    """The pipelined (single-reduction) CG recurrence of Ghysels and
    Vanroose, unguarded (JAX ``pipelined_cg_loop``, ``:614``; its ``guard``
    branches are :func:`guarded_pipelined_loop`).

    Every inner product of an iteration, ``gamma = <r, u>``, ``delta = <w,
    u>`` and the monitored ``||r||^2``, comes from the current vectors in
    ONE reduction, ``fused(r, u, w) -> (gamma, delta, rr)`` (one ``psum`` of
    a stacked partial per shard); the next applies ``m = M w``, ``n = A m``
    do not wait for it. The state ``S = [w, u, r, x]`` and the directions
    ``V = [z, q, s, p]`` are each one tensor: ``V = [n, m, w, u] + beta V``
    row by row, then ``S += alpha sgn V`` in one pass (``sgn`` subtracts
    from w/u/r and adds to x). The monitored norm lags one iteration, so
    iterations run one higher than classic CG's.

    One host read at set-up, one per iteration (the loop condition's
    ``rn`` and breakdown flag), one at the end for the exact final residual
    ``||b - A x||``, which the result reports while the reason is judged on
    the norm the loop tested. ``x0`` receives the iterate. With
    :class:`ManyBatch` the scalars are per column, a frozen column keeps
    its state through ``torch.where`` selects (JAX ``_lockstep``
    discipline), and the middle three results are per-column lists. A mixed
    :class:`PrecisionPlan` keeps the scalars in its reduce dtype and rounds
    each updated row to storage once."""
    mixed = prec is not None and prec.mixed
    sdt = prec.reduce if mixed else b.dtype
    r = b - A(x0)
    bnorm = pnorm(b)
    tol = torch.clamp_min(rtol * bnorm, atol)
    u = M(r)
    w = A(u)
    rn0 = pnorm(r)
    dmax = _dmax(rn0, dtol)
    atol_h = torch.tensor(atol, dtype=rn0.dtype).item()
    S = torch.stack([w, u, r, x0])      # copies: u may be r itself
    V = torch.zeros_like(S)
    gamma = torch.zeros(rn0.shape, dtype=sdt, device=b.device)
    alpha = torch.zeros_like(gamma)
    sgn = torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=real_dtype(sdt),
                       device=b.device).reshape((4,) + (1,) * b.ndim)
    many = bp is not None
    if many:
        it_t = torch.zeros(rn0.shape, dtype=torch.int64, device=b.device)
        brk_t = torch.zeros(rn0.shape, dtype=torch.bool, device=b.device)
        cont = _live(rn0, tol, dmax, it_t, maxit, brk_t)
        rn_h, tol_h, dmax_h, cont_h = torch.stack(
            [rn0, tol, dmax, cont.to(rn0.dtype)]).tolist()
        k = len(rn_h)
        it_h, brk_h = [0] * k, [0.0] * k
        rn = rn0
        if monitor is not None:
            for j in range(k):
                monitor(j, 0, rn_h[j])
    else:
        rn_h, tol_h, dmax_h = torch.stack([rn0, tol, dmax]).tolist()
        cont_h = [rn_h > tol_h and rn_h < dmax_h and maxit > 0]
        it_h, brk_h = 0, False
        if monitor is not None:
            monitor(0, rn_h)
    syncs = 1

    while any(cont_h):
        masked = many and not all(cont_h)
        w, u, r = S[0], S[1], S[2]
        g_new, delta, rr = fused(r, u, w)
        m = M(w)
        n = A(m)
        first = gamma == 0
        beta = torch.where(first, 0.0, g_new / torch.where(first, 1.0,
                                                            gamma))
        aold = torch.where(alpha == 0, 1.0, alpha)
        denom = torch.where(first, delta, delta - beta * g_new / aold)
        a_new = torch.where(denom == 0, 0.0,
                            g_new / torch.where(denom == 0, 1.0, denom))
        be = bp.ex(beta) if many else beta
        al = bp.ex(a_new) if many else a_new
        if masked:
            cm = bp.ex(cont)
            Vn = torch.stack([_mix_axpy(prec, c, V[i], be)
                              for i, c in enumerate((n, m, w, u))])
            V = torch.where(cm, Vn, V)
            S = torch.where(cm, _mix_axpy(prec, S, V, al * sgn), S)
        else:
            for i, c in enumerate((n, m, w, u)):
                _mix_axpy(prec, c, V[i], be, out=V[i])
            _mix_axpy(prec, S, V, al * sgn, out=S)
        rn_new = torch.sqrt(torch.clamp_min(_re(rr), 0.0))
        if many:
            brk_t = brk_t | (cont & (denom == 0))
            rn = torch.where(cont, rn_new, rn)
            gamma = torch.where(cont, g_new, gamma)
            alpha = torch.where(cont, a_new, alpha)
            it_t = it_t + cont
            stepped = cont_h
            it_h = [i + int(c) for i, c in zip(it_h, cont_h)]
            cont = _live(rn, tol, dmax, it_t, maxit, brk_t)
            rn_h, cont_h, brk_h = torch.stack(
                [rn, cont.to(rn.dtype), brk_t.to(rn.dtype)]).tolist()
            if monitor is not None:
                for j in range(k):
                    if stepped[j]:
                        monitor(j, it_h[j], rn_h[j])
        else:
            gamma, alpha = g_new, a_new
            it_h += 1
            rn_h, brk_n = torch.stack(
                [rn_new, (denom == 0).to(rn_new.dtype)]).tolist()
            brk_h = brk_h or brk_n != 0
            cont_h = [rn_h > tol_h and rn_h < dmax_h and it_h < maxit
                      and not brk_h]
            if monitor is not None:
                monitor(it_h, rn_h)
        syncs += 1
    x = x0.copy_(S[3])
    # the monitored norm lags one iteration: report the exact final residual
    true = pnorm(b - A(x)).tolist()
    syncs += 1
    if many:
        reasons = [_reason(rn_h[j], tol_h[j], atol_h, brk_h[j], dmax_h[j])
                   for j in range(k)]
        return x, it_h, true, reasons, syncs
    return x, it_h, true, _reason(rn_h, tol_h, atol_h, brk_h, dmax_h), syncs


# the s-step plan's coordinate-resolution floor and its rationale: JAX
# cg_plans.py:190-197 (_SSTEP_RR_FLOOR)
_SSTEP_RR_FLOOR = 256.0


def sstep_shift(s: int, m: int) -> np.ndarray:
    """The coordinate shift of ``(MA)`` over the two monomial sub-bases
    (JAX ``_sstep_shift``, ``:840``): column ``i`` of the p-chain maps to
    ``i+1`` (``i < s``), column ``i`` of the z-chain likewise (``i <
    s-1``)."""
    S = np.zeros((m, m))
    for i in range(s):
        S[i + 1, i] = 1.0
    for i in range(s - 1):
        S[s + 2 + i, s + 1 + i] = 1.0
    return S


def _sstep_coefficients(E, s, tol, dmax, maxit, it, rn, cont, brk,
                        monitor=None):
    """The ``s`` CG iterations of one block as coefficient recurrences in
    basis coordinates (JAX ``sstep_cg_loop``, ``:1048-1107``), in numpy on
    the host from the block's Gram matrix ``E (2m+1, 2m+1[, k])``, which
    every process holds (the same bits, so the same answer on every rank).
    Scalars are numpy arrays: 0-d for one RHS, ``(k,)`` per column; a
    column block runs each column's recurrences as one RHS's. Returns
    ``(chat, phat, it, rn, brk)``; ``monitor(j, it, rn)`` hears each step a
    column takes (``j`` None for one RHS)."""
    if E.ndim == 3:
        # each column's block laid out as one RHS's: numpy's products
        # round a strided operand differently
        cols = [_sstep_coefficients(
            np.ascontiguousarray(E[..., j]), s, tol[j], dmax[j], maxit,
            it[j], rn[j], cont[j],
            brk[j], None if monitor is None else
            (lambda _j, i, v, j=j: monitor(j, i, v)))
            for j in range(E.shape[2])]
        return tuple(np.stack(v, axis=-1) for v in zip(*cols))
    m = 2 * s + 1
    dt = E.dtype.type
    rdt = np.real(E[:1, :1]).dtype
    Sm = sstep_shift(s, m).astype(E.dtype)

    def cmat(G, v):
        return G @ v

    def cdot(u, v):
        return np.sum(np.conj(u) * v, axis=0)

    def onehot(i):
        v = np.zeros(m, E.dtype)
        v[i] = 1
        return v

    G1, G2 = E[0:m, m:2 * m], E[m:2 * m, m:2 * m]
    g0, w0, rr0 = E[0:m, 2 * m], E[m:2 * m, 2 * m], np.real(E[2 * m, 2 * m])
    G1H = np.conj(np.swapaxes(G1, 0, 1))
    zero, one = dt(0), dt(1)

    def rz_of(zh, ch):
        return cdot(g0, zh) - cdot(ch, cmat(G1H, zh))

    phat, zhat, chat = onehot(0), onehot(s + 1), np.zeros(m, E.dtype)
    rz = rz_of(zhat, chat)
    rr0p = np.maximum(rr0, rdt.type(0))
    # the block-start refresh: rr0 is summed directly, not a difference
    rn = np.where(cont, np.sqrt(rr0p), rn).astype(rdt)
    rr_floor = _SSTEP_RR_FLOOR * m * np.finfo(rdt).eps * rr0p
    rn_floor = np.sqrt(rr_floor)
    a = cont & (rn > tol)
    for _ in range(s):
        pAp = cdot(phat, cmat(G1, phat))
        brk_j = a & (pAp == 0)
        brk = brk | brk_j
        a = a & ~brk_j
        alpha = np.where(pAp == 0, zero, rz / np.where(pAp == 0, one, pAp))
        chat = np.where(a, chat + alpha * phat, chat)
        zhat = np.where(a, zhat - alpha * cmat(Sm, phat), zhat)
        rz_new = rz_of(zhat, chat)
        rr_new = (rr0 - rdt.type(2) * np.real(cdot(chat, w0))
                  + np.real(cdot(chat, cmat(G2, chat))))
        floor_hit = rr_new <= rr_floor
        rn_new = np.maximum(np.sqrt(np.maximum(rr_new, rdt.type(0))),
                            rn_floor)
        beta = np.where(rz == 0, zero, rz_new / np.where(rz == 0, one, rz))
        phat = np.where(a, zhat + beta * phat, phat)
        rz = np.where(a, rz_new, rz)
        rn = np.where(a, rn_new, rn)
        it = it + a.astype(it.dtype)
        if monitor is not None and a:
            monitor(None, int(it), float(rn))
        a = a & ~floor_hit & (rn > tol) & (rn < dmax) & (it < maxit)
    return chat, phat, it, rn, brk


def sstep_cg_loop(*, b, x0, rtol, atol, maxit, s, gram, combine, A=None,
                  M=None, pnorm=None, dtol=None, bp=None, monitor=None,
                  prec=None):
    """s-step (communication-avoiding) CG, unguarded (JAX ``sstep_cg_loop``,
    ``:854``; its ``guard`` branches are :func:`guarded_sstep_loop`).

    Each block advances CG by ``s`` iterations around ONE reduction: from
    the carried ``(p, r)`` it builds the preconditioned monomial chains
    ``[p, (MA)p, ..., (MA)^s p]`` and ``[z, ..., (MA)^(s-1) z]`` (``z = M
    r``) and their A-images (``2s-1`` operator and ``2s`` PC applies, no
    reduction), stores them with ``r`` as the rows of ``C (size, 2m+1,
    ...)`` (``m = 2s+1``), and ``gram(C)`` reduces the Gram matrix of the
    rows in one ``psum`` of a stacked partial per shard. The host reads it
    (the block's one read), runs the ``s`` iterations as coefficient
    recurrences (:func:`_sstep_coefficients`), and three basis combinations
    ``combine(coef, rows)`` materialize ``(x, r, p)`` on the device.

    Host reads: one at set-up, one per block, one for the exact final
    residual the result reports (the reason is judged on the recurrence
    norm). With :class:`ManyBatch` every column has its own basis and
    coefficients, the one Gram reduction serves them all, and a frozen
    column keeps its state."""
    st_ = _stc(prec)
    mixed = prec is not None and prec.mixed
    up = prec.up if mixed else (lambda v: v)
    s = int(s)
    if s < 1:
        raise ValueError(f"-ksp_sstep_s must be >= 1, got {s}")
    m = 2 * s + 1
    many = bp is not None
    r = b - A(x0)
    bnorm = pnorm(b)
    tol = torch.clamp_min(rtol * bnorm, atol)
    rn0 = pnorm(r)
    p = M(r)
    dmax = _dmax(rn0, dtol)
    atol_h = torch.tensor(atol, dtype=rn0.dtype).item()
    rn_h, tol_h, dmax_h = (np.asarray(v) for v in torch.stack(
        [rn0, tol, dmax]).cpu().numpy())
    syncs = 1
    it = np.zeros(rn_h.shape, np.int64)
    brk = np.zeros(rn_h.shape, bool)
    # monitor(j, it, rn) for a column block, monitor(it, rn) for one RHS
    mon = None
    if monitor is not None:
        mon = monitor if many else (lambda _j, i, v: monitor(i, v))
        for j, v in enumerate(np.atleast_1d(rn_h)):
            mon(j, 0, float(v))
    x = x0
    # the basis rows and r, shard-major: C[:, :m] = V_Z, C[:, m:2m] = A V_Z
    C = b.new_zeros((b.shape[0], 2 * m + 1) + tuple(b.shape[1:]))

    def active():
        return (rn_h > tol_h) & (rn_h < dmax_h) & (it < maxit) & ~brk

    cont = active()
    while cont.any():
        C[:, 0] = p
        for i in range(s):                  # p-chain and its A-images
            t = A(C[:, i])
            C[:, m + i] = t
            C[:, i + 1] = st_(M(t))
        C[:, s + 1] = st_(M(r))             # z-chain and its A-images
        for i in range(s - 1):
            t = A(C[:, s + 1 + i])
            C[:, m + s + 1 + i] = t
            C[:, s + 2 + i] = st_(M(t))
        C[:, 2 * m] = r
        E = gram(up(C)).cpu().numpy()
        syncs += 1
        chat, phat, it, rn_h, brk = _sstep_coefficients(
            E, s, tol_h, dmax_h, maxit, it, rn_h, cont, brk, mon)
        ch = torch.from_numpy(chat).to(C.device)
        ph = torch.from_numpy(phat).to(C.device)
        x_new = st_(up(x) + combine(ch, up(C[:, :m])))
        r_new = st_(up(r) - combine(ch, up(C[:, m:2 * m])))
        p_new = st_(combine(ph, up(C[:, :m])))
        if many and not cont.all():
            cm = bp.ex(torch.from_numpy(cont).to(C.device))
            x_new = torch.where(cm, x_new, x)
            r_new = torch.where(cm, r_new, r)
            p_new = torch.where(cm, p_new, p)
        x, r, p = x_new, r_new, p_new
        cont = active()
    true = pnorm(b - A(x)).tolist()
    syncs += 1
    if many:
        reasons = [_reason(float(rn_h[j]), float(tol_h[j]), atol_h,
                           bool(brk[j]), float(dmax_h[j]))
                   for j in range(len(rn_h))]
        return x, [int(v) for v in it], true, reasons, syncs
    return (x, int(it), true,
            _reason(float(rn_h), float(tol_h), atol_h, bool(brk),
                    float(dmax_h)), syncs)


# ---- the silent-corruption guard (JAX cg_plans.py:165-215) ------------------
#
# The guarded loops below are the ``guard`` branches of the JAX
# classic/pipelined/s-step plans (``:509-595``, ``:774-805``, ``:1120-1200``).
# A guard bundle ``g`` (built by ``solvers/krylov.py``) folds the ABFT
# partials into the reductions the loop already makes and supplies the
# replacement's plain-reduction verifier; the loops add the NaN and
# monotonicity sentinels, the periodic true-residual replacement with its
# drift gate, and the rollback target ``xv``, the last verified iterate.
# Every loop returns ``(x, it, rnorm, reason, host_syncs, det, rrc, xv)``:
# ``det`` the first detector code (per column under :class:`ManyBatch`),
# ``rrc`` the replacements that passed.

(SDC_NONE, SDC_ABFT, SDC_ABFT_PC, SDC_DRIFT, SDC_NAN, SDC_MONO,
 SDC_DEMOTE) = range(7)
SDC_DETECTOR_NAMES = {SDC_ABFT: "abft", SDC_ABFT_PC: "abft_pc",
                      SDC_DRIFT: "drift", SDC_NAN: "nan",
                      SDC_MONO: "monotonic",
                      # not a corruption: the s-step drift gate spent its
                      # basis-restart budget; the host demotes to classic CG
                      SDC_DEMOTE: "sstep_demote"}

# a residual norm this far above the best seen is beyond any healthy CG
# transient (bounded by sqrt(cond(A)))
_SDC_MONO_FACTOR = 1e4
# drift gate: recurrence-vs-true relative mismatch beyond this fraction, plus
# a rounding floor of _SDC_DRIFT_FLOOR_EPS * eps * ||b||, flags SDC
_SDC_DRIFT_REL = 0.25
_SDC_DRIFT_FLOOR_EPS = 1024.0
# s-step stagnation gate: a replacement check that finds less than this
# reduction of the TRUE residual since the last one declares the basis
# ineffective at this s
_SSTEP_STALL_FACTOR = 0.9


def _det4_host(badA, badM, badnan, badmono) -> int:
    """First-detector-wins code of one recurrence (JAX ``_det4``)."""
    if badA:
        return SDC_ABFT
    if badM:
        return SDC_ABFT_PC
    if badnan:
        return SDC_NAN
    if badmono:
        return SDC_MONO
    return SDC_NONE


def _det4(badA, badM, badnan, badmono):
    """:func:`_det4_host` per column, on bool tensors (or numpy arrays)."""
    lib = torch if isinstance(badnan, torch.Tensor) else np
    code = lib.where(badmono, SDC_MONO, SDC_NONE)
    code = lib.where(badnan, SDC_NAN, code)
    code = lib.where(badM, SDC_ABFT_PC, code)
    return lib.where(badA, SDC_ABFT, code)


def _flags(*vals):
    """One host read of scalars and flags (tensors, or None for a check
    that does not exist, read as 0)."""
    ts = [v for v in vals if isinstance(v, torch.Tensor)]
    dt = _re(ts[0]).dtype
    stacked = torch.stack([
        (_re(v).to(dt).reshape(()) if isinstance(v, torch.Tensor)
         else torch.tensor(0.0 if v is None else float(v), dtype=dt,
                           device=ts[0].device)) for v in vals])
    return stacked.tolist()


def _read_step(rn, pAp, chkA, chkM, te):
    """The one host read of a guarded classic step: ``rn``, the breakdown
    flag and the two ABFT verdicts, judged on the host from the phases'
    check sums (:func:`_bad4`). Complex check sums are judged on the
    device."""
    rows = [rn.reshape(1), _zero_flag(pAp).to(rn.dtype).reshape(1)]
    for chk in (chkA, chkM):
        if chk is None:
            continue
        if chk.is_complex():
            rows.append(_bad4(chk, te).to(rn.dtype).reshape(1))
        else:
            rows.append(chk.to(rn.dtype))
    vals = torch.cat(rows).tolist()
    rn_h, pz = vals[0], vals[1]
    flags, i = [], 2
    for chk in (chkA, chkM):
        if chk is None:
            flags.append(False)
        elif chk.is_complex():
            flags.append(vals[i] != 0)
            i += 1
        else:
            a, c, sa, sc = vals[i:i + 4]
            flags.append(abs(a - c) > te * (sa + sc))
            i += 4
    return rn_h, pz, flags[0], flags[1]


def _bad4(chk, te):
    """The device verdict of a phase's check sums ``chk = [Σ y, <c, x>,
    Σ|y|, Σ|c x|]`` (a row each; per column under a block): ``|Σ y -
    <c, x>| > tol eps (Σ|y| + Σ|c x|)``, ``te`` being ``tol eps``."""
    return torch.abs(chk[0] - chk[1]) > te * (_re(chk[2]) + _re(chk[3]))


def guarded_cg_loop(*, b, x0, rtol, atol, maxit, g, dtol=None, A=None,
                    M=None, Adot=None, inv_diag=None, bp=None, prec=None,
                    monitor=None):
    """The classic CG recurrence with the silent-corruption guard (JAX
    ``classic_cg_loop`` with ``guard``, ``:326-611``).

    Routes: the general one (``A``, ``M``; the guard's ``g.p1`` stacks the
    operator ABFT partials with ``<p, A p>``, ``g.p2`` the PC's with ``<r,
    z>`` and ``||r||^2``), and the stencil one (``Adot`` with the scalar
    ``inv_diag``: the fused kernel's ``<p, A p>`` stays its own, and
    ``g.p2_stencil`` stacks the operator partials with ``||r||^2``), for one
    RHS; a :class:`ManyBatch` block takes the general route with per-column
    detection (JAX ``cg_kernel_many_guarded``). The arithmetic of a clean
    step is :func:`classic_cg_loop`'s. Every ``g.rr_n`` iterations a clean,
    unconverged recurrence replaces its residual with the true ``b - A x``
    (``g.A_rr``, ``g.M_rr``; verified by a plain reduction), restarts its
    direction, and promotes ``x`` to the verified iterate; a recurrence
    norm more than 25% off the true one is a ``drift`` detection."""
    if bp is not None:
        return _guarded_cg_many(bp, b=b, x0=x0, rtol=rtol, atol=atol,
                                maxit=maxit, g=g, dtol=dtol, A=A, M=M,
                                prec=prec, monitor=monitor)
    stencil = Adot is not None
    mixed = prec is not None and prec.mixed
    st_ = _stc(prec)
    x = x0
    xv = x0.clone()
    if stencil:
        r = b - Adot(x)[0]
        bnorm, rr0, badA0 = g.init(b, r, x)
        rnorm = torch.sqrt(rr0)
        rz = rr0 * inv_diag
        p = st_(prec.up(r) * inv_diag) if mixed else r * inv_diag
        badM0 = None
    else:
        r = b - A(x)
        bnorm, badA0 = g.init(b, r, x)
        z = M(r)
        rz, rn2, chkM0 = g.p2(r, z)
        badM0 = None if chkM0 is None else _bad4(chkM0, g.te)
        rnorm = torch.sqrt(torch.clamp_min(_re(rn2), 0.0))
        p = z.clone()                      # M may return r itself
    tol = torch.clamp_min(rtol * bnorm, atol)
    dmax = _dmax(rnorm, dtol)
    atol_h = torch.tensor(atol, dtype=rnorm.dtype).item()
    rn, tol_h, dmax_h, bn_h, fA, fM = _flags(rnorm, tol, dmax, bnorm,
                                             badA0, badM0)
    syncs = 1
    drift_floor = _SDC_DRIFT_FLOOR_EPS * g.eps * bn_h
    it, brk, rrc, rnb = 0, False, 0, rn
    det = _det4_host(fA, fM, not math.isfinite(rn), False)
    if monitor is not None:
        monitor(0, rn)
    while (rn > tol_h and rn < dmax_h and it < maxit and not brk
           and det == SDC_NONE):
        # ---- operator apply + reduction phase 1 ----
        if stencil:
            Ap, pAp = Adot(p)
            chkA = None
        else:
            Ap = A(p)
            pAp, chkA = g.p1(p, Ap)
        alpha = _safe_div(rz, pAp)
        if mixed:
            _lifted_axpy(x, alpha, p)
            _lifted_axpy(r, -alpha, Ap)
        else:
            x.addcmul_(alpha, p)
            r.addcmul_(alpha, Ap, value=-1)
        # ---- PC apply + reduction phase 2 (with the ABFT partials) ----
        chkM = None
        if stencil:
            rr, chkA = g.p2_stencil(r, p, Ap)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = _safe_div(rz_new, rz)
            if mixed:
                _lifted_axpy(st_(prec.up(r) * inv_diag), beta, p, out=p)
            else:
                p.mul_(beta).add_(r, alpha=inv_diag)
        else:
            z = M(r)
            rz_new, rn2, chkM = g.p2(r, z)
            rn_new = torch.sqrt(torch.clamp_min(_re(rn2), 0.0))
            beta = _safe_div(rz_new, rz)
            if mixed:
                _lifted_axpy(z, beta, p, out=p)
            else:
                p.mul_(beta).add_(z)
        rz = rz_new
        it += 1
        # the one host read of the iteration: the norm and the check sums
        rn, pz, fA, fM = _read_step(rn_new, pAp, chkA, chkM, g.te)
        syncs += 1
        brk = brk or pz == 0
        finite = math.isfinite(rn)
        det = _det4_host(fA, fM, not finite,
                         finite and rn > _SDC_MONO_FACTOR * rnb)
        if finite:
            rnb = min(rnb, rn)
        if (det == SDC_NONE and g.rr_n > 0 and it % g.rr_n == 0
                and rn > tol_h):
            # ---- periodic true-residual replacement + drift gate ----
            rt = b - g.A_rr(x)
            if stencil:
                rtn2 = torch.clamp_min(g.vnorm2(rt), 0.0)
                rzt = None
            else:
                zt = g.M_rr(rt)
                rtn2, rzt = g.vpair(rt, zt)
                rtn2 = torch.clamp_min(rtn2, 0.0)
            rtn_t = torch.sqrt(rtn2)
            rtn = rtn_t.item()
            syncs += 1
            if abs(rtn - rn) > _SDC_DRIFT_REL * (rtn + rn) + drift_floor:
                det = SDC_DRIFT
            else:
                r = rt
                if stencil:
                    p = (st_(prec.up(rt) * inv_diag) if mixed
                         else rt * inv_diag)
                    rz = rtn2 * inv_diag
                else:
                    p = zt.clone()
                    rz = rzt
                rn = rtn
                xv.copy_(x)
                rrc += 1
        if monitor is not None:
            monitor(it, rn)
    return (x, it, rn, _reason(rn, tol_h, atol_h, brk, dmax_h), syncs, det,
            rrc, xv)


def _guarded_cg_many(bp, *, b, x0, rtol, atol, maxit, g, dtol, A, M, prec,
                     monitor):
    """:func:`guarded_cg_loop` on a column block (general route): every
    guard decision per column, a detected column frozen with its code
    (sticky) while the clean ones go on; the replacement (every ``g.rr_n``
    lockstep steps) recomputes the whole block and takes only the active,
    clean columns that pass the drift gate (JAX ``:520-595`` under
    ``ManyBatch``)."""
    dev = b.device
    mixed = prec is not None and prec.mixed
    x, xv = x0, x0.clone()
    r = b - A(x)
    bnorm, badA0 = g.init(b, r, x)
    z = M(r).clone()
    rz, rn2, chkM0 = g.p2(r, z)
    badM0 = None if chkM0 is None else _bad4(chkM0, g.te)
    rn = torch.sqrt(torch.clamp_min(_re(rn2), 0.0))
    p = z.clone()
    tol = torch.clamp_min(rtol * bnorm, atol)
    dmax = _dmax(rn, dtol)
    atol_h = torch.tensor(atol, dtype=rn.dtype).item()
    false = torch.zeros(rn.shape, dtype=torch.bool, device=dev)
    it = torch.zeros(rn.shape, dtype=torch.int64, device=dev)
    brk = false.clone()
    det = _det4(false if badA0 is None else badA0,
                false if badM0 is None else badM0, ~torch.isfinite(rn),
                false)
    rrc = torch.zeros_like(it)
    rnb = rn.clone()
    drift_floor = _SDC_DRIFT_FLOOR_EPS * g.eps * bnorm
    cont = _live(rn, tol, dmax, it, maxit, brk) & (det == SDC_NONE)
    rn_h, tol_h, dmax_h, cont_h = torch.stack(
        [rn, tol, dmax, cont.to(rn.dtype)]).tolist()
    syncs, ks, k = 1, 0, len(rn_h)
    it_h = [0] * k
    if monitor is not None:
        for j in range(k):
            monitor(j, 0, rn_h[j])
    while any(cont_h):
        cm = bp.ex(cont)
        Ap = A(p)
        pAp, chkA = g.p1(p, Ap)
        badA = None if chkA is None else _bad4(chkA, g.te)
        brk = brk | (cont & (pAp == 0))
        al = bp.ex(_safe_div(rz, pAp))
        x = torch.where(cm, _mix_axpy(prec, x, p, al), x)
        r = torch.where(cm, _mix_axpy(prec, r, Ap, -al), r)
        z = torch.where(cm, M(r), z)
        rz_new, rn2, chkM = g.p2(r, z)
        badM = None if chkM is None else _bad4(chkM, g.te)
        rn_new = torch.sqrt(torch.clamp_min(_re(rn2), 0.0))
        beta = bp.ex(_safe_div(rz_new, rz))
        # p = z + beta p, rounded as _lockstep rounds it
        p = torch.where(cm, _mix_axpy(prec, z, p, beta) if mixed
                        else torch.mul(p, beta).add_(z), p)
        rz = torch.where(cont, rz_new, rz)
        rn = torch.where(cont, rn_new, rn)
        it = it + cont
        fin = torch.isfinite(rn)
        badnan = cont & ~fin
        badmono = cont & fin & (rn > _SDC_MONO_FACTOR * rnb)
        rnb = torch.where(cont & fin, torch.minimum(rnb, rn), rnb)
        det = torch.where(det == SDC_NONE,
                          _det4(false if badA is None else cont & badA,
                                false if badM is None else cont & badM,
                                badnan, badmono), det)
        ks += 1
        if g.rr_n > 0 and ks % g.rr_n == 0:
            clean = det == SDC_NONE
            rt = b - g.A_rr(x)
            zt = g.M_rr(rt)
            rtn2, rzt = g.vpair(rt, zt)
            rtn = torch.sqrt(torch.clamp_min(rtn2, 0.0))
            drift = (torch.abs(rtn - rn)
                     > _SDC_DRIFT_REL * (rtn + rn) + drift_floor)
            ok = cont & clean & ~drift
            okm = bp.ex(ok)
            r = torch.where(okm, rt, r)
            z = torch.where(okm, zt, z)
            p = torch.where(okm, zt, p)
            rz = torch.where(ok, rzt, rz)
            rn = torch.where(ok, rtn, rn)
            xv = torch.where(okm, x, xv)
            rrc = rrc + ok
            det = torch.where((det == SDC_NONE) & cont & clean & drift,
                              SDC_DRIFT, det)
        stepped = cont_h
        it_h = [i + int(c) for i, c in zip(it_h, cont_h)]
        cont = _live(rn, tol, dmax, it, maxit, brk) & (det == SDC_NONE)
        rn_h, cont_h = torch.stack([rn, cont.to(rn.dtype)]).tolist()
        syncs += 1
        if monitor is not None:
            for j in range(k):
                if stepped[j]:
                    monitor(j, it_h[j], rn_h[j])
    brk_h, det_h, rrc_h = torch.stack(
        [brk.to(torch.int64), det, rrc]).tolist()
    reasons = [_reason(rn_h[j], tol_h[j], atol_h, brk_h[j], dmax_h[j])
               for j in range(k)]
    return x, it_h, rn_h, reasons, syncs, det_h, rrc_h, xv


def guarded_pipelined_loop(*, b, x0, rtol, atol, maxit, g, dtol=None, A=None,
                           M=None, bp=None, prec=None, monitor=None):
    """Pipelined CG with the guard (JAX ``pipelined_cg_loop`` with ``guard``,
    ``:614-836``), one RHS or a :class:`ManyBatch` block.

    The ONE reduction of an iteration, ``g.fused(r, u, w, chk)``, also sums
    the ABFT partials ``chk`` of the PREVIOUS body's fresh applies ``m = M
    w``, ``n = A m`` (``g.chk_parts``, carried one iteration), so detection
    lags one iteration and the reduction count stays one. The replacement
    refills the whole pipeline from the true residual (``r = b - A x``, ``u
    = M r``, ``w = A u``), zeroes the direction recurrences, and gates drift
    against the CURRENT recurrence residual (``g.vpair2``); the result
    reports the exact final residual through the plain verifier
    (``g.A_final``, ``g.vnorm2``)."""
    mixed = prec is not None and prec.mixed
    sdt = prec.reduce if mixed else b.dtype
    many = bp is not None
    ex = bp.ex if many else (lambda s: s)
    dev = b.device
    r = b - A(x0)
    bnorm, badA0 = g.init(b, r, x0)
    tol = torch.clamp_min(rtol * bnorm, atol)
    u = M(r)
    w = A(u)
    rn = g.pnorm(r)
    dmax = _dmax(rn, dtol)
    atol_h = torch.tensor(atol, dtype=rn.dtype).item()
    S = torch.stack([w, u, r, x0])
    V = torch.zeros_like(S)
    gamma = torch.zeros(rn.shape, dtype=sdt, device=dev)
    alpha = torch.zeros_like(gamma)
    sgn = torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=real_dtype(sdt),
                       device=dev).reshape((4,) + (1,) * b.ndim)
    false = torch.zeros(rn.shape, dtype=torch.bool, device=dev)
    it = torch.zeros(rn.shape, dtype=torch.int64, device=dev)
    brk = false.clone()
    det = _det4(false if badA0 is None else badA0, false,
                ~torch.isfinite(rn), false)
    rrc = torch.zeros_like(it)
    xv = x0.clone()
    rnb = rn.clone()
    drift_floor = _SDC_DRIFT_FLOOR_EPS * g.eps * bnorm
    chk = g.chk_init(r, u, w)
    cont = _live(rn, tol, dmax, it, maxit, brk) & (det == SDC_NONE)
    rn_h, tol_h, dmax_h, cont_h = (np.atleast_1d(v).tolist() for v in
                                   torch.stack([rn, tol, dmax,
                                                cont.to(rn.dtype)]).cpu()
                                   .numpy())
    syncs, ks, k = 1, 0, len(rn_h)
    it_h = [0] * k
    if monitor is not None:
        for j in range(k):
            (monitor(j, 0, rn_h[j]) if many else monitor(0, rn_h[j]))
    while any(cont_h):
        masked = not all(cont_h)
        cm = ex(cont)
        w, u, r = S[0], S[1], S[2]
        g_new, delta, rr, badA, badM = g.fused(r, u, w, chk)
        m = M(w)
        n = A(m)
        chk = g.chk_parts(m, n, w)
        first = gamma == 0
        beta = torch.where(first, 0.0,
                           g_new / torch.where(first, 1.0, gamma))
        aold = torch.where(alpha == 0, 1.0, alpha)
        denom = torch.where(first, delta, delta - beta * g_new / aold)
        a_new = torch.where(denom == 0, 0.0,
                            g_new / torch.where(denom == 0, 1.0, denom))
        be, al = ex(beta), ex(a_new)
        if masked:
            Vn = torch.stack([_mix_axpy(prec, c, V[i], be)
                              for i, c in enumerate((n, m, w, u))])
            V = torch.where(cm, Vn, V)
            S = torch.where(cm, _mix_axpy(prec, S, V, al * sgn), S)
        else:
            for i, c in enumerate((n, m, w, u)):
                _mix_axpy(prec, c, V[i], be, out=V[i])
            _mix_axpy(prec, S, V, al * sgn, out=S)
        rn_new = torch.sqrt(torch.clamp_min(_re(rr), 0.0))
        brk = brk | (cont & (denom == 0))
        rn = torch.where(cont, rn_new, rn)
        gamma = torch.where(cont, g_new, gamma)
        alpha = torch.where(cont, a_new, alpha)
        it = it + cont
        fin = torch.isfinite(rn)
        badnan = cont & ~fin
        badmono = cont & fin & (rn > _SDC_MONO_FACTOR * rnb)
        rnb = torch.where(cont & fin, torch.minimum(rnb, rn), rnb)
        det = torch.where(det == SDC_NONE,
                          _det4(false if badA is None else cont & badA,
                                false if badM is None else cont & badM,
                                badnan, badmono), det)
        ks += 1
        if many:
            want = g.rr_n > 0 and ks % g.rr_n == 0
        else:
            # one RHS: the interval runs on the iteration count, and an
            # unconverged clean recurrence only (JAX :757-758)
            want = g.rr_n > 0 and (it_h[0] + 1) % g.rr_n == 0
        if want:
            clean = det == SDC_NONE
            base = cont & clean if many else clean & (rn > tol)
            x = S[3]
            rt = b - g.A_rr(x)
            ut = g.M_rr(rt)
            wt = g.A_rr2(ut)
            rtn2, rc2 = g.vpair2(rt, S[2])
            rtn = torch.sqrt(torch.clamp_min(rtn2, 0.0))
            rcur = torch.sqrt(torch.clamp_min(rc2, 0.0))
            drift = (torch.abs(rtn - rcur)
                     > _SDC_DRIFT_REL * (rtn + rcur) + drift_floor)
            ok = base & ~drift
            okm = ex(ok)
            S = torch.where(okm, torch.stack([wt, ut, rt, x]), S)
            V = torch.where(okm, 0.0, V)
            gamma = torch.where(ok, 0.0, gamma)
            alpha = torch.where(ok, 0.0, alpha)
            rn = torch.where(ok, rtn, rn)
            xv = torch.where(okm, x, xv)
            rrc = rrc + ok
            det = torch.where((det == SDC_NONE) & base & drift, SDC_DRIFT,
                              det)
        stepped = cont_h
        it_h = [i + int(c) for i, c in zip(it_h, cont_h)]
        cont = _live(rn, tol, dmax, it, maxit, brk) & (det == SDC_NONE)
        rn_h, cont_h = (np.atleast_1d(v).tolist() for v in torch.stack(
            [rn, cont.to(rn.dtype)]).cpu().numpy())
        syncs += 1
        if monitor is not None:
            for j in range(k):
                if stepped[j]:
                    (monitor(j, it_h[j], rn_h[j]) if many
                     else monitor(it_h[j], rn_h[j]))
    x = x0.copy_(S[3])
    # the monitored norm lags one iteration: the exact final residual,
    # through the plain-reduction verifier
    true = torch.sqrt(torch.clamp_min(g.vnorm2(b - g.A_final(x)), 0.0))
    brk_h, det_h, rrc_h = (np.atleast_1d(v).tolist() for v in torch.stack(
        [brk.to(torch.int64), det.to(torch.int64), rrc]).cpu().numpy())
    true_h = np.atleast_1d(true.cpu().numpy()).tolist()
    syncs += 1
    reasons = [_reason(rn_h[j], tol_h[j], atol_h, brk_h[j], dmax_h[j])
               for j in range(k)]
    if many:
        return x, it_h, true_h, reasons, syncs, det_h, rrc_h, xv
    return (x, it_h[0], true_h[0], reasons[0], syncs, det_h[0], rrc_h[0],
            xv)


def _sstep_guard_flags(outs, g, s, m, many):
    """The ABFT verdicts of an s-block from the reduced guard partials
    (numpy arrays, or device tensors in the fused program; JAX
    ``:1024-1050``): ``(badA, badM)``, each None when its checksum is
    absent. Only the chain columns with an A-image are checked; the PC
    channel checks each basis column against the M apply that made it
    (column 0, the carried ``p``, against itself)."""
    dev = isinstance(outs[0], torch.Tensor) if outs else False
    lib = torch if dev else np
    thr = lambda scale: g.abft_tol * g.eps * scale
    w_valid = np.zeros((m,), bool)
    w_valid[0:s] = True
    w_valid[s + 1:2 * s] = True
    vm = w_valid[:, None] if many else w_valid
    if dev:
        vm = torch.from_numpy(vm).to(outs[0].device)
    i = 0
    badA = badM = None
    if g.cs is not None:
        sW, cV, aW, aCV = outs[i:i + 4]
        i += 4
        badA = ((abs(sW - cV) > thr(aW.real + aCV.real)) & vm).any(0)
    if g.csM is not None:
        sV, cW, aV, aCW, cr, acr = outs[i:i + 6]
        exp = lib.concatenate([sV[0:1], cW[0:s], cr[None],
                               cW[s + 1:2 * s]], axis=0)
        aexp = lib.concatenate([aV[0:1], aCW[0:s], acr[None],
                                aCW[s + 1:2 * s]], axis=0)
        badM = (abs(sV - exp) > thr(aV.real + aexp.real)).any(0)
    return badA, badM


def guarded_sstep_loop(*, b, x0, rtol, atol, maxit, s, g, combine, max_repl,
                       A=None, M=None, dtol=None, bp=None, monitor=None,
                       prec=None):
    """s-step CG with the guard (JAX ``sstep_cg_loop`` with ``guard``,
    ``:854-1213``), one RHS or a :class:`ManyBatch` block.

    The basis build's applies are checked through their column sums, folded
    into the block's ONE reduction with the Gram matrix (``g.greduce(C,
    Bw_valid)``), and judged on the host with the coefficients
    (:func:`_sstep_guard_flags`). The sentinels watch the exact block-start
    norm. With a replacement interval (``g.rr_n`` iterations, every
    ``ceil(rr_n / s)`` blocks) the gate compares the TRUE residual with the
    last check's: a stall (less than 10% progress) or a NaN/blow-up of the
    block-start norm restarts the recurrence from the true residual (an
    anomaly first rolls back to the verified iterate), at most ``max_repl``
    times; past that budget the code is ``SDC_DEMOTE`` and the host
    continues with classic CG."""
    st_ = _stc(prec)
    mixed = prec is not None and prec.mixed
    up = prec.up if mixed else (lambda v: v)
    s = int(s)
    if s < 1:
        raise ValueError(f"-ksp_sstep_s must be >= 1, got {s}")
    m = 2 * s + 1
    many = bp is not None
    dev = b.device
    r = b - A(x0)
    bnorm, badA0 = g.init(b, r, x0)
    tol = torch.clamp_min(rtol * bnorm, atol)
    rn0 = g.pnorm(r)
    p = M(r)
    dmax = _dmax(rn0, dtol)
    atol_h = torch.tensor(atol, dtype=rn0.dtype).item()
    rows = [rn0, tol, dmax, bnorm]
    if badA0 is not None:
        rows.append(badA0.to(rn0.dtype))
    host = torch.stack(rows).cpu().numpy()
    rn_h, tol_h, dmax_h, bn_h = (np.asarray(v) for v in host[:4])
    fA0 = host[4] != 0 if badA0 is not None else np.zeros(rn_h.shape, bool)
    syncs = 1
    it = np.zeros(rn_h.shape, np.int64)
    brk = np.zeros(rn_h.shape, bool)
    det = np.asarray(_det4(fA0, np.zeros_like(fA0), ~np.isfinite(rn_h),
                           np.zeros_like(fA0)))
    rrc = np.zeros(rn_h.shape, np.int64)
    drc = np.zeros(rn_h.shape, np.int64)
    rnb = rn_h.copy()
    rn_rr = rn_h.copy()
    gated = g.rr_n > 0
    ungated = not gated
    interval = max((g.rr_n + s - 1) // s, 1)
    ks = 0
    mon = None
    if monitor is not None:
        mon = monitor if many else (lambda _j, i, v: monitor(i, v))
        for j, v in enumerate(np.atleast_1d(rn_h)):
            mon(j, 0, float(v))
    x, xv = x0, x0.clone()
    C = b.new_zeros((b.shape[0], 2 * m + 1) + tuple(b.shape[1:]))

    def active():
        return ((rn_h > tol_h) & (rn_h < dmax_h) & (it < maxit) & ~brk
                & (det == SDC_NONE))

    def dmask(a):
        return bp.ex(torch.from_numpy(np.asarray(a)).to(dev)) if many \
            else bool(a)

    def sel(a, new, old):
        if not many:
            return new if a else old
        return torch.where(dmask(a), new, old)

    cont = active()
    while cont.any():
        C[:, 0] = p
        for i in range(s):                  # p-chain and its A-images
            t = A(C[:, i])
            C[:, m + i] = t
            C[:, i + 1] = st_(M(t))
        C[:, s + 1] = st_(M(r))             # z-chain and its A-images
        for i in range(s - 1):
            t = A(C[:, s + 1 + i])
            C[:, m + s + 1 + i] = t
            C[:, s + 2 + i] = st_(M(t))
        C[:, 2 * m] = r
        E, outs = g.greduce(up(C))
        syncs += 1
        badA, badM = _sstep_guard_flags(outs, g, s, m, many)
        rr0 = np.real(E[2 * m, 2 * m])
        rn_bs = np.where(cont, np.sqrt(np.maximum(rr0, 0.0)), rn_h)
        chat, phat, it, rn_h, brk = _sstep_coefficients(
            E, s, tol_h, dmax_h, maxit, it, rn_h, cont, brk, mon)
        ch = torch.from_numpy(chat).to(dev)
        ph = torch.from_numpy(phat).to(dev)
        x_new = st_(up(x) + combine(ch, up(C[:, :m])))
        r_new = st_(up(r) - combine(ch, up(C[:, m:2 * m])))
        p_new = st_(combine(ph, up(C[:, :m])))
        if many and not cont.all():
            x_new = sel(cont, x_new, x)
            r_new = sel(cont, r_new, r)
            p_new = sel(cont, p_new, p)
        fin = np.isfinite(rn_bs)
        badnan = cont & ~fin
        with np.errstate(invalid="ignore"):
            badmono = cont & fin & (rn_bs > _SDC_MONO_FACTOR * rnb)
        rnb = np.where(cont & fin, np.minimum(rnb, rn_bs), rnb)
        fA = (cont & badA) if badA is not None else np.zeros_like(cont)
        fM = (cont & badM) if badM is not None else np.zeros_like(cont)
        det = np.where(det == SDC_NONE,
                       _det4(fA, fM, badnan & ungated, badmono & ungated),
                       det)
        ks += 1
        clean = det == SDC_NONE
        anomaly = (badnan | badmono) & gated & clean
        do_rr = ((np.any(cont & clean) and gated and ks % interval == 0)
                 or np.any(anomaly))
        x, r, p = x_new, r_new, p_new
        if do_rr:
            xr = sel(anomaly, xv, x)
            rt = b - g.A_rr(xr)
            zt = g.M_rr(rt)
            rtn2, _rzt = g.vpair(rt, zt)
            rtn = np.sqrt(np.maximum(
                np.asarray(rtn2.cpu().numpy(), dtype=rn_h.dtype), 0.0))
            syncs += 1
            stall = anomaly | ((rtn > tol_h)
                               & (rtn >= _SSTEP_STALL_FACTOR * rn_rr))
            base = cont & clean
            ok = base & ~stall
            restart = base & stall & (drc < max_repl)
            demote = base & stall & (drc >= max_repl)
            take = ok | restart
            x_prev = x
            x = sel(anomaly, xv, x)
            r = sel(take, st_(rt), r)
            p = sel(take, st_(zt), p)
            rn_h = np.where(ok | restart | demote, rtn, rn_h)
            xv = sel(ok, x_prev, xv)
            rrc = rrc + ok
            drc = drc + restart
            rn_rr = np.where(ok | restart, rtn, rn_rr)
            det = np.where((det == SDC_NONE) & demote, SDC_DEMOTE, det)
        cont = active()
    true = torch.sqrt(torch.clamp_min(g.vnorm2(b - g.A_final(x)), 0.0))
    true_h = np.atleast_1d(true.cpu().numpy()).tolist()
    syncs += 1
    if many:
        reasons = [_reason(float(rn_h[j]), float(tol_h[j]), atol_h,
                           bool(brk[j]), float(dmax_h[j]))
                   for j in range(len(rn_h))]
        return (x, [int(v) for v in it], true_h, reasons, syncs,
                [int(v) for v in det], [int(v) for v in rrc], xv)
    return (x, int(it), true_h[0],
            _reason(float(rn_h), float(tol_h), atol_h, bool(brk),
                    float(dmax_h)), syncs, int(det), int(rrc), xv)


# ---- device-resident plan steps (the fused megasolve's inner loops) ----------
#
# The loops above read the host once per iteration to decide whether to go on.
# The fused whole-solve program (``solvers/megasolve.py``) runs the same
# recurrences as MASKED steps with no host read: a :class:`DevicePlan` holds
# ``init(b) -> state``, a dict of device tensors, and ``step(state) ->
# state``, which computes every update and keeps a frozen recurrence (or
# column) by ``torch.where`` selects, never by a multiply with a zero gate,
# so a frozen step leaves every carry bit-equal and inf/NaN cannot leak in
# (JAX ``classic_cg_loop``'s ``jnp.where(cm, ...)``, ``cg_plans.py:448-480``).
# A live step's arithmetic is the eager loop's, op for op. The tolerance
# scalars are device tensors (``rtol``, ``atol``, ``dtol`` of the reduce
# dtype, ``maxit`` int64): nothing in a step reads the host or makes a host
# copy, so a CUDA graph can capture it.


class DevicePlan:
    """A masked-step recurrence: ``init(b)`` (from a zero guess) returns the
    state dict, ``step(state)`` one masked iteration (s-step: one block) as
    a new dict, ``live(state)`` the per-recurrence continue mask, and
    ``result(state)`` ``(x, it, reason)`` as device tensors. ``state["ls"]``
    counts the steps in which some recurrence was live.

    A guarded plan (built with a guard bundle ``g``) also carries ``det``
    (the first detector code, per recurrence), ``rrc`` (the replacements
    that passed) and ``due``: a step after which the recurrence owes its
    periodic true-residual replacement sets ``due``, which holds every
    recurrence (``live`` is false) until ``replace(state)`` has run it; the
    host runs ``replace`` between replays when the flag says so, so the
    replacement's applies run only where one is due."""

    def __init__(self, init, step, live, result, replace=None):
        self.init, self.step, self.live, self.result = init, step, live, result
        self.replace = replace


def _dmax_dev(rnorm0, dtol):
    """:func:`_dmax` for a device ``dtol``: ``dtol * rnorm0``, and no
    ceiling where ``dtol <= 0``."""
    return torch.where(dtol > 0, dtol * rnorm0,
                       torch.full_like(rnorm0, math.inf))


def _reason_dev(rn, tol, atol, brk, dmax):
    """:func:`_reason` on device tensors (per column under a batch plan)."""
    return torch.where(
        brk, CR.DIVERGED_BREAKDOWN,
        torch.where(rn <= tol,
                    torch.where(rn <= atol, CR.CONVERGED_ATOL,
                                CR.CONVERGED_RTOL),
                    torch.where(rn >= dmax, CR.DIVERGED_DTOL,
                                CR.DIVERGED_MAX_IT))).to(torch.int32)


def _zero_counts(rn):
    it = torch.zeros(rn.shape, dtype=torch.int64, device=rn.device)
    return it, torch.zeros(rn.shape, dtype=torch.bool, device=rn.device)


def _live_steps(st, cont):
    return st["ls"] + cont.any().to(torch.int64)


def _finish(x, st):
    return x, st["it"], _reason_dev(st["rn"], st["tol"], st["atol"],
                                    st["brk"], st["dmax"])


# ---- the guard on the device (the fused program's guarded modes) ------------
#
# The guarded loops above judge their checks on the host once a step. The
# fused program cannot read the host inside a replay, so its guarded plans
# keep every verdict on the device: the detector code ``det`` (sticky, per
# recurrence) freezes a recurrence as the host loop's exit does, and the
# replacement becomes a piece of its own that the host replays when ``due``
# says one is owed. The guard bundles (``solvers/krylov.py``) are the unfused
# programs'; only their site names are passed explicitly (a capture runs a
# piece twice).

def _guard_state(g, rn, bnorm, badA0, badM0):
    """The guard's part of an initial state: the init detector code, the
    replacement count, the best norm seen, the drift floor and the flags."""
    false = torch.zeros(rn.shape, dtype=torch.bool, device=rn.device)
    det = _det4(false if badA0 is None else badA0,
                false if badM0 is None else badM0, ~torch.isfinite(rn),
                false)
    return dict(det=det, rrc=torch.zeros_like(det), rnb=rn.clone(),
                dfl=_SDC_DRIFT_FLOOR_EPS * g.eps * bnorm, stp=false,
                due=torch.zeros((), dtype=torch.bool, device=rn.device))


def _guard_live(live, g):
    """``live`` of a guarded plan: also clean, and not held for a due
    replacement."""
    if g is None:
        return live
    return lambda st: live(st) & (st["det"] == SDC_NONE) & ~st["due"]


def _guard_step(g, st, new, cont, badA, badM, many):
    """The sentinels and the ABFT verdicts of one masked step (the host
    loops' per-step decisions): the NaN and monotonicity sentinels on the
    new norm, the first detector code, and ``due`` when the step ends on a
    replacement (every ``g.rr_n`` steps: the lockstep count of a block, the
    iteration count of one clean, unconverged recurrence)."""
    rn, rnb, det = new["rn"], st["rnb"], st["det"]
    false = torch.zeros_like(cont)
    fin = torch.isfinite(rn)
    badnan = cont & ~fin
    badmono = cont & fin & (rn > _SDC_MONO_FACTOR * rnb)
    det = torch.where(det == SDC_NONE,
                      _det4(false if badA is None else cont & badA,
                            false if badM is None else cont & badM,
                            badnan, badmono), det)
    due = st["due"]                   # held steps keep it
    if g.rr_n > 0:
        hit = cont.any() & (new["ls"] % g.rr_n == 0)
        if not many:
            hit = hit & cont & (det == SDC_NONE) & (rn > st["tol"])
        due = due | hit
    return dict(new, det=det, stp=torch.where(st["due"], st["stp"], cont),
                due=due,
                rnb=torch.where(cont & fin, torch.minimum(rnb, rn), rnb))


def _drift(rtn, rn, dfl):
    return torch.abs(rtn - rn) > _SDC_DRIFT_REL * (rtn + rn) + dfl


def _sq(t):
    return torch.sqrt(torch.clamp_min(_re(t), 0.0))


def classic_cg_device(*, rtol, atol, maxit, dtol, A=None, M=None, Adot=None,
                      inv_diag=None, pdot=None, pnorm=None, bp=None,
                      prec=None, g=None, A0=None, M0=None) -> DevicePlan:
    """The classic CG recurrence as a :class:`DevicePlan`, on the general
    route (``A``, ``M``) or the stencil route (``Adot`` with the scalar
    ``inv_diag``), one RHS or a :class:`ManyBatch` block: the arithmetic of
    :func:`classic_cg_loop` and its ``_lockstep``, with every update
    selected by the continue mask.

    With a guard bundle ``g`` (general route only) the reductions are the
    guard's (``g.p1`` stacks ``<p, A p>`` with the operator's check sums,
    ``g.p2`` ``<r, z>`` and ``||r||^2`` with the PC's), the verdicts are
    :func:`guarded_cg_loop`'s, and ``replace`` is its periodic true-residual
    replacement with the drift gate. ``A0``/``M0`` are the applies of the
    initial residual (their own fault sites), by default ``A``/``M``."""
    stencil = Adot is not None
    if stencil and g is not None:
        raise ValueError("the guarded plans take the general route")
    mixed = prec is not None and prec.mixed
    st_ = _stc(prec)
    many = bp is not None
    ex = bp.ex if many else (lambda s: s)
    A0, M0 = A0 or A, M0 or M

    def init(b):
        x = torch.zeros_like(b)
        if stencil:
            bnorm = pnorm(b)
            r = b - Adot(x)[0]
            rr0 = pdot(r, r)
            rn = torch.sqrt(rr0)
            rz = rr0 * inv_diag
            p = st_(prec.up(r) * inv_diag) if mixed else r * inv_diag
            tol = torch.clamp_min(rtol * bnorm, atol)
        elif g is not None:
            r = b - A0(x)
            bnorm, badA0 = g.init(b, r, x)
            p = M0(r).clone()
            rz, rn2, chkM0 = g.p2(r, p, site="P.p2init")
            rn = _sq(rn2)
            tol = torch.clamp_min(rtol * bnorm, atol)
        else:
            r = b - A(x)
            p = M(r).clone()
            rz = pdot(r, p)
            _, tol = _tol(pnorm, b, rtol, atol)
            rn = pnorm(r)
        it, brk = _zero_counts(rn)
        st = dict(x=x, r=r, p=p, rz=rz, rn=rn, tol=tol,
                  atol=torch.zeros_like(rn) + atol, dmax=_dmax_dev(rn, dtol),
                  it=it, brk=brk, ls=it.new_zeros(()))
        if g is not None:
            st.update(_guard_state(
                g, rn, bnorm, badA0,
                None if chkM0 is None else _bad4(chkM0, g.te)), b=b)
        return st

    live = _guard_live(
        lambda st: _live(st["rn"], st["tol"], st["dmax"], st["it"], maxit,
                         st["brk"]), g)

    def axpy(y, a, v):
        # store(up(y) + a up(v)) under a mixed plan, else y + a v (addcmul)
        return _mix_axpy(prec, y, v, a)

    def step(st):
        cont = live(st)
        cm = ex(cont)
        x, r, p, rz = st["x"], st["r"], st["p"], st["rz"]
        chkA = chkM = None
        if stencil:
            Ap, pAp = Adot(p)
        elif g is not None:
            Ap = A(p)
            pAp, chkA = g.p1(p, Ap)
        else:
            Ap = A(p)
            pAp = pdot(p, Ap)
        brk = st["brk"] | (cont & (pAp == 0))
        al = ex(_safe_div(rz, pAp))
        if mixed:
            x = torch.where(cm, axpy(x, al, p), x)
            r = torch.where(cm, axpy(r, -al, Ap), r)
        else:
            # the unfused loop's operations, operand for operand: a complex
            # product of -alpha can round apart from the negated product
            x = torch.where(cm, torch.addcmul(x, al, p), x)
            r = torch.where(cm, torch.addcmul(r, al, Ap, value=-1), r)
        if stencil:
            r32 = prec.up(r) if mixed else r
            rr = pdot(r32, r32)
            rz_new = rr * inv_diag
            rn_new = torch.sqrt(rr)
            beta = ex(_safe_div(rz_new, rz))
            if mixed:
                pn = _lifted_axpy(st_(r32 * inv_diag), beta, p,
                                  out=torch.empty_like(p))
            else:
                pn = torch.mul(p, beta).add_(r, alpha=inv_diag)
        else:
            z = M(r)
            if g is not None:
                rz_new, rn2, chkM = g.p2(r, z, site="P.p2")
                rn_new = _sq(rn2)
            else:
                rz_new = pdot(r, z)
                rn_new = pnorm(r)
            beta = ex(_safe_div(rz_new, rz))
            pn = (_lifted_axpy(z, beta, p, out=torch.empty_like(p)) if mixed
                  else torch.mul(p, beta).add_(z))
        new = dict(st, x=x, r=r, p=torch.where(cm, pn, p),
                   rz=torch.where(cont, rz_new, rz),
                   rn=torch.where(cont, rn_new, st["rn"]),
                   it=st["it"] + cont, brk=brk, ls=_live_steps(st, cont))
        if g is None:
            return new
        return _guard_step(g, st, new, cont,
                           None if chkA is None else _bad4(chkA, g.te),
                           None if chkM is None else _bad4(chkM, g.te), many)

    def replace(st):
        """The periodic true-residual replacement of the due recurrences
        (``guarded_cg_loop``): ``r = b - A x`` verified by a plain
        reduction, the direction restarted from ``M r``; a recurrence norm
        more than 25% off the true one is a ``drift`` detection."""
        rt = st["b"] - g.A_rr(st["x"])
        zt = g.M_rr(rt)
        rtn2, rzt = g.vpair(rt, zt)
        rtn = _sq(rtn2)
        clean = st["det"] == SDC_NONE
        base = st["due"] & st["stp"] & clean
        drift = _drift(rtn, st["rn"], st["dfl"])
        ok = base & ~drift
        okm = ex(ok)
        return dict(st, r=torch.where(okm, rt, st["r"]),
                    p=torch.where(okm, zt, st["p"]),
                    rz=torch.where(ok, rzt, st["rz"]),
                    rn=torch.where(ok, rtn, st["rn"]), rrc=st["rrc"] + ok,
                    det=torch.where(base & drift, SDC_DRIFT, st["det"]),
                    due=torch.zeros_like(st["due"]))

    return DevicePlan(init, step, live, lambda st: _finish(st["x"], st),
                      replace if g is not None and g.rr_n > 0 else None)


def pipelined_cg_device(*, rtol, atol, maxit, dtol, A, M, pnorm, fused,
                        bp=None, prec=None, g=None, A0=None, M0=None
                        ) -> DevicePlan:
    """The pipelined CG recurrence of :func:`pipelined_cg_loop` as a
    :class:`DevicePlan` (one RHS or a :class:`ManyBatch` block): the masked
    branch of that loop's update, for every step.

    With a guard bundle ``g``, :func:`guarded_pipelined_loop`'s: the one
    reduction ``g.fused`` also sums the ABFT partials of the previous
    step's fresh applies (carried as ``chk``), and ``replace`` refills the
    pipeline from the true residual. ``A0`` is the pair of initial applies
    (``r = b - A x``, ``w = A u``), ``M0`` the initial PC apply."""
    mixed = prec is not None and prec.mixed
    many = bp is not None
    ex = bp.ex if many else (lambda s: s)
    A0 = A0 or (A, A)
    M0 = M0 or M
    consts = {}

    def chk_stack(chk, sdt):
        if not chk[0]:
            return None
        return torch.stack([torch.stack([q.to(sdt) for q in row])
                            for row in chk])

    def init(b):
        sdt = prec.reduce if mixed else b.dtype
        x0 = torch.zeros_like(b)
        r = b - A0[0](x0)
        if g is not None:
            bnorm, badA0 = g.init(b, r, x0)
            u = M0(r)
            w = A0[1](u)
            rn0 = g.pnorm(r)
        else:
            bnorm = pnorm(b)
            u = M(r)
            w = A(u)
            rn0 = pnorm(r)
        tol = torch.clamp_min(rtol * bnorm, atol)
        S = torch.stack([w, u, r, x0])
        if "sgn" not in consts:
            consts["sgn"] = torch.tensor(
                [-1.0, -1.0, -1.0, 1.0], dtype=real_dtype(sdt),
                device=b.device).reshape((4,) + (1,) * b.ndim)
        it, brk = _zero_counts(rn0)
        gamma = torch.zeros(rn0.shape, dtype=sdt, device=b.device)
        st = dict(S=S, V=torch.zeros_like(S), gamma=gamma,
                  alpha=torch.zeros_like(gamma), rn=rn0, tol=tol,
                  atol=torch.zeros_like(rn0) + atol,
                  dmax=_dmax_dev(rn0, dtol), it=it, brk=brk,
                  ls=it.new_zeros(()))
        if g is not None:
            st.update(_guard_state(g, rn0, bnorm, badA0, None), b=b)
            chk = chk_stack(g.chk_init(r, u, w), sdt)
            if chk is not None:
                st["chk"] = chk
        return st

    live = _guard_live(
        lambda st: _live(st["rn"], st["tol"], st["dmax"], st["it"], maxit,
                         st["brk"]), g)

    def step(st):
        cont = live(st)
        cm = ex(cont)
        S, V, gamma, alpha = st["S"], st["V"], st["gamma"], st["alpha"]
        w, u, r = S[0], S[1], S[2]
        badA = badM = None
        if g is not None:
            chk = st.get("chk")
            rows = ([list(t.unbind(0)) for t in chk] if chk is not None
                    else [[] for _ in range(S.shape[1])])
            g_new, delta, rr, badA, badM = g.fused(r, u, w, rows)
        else:
            g_new, delta, rr = fused(r, u, w)
        m = M(w)
        n = A(m)
        first = gamma == 0
        beta = torch.where(first, 0.0,
                           g_new / torch.where(first, 1.0, gamma))
        aold = torch.where(alpha == 0, 1.0, alpha)
        denom = torch.where(first, delta, delta - beta * g_new / aold)
        a_new = torch.where(denom == 0, 0.0,
                            g_new / torch.where(denom == 0, 1.0, denom))
        be, al = ex(beta), ex(a_new)
        Vn = torch.stack([_mix_axpy(prec, c, V[i], be)
                          for i, c in enumerate((n, m, w, u))])
        V = torch.where(cm, Vn, V)
        S = torch.where(cm, _mix_axpy(prec, S, V, al * consts["sgn"]), S)
        rn_new = _sq(rr)
        new = dict(st, S=S, V=V, gamma=torch.where(cont, g_new, gamma),
                   alpha=torch.where(cont, a_new, alpha),
                   rn=torch.where(cont, rn_new, st["rn"]),
                   it=st["it"] + cont,
                   brk=st["brk"] | (cont & (denom == 0)),
                   ls=_live_steps(st, cont))
        if g is None:
            return new
        if "chk" in st:
            new["chk"] = chk_stack(g.chk_parts(m, n, w), st["chk"].dtype)
        return _guard_step(g, st, new, cont, badA, badM, many)

    def replace(st):
        """``guarded_pipelined_loop``'s replacement: ``r = b - A x``, ``u =
        M r``, ``w = A u``, the direction recurrences zeroed, the drift
        gated against the current recurrence residual."""
        S = st["S"]
        x = S[3]
        rt = st["b"] - g.A_rr(x)
        ut = g.M_rr(rt)
        wt = g.A_rr2(ut)
        rtn2, rc2 = g.vpair2(rt, S[2])
        rtn, rcur = _sq(rtn2), _sq(rc2)
        clean = st["det"] == SDC_NONE
        base = st["due"] & st["stp"] & clean
        drift = _drift(rtn, rcur, st["dfl"])
        ok = base & ~drift
        okm = ex(ok)
        zero = torch.zeros_like(st["gamma"])
        return dict(st, S=torch.where(okm, torch.stack([wt, ut, rt, x]), S),
                    V=torch.where(okm, 0.0, st["V"]),
                    gamma=torch.where(ok, zero, st["gamma"]),
                    alpha=torch.where(ok, zero, st["alpha"]),
                    rn=torch.where(ok, rtn, st["rn"]), rrc=st["rrc"] + ok,
                    det=torch.where(base & drift, SDC_DRIFT, st["det"]),
                    due=torch.zeros_like(st["due"]))

    return DevicePlan(init, step, live, lambda st: _finish(st["S"][3], st),
                      replace if g is not None and g.rr_n > 0 else None)


def _sstep_coefficients_dev(E, s, Sm, tol, dmax, maxit, it, rn, cont, brk):
    """:func:`_sstep_coefficients` as device tensor operations in the Gram
    matrix's dtype, with no host read (the JAX program runs it in-program,
    ``cg_plans.py:1048-1107``): ``E (q, q)`` for one RHS or ``(q, q, k)``
    for a column block, whose columns run as a batch. ``Sm`` is the
    :func:`sstep_shift` matrix on the device. Returns ``(chat, phat, it, rn,
    brk)``, the coefficients ``(m,)`` or ``(m, k)``."""
    single = E.dim() == 2
    Eb = E[None] if single else E.permute(2, 0, 1)
    tol, dmax, it, rn, cont, brk = (t.reshape(-1)
                                    for t in (tol, dmax, it, rn, cont, brk))
    m = 2 * s + 1
    dt = E.dtype
    k = Eb.shape[0]

    def cmat(G, v):
        return torch.matmul(G, v[..., None])[..., 0]

    def cdot(u, v):
        return (u.conj() * v).sum(-1)

    def onehot(i):
        v = torch.zeros((k, m), dtype=dt, device=E.device)
        v[:, i] = 1
        return v

    G1, G2 = Eb[:, 0:m, m:2 * m], Eb[:, m:2 * m, m:2 * m]
    g0, w0 = Eb[:, 0:m, 2 * m], Eb[:, m:2 * m, 2 * m]
    rr0 = _re(Eb[:, 2 * m, 2 * m])
    G1H = G1.transpose(1, 2).conj()

    def rz_of(zh, ch):
        return cdot(g0, zh) - cdot(ch, cmat(G1H, zh))

    phat, zhat = onehot(0), onehot(s + 1)
    chat = torch.zeros((k, m), dtype=dt, device=E.device)
    rz = rz_of(zhat, chat)
    rr0p = torch.clamp_min(rr0, 0.0)
    rn = torch.where(cont, torch.sqrt(rr0p), rn)
    rr_floor = _SSTEP_RR_FLOOR * m * torch.finfo(real_dtype(dt)).eps * rr0p
    rn_floor = torch.sqrt(rr_floor)
    a = cont & (rn > tol)
    for _ in range(s):
        pAp = cdot(phat, cmat(G1, phat))
        brk_j = a & (pAp == 0)
        brk = brk | brk_j
        a = a & ~brk_j
        alpha = torch.where(pAp == 0, 0.0,
                            rz / torch.where(pAp == 0, 1.0, pAp))
        am = a[:, None]
        chat = torch.where(am, chat + alpha[:, None] * phat, chat)
        zhat = torch.where(am, zhat - alpha[:, None] * cmat(Sm, phat), zhat)
        rz_new = rz_of(zhat, chat)
        rr_new = (rr0 - 2.0 * _re(cdot(chat, w0))
                  + _re(cdot(chat, cmat(G2, chat))))
        floor_hit = rr_new <= rr_floor
        rn_new = torch.maximum(torch.sqrt(torch.clamp_min(rr_new, 0.0)),
                               rn_floor)
        beta = torch.where(rz == 0, 0.0, rz_new / torch.where(rz == 0, 1.0,
                                                              rz))
        phat = torch.where(am, zhat + beta[:, None] * phat, phat)
        rz = torch.where(a, rz_new, rz)
        rn = torch.where(a, rn_new, rn)
        it = it + a
        a = a & ~floor_hit & (rn > tol) & (rn < dmax) & (it < maxit)
    if single:
        return chat[0], phat[0], it[0], rn[0], brk[0]
    return chat.T, phat.T, it, rn, brk


def sstep_cg_device(*, rtol, atol, maxit, dtol, s, A, M, pnorm, gram,
                    combine, bp=None, prec=None, g=None, A0=None, M0=None,
                    max_repl=3) -> DevicePlan:
    """The s-step CG recurrence of :func:`sstep_cg_loop` as a
    :class:`DevicePlan`: one step is one block of ``s`` iterations around
    the one Gram reduction, its coefficient recurrences on the device
    (:func:`_sstep_coefficients_dev`).

    With a guard bundle ``g``, :func:`guarded_sstep_loop`'s: the basis
    build's column sums ride the Gram reduction (``g.greduce``) and are
    judged on the device (:func:`_sstep_guard_flags`); with a replacement
    interval, a block that ends on it (every ``ceil(rr_n / s)`` blocks), or
    whose block-start norm is NaN or blew up, owes ``replace``: the drift
    gate against the true residual, with at most ``max_repl`` basis
    restarts before ``SDC_DEMOTE``."""
    st_ = _stc(prec)
    mixed = prec is not None and prec.mixed
    up = prec.up if mixed else (lambda v: v)
    many = bp is not None
    ex = bp.ex if many else (lambda s_: s_)
    s = int(s)
    if s < 1:
        raise ValueError(f"-ksp_sstep_s must be >= 1, got {s}")
    m = 2 * s + 1
    A0, M0 = A0 or A, M0 or M
    gated = g is not None and g.rr_n > 0
    interval = max((g.rr_n + s - 1) // s, 1) if gated else 0
    consts = {}

    def init(b):
        x = torch.zeros_like(b)
        r = b - A0(x)
        if g is not None:
            bnorm, badA0 = g.init(b, r, x)
            rn0 = g.pnorm(r)
        else:
            bnorm = pnorm(b)
            rn0 = pnorm(r)
        tol = torch.clamp_min(rtol * bnorm, atol)
        p = M0(r)
        if "Sm" not in consts:
            # in the Gram matrix's dtype (complex for a complex operator)
            consts["Sm"] = torch.from_numpy(sstep_shift(s, m)).to(
                dtype=torch.promote_types(rn0.dtype, b.dtype),
                device=b.device)
        it, brk = _zero_counts(rn0)
        st = dict(x=x, r=r, p=p, rn=rn0, tol=tol,
                  atol=torch.zeros_like(rn0) + atol,
                  dmax=_dmax_dev(rn0, dtol), it=it, brk=brk,
                  ls=it.new_zeros(()))
        if g is not None:
            st.update(_guard_state(g, rn0, bnorm, badA0, None), b=b,
                      xv=x.clone(), drc=torch.zeros_like(it),
                      rn_rr=rn0.clone(), anom=torch.zeros_like(brk))
        return st

    live = _guard_live(
        lambda st: _live(st["rn"], st["tol"], st["dmax"], st["it"], maxit,
                         st["brk"]), g)

    def step(st):
        cont = live(st)
        x, r, p = st["x"], st["r"], st["p"]
        C = p.new_zeros((p.shape[0], 2 * m + 1) + tuple(p.shape[1:]))
        C[:, 0] = p
        for i in range(s):
            t = A(C[:, i])
            C[:, m + i] = t
            C[:, i + 1] = st_(M(t))
        C[:, s + 1] = st_(M(r))
        for i in range(s - 1):
            t = A(C[:, s + 1 + i])
            C[:, m + s + 1 + i] = t
            C[:, s + 2 + i] = st_(M(t))
        C[:, 2 * m] = r
        if g is not None:
            E, outs = g.greduce(up(C), host=False)
            rn_bs = torch.where(cont, _sq(E[2 * m, 2 * m]), st["rn"])
        else:
            E = gram(up(C))
        chat, phat, it, rn, brk = _sstep_coefficients_dev(
            E, s, consts["Sm"], st["tol"], st["dmax"], maxit, st["it"],
            st["rn"], cont, st["brk"])
        cm = ex(cont)
        x_new = st_(up(x) + combine(chat, up(C[:, :m])))
        r_new = st_(up(r) - combine(chat, up(C[:, m:2 * m])))
        p_new = st_(combine(phat, up(C[:, :m])))
        new = dict(st, x=torch.where(cm, x_new, x),
                   r=torch.where(cm, r_new, r), p=torch.where(cm, p_new, p),
                   rn=rn.reshape(st["rn"].shape),
                   it=it.reshape(st["it"].shape),
                   brk=brk.reshape(st["brk"].shape),
                   ls=_live_steps(st, cont))
        if g is None:
            return new
        # the sentinels watch the exact block-start norm; with a
        # replacement interval a NaN or blow-up is an anomaly the gate
        # repairs, not a detection
        badA, badM = _sstep_guard_flags(outs, g, s, m, many)
        rnb = st["rnb"]
        false = torch.zeros_like(cont)
        fin = torch.isfinite(rn_bs)
        badnan = cont & ~fin
        badmono = cont & fin & (rn_bs > _SDC_MONO_FACTOR * rnb)
        det = torch.where(
            st["det"] == SDC_NONE,
            _det4(false if badA is None else cont & badA,
                  false if badM is None else cont & badM,
                  badnan & (not gated), badmono & (not gated)), st["det"])
        clean = det == SDC_NONE
        anom = (badnan | badmono) & clean & gated
        due = st["due"]               # held steps keep it
        if gated:
            due = due | ((cont & clean).any()
                         & (new["ls"] % interval == 0)) | anom.any()
        return dict(new, det=det, stp=torch.where(st["due"], st["stp"], cont),
                    due=due, anom=torch.where(st["due"], st["anom"], anom),
                    rnb=torch.where(cont & fin, torch.minimum(rnb, rn_bs),
                                    rnb))

    def replace(st):
        """``guarded_sstep_loop``'s gate: the true residual (from the
        verified iterate after an anomaly) against the last check's; a
        stall restarts the recurrence from it, past ``max_repl`` restarts
        the code is ``SDC_DEMOTE``."""
        x, anom, rn_rr = st["x"], st["anom"], st["rn_rr"]
        am = ex(anom)
        xr = torch.where(am, st["xv"], x)
        rt = st["b"] - g.A_rr(xr)
        zt = g.M_rr(rt)
        rtn = _sq(g.vpair(rt, zt)[0])
        stall = anom | ((rtn > st["tol"])
                        & (rtn >= _SSTEP_STALL_FACTOR * rn_rr))
        clean = st["det"] == SDC_NONE
        base = st["due"] & st["stp"] & clean
        ok = base & ~stall
        restart = base & stall & (st["drc"] < max_repl)
        demote = base & stall & (st["drc"] >= max_repl)
        take = ex(ok | restart)
        return dict(st, x=xr, r=torch.where(take, st_(rt), st["r"]),
                    p=torch.where(take, st_(zt), st["p"]),
                    rn=torch.where(ok | restart | demote, rtn, st["rn"]),
                    xv=torch.where(ex(ok), x, st["xv"]),
                    rrc=st["rrc"] + ok, drc=st["drc"] + restart,
                    rn_rr=torch.where(ok | restart, rtn, rn_rr),
                    det=torch.where(demote, SDC_DEMOTE, st["det"]),
                    due=torch.zeros_like(st["due"]))

    return DevicePlan(init, step, live, lambda st: _finish(st["x"], st),
                      replace if gated else None)
