"""Megasolve: the whole refinement (or true-residual gate) loop on the device,
replayed as captured CUDA graphs.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/megasolve.py``.
The JAX module composes the CG plan loops into ONE device program per
request class::

    outer loop over the refinement recurrence (the outer dtype, fp64 under
    refinement, the operator's own when the operator is shared)
      r_lp  = r in the inner dtype
      dx    = inner CG plan loop (A_lp dx = r_lp), from zero
      x    += up(dx)
      r     = b - A_out x                   # the TRUE residual
      exit: ||r|| <= max(rtol ||b||, atol), a stagnation guard, refine_max

so a ``RefinedKSP.solve`` (and ``solve_many`` block) is one dispatch, and the
returned iterate is verified by construction: the exit gate IS the true
residual. With the operator shared (``outer_op`` None) the same program is
the uniform-precision gate: ``KSP.solve`` re-enters from the true residual
in-program (``GATE_REFINE_MAX`` steps). The inner plan is a
:class:`..solvers.cg_plans.DevicePlan`: classic CG (general route, or the
stencil fused-dot fast path with ``stencil_fastpath``), pipelined CG or
s-step CG, one RHS or a ``ManyBatch`` block, and the PC is whatever
``pc.local_apply`` closes over, the V-cycle of PC mg included.

**The port's analog of one dispatch.** A JAX while-loop has no counterpart
that a CUDA graph can hold without conditional nodes, so the program runs in
pieces whose device state lives in static buffers: ``start`` (the outer
set-up and the first inner set-up), ``chunk`` (``MEGASOLVE_CHUNK`` masked
inner steps; a step past an inner loop's end changes no carry, it is
counted in ``masked_steps``) and ``outer`` (the correction, the true
residual, the guard and the next inner set-up). On a CUDA tensor each piece
is captured once as a ``torch.cuda.CUDAGraph`` (after a warm-up run on a
side stream, whose effect on the state is undone) and a solve replays
them; between replays the host reads ONE small flag tensor (is the inner
loop live, is the outer loop live). A solve costs ``1 + steps (chunks +
1)`` replays and as many reads, plus one read of the result, where the
eager loops read the host once per iteration. On a CPU tensor the same
pieces run uncaptured: that is the plain version the tests hold against
the JAX package. ``DeviceComm`` and a NCCL ``ProcessComm`` of one process
are captured: only communicators of one process. gloo cannot be captured,
so on a gloo communicator the pieces run uncaptured on every device; so
they do on a NCCL ``ProcessComm`` of several processes, whose captured
graphs ran on four cards but kept the ranks from leaving the process group
while they lived (``ROADMAP.md`` Queue C). The choice is made from the
communicator alone, and ``MegasolveResult.graph`` says which ran. A capture or replay that fails raises; nothing re-runs it
eagerly.

A complex operator takes the general plan (its stencil fast path stays off,
JAX ``megasolve.py:127``), with the conjugating reductions of the unfused
programs and real outer norms and targets (``utils.dtypes.tolerance_dtype``).

The kernel wrappers count launches in Python, which a replay does not run:
a capture records each piece's launches and collectives (and undoes the
counts the capture pass made), and each replay adds them to
``ops.stencil`` counters and ``comm.collectives``.

The graph captures the operator's and the PC's tensors by address. The
program cache key carries the JAX key's parts (``megasolve.py:242-246``),
the ``data_ptr`` of every tensor the operator and the PC hold, and the
operator and mutation counter the PC was built from (jacobi's inverse
diagonal made before the key is read), so a rebuilt operator or PC gets a
new program and a repeated solve the same one; a cached program keeps the
tensors its closures read alive, so an address it captured is never
reused under it.

**The guarded modes** (``abft``, ``abft_pc``, ``rr``; JAX
``megasolve.py:227-229``, ``:314-422``, batched ``:519-521``, ``:612-720``)
run the guarded plans of ``solvers/cg_plans.py`` (``g=`` on the device
plans, with the guard bundles of ``solvers/krylov.py``), so every verdict
stays on the device: a detection freezes its recurrence with its code, and
the ``outer`` piece keeps the verified carry ``xv`` and applies ``x <-
where(detected, x, x + dx)``; the outer loop goes on while no code is set.
The periodic replacement is a fourth piece, ``rr``, which the host replays
when the flag tensor's third entry says one is due (the plan holds every
recurrence until then); the chunk length divides the replacement interval
where it can (:func:`replacement_chunk`), so a due replacement follows no
masked step. The trace-time fault sites (``spmv.result``,
``pc.apply``, ``comm.psum``) are resolved when the program is built and sit
in the captured pieces, so a corrupted site is baked into the graph as JAX
bakes it into its trace; the cache key carries the set of hit sites, so a
faulted graph never serves a clean solve, nor a clean one a faulted solve.
The stencil fast path stays off under the guard (``:114-127``).

**The persistent variant** (JAX ``megasolve.py:87-91``, ``:478-485``,
``:534-538``): ``build_megasolve_program_many(..., persistent=True)`` is the
same batched program with ``rtol``, ``atol`` and the inner rtol held as
``(nrhs,)`` buffers, one tolerance a slot, in a cache of its own
(``_PERSISTENT_CACHE``), so that requests of different tolerances share one
launch (``serving/persistent.py``). A padding slot has ``rtol = atol = 0``
and a zero right-hand side: its norm and target are 0, so it is frozen at
outer step 0. The tolerances are refilled before each solve, so changing
them never re-captures. :meth:`MegasolveProgram.launch` runs a solve and
leaves its outputs on the device, unread, for the server to read in one
copy.

``torch.cond`` under capture (CUDA graph conditional nodes) could skip the
masked steps; it needs the ctypes launches as traceable custom ops, and is
left to a later PR (``ROADMAP.md``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import stencil as _st
from ..resilience import abft as _abft
from ..resilience import faults as _faults
from ..utils.convergence import ConvergedReason as CR
from ..utils.dtypes import reduce_dtype, tolerance_dtype
from . import cg_plans as _plans
from .krylov import (_GuardSums, _combine, _guard_sites, _make_guard,
                     _make_pipe_guard, _make_sstep_guard, _site_calls,
                     batched_pc_supported, fused_dots, gram_psum,
                     shard_dots)

#: KSP types with a fused whole-solve program (the plan-built CG family)
MEGASOLVE_TYPES = ("cg", "pipecg", "sstep")

#: outer refinement-step cap of the uniform-precision (gate-fusion) path:
#: the first full solve + the unfused gate's 3 re-entries
GATE_REFINE_MAX = 4

#: masked inner steps a ``chunk`` replay runs: more steps a replay means
#: fewer host reads, and more masked steps past the inner loop's end
MEGASOLVE_CHUNK = 8

_CACHE: dict = {}
#: the persistent-serving programs: per-slot tolerance buffers
_PERSISTENT_CACHE: dict = {}


def replacement_chunk(interval: int, chunk: int = MEGASOLVE_CHUNK) -> int:
    """The chunk length of a guarded plan whose replacement falls due every
    ``interval`` steps: the divisor of ``interval`` nearest ``chunk`` (from
    ``chunk / 2`` to ``2 chunk``), so a chunk ends where a replacement
    falls due and no masked step follows it; ``chunk`` when none does."""
    for c in sorted(range(max(1, chunk // 2), 2 * chunk + 1),
                    key=lambda c: abs(c - chunk)):
        if interval % c == 0:
            return c
    return chunk


def clear_cache():
    """Drop every cached program (and its CUDA graphs and their memory)."""
    _CACHE.clear()
    _PERSISTENT_CACHE.clear()


def megasolve_supported(ksp_type: str, pc, operator,
                        nrhs: int | None = None) -> bool:
    """Whether this (type, PC, operator) configuration has a fused
    whole-solve program (JAX ``megasolve.py:93``): the KSP routing test;
    ineligible configurations run the unfused path. Batched (``nrhs``)
    programs also need a batched PC apply."""
    if ksp_type not in MEGASOLVE_TYPES:
        return False
    if pc.kind == "hostlu":
        return False
    if not hasattr(operator, "local_spmv"):
        return False
    if nrhs is not None and not batched_pc_supported(pc):
        return False
    return True


def megasolve_stencil_supported(ksp_type: str, pc, operator,
                                nrhs: int | None = None,
                                guard: bool = False) -> bool:
    """Whether the fused inner loop can take the stencil fused-dot fast path
    (``-ksp_megasolve_stencil_fastpath``; JAX ``megasolve.py:114``): CG, PC
    none or a jacobi built on the operator itself, an operator with the
    fused matvec-dot (batched: its ``_many`` twin), a grid and a uniform
    diagonal. PC mg stays on the general plan."""
    if ksp_type != "cg" or guard:
        return False
    if operator.dtype.is_complex:
        return False
    if pc.get_type() not in ("none", "jacobi"):
        return False
    if pc.get_type() == "jacobi" and getattr(pc, "_mat", None) is not operator:
        return False
    need = ["local_matvec_dot", "grid3d"]
    if nrhs is not None:
        need.append("local_matvec_dot_many")
    if not all(hasattr(operator, h) for h in need):
        return False
    return getattr(operator, "uniform_diagonal", None) is not None


def _operators_compatible(inner_op, outer_op) -> None:
    if tuple(outer_op.shape) != tuple(inner_op.shape):
        raise ValueError(
            f"megasolve: outer operator shape {tuple(outer_op.shape)} != "
            f"inner {tuple(inner_op.shape)}: both precisions of the SAME "
            "operator are required (the outer op supplies the exact "
            "residual)")


def _reason_outer(conv, rn, atol, brk, ibrk, stag_reason):
    """The outer exit code (JAX ``megasolve.py:150``): converged means the
    TRUE residual met the target; a stagnation exit whose last inner solve
    broke down reports DIVERGED_BREAKDOWN, plain stagnation ``stag_reason``
    (DIVERGED_BREAKDOWN for refinement, DIVERGED_MAX_IT for the gate), and
    the step cap DIVERGED_MAX_IT."""
    return torch.where(
        conv, torch.where(rn <= atol, CR.CONVERGED_ATOL, CR.CONVERGED_RTOL),
        torch.where(brk,
                    torch.where(ibrk, CR.DIVERGED_BREAKDOWN, stag_reason),
                    CR.DIVERGED_MAX_IT)).to(torch.int32)


@dataclass
class MegasolveResult:
    """What one fused solve returns: the iterate (the program's own output
    buffer, flat), the outer step count, the inner iterations summed over
    the steps (per column for a block), the final true residual norm(s),
    the reason(s), and what the solve cost: host reads (flag reads and the
    result read), graph replays (or uncaptured runs of the pieces), the
    masked inner steps, and whether CUDA graphs ran. A guarded program also
    returns the detector code(s) ``det``, the replacements ``rrc`` and the
    verified carry ``xv`` (flat, as ``x``)."""
    x: torch.Tensor
    steps: int
    iters: object
    rnorm: object
    reason: object
    host_reads: int
    replays: int
    masked_steps: int
    graph: bool
    det: object = None
    rrc: object = None
    xv: torch.Tensor | None = None


def _tensor_ptrs(obj) -> tuple:
    """The ``data_ptr`` of every tensor ``obj`` holds as an attribute (or in
    a tuple/list attribute): the addresses a captured graph reads."""
    out = []
    for v in vars(obj).values():
        items = v if isinstance(v, (tuple, list)) else (v,)
        out += [t.data_ptr() for t in items if isinstance(t, torch.Tensor)]
    return tuple(out)


def _pc_state(pc) -> tuple:
    """What the PC's device data was built from, as the cache key sees it:
    its operator and that operator's mutation counter, the address of every
    tensor it holds, and the same for every child (a composite's). The
    data an apply makes lazily (jacobi's inverse diagonal) is made first,
    so that a solve's key holds the addresses its program captures."""
    if pc.kind == "jacobi" and pc._mat is not None:
        pc.set_up()._jacobi_inverse()
    mat = pc._mat
    return ((id(mat), getattr(mat, "_state", 0), _tensor_ptrs(pc))
            + tuple(_pc_state(c) for c in pc._sub_pcs))


def _counters(comm) -> dict:
    """Every launch counter of ``ops.stencil`` and every collective count
    of ``comm``, by name."""
    out = {("launches", k): w.launches for k, w in _st.KERNELS.items()}
    out.update({("launches_bf16", k): w.launches_bf16
                for k, w in _st.KERNELS.items()})
    out.update({("coll", k): v for k, v in comm.collectives.items()})
    return out


def _set_counters(comm, values: dict):
    for (kind, name), v in values.items():
        if kind == "coll":
            comm.collectives[name] = v
        else:
            setattr(_st.KERNELS[name], kind, v)


def _capturable(comm) -> bool:
    """CUDA graphs on a CUDA device, in one process (no collective crosses
    processes), and never over gloo (whose collectives go through the host
    and cannot be captured)."""
    return (comm.device.type == "cuda" and comm.nprocs == 1
            and getattr(comm, "backend", "nccl") != "gloo")


class MegasolveProgram:
    """The fused solve for one configuration (built by
    :func:`build_megasolve_program` or :func:`build_megasolve_program_many`).

    ``prog(b, x0, rtol, atol, inner_rtol, dtol, maxit, refine_max,
    stag_reason) -> MegasolveResult``: ``b``/``x0`` are shard-stacked
    ``(local_shards, lsize)`` tensors of the outer dtype (``(local_shards,
    k, lsize)`` blocks when batched; ``x0`` None from zero), the rest host
    scalars, which travel to static device buffers before each solve, so
    that changing them never re-captures. With ``per_slot`` (the persistent
    variant) ``rtol``, ``atol`` and ``inner_rtol`` are ``(k,)`` sequences,
    one a column."""

    def __init__(self, comm, A_out, onorm, in_dt, out_dt, shape, many, chunk,
                 guard=False, per_slot=False):
        self.comm = comm
        self.guard = guard
        self.A_out, self.onorm = A_out, onorm
        self.in_dt, self.out_dt = in_dt, out_dt
        # the inner plan and the views between the flat outer layout and
        # the plan's (set by ``_build``, which reads self.scal first)
        self.plan = self.to_inner = self.from_inner = None
        self.many, self.chunk = many, int(chunk)
        self.capture = _capturable(comm)
        dev = comm.device
        otdt = tolerance_dtype(out_dt)
        itdt = tolerance_dtype(in_dt)
        rn_shape = (shape[1],) if many else ()
        tol_shape = rn_shape if per_slot else ()
        z = lambda dt, sh=(): torch.zeros(sh, dtype=dt, device=dev)
        # the runtime scalars, refilled before each solve (the tolerances
        # one a column in the persistent variant)
        self.scal = dict(rtol=z(otdt, tol_shape), atol=z(otdt, tol_shape),
                         irtol=z(itdt, tol_shape),
                         dtol=z(itdt), maxit=z(torch.int64),
                         rmax=z(torch.int64), stag=z(torch.int32),
                         iatol=z(itdt, rn_shape))
        # the outer norm and target: real, also for a complex operator
        rdt = tolerance_dtype(out_dt)
        self.out = dict(b=z(out_dt, shape), x=z(out_dt, shape),
                        r=z(out_dt, shape), rn=z(rdt, rn_shape),
                        tol=z(rdt, rn_shape), it=z(torch.int64),
                        ii=z(torch.int64, rn_shape),
                        brk=z(torch.bool, rn_shape),
                        ibrk=z(torch.bool, rn_shape),
                        lsum=z(torch.int64))
        if guard:
            self.out.update(det=z(torch.int64, rn_shape),
                            rrc=z(torch.int64, rn_shape),
                            xv=z(out_dt, shape))
        # (inner loop live, outer loop live, replacement due)
        self.flags = z(torch.int32, (3,))
        self.inner = None              # the inner plan's state, static
        self.graphs, self.captured = {}, {}

    # ---- the three pieces ---------------------------------------------------
    def _ex(self, s):
        return s[:, None] if self.many else s

    def _active(self):
        o = self.out
        act = (o["rn"] > o["tol"]) & ~o["brk"]
        if self.guard:
            act = act & (o["det"] == _plans.SDC_NONE)
        return act

    def _set_flags(self):
        o = self.out
        olive = self._active().any() & (o["it"] < self.scal["rmax"])
        ilive = self.plan.live(self.inner).any() & olive
        due = (self.inner["due"] & olive if self.plan.replace is not None
               else torch.zeros_like(olive))
        self.flags.copy_(torch.stack([ilive, olive, due]).to(torch.int32))

    def _init_inner(self):
        st = self.plan.init(self.to_inner(self.out["r"].to(self.in_dt)))
        if self.inner is None:
            self.inner = {k: v.clone() for k, v in st.items()}
        else:
            for k, v in st.items():
                self.inner[k].copy_(v)

    def _start(self):
        o, s = self.out, self.scal
        tol = torch.maximum(s["rtol"] * self.onorm(o["b"]), s["atol"])
        r = o["b"] - self.A_out(o["x"])
        o["r"].copy_(r)
        o["rn"].copy_(self.onorm(r))
        o["tol"].copy_(tol)
        s["iatol"].copy_(tol)
        for k in ("it", "ii", "brk", "ibrk", "lsum") + (
                ("det", "rrc") if self.guard else ()):
            o[k].zero_()
        if self.guard:
            o["xv"].copy_(o["x"])
        self._init_inner()
        self._set_flags()

    def _chunk(self):
        st = dict(self.inner)
        for _ in range(self.chunk):
            st = self.plan.step(st)
        for k, v in st.items():
            self.inner[k].copy_(v)
        self._set_flags()

    def _rr(self):
        st = self.plan.replace(dict(self.inner))
        for k, v in st.items():
            self.inner[k].copy_(v)
        self._set_flags()

    def _outer(self):
        o = self.out
        act = self._active()
        dx, it_i, reason_i = self.plan.result(self.inner)
        x = o["x"]
        apply = act
        if self.guard:
            # a poisoned correction is never applied: the carry stays at the
            # last iterate whose true residual was measured
            det_i = self.inner["det"]
            detected = act & (det_i != _plans.SDC_NONE)
            apply = act & ~detected
        x_new = torch.where(self._ex(apply),
                            x + self.from_inner(dx).to(self.out_dt), x)
        r_new = o["b"] - self.A_out(x_new)
        rn_new = self.onorm(r_new)
        # the stagnation guard (RefinedKSP semantics): a correction the
        # inner precision cannot resolve stops the recurrence
        stag = act & (rn_new > o["tol"]) & (rn_new >= 0.9 * o["rn"])
        o["ii"].add_(torch.where(act, it_i, 0))
        o["lsum"].add_(self.inner["ls"])
        o["ibrk"].logical_or_(stag & (reason_i == CR.DIVERGED_BREAKDOWN))
        o["brk"].logical_or_(stag)
        o["it"].add_(1)
        if self.guard:
            o["det"].copy_(torch.where(detected, det_i, o["det"]))
            o["rrc"].add_(torch.where(act, self.inner["rrc"], 0))
            o["xv"].copy_(torch.where(self._ex(detected), o["xv"], x_new))
        x.copy_(x_new)
        o["r"].copy_(r_new)
        o["rn"].copy_(rn_new)
        self._init_inner()
        self._set_flags()

    # ---- replay / uncaptured run ------------------------------------------------
    def _static(self):
        return (list(self.scal.values()) + list(self.out.values())
                + [self.flags] + list((self.inner or {}).values()))

    def _capture(self, name, fn):
        dev = self.comm.device
        saved = [t.clone() for t in self._static()]
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()                       # warm-up: caches, handles, libraries
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, v in zip(self._static(), saved):
            t.copy_(v)
        before = _counters(self.comm)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            fn()
        after = _counters(self.comm)
        self.captured[name] = {k: after[k] - v for k, v in before.items()
                               if after[k] != v}
        _set_counters(self.comm, before)     # the capture launched nothing
        self.graphs[name] = g
        return g

    def _run(self, name, fn):
        if not self.capture:
            fn()
            return
        g = self.graphs.get(name) or self._capture(name, fn)
        g.replay()
        now = _counters(self.comm)
        _set_counters(self.comm, {k: now[k] + d
                                  for k, d in self.captured[name].items()})

    def _fill(self, b, x0, rtol, atol, inner_rtol, dtol, maxit, refine_max,
              stag_reason):
        s, o = self.scal, self.out
        for k, v in (("rtol", rtol), ("atol", atol), ("irtol", inner_rtol),
                     ("dtol", dtol), ("maxit", maxit), ("rmax", refine_max),
                     ("stag", stag_reason)):
            if s[k].dim():
                s[k].copy_(torch.as_tensor(v, dtype=s[k].dtype))
            else:
                s[k].fill_(v)
        o["b"].copy_(b)
        if x0 is None:
            o["x"].zero_()
        else:
            o["x"].copy_(x0)

    def _drive(self):
        """Run the pieces to the end of the outer loop: ``(host reads,
        replays, chunks)``."""
        self._run("start", self._start)
        ilive, olive, due = self.flags.tolist()
        reads = runs = 1
        chunks = 0
        while olive:
            while ilive or due:
                if due:
                    self._run("rr", self._rr)
                else:
                    self._run("chunk", self._chunk)
                    chunks += 1
                ilive, olive, due = self.flags.tolist()
                reads, runs = reads + 1, runs + 1
            self._run("outer", self._outer)
            ilive, olive, due = self.flags.tolist()
            reads, runs = reads + 1, runs + 1
        return reads, runs, chunks

    def _solve(self, *args):
        """One solve (the arguments of ``__call__``) to the end of the outer
        loop, its outputs left on the device: ``head`` (outer steps, live
        inner steps), the per-column outputs (inner iterations, true
        residual norms, reasons, and the guard's detections and
        replacements), and the flag reads, replays and chunks."""
        self._fill(*args)
        reads, runs, chunks = self._drive()
        o, s = self.out, self.scal
        reason = _reason_outer(o["rn"] <= o["tol"], o["rn"], s["atol"],
                               o["brk"], o["ibrk"], s["stag"])
        cols = [o["ii"], o["rn"], reason] + (
            [o["det"], o["rrc"]] if self.guard else [])
        head = torch.stack([o["it"], o["lsum"]])
        return head, cols, reads, runs, chunks

    def launch(self, *args) -> dict:
        """One unguarded solve (the arguments of ``__call__``) whose outputs
        stay on the device, unread, for the persistent serving launch
        (``serving/persistent.py``), which reads them in one copy: fresh
        tensors (the next solve refills the static buffers) ``x``, ``head``
        and ``cols`` (inner iterations, true residual norms, reasons; one
        row each), with the flag reads and replays made so far."""
        if self.guard:
            raise ValueError("megasolve: launch() runs unguarded programs")
        head, cols, reads, runs, chunks = self._solve(*args)
        return dict(x=self.out["x"].clone(), head=head,
                    cols=torch.stack([c.double() for c in cols]),
                    host_reads=reads, replays=runs, chunks=chunks)

    def __call__(self, b, x0, rtol, atol, inner_rtol, dtol, maxit,
                 refine_max, stag_reason) -> MegasolveResult:
        o = self.out
        head, cols, reads, runs, chunks = self._solve(
            b, x0, rtol, atol, inner_rtol, dtol, maxit, refine_max,
            stag_reason)
        vals = torch.cat([head.double()] + [c.reshape(-1).double()
                                            for c in cols]).tolist()
        reads += 1
        steps, lsum = int(vals[0]), int(vals[1])
        k = (len(vals) - 2) // len(cols)
        per = [vals[2 + i * k:2 + (i + 1) * k] for i in range(len(cols))]
        ii, rn, rs = ([int(v) for v in per[0]], per[1],
                      [int(v) for v in per[2]])
        det = rrc = xv = None
        if self.guard:
            det, rrc = [int(v) for v in per[3]], [int(v) for v in per[4]]
            xv = o["xv"].clone()
        if not self.many:
            ii, rn, rs = ii[0], rn[0], rs[0]
            if self.guard:
                det, rrc = det[0], rrc[0]
        return MegasolveResult(
            x=o["x"].clone(), steps=steps, iters=ii, rnorm=rn, reason=rs,
            host_reads=reads, replays=runs,
            masked_steps=chunks * self.chunk - lsum, graph=self.capture,
            det=det, rrc=rrc, xv=xv)


def _build(comm, ksp_type, pc, inner_op, outer_op, *, nrhs, abft=False,
           abft_pc=False, rr=False, cs=None, csM=None,
           abft_tol=_abft.DEFAULT_ABFT_TOL, rr_n=0, max_repl=3, sstep_s=4,
           stencil_fastpath=False, chunk=MEGASOLVE_CHUNK, persistent=False):
    """The program for one configuration, built or from the cache; ``chunk``
    other than ``MEGASOLVE_CHUNK`` is for tests that hold the masked steps
    to changing no bit."""
    many = nrhs is not None
    guard_k = bool(abft or rr)
    if persistent and (guard_k or not many):
        raise ValueError("megasolve: the persistent variant is a batched "
                         "program without the silent-corruption guard")
    if abft and cs is None:
        raise ValueError("megasolve: -ksp_abft needs the operator's column "
                         "checksum (cs)")
    if rr and int(rr_n) <= 0:
        raise ValueError("megasolve: the replacement mode needs rr_n > 0")
    if guard_k and stencil_fastpath:
        raise ValueError("megasolve: the stencil fast path stays off under "
                         "the silent-corruption guard")
    if not megasolve_supported(ksp_type, pc, inner_op, nrhs=nrhs):
        raise ValueError(f"megasolve: KSP {ksp_type!r} with pc "
                         f"{pc.get_type()!r} on {type(inner_op).__name__} "
                         "has no fused program")
    shared = outer_op is None or outer_op is inner_op
    out_op = inner_op if shared else outer_op
    _operators_compatible(inner_op, out_op)
    n = inner_op.shape[0]
    in_dt, out_dt = inner_op.dtype, out_op.dtype
    if in_dt.is_complex != out_dt.is_complex:
        raise ValueError("megasolve: inner/outer operators must agree on "
                         "real vs complex scalars")
    prec = _plans.precision_plan(in_dt)
    sstep_k = max(1, int(sstep_s)) if ksp_type == "sstep" else 0
    stencil_k = bool(stencil_fastpath)
    if stencil_k and not megasolve_stencil_supported(ksp_type, pc, inner_op,
                                                     nrhs=nrhs):
        raise ValueError(
            "megasolve: stencil fast path requested for an ineligible "
            "(type, PC, operator) configuration; gate the routing on "
            "megasolve_stencil_supported")
    gkey = ()
    sites = _faults.NO_SITES
    if not guard_k and _faults.trace_time_live():
        raise NotImplementedError(
            "a trace-time fault (spmv.result/pc.apply/comm.psum) is armed, "
            "and the port wires their sites into the fused program's "
            "guarded modes only, not into its unguarded plans (ROADMAP.md "
            "Queue A item 6.5)")
    if guard_k:
        cs_k = cs if abft else None
        csM_k = csM if abft and abft_pc else None
        rr_k = int(rr_n) if rr else 0
        # the trace-time faults of this build: baked into its pieces, so
        # the key carries the sites they hit (JAX keys on trace_key())
        sites = _faults.trace_sites(_guard_sites(
            ksp_type, sstep_k or 4, cs=cs_k is not None))
        if rr_k > 0:
            # sstep's replacement falls due every ceil(rr_n / s) blocks
            chunk = replacement_chunk(
                -(-rr_k // sstep_k) if ksp_type == "sstep" else rr_k,
                int(chunk))
        gkey = (cs_k is not None, csM_k is not None, rr_k, float(abft_tol),
                int(max_repl) if ksp_type == "sstep" else 0,
                tuple(t.data_ptr() for t in (cs_k, csM_k) if t is not None),
                tuple(sorted((k, f.kind, f.mag)
                             for k, f in sites.hits.items())))
    key = (id(comm), ksp_type, pc.program_key(), pc._tunables_key(), id(pc),
           n, prec.key(), str(out_dt), shared, nrhs, id(inner_op),
           id(out_op), inner_op.program_key(), out_op.program_key(),
           getattr(inner_op, "_state", 0), getattr(out_op, "_state", 0),
           getattr(inner_op, "force_plain", False), sstep_k, stencil_k,
           int(chunk), _tensor_ptrs(inner_op), _tensor_ptrs(out_op),
           () if stencil_k else _pc_state(pc), gkey)
    cache = _PERSISTENT_CACHE if persistent else _CACHE
    prog = cache.get(key)
    if prog is not None:
        return prog

    size = comm.local_shards
    up = prec.up
    out_rdt = reduce_dtype(out_dt)
    ou = (lambda v: v.to(out_rdt)) if out_rdt != out_dt else (lambda v: v)
    cols = (int(nrhs),) if many else ()
    shape = (size,) + cols + (comm.local_size(n),)

    # the reductions of the unfused programs; the outer norm in the outer
    # reduce dtype (JAX ``onorm``)
    pdot, pnorm = shard_dots(comm, up, cols=many)
    onorm = shard_dots(comm, ou, cols=many)[1]
    A_out = (out_op.local_spmv_many(comm) if many
             else out_op.local_spmv(comm))
    flat = lambda v: v.reshape(shape)
    to_inner = flat
    prog = MegasolveProgram(comm, A_out, onorm, in_dt, out_dt, shape, many,
                            chunk, guard=guard_k, per_slot=persistent)
    s = prog.scal
    kw = dict(rtol=s["irtol"], atol=s["iatol"], maxit=s["maxit"],
              dtol=s["dtol"], prec=prec if prec.mixed else None,
              bp=_plans.ManyBatch("slabs" if stencil_k else "cols")
              if many else None)
    if stencil_k:
        grid = (size,) + cols + tuple(inner_op.grid3d)
        to_inner = lambda v: v.reshape(grid)
        plan = _plans.classic_cg_device(
            Adot=(inner_op.local_matvec_dot_many(comm) if many
                  else inner_op.local_matvec_dot(comm)),
            inv_diag=(1.0 if pc.get_type() == "none"
                      else 1.0 / inner_op.uniform_diagonal),
            pdot=pdot, pnorm=pnorm, **kw)
    else:
        A = (inner_op.local_spmv_many(comm) if many
             else inner_op.local_spmv(comm))
        M = pc.local_apply_many(comm, n) if many else pc.local_apply(comm, n)
        if guard_k:
            plan = _guarded_plan(comm, ksp_type, A, M, many, prec, sites,
                                 in_dt, cs_k, csM_k, abft_tol, rr_k, sstep_k,
                                 max_repl, kw)
        elif ksp_type == "pipecg":
            fd = fused_dots(comm, up, cols=many)
            plan = _plans.pipelined_cg_device(
                A=A, M=M, pnorm=pnorm,
                fused=lambda r, u, w: tuple(fd([(r, u), (w, u), (r, r)])),
                **kw)
        elif ksp_type == "sstep":
            plan = _plans.sstep_cg_device(
                s=sstep_k, A=A, M=M, pnorm=pnorm,
                gram=gram_psum(comm, cols=many), combine=_combine, **kw)
        else:
            plan = _plans.classic_cg_device(A=A, M=M, pdot=pdot,
                                            pnorm=pnorm, **kw)
    prog.plan, prog.to_inner, prog.from_inner = plan, to_inner, flat
    cache[key] = prog
    return prog


def _guarded_plan(comm, ksp_type, A, M, many, prec, sites, in_dt, cs, csM,
                  abft_tol, rr_n, sstep_k, max_repl, kw):
    """The guarded inner plan: the guard bundle of the unfused guarded
    programs (``solvers/krylov.py``) on the inner precision, each apply
    bound to its trace-time fault site (the JAX package's trace order,
    ``krylov._guard_sites``) by name, not by call count, since a capture
    runs each piece twice."""
    sdt = prec.reduce if prec.mixed else in_dt
    eps = _abft.checksum_tolerance_dtype(in_dt)
    sums = _GuardSums(comm, prec.up, many, sdt, sites)

    def at(fn, *names):
        return _site_calls(sites, fn, [], list(names))

    if ksp_type == "pipecg":
        g = _make_pipe_guard(sums, cs, csM, abft_tol, rr_n, eps)
        g.A_rr, g.A_rr2, g.M_rr = (at(A, "A.rr"), at(A, "A.rr2"),
                                   at(M, "M.rr"))
        return _plans.pipelined_cg_device(
            A=at(A, "A.body"), M=at(M, "M.body"), pnorm=None, fused=None,
            g=g, A0=(at(A, "A.init0"), at(A, "A.init1")),
            M0=at(M, "M.init"), **kw)
    if ksp_type == "sstep":
        s = sstep_k
        g = _make_sstep_guard(sums, cs, csM, abft_tol, rr_n, eps, s)
        g.A_rr, g.M_rr = at(A, "A.rr"), at(M, "M.rr")
        return _plans.sstep_cg_device(
            s=s, A=at(A, *[f"A.p{i}" for i in range(s)],
                      *[f"A.r{i}" for i in range(s - 1)]),
            M=at(M, *[f"M.p{i}" for i in range(s)], "M.z",
                 *[f"M.r{i}" for i in range(s - 1)]),
            pnorm=None, gram=None, combine=_combine, g=g,
            A0=at(A, "A.init"), M0=at(M, "M.init"), max_repl=int(max_repl),
            **kw)
    g = _make_guard(sums, cs, csM, abft_tol, rr_n, eps)
    g.A_rr, g.M_rr = at(A, "A.rr"), at(M, "M.rr")
    return _plans.classic_cg_device(A=at(A, "A.body"), M=at(M, "M.body"),
                                    g=g, A0=at(A, "A.init"),
                                    M0=at(M, "M.init"), **kw)


def build_megasolve_program(comm, ksp_type, pc, inner_op, outer_op=None, *,
                            abft=False, abft_pc=False, rr=False, cs=None,
                            csM=None, abft_tol=_abft.DEFAULT_ABFT_TOL,
                            rr_n=0, max_repl=3, sstep_s=4,
                            stencil_fastpath=False) -> MegasolveProgram:
    """The fused single-RHS program for this configuration, built or taken
    from the cache (JAX ``megasolve.py:179``). ``outer_op`` None (or the
    inner operator) shares the operands: the uniform-precision gate.
    ``stencil_fastpath`` asks for the stencil fused-dot inner loop and
    raises ``ValueError`` where it is not eligible (JAX ``:236-241``).

    The guard (JAX's ``abft``, ``abft_pc``, ``rr``): ``cs``/``csM`` are the
    shard-stacked column checksums (``KSP._guard_checksums``), ``abft_tol``
    the ``-ksp_abft_tol`` multiplier, ``rr_n`` the replacement interval and
    ``max_repl`` the s-step basis-restart budget, all part of the program
    (JAX passes them as runtime scalars); the result then carries ``det``,
    ``rrc`` and the verified carry ``xv``."""
    return _build(comm, ksp_type, pc, inner_op, outer_op, nrhs=None,
                  abft=abft, abft_pc=abft_pc, rr=rr, cs=cs, csM=csM,
                  abft_tol=abft_tol, rr_n=rr_n, max_repl=max_repl,
                  sstep_s=sstep_s, stencil_fastpath=stencil_fastpath)


def build_megasolve_program_many(comm, ksp_type, pc, inner_op, outer_op=None,
                                 *, nrhs, abft=False, abft_pc=False, rr=False,
                                 cs=None, csM=None,
                                 abft_tol=_abft.DEFAULT_ABFT_TOL, rr_n=0,
                                 max_repl=3, sstep_s=4,
                                 stencil_fastpath=False,
                                 persistent=False) -> MegasolveProgram:
    """The batched fused program (JAX ``megasolve.py:478``): ``nrhs``
    refinement recurrences in lockstep over a ``(local_shards, nrhs,
    lsize)`` block, with per-column freezing at both levels (a column whose
    true residual meets its target freezes in the outer recurrence, and its
    inner loop, whose target is floored at that tolerance, at once) and
    per-column stagnation (JAX ``:499-508``); the guard's arguments as
    :func:`build_megasolve_program`'s, its outputs per column.
    ``persistent`` gives the persistent-serving variant (module docstring):
    per-slot tolerances, its own cache, no guard."""
    return _build(comm, ksp_type, pc, inner_op, outer_op, nrhs=int(nrhs),
                  abft=abft, abft_pc=abft_pc, rr=rr, cs=cs, csM=csM,
                  abft_tol=abft_tol, rr_n=rr_n, max_repl=max_repl,
                  sstep_s=sstep_s, stencil_fastpath=stencil_fastpath,
                  persistent=persistent)
