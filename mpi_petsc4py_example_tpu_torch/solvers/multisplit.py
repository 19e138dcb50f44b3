"""Asynchronous two-stage multisplitting: the stale-tolerant solver tier.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/multisplit.py``
(``MultisplitSolver`` :170, ``build_multisplit_residual_program`` :84,
``MultisplitResult`` :108). Every synchronous plan (classic/pipecg/s-step
CG) waits for its slowest shard at every reduction; this tier changes the
contract from synchrony to bounded staleness:

* the operator is row-partitioned into ``-multisplit_blocks`` blocks (the
  contiguous split of ``parallel/partition.py``);
* each block runs an INNER solve on its diagonal block ``A_ii`` with its own
  :class:`..solvers.ksp.KSP` (``-multisplit_inner_type``, any KSP type, with
  the session's PC), on a one-shard communicator of its own;
* the OUTER iteration is asynchronous block relaxation: block ``i`` solves
  ``A_ii x_i = b_i - sum_{j != i} A_ij x_j`` against whatever neighbour
  iterates the stale exchange (``parallel/exchange.py``) holds. Reads never
  block; a partner more than ``-multisplit_max_stale`` versions behind
  forces a RESYNC (the one deliberate wait, ``multisplit.resyncs``);
* convergence is declared only at a consistent version cut
  (``StaleExchange.consistent_cut``): the supervisor assembles the iterate
  with every live block at one version and measures the true residual with
  one program holding exactly ONE ``psum``
  (:func:`build_multisplit_residual_program`; ``comm.collectives`` counts
  it).

A ``comm.delay`` timing fault (``resilience/faults.delay_seconds``) makes a
block sleep before its step: jitter or a sticky slow shard, which the tier
absorbs as staleness. A mid-solve ``device.lost`` on a block's id degrades
to ONE stale block: the exchange freezes it at its last version, the
survivors iterate against it, and the block re-homes onto a surviving id
FROM that version, so no block's version ever returns to 0. The residual
check shrinks its communicator to the surviving ids the same way.

**On the card.** The port's mesh is virtual: shard ids name the JAX
package's devices (``parallel/mesh.py``), and every shard lives on the one
device of the communicator. So block ``i``'s inner KSP runs on
``DeviceComm(1, device_ids=(ids[i % N],))`` on the same card as the others,
and the residual check on a ``DeviceComm`` of all N ids. The block threads
share that card and its default stream: their launches interleave, and a
comparison of the tier against a synchronous plan on one card is a
comparison, never a scaling claim.

**Threads.** Each block's thread owns its comm, Mat, KSP and iterate; what
the threads share is locked: the exchange (one condition variable), the
fault plan and the lost registry (``faults._LOCK``), and the telemetry
registry's counters and histograms (a lock each). The inner KSPs run the
unfused loops (``megasolve`` off), which capture no CUDA graph and keep no
program cache, so no capture can meet another thread's launches; the
thread-local span stacks keep each block's ``ksp.solve`` spans apart.

**One controller.** The supervisor and the block threads live in one
process. On a ``ProcessComm`` of several processes :class:`MultisplitSolver`
raises ``NotImplementedError``: the blocks on every rank, driven from one,
are ROADMAP.md Queue A item 7.3, with the server across processes.

Convergence of the outer iteration needs the usual multisplitting
hypotheses (block diagonally dominant, M-matrix style splittings); for a
general SPD system the synchronous tier stays the default.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..core.mat import Mat
from ..core.vec import Vec
from ..parallel.exchange import StaleExchange, check_staleness_bound
from ..parallel.mesh import DeviceComm, as_comm, torch_dtype
from ..parallel.partition import row_partition
from ..resilience import faults as _faults
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _telemetry
from ..utils.convergence import ConvergedReason
from ..utils.errors import DeviceExecutionError
from ..utils.options import global_options

#: program-kind names, the JAX package's (its ``contracts.PROGRAM_KINDS``):
#: a block's inner solve, and the consistent-cut residual (one psum)
BLOCK_PROGRAM_KIND = "multisplit_block"
RESIDUAL_PROGRAM_KIND = "multisplit_residual"

DEFAULT_MAX_STALE = 4
DEFAULT_MAX_OUTER = 500
DEFAULT_INNER_RTOL = 1e-2
DEFAULT_INNER_MAX_IT = 50
DEFAULT_RESYNC_TIMEOUT = 30.0


def build_multisplit_residual_program(comm: DeviceComm, A: Mat):
    """The consistent-cut residual: ``run(b, x) -> ||b - A x||^2`` (a 0-d
    tensor) for shard-stacked ``b``/``x`` on ``comm``, with exactly ONE
    ``comm.psum`` of the per-shard partials, the tier's only reduction
    across shards, paid per convergence check and never per step. A live
    trace-time fault clause (``comm.psum``, ``spmv.result``, ``pc.apply``)
    raises: this program has no fault sites (ROADMAP.md Queue A item
    6.5)."""
    if _faults.trace_time_live():
        raise NotImplementedError(
            "a trace-time fault (spmv.result/pc.apply/comm.psum) is armed, "
            "and the multisplit residual program has no fault sites "
            "(ROADMAP.md Queue A item 6.5)")
    spmv = A.local_spmv(comm)

    def run(b, x):
        r = b - spmv(x)
        rr = (r.conj() * r).real if r.is_complex() else r * r
        return comm.psum([rr[i].sum() for i in range(comm.local_shards)])

    return run


class MultisplitResult:
    """Outcome of one asynchronous multisplit solve."""

    __slots__ = ("x", "iterations", "residual_norm", "reason", "wall_time",
                 "history", "resyncs", "blocks_lost", "block_steps",
                 "cut_version", "max_stale_seen")

    def __init__(self, x, iterations, residual_norm, reason, wall_time,
                 history, resyncs, blocks_lost, block_steps, cut_version,
                 max_stale_seen):
        self.x = x
        self.iterations = iterations          # consistent-cut version
        self.residual_norm = residual_norm
        self.reason = reason
        self.wall_time = wall_time
        self.history = history                # (cut_version, rnorm) pairs
        self.resyncs = resyncs
        self.blocks_lost = blocks_lost
        self.block_steps = block_steps        # outer steps per block
        self.cut_version = cut_version
        self.max_stale_seen = max_stale_seen

    @property
    def converged(self) -> bool:
        return self.reason > 0

    def __repr__(self):
        return (f"MultisplitResult(reason="
                f"{ConvergedReason.name(self.reason)}, "
                f"cut={self.cut_version}, rnorm={self.residual_norm:.3e}, "
                f"steps={self.block_steps}, resyncs={self.resyncs}, "
                f"lost={self.blocks_lost})")


class _BlockState:
    """What one block's thread owns: its one-shard comm, the diagonal block
    as a Mat with its inner KSP, the host off-diagonal coupling, and the
    iterate."""

    __slots__ = ("index", "rstart", "rend", "device_id", "comm", "mat",
                 "ksp", "A_diag", "A_off", "b_local", "x", "version",
                 "steps", "resyncs", "lost_count", "max_age")

    def __init__(self, index, rstart, rend):
        self.index = index
        self.rstart = rstart
        self.rend = rend
        self.device_id = None
        self.comm = None
        self.mat = None
        self.ksp = None
        self.A_diag = None      # scipy CSR of A[rows, rows] (re-home source)
        self.A_off = None       # scipy CSR of A[rows, :], own block zeroed
        self.b_local = None
        self.x = None
        self.version = 0        # last exchange version this block holds
        self.steps = 0
        self.resyncs = 0
        self.lost_count = 0
        self.max_age = 0        # worst staleness this block read


def _at_least(name: str, value, low):
    """``value`` unchanged when ``>= low``; a value the tier cannot honour
    raises ``ValueError`` naming its flag (never clamped)."""
    if value < low:
        raise ValueError(f"-multisplit_{name} {value!r}: must be >= {low}")
    return value


class MultisplitSolver:
    """Asynchronous two-stage multisplit solver (module docstring; JAX
    ``multisplit.py:170``).

    The ``-multisplit_*`` flags set the defaults and the keywords override
    them, the JAX package's precedence (the flags are the operator's knobs,
    the keywords the embedding layer's: the server tightens ``max_stale``
    per QoS class this way). A value the tier cannot honour (``nblocks`` <
    1, ``max_stale`` < 0, ``inner_max_it``/``max_outer`` < 1, an unknown
    ``inner_type``) raises ``ValueError``; a negative ``resync_timeout``
    waits without limit, as in the JAX package.
    """

    def __init__(self, comm=None, *, nblocks: int | None = None,
                 max_stale: int | None = None,
                 inner_type: str | None = None,
                 inner_rtol: float | None = None,
                 inner_max_it: int | None = None,
                 max_outer: int | None = None,
                 resync_timeout: float | None = None,
                 pc_type: str = "jacobi",
                 rtol: float = 1e-5, atol: float = 0.0, dtype=None):
        from .krylov import check_ksp_type
        self.comm = as_comm(comm)
        if self.comm.multiprocess:
            raise NotImplementedError(
                f"MultisplitSolver on a ProcessComm of {self.comm.nprocs} "
                "processes: the supervisor and its block threads run in one "
                "process; the blocks on every rank, driven from one, are "
                "ROADMAP.md Queue A item 7.3")
        opts = global_options()
        if nblocks is None:
            nblocks = opts.get_int("multisplit_blocks", self.comm.size)
        if max_stale is None:
            max_stale = opts.get_int("multisplit_max_stale",
                                     DEFAULT_MAX_STALE)
        if inner_type is None:
            inner_type = opts.get_string("multisplit_inner_type", "cg")
        if inner_rtol is None:
            inner_rtol = opts.get_real("multisplit_inner_rtol",
                                       DEFAULT_INNER_RTOL)
        if inner_max_it is None:
            inner_max_it = opts.get_int("multisplit_inner_max_it",
                                        DEFAULT_INNER_MAX_IT)
        if max_outer is None:
            max_outer = opts.get_int("multisplit_max_outer",
                                     DEFAULT_MAX_OUTER)
        if resync_timeout is None:
            resync_timeout = opts.get_real("multisplit_resync_timeout",
                                           DEFAULT_RESYNC_TIMEOUT)
        self.nblocks = _at_least("blocks", int(nblocks), 1)
        self.max_stale = _at_least("max_stale", int(max_stale), 0)
        self.inner_type = check_ksp_type(str(inner_type))
        self.inner_rtol = float(inner_rtol)
        self.inner_max_it = _at_least("inner_max_it", int(inner_max_it), 1)
        self.max_outer = _at_least("max_outer", int(max_outer), 1)
        self.resync_timeout = float(resync_timeout)   # < 0: no limit
        self.pc_type = pc_type
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.dtype = dtype
        self.n = 0
        self._A = None                 # host scipy CSR (set_operator)
        self._A_full = None            # residual-mesh Mat (cut checks)
        self._residual_prog = None
        self._residual_comm = None     # all ids, shrunk on a loss
        self._b_dev = None             # placed rhs of the CURRENT solve
        self._x0 = None                # the CURRENT solve's initial guess
        self._blocks: list[_BlockState] = []
        self._exchange: StaleExchange | None = None
        self._stop = threading.Event()
        self._worker_error = None

    # ---- operator -----------------------------------------------------------
    def set_operator(self, A):
        """A scipy sparse matrix, a dense array, or a port :class:`Mat`
        (fetched back to host CSR: the two-stage splitting is a host
        restructuring, like PETSc's PCASM subdomain extraction)."""
        import scipy.sparse as sp
        if hasattr(A, "to_scipy"):
            A = A.to_scipy()
        A = sp.csr_matrix(A)
        if A.shape[0] != A.shape[1]:
            raise ValueError(f"multisplit needs a square operator, "
                             f"got {A.shape}")
        self.n = int(A.shape[0])
        self._A = A
        self._A_full = None
        self._residual_prog = None
        self._residual_comm = self.comm
        count, displ = row_partition(self.n, self.nblocks)
        self._blocks = []
        ids = self.comm.device_ids
        for i in range(self.nblocks):
            st = _BlockState(i, int(displ[i]), int(displ[i] + count[i]))
            rows = slice(st.rstart, st.rend)
            st.A_diag = sp.csr_matrix(A[rows, rows])
            off = sp.lil_matrix(A[rows, :])
            off[:, rows] = 0            # own-block coupling lives in A_ii
            st.A_off = sp.csr_matrix(off)
            self._place_block(st, ids[i % len(ids)])
            self._blocks.append(st)
        return self

    set_operators = set_operator       # the KSP surface's spelling

    def _mat_dtype(self):
        return torch_dtype(self._A.dtype if self.dtype is None
                           else self.dtype)

    def _place_block(self, st: _BlockState, device_id: int):
        """(Re-)build a block's residency: its one-shard comm under
        ``device_id``, the diagonal block and its inner KSP, the recipe the
        ``device.lost`` re-home replays on a surviving id."""
        from .ksp import KSP
        st.device_id = int(device_id)
        st.comm = DeviceComm(1, device=self.comm.device,
                             device_ids=(st.device_id,))
        st.mat = Mat.from_scipy(st.comm, st.A_diag, dtype=self._mat_dtype())
        ksp = KSP().create(st.comm)
        ksp.set_operators(st.mat)
        ksp.set_type(self.inner_type)
        ksp.get_pc().set_type(self.pc_type)
        ksp.set_tolerances(rtol=self.inner_rtol, max_it=self.inner_max_it)
        ksp.set_initial_guess_nonzero(True)   # warm-started outer steps
        ksp.megasolve = False                 # no graph capture (docstring)
        st.ksp = ksp

    # ---- solve --------------------------------------------------------------
    def solve(self, b, x0=None, *, rtol=None, atol=None,
              max_stale=None) -> MultisplitResult:
        """Run the asynchronous outer iteration until the consistent-cut
        residual meets ``max(rtol ||b||, atol)`` or every block reaches
        ``-multisplit_max_outer`` steps. ``max_stale`` overrides the
        staleness bound for THIS solve (the server's QoS-urgent tightening,
        ``-multisplit_urgent_stale``); a negative one raises."""
        if self._A is None:
            raise RuntimeError("set_operator first")
        rtol = self.rtol if rtol is None else float(rtol)
        atol = self.atol if atol is None else float(atol)
        bound = (self.max_stale if max_stale is None
                 else _at_least("max_stale", int(max_stale), 0))
        b = np.asarray(b, dtype=self._blocks[0].A_diag.dtype).ravel()
        if b.shape[0] != self.n:
            raise ValueError(f"rhs length {b.shape[0]} != n {self.n}")
        bnorm = float(np.linalg.norm(b))
        target = max(rtol * bnorm, atol)
        x0 = (np.zeros_like(b) if x0 is None
              else np.asarray(x0, dtype=b.dtype).ravel())
        if x0.shape[0] != self.n:
            raise ValueError(f"x0 length {x0.shape[0]} != n {self.n}")
        # every block's version 0: what a neighbour that has not published
        # yet is read as (the JAX package reads it as zero, which undoes a
        # warm start in each block's first step)
        self._x0 = x0.copy()
        # the history ring covers the staleness the bound tolerates, so the
        # consistent cut stays reconstructible (parallel/exchange.py)
        self._exchange = StaleExchange(self.nblocks, history=bound + 4)
        self._stop.clear()
        self._worker_error = None
        self._b_dev = None
        for st in self._blocks:
            st.b_local = b[st.rstart:st.rend].copy()
            st.x = x0[st.rstart:st.rend].copy()
            st.version = 0
            st.steps = 0
            st.resyncs = 0
            st.lost_count = 0
            st.max_age = 0
        t0 = time.monotonic()
        with _telemetry.span("multisplit.solve", blocks=self.nblocks,
                             n=self.n, max_stale=bound,
                             inner=self.inner_type) as sp:
            threads = [threading.Thread(target=self._block_worker,
                                        args=(st, bound),
                                        name=f"multisplit-b{st.index}",
                                        daemon=True)
                       for st in self._blocks]
            for t in threads:
                t.start()
            try:
                result = self._supervise(b, target, threads, t0, rtol)
            finally:
                # the workers are parked before this thread may raise: a
                # worker still launching at interpreter teardown would
                # outlive the process's CUDA context
                self._stop.set()
                for t in threads:
                    t.join()
            if self._worker_error is not None:
                raise self._worker_error
            sp.set_attrs(reason=ConvergedReason.name(result.reason),
                         cut=result.cut_version, resyncs=result.resyncs,
                         blocks_lost=result.blocks_lost)
        return result

    # Convergence is declared only through consistent_cut(), never on a
    # block's stale reads.
    def _supervise(self, b, target, threads, t0, rtol) -> MultisplitResult:
        exch = self._exchange
        history = []
        last_cut = 0
        rnorm = float("inf")
        reason = ConvergedReason.ITERATING
        while True:
            cut = exch.consistent_cut()
            if cut is not None and cut[0] > last_cut:
                last_cut, payloads = cut
                x_full = self._assemble_cut(payloads)
                rnorm = self._residual_norm(b, x_full)
                history.append((last_cut, rnorm))
                if rnorm <= target:
                    reason = (ConvergedReason.CONVERGED_RTOL
                              if rnorm <= rtol * max(
                                  float(np.linalg.norm(b)), 1e-300)
                              else ConvergedReason.CONVERGED_ATOL)
                    break
            if self._worker_error is not None:
                break
            if not any(t.is_alive() for t in threads):
                # every block spent its outer budget (or died): one last
                # cut check, then divergence
                cut = exch.consistent_cut()
                if cut is not None and cut[0] > last_cut:
                    continue
                reason = ConvergedReason.DIVERGED_MAX_IT
                break
            exch.wait_change(timeout=0.01)
        x = self._final_iterate(last_cut)
        return MultisplitResult(
            x=x, iterations=last_cut, residual_norm=rnorm,
            reason=reason, wall_time=time.monotonic() - t0,
            history=history,
            resyncs=sum(st.resyncs for st in self._blocks),
            blocks_lost=sum(st.lost_count for st in self._blocks),
            block_steps=tuple(st.steps for st in self._blocks),
            cut_version=last_cut,
            max_stale_seen=max(st.max_age for st in self._blocks))

    def _final_iterate(self, cut_version):
        """The iterate at the LAST verified cut when there is one, else the
        freshest per-block iterates (the diverged report)."""
        exch = self._exchange
        cut = exch.consistent_cut()
        if cut is not None and cut[0] >= cut_version and cut_version > 0:
            return self._assemble_cut(cut[1])
        x = np.zeros(self.n, dtype=self._blocks[0].b_local.dtype)
        for st in self._blocks:
            r = exch.latest(st.index)
            x[st.rstart:st.rend] = (r.payload if r.payload is not None
                                    else st.x)
        return x

    def _assemble_cut(self, payloads) -> np.ndarray:
        x = np.zeros(self.n, dtype=self._blocks[0].b_local.dtype)
        for st in self._blocks:
            x[st.rstart:st.rend] = payloads[st.index]
        return x

    def _residual_norm(self, b, x_full) -> float:
        """The true residual at a consistent cut: one program, one psum, in
        the operator's dtype (fp64 for an fp64 operator). It runs on every
        id; when that mesh holds a LOST id, the check moves onto the
        surviving ids (the shrink the block workers make too) and retries
        once."""
        for attempt in (0, 1):
            try:
                comm = self._residual_comm
                if self._A_full is None:
                    self._A_full = Mat.from_scipy(comm, self._A,
                                                  dtype=self._mat_dtype())
                    self._residual_prog = build_multisplit_residual_program(
                        comm, self._A_full)
                    self._b_dev = None
                shape = (comm.local_shards, comm.local_size(self.n))
                dt = self._A_full.dtype
                if self._b_dev is None:
                    self._b_dev = comm.put_rows(b, dt).view(shape)
                x_dev = comm.put_rows(x_full, dt).view(shape)
                out = self._residual_prog(self._b_dev, x_dev)
                _telemetry.record_program_dispatch(RESIDUAL_PROGRAM_KIND)
                return float(np.sqrt(max(0.0, float(out))))
            except (DeviceExecutionError, _faults.XlaRuntimeError):
                lost = _faults.lost_devices()
                if attempt or not lost:
                    raise
                survivors = [d for d in self.comm.device_ids
                             if d not in lost]
                if not survivors:
                    raise
                with _telemetry.span("resilient.shrink",
                                     what="multisplit_residual",
                                     old_devices=comm.size,
                                     new_devices=len(survivors)):
                    self._residual_comm = DeviceComm(
                        len(survivors), device=self.comm.device,
                        device_ids=survivors)
                    self._A_full = None
                    self._residual_prog = None
                    self._b_dev = None
        raise AssertionError("unreachable")

    # ---- block worker -------------------------------------------------------
    def _block_worker(self, st: _BlockState, bound: int):
        exch = self._exchange
        registry = _metrics.registry
        try:
            while not self._stop.is_set() and st.steps < self.max_outer:
                # the comm.delay timing fault: seeded jitter or a sticky
                # slow shard, the straggler the tier absorbs as staleness
                d = _faults.delay_seconds("comm.delay", device=st.device_id)
                if d > 0:
                    time.sleep(d)
                reads = exch.read_all(st.index, st.version)
                for r in reads.values():
                    registry.histogram("multisplit.stale_age").observe(r.age)
                    st.max_age = max(st.max_age, r.age)
                over = check_staleness_bound(reads, bound)
                if over:
                    # partners over the bound force a resync: wait (bounded)
                    # until each is within the bound or marked lost
                    st.resyncs += 1
                    registry.counter("multisplit.resyncs").inc()
                    floor = max(1, st.version - bound)
                    for nb in over:
                        exch.wait_for(nb, floor,
                                      timeout=self.resync_timeout)
                    reads = exch.read_all(st.index, st.version)
                try:
                    self._inner_step(st, reads)
                except (DeviceExecutionError,
                        _faults.XlaRuntimeError) as exc:
                    if not self._block_device_lost(st, exc):
                        self._worker_error = exc
                        return
                    self._rehome(st)
                    continue
                v = exch.publish(st.index, st.x.copy())
                if v is not None:
                    st.version = v
                st.steps += 1
                registry.counter("multisplit.step").inc(
                    label=f"block{st.index}")
        except Exception as exc:  # noqa: BLE001 (solve() raises it)
            self._worker_error = exc
        finally:
            exch.kick()        # wake the supervisor for a last look

    def _inner_step(self, st: _BlockState, reads):
        """One outer step: the stale boundary coupling on the host, then the
        inner solve of ``A_ii x_i = b_i - A_off x_stale`` on the block's
        comm (program kind ``multisplit_block``). A neighbour that has not
        published yet enters at its initial guess, its version 0."""
        x_stale = self._x0.copy()
        for nb, r in reads.items():
            if r.payload is not None:
                o = self._blocks[nb]
                x_stale[o.rstart:o.rend] = r.payload
        x_stale[st.rstart:st.rend] = st.x
        rhs = st.b_local - st.A_off.dot(x_stale)
        # The two-stage forcing term: the inner target is relative to the
        # WARM-START residual ``rhs - A_ii x_i``, not to ||rhs||, which
        # tends to a nonzero constant as the outer iteration converges (an
        # ||rhs||-relative tolerance would floor the outer error at
        # inner_rtol). Contracting the inner residual by inner_rtol each
        # step keeps the iteration a contraction down to the outer target.
        r0 = float(np.linalg.norm(rhs - st.A_diag.dot(st.x)))
        if r0 == 0.0:
            return                     # block already exact for this rhs
        dt = st.mat.dtype
        bvec = Vec.from_global(st.comm, rhs, dtype=dt)
        xvec = Vec.from_global(st.comm, st.x, dtype=dt)
        st.ksp.solve(bvec, xvec, _rtol=0.0, _atol=self.inner_rtol * r0)
        st.x = xvec.to_numpy()[: st.rend - st.rstart].astype(st.x.dtype)

    @staticmethod
    def _block_device_lost(st: _BlockState, exc) -> bool:
        """Is this failure the loss of the block's id (and not a transient
        or other error the solve must surface)?"""
        lost = _faults.lost_devices()
        if st.device_id in lost:
            return True
        dev = _faults.device_from_error(exc)
        return dev is not None and dev in lost

    def _rehome(self, st: _BlockState):
        """Degrade, then re-home, after ``device.lost``: freeze the block at
        its last exchanged version (the survivors iterate against it), build
        it again on a surviving id, restore its iterate FROM the frozen
        version and publish on from that version (``republish``): no version
        returns to 0."""
        exch = self._exchange
        exch.mark_lost(st.index)
        st.lost_count += 1
        _metrics.registry.counter("multisplit.block_lost").inc()
        last = exch.latest(st.index)
        lost_ids = _faults.lost_devices()
        survivors = [d for d in self.comm.device_ids if d not in lost_ids]
        if not survivors:
            raise DeviceExecutionError(
                "multisplit re-home", RuntimeError(
                    "UNAVAILABLE: every device is lost — no survivor "
                    "can adopt the block"))
        with _telemetry.span("resilient.shrink", block=st.index,
                             old_device=st.device_id):
            self._place_block(st, survivors[st.index % len(survivors)])
            if last.payload is not None:
                st.x = np.array(last.payload, dtype=st.x.dtype)
            exch.republish(st.index, st.x.copy())
            st.version = max(st.version, last.version)
