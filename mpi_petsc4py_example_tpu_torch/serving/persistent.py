"""Persistent serving: the resident multi-request program on the card.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/persistent.py``.
A persistent session owns a resident program, the ``persistent_serve``
variant of the batched fused program (``solvers/megasolve.py``,
``build_megasolve_program_many(..., persistent=True)``): one launch solves
up to Q request slots, each a full fused solve (the true-residual gate
in-program) with per-slot masked independence and per-slot tolerances, so
requests of different coalescer groups share one launch, which a per-batch
dispatch cannot do.

The host side keeps JAX's double buffer. Every batch the dispatcher routes
here is staged into the next launch's slots (host only) and the dispatcher
goes back to its queue; a staged backlog of Q slots turns the buffer over
(resolve the launch in flight, open the next); the dispatcher's idle pass
flushes every outstanding launch, and ``drain``/``shutdown`` count the
staged and riding slots (``unresolved``). A burst of B requests costs
ceil(B / Q) launches. Slot counts are padded to powers of two; a padding
slot has a zero right-hand side and zero tolerances and freezes at outer
step 0. Slots fill in the dispatcher's deadline-weighted batch order.

**The port's launch.** The fused program replays captured CUDA graphs and
reads one flag tensor between replays, so :meth:`_launch_device` runs the
whole solve on the card before it returns; nothing runs beside it, as
JAX's asynchronous dispatch lets launch N+1 run while the host waits on
launch N. So a turnover resolves the launch in flight before it opens the
next (JAX opens first): the order JAX needs for the overlap would only hold
launch N's futures for the whole of launch N+1. The launch's outputs stay on
the card (``MegasolveProgram.launch``) until :meth:`_resolve` reads them in
one copy (iterate, inner iterations, true residual norms, reasons). A
launch without flag reads needs conditional graph nodes (ROADMAP.md Queue
B).

**Resilience.** A fault plan armed (or a lost shard inside the session's
mesh) routes the whole launch through :meth:`_resolve_fallback`: one
``resilient_solve_many`` of the session's fused per-batch program on the
same card, where the ``ksp.program`` boundary fires the fault and the
retry tier recovers; a device loss shrinks the mesh, the server adopts
it, and the next launch builds the persistent program for the surviving
mesh (``stats["rebuilds"]``). A launch that fails takes the same path, and a
fallback that fails resolves every slot's future with the error. A guard
armed after registration (``ksp.abft``, a replacement interval) also sends
launches to the fallback, with one warning a registration.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from ..resilience import faults as _faults
from ..resilience.retry import resilient_solve_many
from ..telemetry import spans as _telemetry
from ..utils.convergence import ConvergedReason
from ..utils.profiling import record_requests_per_launch, record_sync
from .coalescer import padded_width

__all__ = ["PersistentRunner"]


class _Launch:
    """One launch: the staged slots and the program's device outputs (or the
    fallback mark)."""

    __slots__ = ("reqs", "waits", "k", "kpad", "t0", "out", "fallback",
                 "span", "n")

    def __init__(self, reqs, waits, k, kpad, n):
        self.reqs = reqs
        self.waits = waits
        self.k = k
        self.kpad = kpad
        self.n = n
        self.t0 = time.monotonic()
        self.out = None          # MegasolveProgram.launch's outputs
        self.fallback = False    # resolve through resilient_solve_many
        self.span = None


class PersistentRunner:
    """The host half of one persistent session (module docstring; JAX
    ``persistent.py:97``).

    ``enqueue``, ``flush`` and ``quiesce`` run under the server's session
    lock (the dispatcher for the first two, any thread rebuilding the
    mesh for the last), so the staged list and the in-flight launch need no
    lock of their own; resolution notifies the server's condition last (the
    lock order: session lock, then the condition)."""

    def __init__(self, server, sess, capacity: int | None = None):
        self._server = server
        self._sess = sess
        self.capacity = int(capacity or server.max_k)
        self._staged: list = []        # [(SolveRequest, wait_s), ...]
        self._rec: _Launch | None = None
        # requests owed a resolution: up at enqueue, down only after their
        # futures resolved, so a drain never exits while a launch is being
        # opened
        self._live = 0
        # the mesh of the last launch
        self._comm = sess.ksp.get_operators()[0].comm
        self._guard_warned = False
        self.stats = {"launches": 0, "requests": 0, "padded_slots": 0,
                      "fallbacks": 0, "rebuilds": 0, "turnovers": 0}

    # ---- dispatcher entry points -------------------------------------------
    def enqueue(self, reqs, waits):
        """Stage one coalesced batch's slots into the next launch; a
        backlog of ``capacity`` slots turns the buffer over."""
        self._live += len(reqs)
        self._staged.extend(zip(reqs, waits))
        if self._rec is None:
            self._launch()
            return
        while self._rec is not None and len(self._staged) >= self.capacity:
            self.stats["turnovers"] += 1
            self._turn()

    def flush(self):
        """Resolve every outstanding launch and drain the staged backlog:
        the idle pass, ``drain`` and ``shutdown``."""
        while self._rec is not None or self._staged:
            self._turn()

    def quiesce(self):
        """Resolve the in-flight launch without opening the next one (the
        mesh-rebuild hook): staged slots stay staged and launch on the
        rebuilt mesh. Inside this runner's own fallback the record is
        already detached, so this is a no-op there."""
        rec, self._rec = self._rec, None
        if rec is not None:
            self._resolve(rec)

    @property
    def unresolved(self) -> int:
        """Requests whose futures this runner still owes (staged, being
        launched, or riding a launch)."""
        return self._live

    # ---- launch / resolve ---------------------------------------------------
    def _turn(self):
        rec, self._rec = self._rec, None
        if rec is not None:
            # the port's launch N ran to its end when it opened: resolve it
            # before N+1 runs (module docstring)
            self._resolve(rec)
        if self._staged:
            self._launch()

    def _launch(self):
        """Open a launch over the first ``capacity`` staged slots."""
        take = self._staged[: self.capacity]
        del self._staged[: len(take)]
        reqs = [r for r, _w in take]
        waits = [w for _r, w in take]
        k = len(reqs)
        kpad = padded_width(k, self.capacity, self._server.pad_pow2)
        sess = self._sess
        rec = _Launch(reqs, waits, k, kpad, sess.n)
        rec.span = _telemetry.start_span(
            "serving.persistent_launch", op=sess.name, width=k,
            padded=kpad - k)
        record_requests_per_launch(k)
        self.stats["launches"] += 1
        self.stats["requests"] += k
        self.stats["padded_slots"] += kpad - k
        # an armed fault plan (or a lost shard of this session's mesh) goes
        # through the resilient per-batch path, where the ksp.program
        # boundary fires it; a guard armed after registration too (the
        # persistent program has no detectors)
        mesh_devs = set(sess.ksp.get_operators()[0].comm.device_ids)
        guard = (bool(sess.ksp.abft)
                 or int(sess.ksp.residual_replacement) > 0)
        if guard and not self._guard_warned:
            self._guard_warned = True
            warnings.warn(
                f"persistent session {sess.name!r}: the ABFT/"
                "residual-replacement guard was enabled after "
                "registration — launches fall back to per-batch "
                "dispatch (counted in stats['fallbacks']; this warns "
                "once per registration)", stacklevel=2)
        if (guard or _faults.active()
                or (set(_faults.lost_devices()) & mesh_devs)):
            rec.fallback = True
            self._rec = rec
            return
        try:
            rec.out = self._launch_device(rec)
        except Exception:  # noqa: BLE001 (the fallback resolves the slots)
            rec.fallback = True
        self._rec = rec

    def _launch_device(self, rec):
        """Stage the slots and run the persistent program on the session's
        card (JAX ``persistent.py:247``); the outputs stay on the device."""
        from ..solvers.megasolve import (GATE_REFINE_MAX,
                                         build_megasolve_program_many,
                                         megasolve_stencil_supported)
        sess = self._sess
        ksp = sess.ksp
        mat = ksp.get_operators()[0]
        pc = ksp.get_pc()
        comm = mat.comm
        if comm is not self._comm:
            # the session was rebuilt (shrink adoption, regrow): this launch
            # builds the program for the new mesh
            self.stats["rebuilds"] += 1
        self._comm = comm
        sf = (ksp.megasolve_stencil_fastpath
              and megasolve_stencil_supported(ksp.get_type(), pc, mat,
                                              nrhs=rec.kpad))
        prog = build_megasolve_program_many(
            comm, ksp.get_type(), pc, mat, nrhs=rec.kpad,
            sstep_s=ksp.sstep_s, stencil_fastpath=sf, persistent=True)
        from .server import _block
        B = _block(sess, rec.reqs, rec.kpad)
        rt = np.zeros(rec.kpad)
        at = np.zeros(rec.kpad)
        for j, r in enumerate(rec.reqs):
            rt[j] = r.rtol
            at[j] = r.atol
        # padding slots keep rtol = atol = 0 and a zero right-hand side:
        # norm 0, target 0, frozen at outer step 0
        maxit = max((r.max_it for r in rec.reqs), default=1)
        Bd = comm.put_cols(B, mat.dtype)
        _telemetry.record_program_dispatch("persistent_serve")
        return prog.launch(Bd, None, rt, at, rt.copy(), ksp.divtol, maxit,
                           GATE_REFINE_MAX, ConvergedReason.DIVERGED_MAX_IT)

    def _resolve(self, rec):
        """Resolve every slot's future from a launch; a failure goes to the
        fallback. Never raises: the dispatcher and ``drain`` rely on it."""
        try:
            if not rec.fallback:
                try:
                    self._resolve_device(rec)
                    return
                except Exception:  # noqa: BLE001 (the fallback resolves)
                    rec.fallback = True
            self._resolve_fallback(rec)
        finally:
            # every slot's future is resolved now: release the drain
            # count, then wake the waiters
            self._live -= rec.k
            self._notify()

    def _resolve_device(self, rec):
        """The one host read of a launch: its iterate and per-slot results
        in one copy."""
        from .server import ServedSolveResult, SolveServer
        out = rec.out
        x = out["x"]
        L, kp, lsize = x.shape
        xr = torch.view_as_real(x) if x.is_complex() else x
        packed = torch.cat([out["head"].double(), out["cols"].reshape(-1),
                            xr.reshape(-1).double()])
        h = packed.cpu().numpy()
        record_sync("persistent launch", out["host_reads"] + 1)
        wall = time.monotonic() - rec.t0
        iters = h[2:2 + kp].astype(np.int64)
        rnorms = h[2 + kp:2 + 2 * kp]
        reasons = h[2 + 2 * kp:2 + 3 * kp].astype(np.int64)
        reasons[~np.isfinite(rnorms)] = ConvergedReason.DIVERGED_NANORINF
        xs = h[2 + 3 * kp:]
        if x.is_complex():
            xs = xs.reshape(-1, 2) @ np.array([1.0, 1.0j])
        # one row a slot: (L, kp, lsize) -> (kp, L * lsize), padding dropped
        XT = (xs.reshape(L, kp, lsize).transpose(1, 0, 2).reshape(kp, -1)
              [:, : rec.n].astype(self._sess.dtype))
        for j, r in enumerate(rec.reqs):
            res = ServedSolveResult(
                iterations=int(iters[j]),
                residual_norm=float(rnorms[j]),
                reason=int(reasons[j]), wall_time=wall,
                host_syncs=out["host_reads"] + 1,
                x=XT[j], op=r.op, batch_width=rec.k,
                queue_wait=rec.waits[j])
            r.future.set_result(res)
            SolveServer._end_request_span(
                r, "ok", batch=rec.span, iterations=int(iters[j]),
                queue_wait=rec.waits[j])
        rec.span.set_attrs(outcome="ok", width=rec.k).end()

    def _resolve_fallback(self, rec):
        """The recovery path (JAX ``persistent.py:350``): one resilient
        per-batch fused solve of the launch's slots on the same card, at the
        strictest of their tolerances (min rtol/atol, max max_it), so every
        slot is solved at least as accurately as it asked. A device loss
        shrinks the mesh and the server adopts it."""
        from .server import SolveServer, _block
        self.stats["fallbacks"] += 1
        sess = self._sess
        ksp = sess.ksp
        reqs = rec.reqs
        t0 = time.monotonic()
        try:
            ksp.set_tolerances(
                rtol=min(r.rtol for r in reqs),
                atol=min(r.atol for r in reqs),
                max_it=max(r.max_it for r in reqs))
            B = _block(sess, reqs, rec.kpad)
            res = resilient_solve_many(
                ksp, B, policy=self._server.retry_policy)
        except Exception as exc:  # noqa: BLE001 (resolves every slot)
            rec.span.set_attr("error", type(exc).__name__)
            rec.span.set_attrs(outcome="error").end()
            for r in reqs:
                r.future.set_exception(exc)
                SolveServer._end_request_span(r, "error", batch=rec.span)
            return
        shrinks = [e for e in res.recovery_events
                   if e.kind == "mesh_shrink"]
        if shrinks:
            self._server._adopt_shrunk_mesh(sess, shrinks,
                                            time.monotonic() - t0)
        self._server._resolve_block(reqs, res, rec.waits, rec.k, rec.span)
        rec.span.set_attrs(outcome="recovered",
                           attempts=res.attempts).end()

    def _notify(self):
        with self._server._cv:
            self._server._cv.notify_all()
