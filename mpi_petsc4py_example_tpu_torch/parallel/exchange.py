"""Stale-tolerant boundary exchange for asynchronous multisplitting.

The port's own copy of ``mpi_petsc4py_example_tpu/parallel/exchange.py``
(``StaleExchange`` :102, ``check_staleness_bound`` :69): the same versioned
slots, aged reads, consistent cut, loss marking and re-home, so the
asynchronous outer iteration of ``solvers/multisplit.py`` behaves as the
JAX package's. The synchronous plans (classic/pipecg/s-step) stall the
whole mesh on its slowest shard at every reduction; the asynchronous tier
replaces those collectives with this buffer. Each block PUBLISHES its
iterate under a monotonically increasing per-block version, and neighbours
READ whatever version is there: **reads never block**, and every read
carries a staleness ``age`` (how many versions behind the reader the slot
is).

* :meth:`StaleExchange.publish` version-stamps and stores a block's
  iterate, keeping a bounded history ring so that a *consistent cut* (all
  blocks at one matching version) stays reconstructible. The publish is the
  ``exchange.put`` fault point (``resilience/faults.py``): ``drop``
  discards one publish (readers keep the previous version, staleness grows
  by one), ``partition`` with ``device=D:times=*`` discards every publish
  from block D while armed (a partitioned peer).
* :meth:`StaleExchange.read` is a non-blocking versioned read. It never
  returns fresher-than-published data and never waits for it; the caller
  polices the age (:func:`check_staleness_bound`).
* :meth:`StaleExchange.consistent_cut` is the only basis on which
  multisplit convergence may be declared: the largest version every live
  block has published, with each block's payload *at exactly that version*
  from the history ring. Stale local norms can undershoot the true
  residual; a matching cut cannot.
* :meth:`StaleExchange.mark_lost` freezes a block whose device died: its
  last exchanged payload serves every read and cut until the re-home
  republishes it (:meth:`StaleExchange.republish`), so a mid-solve
  ``device.lost`` degrades to one stale block instead of a restart.

Thread model: one writer per block id (the block's own solver thread), any
number of readers. One lock and condition variable guard the slots;
payloads are host numpy arrays, immutable once published (publishers hand
them over and never mutate them after).

This module imports nothing of torch: threading and ``resilience/faults``
only.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, NamedTuple

from ..resilience import faults as _faults


class ExchangeRead(NamedTuple):
    """One non-blocking read: the payload, the version it was published
    under, and its staleness age relative to the reader (0 = the
    neighbor is at least as fresh as the reader; ``reader_version -
    version`` otherwise)."""

    payload: Any
    version: int
    age: int


class StalenessBoundExceeded(RuntimeError):
    """A convergence-path read exceeded ``-multisplit_max_stale`` and the
    caller asked for the raising check (:func:`check_staleness_bound`
    with ``strict=True``)."""


def check_staleness_bound(reads, max_stale: int, *, strict: bool = False):
    """The bounded-staleness check every convergence-feeding read must
    flow through (with :meth:`StaleExchange.consistent_cut`, the sanitizers
    the JAX package's lint rule TPS018 recognizes).

    ``reads`` maps neighbor/block id -> :class:`ExchangeRead` (or is an
    iterable of ``(id, ExchangeRead)``). Returns the tuple of ids whose
    age exceeds ``max_stale`` — empty means every partner is within the
    bound and the iterate may feed a convergence decision. With
    ``strict=True`` an over-bound read raises instead, for call sites
    with no resync path.
    """
    items = reads.items() if hasattr(reads, "items") else reads
    over = tuple(sorted(nb for nb, r in items if r.age > max_stale))
    if over and strict:
        raise StalenessBoundExceeded(
            f"neighbors {list(over)} exceed the staleness bound "
            f"max_stale={max_stale} — resync before trusting this "
            "iterate")
    return over


class _Slot:
    """Per-block publication state: latest version + bounded history."""

    __slots__ = ("version", "history", "lost")

    def __init__(self, history_len: int):
        self.version = 0                       # 0 = nothing published yet
        self.history = deque(maxlen=history_len)   # (version, payload)
        self.lost = False


class StaleExchange:
    """Versioned per-block slots with non-blocking aged reads.

    ``history`` bounds how far back :meth:`consistent_cut` can look —
    it must be at least ``max_stale + 1`` for the cut to stay
    reconstructible under the staleness the supervisor tolerates
    (:class:`solvers.multisplit.MultisplitSolver` sizes it so).
    """

    def __init__(self, nblocks: int, *, history: int = 8):
        if nblocks < 1:
            raise ValueError(f"nblocks must be >= 1, got {nblocks}")
        self.nblocks = int(nblocks)
        self._slots = [_Slot(max(2, int(history)))
                       for _ in range(self.nblocks)]
        self._cv = threading.Condition()
        self.drops = 0          # publishes discarded by injected faults

    # ------------------------------------------------------------- publish
    def publish(self, block: int, payload) -> int | None:
        """Store ``payload`` as block ``block``'s next version and wake
        waiters. Returns the new version, or None when an armed
        ``exchange.put`` fault discarded the publish (the slot keeps
        serving the previous version — staleness grows by one; the
        block's OWN notion of progress still advances, which is exactly
        the async model: work is never lost, only its visibility)."""
        fault = _faults.triggered("exchange.put", device=block)
        with self._cv:
            slot = self._slots[block]
            if slot.lost:
                raise RuntimeError(
                    f"block {block} is marked lost; re-home it via "
                    "republish() instead of publish()")
            if fault is not None and fault.kind in ("drop", "partition"):
                self.drops += 1
                return None
            slot.version += 1
            slot.history.append((slot.version, payload))
            self._cv.notify_all()
            return slot.version

    def republish(self, block: int, payload, *, version: int | None = None):
        """Re-home a LOST block: install ``payload`` (canonically the
        block's last exchanged iterate, handed to the adopting survivor)
        and clear the lost mark so publishing resumes. ``version``
        defaults to the frozen slot's version — the re-homed block
        continues from where the exchange last saw it, never from
        version 0 (the no-restart contract ``MultisplitSolver``'s degrade
        relies on)."""
        with self._cv:
            slot = self._slots[block]
            v = slot.version if version is None else int(version)
            if v < slot.version:
                raise ValueError(
                    f"re-home of block {block} at version {v} would move "
                    f"BACKWARD past the exchanged version {slot.version} "
                    "— survivors must never observe regressed state")
            slot.lost = False
            slot.version = v
            slot.history.append((v, payload))
            self._cv.notify_all()

    # --------------------------------------------------------------- reads
    def read(self, neighbor: int, reader_version: int = 0) -> ExchangeRead:
        """Non-blocking versioned read of ``neighbor``'s latest payload.
        ``reader_version`` is the reader's own version counter; the
        returned age is how many versions the slot trails it (clamped at
        0 — a fresher-than-reader neighbor is age 0). A never-published
        slot returns ``(None, 0, reader_version)``: maximally stale, so
        the bound check naturally forces an initial exchange."""
        with self._cv:
            slot = self._slots[neighbor]
            if not slot.history:
                return ExchangeRead(None, 0, max(0, int(reader_version)))
            version, payload = slot.history[-1]
            age = max(0, int(reader_version) - version)
            return ExchangeRead(payload, version, age)

    def read_all(self, reader: int, reader_version: int = 0) -> dict:
        """Every other block's latest payload, keyed by block id — the
        boundary gather of one async step. Never blocks."""
        return {nb: self.read(nb, reader_version)
                for nb in range(self.nblocks) if nb != reader}

    def latest(self, block: int) -> ExchangeRead:
        """The block's own latest published payload (age 0 by
        definition) — the re-home source after ``device.lost``."""
        return self.read(block, 0)

    def version(self, block: int) -> int:
        with self._cv:
            return self._slots[block].version

    def versions(self) -> tuple:
        """Latest published version of every block, in block order."""
        with self._cv:
            return tuple(s.version for s in self._slots)

    # ------------------------------------------------------------ liveness
    def mark_lost(self, block: int):
        """Freeze the block at its last exchanged version: no further
        publishes, reads and cuts serve the frozen payload."""
        with self._cv:
            self._slots[block].lost = True
            self._cv.notify_all()

    def lost(self) -> frozenset:
        with self._cv:
            return frozenset(i for i, s in enumerate(self._slots)
                             if s.lost)

    def wait_for(self, block: int, version: int,
                 timeout: float | None = None) -> bool:
        """Block until ``block`` has published ``version`` (or is marked
        lost, or ``timeout`` elapses). This is the RESYNC path — the one
        deliberate wait in the async tier, taken only when the
        bounded-staleness supervisor finds a partner over the bound.
        Returns True when the version (or the lost mark — waiting
        further is futile) arrived."""
        deadline = (None if timeout is None
                    else threading.TIMEOUT_MAX if timeout < 0
                    else timeout)
        with self._cv:
            def ready():
                s = self._slots[block]
                return s.version >= version or s.lost
            return self._cv.wait_for(ready, timeout=deadline)

    def wait_change(self, timeout: float | None = None):
        """Park until someone publishes/marks/kicks (or ``timeout``
        elapses) — the supervisor's poll gate. Spurious wakeups are
        fine: callers re-derive state from :meth:`consistent_cut`."""
        with self._cv:
            self._cv.wait(timeout=timeout)

    def kick(self):
        """Wake every waiter without changing state (a worker exiting
        tells the supervisor to take a final look)."""
        with self._cv:
            self._cv.notify_all()

    # ----------------------------------------------------- consistent cut
    def consistent_cut(self):
        """The matching-version cut convergence may be declared on.

        Returns ``(cut_version, payloads)`` where ``cut_version`` is the
        largest version every LIVE block has published and ``payloads``
        maps every block id to its payload *at that exact version* —
        lost blocks contribute their frozen latest instead (their
        staleness is the accepted degradation cost). Returns None when
        no such cut exists: nothing published yet, or some block's
        history ring no longer holds the cut version (the supervisor
        then waits for the next publish rather than declaring
        convergence on mismatched iterates — stale local norms are
        NEVER a convergence basis)."""
        with self._cv:
            live = [(i, s) for i, s in enumerate(self._slots) if not s.lost]
            if not live:
                return None
            cut = min(s.version for _, s in live)
            if cut < 1:
                return None
            payloads = {}
            for i, slot in enumerate(self._slots):
                if slot.lost:
                    if not slot.history:
                        return None
                    payloads[i] = slot.history[-1][1]
                    continue
                for version, payload in slot.history:
                    if version == cut:
                        payloads[i] = payload
                        break
                else:
                    return None        # ring pruned past the cut
            return cut, payloads

    def __repr__(self):
        with self._cv:
            vs = tuple(s.version for s in self._slots)
            lost = tuple(i for i, s in enumerate(self._slots) if s.lost)
        return (f"StaleExchange(nblocks={self.nblocks}, versions={vs}, "
                f"lost={lost or '()'}, drops={self.drops})")
