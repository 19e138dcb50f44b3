"""Solve fleet: a replica router in front of N SolveServers.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/fleet.py``. One
:class:`~.server.SolveServer` amortizes dispatch latency; a fleet of them
shards sessions (registered operators) over replicas:

* **Placement** -- :class:`HashRing`: each replica contributes
  ``-fleet_vnodes`` virtual points (stable md5 hashes, never Python's salted
  ``hash()``: placement must survive restarts and match across processes),
  and a session lands on the first point clockwise of its own hash. Adding
  or removing a replica moves only the sessions whose arc changed.
* **Migration** -- :meth:`SolveRouter.migrate`: drain the source replica's
  queue for the session, checkpoint its operator through
  :mod:`..utils.checkpoint` (the elastic format, which encodes no mesh
  size), register it on the destination (``SolveServer.register_session``),
  and replay the submissions that arrived meanwhile. Every held future
  resolves with its replayed result.
* **QoS and autoscale** -- submissions carry their class labels to the
  owner replica's scheduler; :meth:`SolveRouter.autoscale_step` feeds the
  replicas' stats to :class:`~.qos.AutoscalePolicy` and executes its
  decision (span ``fleet.scale``).
* **Heal** -- :meth:`SolveRouter.heal_check` asks every degraded replica to
  grow back onto healed shards (``SolveServer.regrow``).

**One card, one lock.** Replicas built by the router (the default factory)
share one session lock: every CUDA call of every replica, and the router's
own checkpoint reads and writes of a migration, run under it, so a fused
session's graph capture on one replica's dispatcher never meets another
replica's CUDA work (torch's ``capture_error_mode="global"``; ROADMAP.md
Queue C). Replicas on one card serialize their device work anyway; rates
against the replica count are comparisons, not scaling.

**Across processes.** On a ``ProcessComm`` of several processes the
router is built on every rank (the script is SPMD), and its replicas share
the card lock and the one command stream of the process
(``parallel/control.py``), each command tagged by its server. Routing,
migration with the held queue, autoscale and :meth:`SolveRouter.
heal_check` run on rank 0; a migration's checkpoint is written there (host
data: the operator's CSR) and its reload, registration and departure are
one command the router runs on every rank, as are a replica's arrival and
departure. A router with a ``server_factory`` of its own (the
:class:`~.remote.FleetManager`'s stubs) drives its replicas from rank 0
alone: their device work is their hosts' commands.

A stencil session cannot migrate: the checkpoint needs ``to_scipy``, which
``StencilPoisson3D`` lacks in both packages, so its ``migrate`` fails, rolls
back and keeps serving on the source, as the JAX package's does.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import tempfile
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..parallel import mesh as _mesh
from ..parallel.control import Mailbox, stream_for
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _telemetry
from ..utils.options import global_options
from ..utils.profiling import record_migration
from . import qos as _qos
from .server import SolveServer

__all__ = ["HashRing", "SolveRouter"]


def _stable_hash(key: str) -> int:
    """64-bit stable hash: placement must be identical across processes and
    restarts (Python's builtin ``hash`` is salted per process)."""
    return int.from_bytes(
        hashlib.md5(key.encode("utf-8")).digest()[:8], "big")


def _comm_or_default(comm):
    """``comm`` as a communicator, or the default one when ``comm`` is None
    and one was set (the default is not built here); None otherwise."""
    c = comm if comm is not None else _mesh._default_comm
    return None if c is None else _mesh.as_comm(c)


class HashRing:
    """Consistent-hash ring over replica names (pure).

    ``vnodes`` virtual points a replica smooth the arcs; a lookup is a
    binary search over the sorted points. A membership change re-places
    only the keys whose owning arc it touched."""

    def __init__(self, replicas=(), vnodes: int = 64):
        self.vnodes = max(1, int(vnodes))
        self._points: list[tuple[int, str]] = []
        self._replicas: set[str] = set()
        for r in replicas:
            self.add(r)

    def add(self, replica: str):
        if replica in self._replicas:
            raise ValueError(f"replica {replica!r} already on the ring")
        self._replicas.add(replica)
        for v in range(self.vnodes):
            self._points.append((_stable_hash(f"{replica}#{v}"), replica))
        self._points.sort()
        return self

    def remove(self, replica: str):
        if replica not in self._replicas:
            raise ValueError(f"replica {replica!r} not on the ring")
        self._replicas.discard(replica)
        self._points = [p for p in self._points if p[1] != replica]
        return self

    def replicas(self):
        return sorted(self._replicas)

    def owner(self, key: str) -> str:
        """The replica owning ``key``: the first ring point clockwise of
        the key's hash (wrapping)."""
        if not self._points:
            raise ValueError("empty hash ring (no replicas)")
        h = _stable_hash(str(key))
        i = bisect.bisect_right(self._points, (h, "￿"))
        if i >= len(self._points):
            i = 0
        return self._points[i][1]

    def __len__(self):
        return len(self._replicas)


class SolveRouter:
    """Shard solve sessions across N server replicas (module docstring; JAX
    ``fleet.py:116``).

    ``replicas`` (``-fleet_replicas``) is the initial replica count,
    ``vnodes`` (``-fleet_vnodes``) the ring points a replica; the options
    database wins, and a value below 1 raises. ``server_factory`` is a
    zero-argument callable building one replica (default
    ``SolveServer(comm, session_lock=<the router's>, **server_kw)``);
    ``autoscale`` an :class:`~.qos.AutoscalePolicy` (default: the
    ``-autoscale_*`` flags), whose decisions execute only through
    :meth:`autoscale_step`."""

    def __init__(self, replicas: int | None = None, comm=None, *,
                 vnodes: int | None = None, server_factory=None,
                 autoscale: _qos.AutoscalePolicy | None = None,
                 **server_kw):
        opt = global_options()
        n = opt.get_int("fleet_replicas",
                        2 if replicas is None else int(replicas))
        self.vnodes = opt.get_int("fleet_vnodes",
                                  64 if vnodes is None else int(vnodes))
        if n < 1 or self.vnodes < 1:
            raise ValueError(f"SolveRouter: {n} replicas and {self.vnodes} "
                             "vnodes; each must be at least 1")
        # the replicas' shared session lock (module docstring); across
        # processes the command stream's, and a router of local replicas
        # joins the stream for its membership changes and migrations
        c = _comm_or_default(comm)
        self._stream = stream_for(c)
        self.card_lock = self._stream.lock
        self._tag = None
        self._mailbox = Mailbox()
        if self._stream.multiprocess and server_factory is None:
            self._tag = self._stream.attach(self, c)
        self._factory = (server_factory or (lambda: SolveServer(
            comm, session_lock=self.card_lock, **server_kw)))
        self.autoscale = autoscale or _qos.AutoscalePolicy.from_options()
        self._lock = threading.RLock()
        # serializes session moves and membership changes against each
        # other while the router lock stays free during a move's heavy
        # steps. Order: _move_lock before _lock, never the reverse.
        self._move_lock = threading.Lock()
        self._replicas: dict[str, SolveServer] = {}
        self._ring = HashRing(vnodes=self.vnodes)
        self._serial = 0
        # op -> dict(operator=..., kwargs=...): the registration spec a
        # migration replays on the destination replica
        self._ops: dict[str, dict] = {}
        # op -> replica name: where the session actually lives (the
        # routing table). The ring and its overrides only express the
        # desired placement, so a failed move leaves routing truthful.
        self._placement: dict[str, str] = {}
        # autoscale rebalance overrides: op -> replica name, consulted
        # before the ring for the desired placement
        self._overrides: dict[str, str] = {}
        self._migrating: set[str] = set()
        self._held: dict[str, list] = {}
        self._closed = False
        for _ in range(n):
            self._add_replica_cmd()

    # ---- replica membership -------------------------------------------------
    def _new_name(self) -> str:
        name = f"r{self._serial}"
        self._serial += 1
        return name

    def _everywhere(self, method: str, *args):
        """Run ``method`` on every rank's router (a command of the stream)
        when the router drives local replicas across processes; here
        otherwise."""
        if self._tag is None:
            return getattr(self, method)(*args)
        return self._stream.call(self._tag, method, *args)

    def _add_replica_locked(self) -> str:
        return self._everywhere("_add_replica_cmd")

    def _add_replica_cmd(self) -> str:
        with self._lock:
            name = self._new_name()
            self._replicas[name] = self._factory()
            self._ring.add(name)
            _metrics.registry.gauge("fleet.replicas").set(
                len(self._replicas))
            return name

    def replicas(self):
        with self._lock:
            return self._ring.replicas()

    def replica(self, name: str) -> SolveServer:
        with self._lock:
            return self._replicas[name]

    def owner(self, op: str) -> str:
        """The replica actually serving ``op`` (the placement table)."""
        with self._lock:
            if op not in self._ops:
                raise ValueError(f"unknown operator {op!r}; registered: "
                                 f"{sorted(self._ops)}")
            return self._placement[op]

    def _desired(self, op: str) -> str:
        """Where the ring and the overrides say ``op`` should live (lock
        held)."""
        return self._overrides.get(op) or self._ring.owner(op)

    def _reconcile_locked(self):
        """Move every session whose placement differs from its desired
        placement (lock held). A move's failure is raised after the other
        sessions were tried; placement stays truthful either way."""
        errors = []
        for op in sorted(self._ops):
            dst = self._desired(op)
            src = self._placement[op]
            if src == dst:
                continue
            try:
                self._move_session(op, src, dst)
            except Exception as exc:  # noqa: BLE001 (collected, re-raised)
                errors.append((op, exc))
        if errors:
            raise RuntimeError(
                f"fleet reconcile: {len(errors)} session move(s) failed "
                f"({', '.join(op for op, _ in errors)}); routing remains "
                "on the source replicas") from errors[0][1]

    def add_replica(self) -> str:
        """Grow the fleet by one replica; the sessions whose arc it took
        over migrate to it (the consistent-hash minimum)."""
        with self._move_lock:
            with self._lock:
                name = self._add_replica_locked()
                self._reconcile_locked()
                return name

    def remove_replica(self, name: str):
        """Drain one replica out of the fleet: its sessions migrate to their
        new ring owners, then it shuts down. A failed move aborts the
        removal (ring membership restored), every session still routed
        where it lives."""
        with self._move_lock:
            with self._lock:
                if len(self._replicas) <= 1:
                    raise ValueError("cannot remove the last replica")
                srv = self._replicas[name]   # KeyError: unknown replica
                saved_overrides = dict(self._overrides)
                self._everywhere("_ring_cmd", "remove", name)
                # overrides pinned to the leaving replica fall back to the
                # ring
                self._overrides = {op: r
                                   for op, r in self._overrides.items()
                                   if r != name}
                try:
                    self._reconcile_locked()
                except Exception:  # noqa: BLE001 (rolled back, re-raised)
                    self._everywhere("_ring_cmd", "add", name)
                    self._overrides = saved_overrides
                    raise
                self._everywhere("_ring_cmd", "drop", name)
        srv.shutdown(wait=True)

    def _ring_cmd(self, action: str, name: str):
        """A membership step on every rank's router: ring ``add`` or
        ``remove``, or ``drop`` the replica from the table."""
        with self._lock:
            if action == "drop":
                del self._replicas[name]
                _metrics.registry.gauge("fleet.replicas").set(
                    len(self._replicas))
            else:
                getattr(self._ring, action)(name)

    # ---- session registry ---------------------------------------------------
    def register_operator(self, name: str, A, **kw):
        """Register ``name`` on its ring owner; the registration spec is
        kept so that a migration re-registers it elsewhere (same keyword
        arguments, the checkpoint-reloaded operator). Across processes
        every rank calls it with its own ``A``, and rank 0's owner lookup
        and the registration run as one command on every rank."""
        if self._tag is not None:
            if not self._stream.leader:
                return self._mailbox.post_and_wait(name, (A, kw))
            with self._lock:
                self._check_new(name)
                self._mailbox.post(name, (A, kw))
                return self._stream.call(self._tag, "_register_cmd", name,
                                         self._ring.owner(name))
        with self._lock:
            self._check_new(name)
            return self._register_on(name, self._ring.owner(name), A, kw)

    def _check_new(self, name: str):
        if self._closed:
            raise RuntimeError("SolveRouter is shut down")
        if name in self._ops:
            raise ValueError(f"operator {name!r} already registered")

    def _register_cmd(self, name: str, owner: str):
        return self._mailbox.run(
            name, lambda v: self._register_on(name, owner, *v),
            hand_on=not self._stream.leader)

    def _register_on(self, name: str, owner: str, A, kw: dict):
        with self._lock:
            sess = self._replicas[owner].register_operator(name, A, **kw)
            # keep the placed operator (not the caller's raw A): a
            # migration's checkpoint needs the port operator's to_scipy
            self._ops[name] = {"kwargs": dict(kw),
                               "operator": sess.operator}
            self._placement[name] = owner
            return sess

    def operators(self):
        with self._lock:
            return sorted(self._ops)

    # ---- client APIs --------------------------------------------------------
    def submit(self, op: str, b, **kw) -> Future:
        """Route one solve to ``op``'s owner replica (QoS and tolerance
        keywords pass through to ``SolveServer.submit``). While ``op``
        migrates the submission is held and replayed where it lands.
        Across processes rank 0 alone takes requests: another rank raises
        ``ValueError``."""
        if not self._stream.leader:
            raise ValueError(
                f"SolveRouter.submit on rank {self._stream.comm.rank}: rank "
                "0 takes the requests of a fleet across processes")
        with self._lock:
            if self._closed:
                raise RuntimeError("SolveRouter is shut down")
            owner = self.owner(op)
            if op in self._migrating:
                fut: Future = Future()
                self._held.setdefault(op, []).append((b, dict(kw), fut))
                return fut
            return self._replicas[owner].submit(op, b, **kw)

    def solve(self, op: str, b, *, timeout: float | None = None, **kw):
        """Synchronous client API: submit and wait."""
        return self.submit(op, b, **kw).result(timeout)

    # ---- migration ----------------------------------------------------------
    def migrate(self, op: str, dst: str):
        """Move session ``op`` to replica ``dst`` (drain, checkpoint,
        re-register, replay), pinning an override so that ring lookups keep
        it there. The source drain runs outside the router lock, so arrivals
        for ``op`` are held meanwhile. On failure the override rolls back,
        the session keeps serving on the source, and the held futures are
        replayed there."""
        with self._move_lock:
            self._migrate_impl(op, dst)

    def _migrate_impl(self, op: str, dst: str):
        with self._lock:
            src = self.owner(op)
            if src == dst:
                return
            if dst not in self._replicas:
                raise ValueError(f"unknown replica {dst!r}")
            prev = self._overrides.get(op)
            self._overrides[op] = dst
            self._migrating.add(op)
            src_srv = self._replicas[src]
        moved = False
        try:
            # drain this session's queue with the router lock released:
            # new arrivals for it are held, so its backlog only shrinks
            src_srv.drain_operator(op)
            self._move_session(op, src, dst)
            moved = True
        finally:
            with self._lock:
                self._migrating.discard(op)
                if not moved:
                    if prev is None:
                        self._overrides.pop(op, None)
                    else:
                        self._overrides[op] = prev
                landed = self._replicas[self._placement[op]]
                held = self._held.pop(op, [])
            # replay where the session lives now: every held future resolves
            for b, kw, outer in held:
                try:
                    _chain_future(landed.submit(op, b, **kw), outer)
                except Exception as exc:  # noqa: BLE001 (resolves the future)
                    if outer.set_running_or_notify_cancel():
                        outer.set_exception(exc)

    def _move_session(self, op: str, src: str, dst: str):
        """The migration engine (move lock held; the router lock only for
        the table reads and writes). The destination session is registered
        before the source one departs, so a failure at any step leaves the
        session serving somewhere and ``_placement`` truthful. The
        checkpoint's operator read and its reload onto the destination's
        mesh are CUDA work: each runs under its replica's session lock.
        Across processes the checkpoint is written on rank 0 (the
        operator's host CSR) and its bytes travel with the one command
        that reloads, registers and departs on every rank."""
        from ..utils.checkpoint import save_solve_state_many
        with self._lock:
            src_srv = self._replicas[src]
            spec = self._ops[op]
        t0 = time.perf_counter()
        fd, path = tempfile.mkstemp(suffix=".npz",
                                    prefix=f"tpu_solve_migrate_{op}_")
        os.close(fd)
        try:
            with _telemetry.span("fleet.migrate", op=op, src=src,
                                 dst=dst) as msp:
                # 1. drain this session's queue (idempotent after migrate's)
                src_srv.drain_operator(op)
                # 2. the operator as mesh-portable bytes (a drained session
                # has no live iterate: a zero block keeps the schema)
                mat = spec["operator"]
                n = int(mat.shape[0])
                z = np.zeros((n, 1), dtype=_mesh.numpy_dtype(mat.dtype))
                with src_srv._session_lock:
                    save_solve_state_many(path, mat, z, z, iteration=0)
                if self._tag is None:
                    self._land(op, src, dst, path)
                else:
                    with open(path, "rb") as f:
                        blob = f.read()
                    self._stream.call(self._tag, "_land_cmd", op, src, dst,
                                      blob)
                msp.set_attrs(wall_s=time.perf_counter() - t0)
        finally:
            try:
                os.remove(path)
            except OSError:
                pass
        record_migration(op, src, dst, time.perf_counter() - t0)

    def _land_cmd(self, op: str, src: str, dst: str, blob: bytes):
        """:meth:`_land` from the checkpoint's bytes, on every rank."""
        fd, path = tempfile.mkstemp(suffix=".npz",
                                    prefix=f"tpu_solve_migrate_{op}_")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(blob)
            self._land(op, src, dst, path)
        finally:
            try:
                os.remove(path)
            except OSError:
                pass

    def _land(self, op: str, src: str, dst: str, path: str):
        """Steps 3 and 4 of a move: register on the destination from the
        reloaded operator (the source session is still live), then depart
        the source and flip the placement; a failed departure undoes the
        destination registration, so exactly one live session remains, on
        the source."""
        from ..utils.checkpoint import load_solve_state_many
        with self._lock:
            src_srv, dst_srv = self._replicas[src], self._replicas[dst]
            spec = self._ops[op]
        with dst_srv._session_lock:
            mat2, _X, _B, _it = load_solve_state_many(path, dst_srv.comm)
        dst_srv.register_session(op, mat2, **spec["kwargs"])
        try:
            src_srv.unregister_operator(op)
        except Exception:  # noqa: BLE001 (compensated, re-raised)
            dst_srv.unregister_operator(op)
            raise
        with self._lock:
            spec["operator"] = mat2
            self._placement[op] = dst

    def rehome(self, op: str, dst: str):
        """Flip the placement of ``op`` to ``dst`` after a failover or a
        reconcile (``serving/remote.py``) already registered it there; pins
        an override so that ring lookups keep it there."""
        with self._lock:
            if op not in self._ops:
                raise ValueError(f"unknown operator {op!r}; registered: "
                                 f"{sorted(self._ops)}")
            if dst not in self._replicas:
                raise ValueError(f"unknown replica {dst!r}")
            self._placement[op] = dst
            self._overrides[op] = dst

    # ---- autoscale / heal ---------------------------------------------------
    def autoscale_step(self) -> _qos.ScaleDecision:
        """One policy evaluation and its execution: grow ->
        :meth:`add_replica`, shrink -> :meth:`remove_replica`, rebalance ->
        migrate one session from the busiest replica to the idlest; hold
        executes nothing. Returns the decision."""
        with self._lock:
            stats = {name: srv.stats()
                     for name, srv in self._replicas.items()}
        decision = self.autoscale.decide(stats)
        _metrics.registry.counter("fleet.scale_decisions").inc(
            label=decision.action)
        if decision.action == "hold":
            return decision
        with _telemetry.span("fleet.scale", action=decision.action,
                             reason=decision.reason) as ssp:
            if decision.action == "grow":
                ssp.set_attr("replica", self.add_replica())
            elif decision.action == "shrink":
                self.remove_replica(decision.replica)
                ssp.set_attr("replica", decision.replica)
            elif decision.action == "rebalance":
                busiest, idlest = decision.replica
                moved = None
                with self._lock:
                    for op in sorted(self._ops):
                        if self.owner(op) == busiest:
                            moved = op
                            break
                if moved is not None:
                    self.migrate(moved, idlest)
                ssp.set_attrs(op=moved or "", src=busiest, dst=idlest)
        return decision

    def heal_check(self) -> int:
        """Ask every degraded replica to grow back onto healed shards
        (:meth:`SolveServer.regrow`, which waits out an in-flight dispatch
        on its session lock); returns how many did."""
        with self._lock:
            servers = list(self._replicas.values())
        return sum(1 for srv in servers if srv.regrow())

    # ---- observability / lifecycle ------------------------------------------
    def stats(self) -> dict:
        """The fleet's totals and the per-replica ``stats()`` dicts."""
        with self._lock:
            per = {name: srv.stats()
                   for name, srv in self._replicas.items()}
            placement = {op: self.owner(op) for op in self._ops}
        return {"replicas": len(per),
                "requests": sum(s["requests"] for s in per.values()),
                "batches": sum(s["batches"] for s in per.values()),
                "shed": sum(s["shed"] for s in per.values()),
                "rejected": sum(s["rejected"] for s in per.values()),
                "mesh_shrinks": sum(len(s["mesh_shrinks"])
                                    for s in per.values()),
                "mesh_regrows": sum(len(s["mesh_regrows"])
                                    for s in per.values()),
                "placement": placement,
                "per_replica": per}

    def drain(self, timeout: float | None = None) -> bool:
        """Block until every replica's queue flushed; False on timeout."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            servers = list(self._replicas.values())
        for srv in servers:
            rem = (None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
            if not srv.drain(rem):
                return False
        return True

    def shutdown(self, wait: bool = True):
        """Shut every replica down (``wait`` as in
        :meth:`SolveServer.shutdown`). Across processes rank 0's call ends
        the replicas and the router on every rank, and another rank's call
        waits for that."""
        if self._tag is not None and not self._stream.leader:
            self._stream.wait_closed(self._tag)
            return
        with self._lock:
            self._closed = True
            servers = list(self._replicas.values())
        for srv in servers:
            srv.shutdown(wait=wait)
        if self._tag is not None:
            self._stream.close(self._tag)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(wait=exc == (None, None, None))
        return False

    def __repr__(self):
        with self._lock:
            return (f"SolveRouter(replicas={self._ring.replicas()}, "
                    f"ops={sorted(self._ops)})")


def _chain_future(inner: Future, outer: Future):
    """Resolve ``outer`` with what ``inner`` resolves to (the replay bridge
    of submissions held across a migration)."""
    def _done(f: Future):
        if f.cancelled():
            outer.cancel()
            return
        if not outer.set_running_or_notify_cancel():
            return
        exc = f.exception()
        if exc is not None:
            outer.set_exception(exc)
        else:
            outer.set_result(f.result())
    inner.add_done_callback(_done)
