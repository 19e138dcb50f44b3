"""Message-based RPC transport for the multi-host fleet.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/transport.py``:
the wire underneath the remote replicas of ``serving/remote.py``, so that a
replica can live behind a deterministic in-process loopback (tests, drills)
or another process's localhost socket. Three guarantees, each enforced here:

1. **Every call has a deadline.** :meth:`RpcClient.call` takes a
   ``deadline`` budget (default ``-rpc_deadline_s``) and spends it across its
   send attempts; no call blocks forever.
2. **Retries are idempotent.** Each logical call carries an idempotency key;
   the host keeps a result cache and an in-flight table, so a retried
   ``solve`` whose first delivery ran joins that execution or is served its
   cached outcome: the handler runs once a key, and the client's future
   resolves once.
3. **Failure is typed and injected.** The ``rpc.send`` and ``rpc.recv``
   fault points (``resilience/faults.py``) fire here with their drop / delay
   / duplicate / reorder / partition kinds: ``rpc.send`` on the client before
   the request leaves (``device=`` selects the destination host index),
   ``rpc.recv`` on the host after the handler ran and before the reply
   leaves, the failure that makes duplicates.

**Host data only.** Requests and replies carry host numpy arrays, bytes and
plain Python values; a ``torch.Tensor`` anywhere in a payload raises
``TypeError`` (:func:`_host_only`) on both transports, so no CUDA tensor is
ever pickled onto the wire or handed across hosts by reference.

Two transports share the client and host classes: :class:`LoopbackTransport`
(in-process; ``kill()`` models abrupt host loss: the handler's work
completes, no reply escapes) and :class:`SocketTransport` /
:class:`SocketHostServer` (TCP on ``127.0.0.1`` only, length-prefixed
pickled frames, one request and one reply a connection).

Telemetry: each client call runs under an ``rpc.call`` span (method, host,
attempts); re-sends count into ``rpc.retries``, collapsed duplicate
deliveries into ``rpc.duplicates``, and the call's wall, backoff included,
into the ``rpc.call_seconds`` histogram.
"""

from __future__ import annotations

import pickle
import random
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

import torch

from ..resilience import faults as _faults
from ..telemetry import metrics as _metrics
from ..telemetry import spans as _telemetry
from ..utils.options import global_options

__all__ = [
    "Message",
    "TransportError",
    "TransportUnreachableError",
    "RpcDeadlineError",
    "RpcHost",
    "RpcClient",
    "RetrySchedule",
    "LoopbackTransport",
    "SocketTransport",
    "SocketHostServer",
]


class TransportError(RuntimeError):
    """Base of the transport's failures (never a handler's: handler
    exceptions travel in the reply and re-raise as their own types)."""


class TransportUnreachableError(TransportError):
    """One send attempt could not reach the host, or its reply was lost.
    Retriable: the client re-sends the same idempotency key."""


class RpcDeadlineError(TransportError):
    """The call's deadline ran out across its retry attempts. Carries
    ``method``, ``host``, ``attempts`` and ``deadline``, so that failover
    logic can tell a lost host from a slow handler."""

    def __init__(self, method: str, host: int, attempts: int,
                 deadline: float):
        self.method = str(method)
        self.host = int(host)
        self.attempts = int(attempts)
        self.deadline = float(deadline)
        super().__init__(
            f"RPC DEADLINE_EXCEEDED: {method!r} to host {host} spent its "
            f"{deadline:.3f}s budget over {attempts} attempt(s) — the "
            "host is unreachable or the handler overran the deadline")

    def __reduce__(self):
        return (type(self), (self.method, self.host, self.attempts,
                             self.deadline))


@dataclass
class Message:
    """One wire frame. ``idem`` is the idempotency key (the same across the
    retries of one logical call), ``seq`` the client's send counter (one a
    attempt), ``error`` the handler's exception on a reply."""
    kind: str                   # "request" | "reply"
    method: str
    seq: int = 0
    idem: str = ""
    payload: object = None
    error: object = None
    host: int = -1


def _host_only(obj, where: str):
    """Raise ``TypeError`` if ``obj`` (a payload: dicts, lists, tuples of
    host values) holds a ``torch.Tensor``."""
    if isinstance(obj, torch.Tensor):
        raise TypeError(
            f"RPC {where}: a torch.Tensor ({tuple(obj.shape)}, "
            f"{obj.device}) in the payload; the wire carries host numpy "
            "arrays and bytes only")
    if isinstance(obj, dict):
        for v in obj.values():
            _host_only(v, where)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _host_only(v, where)


def _marshal_exc(exc: Exception):
    """An exception safe to ship in a reply: the original when it survives
    pickling (either transport may cross a process boundary), else a
    ``RuntimeError`` carrying its type name and message."""
    try:
        pickle.loads(pickle.dumps(exc))
        return exc
    except Exception:  # noqa: BLE001 (any pickling failure: the string form)
        return RuntimeError(f"{type(exc).__name__}: {exc}")


class RpcHost:
    """Host-side dispatcher: named handlers behind an idempotency cache.

    ``handlers`` maps a method name to ``callable(payload) -> result``. The
    cache has two tiers: ``_done`` (key -> ``("ok", result)`` or ``("err",
    exc)``) and ``_inflight`` (key -> ``Event``). A duplicate whose original
    still runs waits on the event (at most ``join_timeout`` seconds) and
    returns the original's outcome; one that arrives later is served from
    ``_done``. Either way a key's handler runs once. The cache keeps the
    last ``cache_cap`` keys (FIFO eviction)."""

    def __init__(self, handlers: dict, host_index: int = 0, *,
                 cache_cap: int = 4096, join_timeout: float = 60.0):
        self.handlers = dict(handlers)
        self.host_index = int(host_index)
        self.cache_cap = int(cache_cap)
        self.join_timeout = float(join_timeout)
        self._done = {}
        self._order = []            # FIFO of done keys for eviction
        self._inflight = {}
        self._lock = threading.Lock()
        self.stats = {"calls": 0, "duplicates": 0, "errors": 0}

    def dispatch(self, msg: Message) -> Message:
        """Run, join or replay the request; always returns a reply (a
        handler's exception travels in ``reply.error``)."""
        outcome = self._execute(msg)
        reply = Message(kind="reply", method=msg.method, seq=msg.seq,
                        idem=msg.idem, host=self.host_index)
        if outcome[0] == "ok":
            reply.payload = outcome[1]
        else:
            reply.error = outcome[1]
        return reply

    # ---- exactly-once core -------------------------------------------------

    def _execute(self, msg: Message):
        key = msg.idem
        if key:
            with self._lock:
                if key in self._done:
                    self.stats["duplicates"] += 1
                    _metrics.registry.counter("rpc.duplicates").inc(
                        label=msg.method)
                    return self._done[key]
                ev = self._inflight.get(key)
                if ev is None:
                    self._inflight[key] = threading.Event()
                else:
                    self.stats["duplicates"] += 1
            if ev is not None:
                _metrics.registry.counter("rpc.duplicates").inc(
                    label=msg.method)
                ev.wait(timeout=self.join_timeout)
                with self._lock:
                    done = self._done.get(key)
                if done is not None:
                    return done
                return ("err", TransportUnreachableError(
                    f"duplicate of {msg.method!r} joined an execution "
                    f"that did not finish within {self.join_timeout}s"))
        outcome = self._run(msg)
        if key:
            with self._lock:
                self._done[key] = outcome
                self._order.append(key)
                ev = self._inflight.pop(key, None)
                while len(self._order) > self.cache_cap:
                    self._done.pop(self._order.pop(0), None)
            if ev is not None:
                ev.set()
        return outcome

    def _run(self, msg: Message):
        self.stats["calls"] += 1
        handler = self.handlers.get(msg.method)
        if handler is None:
            self.stats["errors"] += 1
            return ("err", KeyError(
                f"no RPC handler for method {msg.method!r} on host "
                f"{self.host_index}"))
        try:
            out = handler(msg.payload)
            _host_only(out, f"reply to {msg.method!r}")
            return ("ok", out)
        except Exception as e:  # noqa: BLE001 (the reply carries it)
            self.stats["errors"] += 1
            return ("err", _marshal_exc(e))


# ---- transports ------------------------------------------------------------


def _apply_send_fault(host_index: int):
    """Consume an ``rpc.send`` clause for destination ``host_index``: the
    number of deliveries (1, or 2 for ``duplicate``); drop/partition raise
    :class:`TransportUnreachableError`; delay/reorder sleep ``mean=``."""
    fault = _faults.triggered("rpc.send", device=host_index)
    if fault is None:
        return 1
    if fault.kind in ("drop", "partition"):
        raise TransportUnreachableError(
            f"rpc.send {fault.kind}: request to host {host_index} lost")
    if fault.kind in ("delay", "reorder"):
        time.sleep(max(0.0, float(fault.mean)))
        return 1
    if fault.kind == "duplicate":
        return 2
    return 1


def _apply_recv_fault(host_index: int):
    """Consume an ``rpc.recv`` clause on host ``host_index``'s reply path
    (the handler has run): ``"redeliver"`` for duplicate; drop/partition
    raise (the reply is lost after real work); delay/reorder sleep."""
    fault = _faults.triggered("rpc.recv", device=host_index)
    if fault is None:
        return None
    if fault.kind in ("drop", "partition"):
        raise TransportUnreachableError(
            f"rpc.recv {fault.kind}: reply from host {host_index} lost "
            "after the handler ran")
    if fault.kind in ("delay", "reorder"):
        time.sleep(max(0.0, float(fault.mean)))
        return None
    if fault.kind == "duplicate":
        return "redeliver"
    return None


class LoopbackTransport:
    """In-process transport to one :class:`RpcHost`: every injectable
    failure, plus abrupt host death by :meth:`kill`. The dead flag is
    checked at call entry and again before the reply returns, so killing a
    host mid-call means the work happened and the client never hears."""

    def __init__(self, host: RpcHost):
        self._host = host
        self.host_index = host.host_index
        self._dead = False

    def kill(self):
        """Abrupt host loss: every later call, and any reply not yet
        returned, fails with :class:`TransportUnreachableError`."""
        self._dead = True

    def revive(self):
        self._dead = False

    @property
    def dead(self) -> bool:
        return self._dead

    def call_once(self, msg: Message, timeout: float) -> Message:
        """One delivery attempt (dispatch is synchronous here, so
        ``timeout`` only bounds injected delays)."""
        if self._dead:
            raise TransportUnreachableError(
                f"host {self.host_index} is dead")
        deliveries = _apply_send_fault(self.host_index)
        reply = None
        for _ in range(deliveries):
            reply = self._host.dispatch(msg)
        if _apply_recv_fault(self.host_index) == "redeliver":
            reply = self._host.dispatch(msg)
        if self._dead:
            raise TransportUnreachableError(
                f"host {self.host_index} died before replying")
        return reply

    def close(self):
        self.kill()


def _send_frame(sock, obj, timeout: float):
    sock.settimeout(timeout)
    blob = pickle.dumps(obj)
    sock.sendall(struct.pack(">I", len(blob)) + blob)


def _recv_frame(sock, timeout: float):
    sock.settimeout(timeout)
    need = struct.unpack(">I", _recv_exact(sock, 4))[0]
    return pickle.loads(_recv_exact(sock, need))


def _recv_exact(sock, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TransportUnreachableError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


class SocketHostServer:
    """Host side of :class:`SocketTransport`: a TCP listener on
    ``127.0.0.1`` feeding an :class:`RpcHost`, one thread per accepted
    connection (clients connect per call; a frame is a 4-byte big-endian
    length and a pickled :class:`Message`)."""

    def __init__(self, host: RpcHost, *, port: int = 0,
                 frame_timeout: float = 30.0):
        self._host = host
        self.frame_timeout = float(frame_timeout)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("127.0.0.1", int(port)))
        self._sock.listen(32)
        # accept() wakes up every 0.2 s to see close(): closing a socket
        # does not interrupt a thread blocked in accept()
        self._sock.settimeout(0.2)
        self.address = self._sock.getsockname()
        self._closed = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="rpc-host-accept", daemon=True)
        self._thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn, _addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return          # listener closed
            threading.Thread(target=self._serve_one, args=(conn,),
                             daemon=True).start()

    def _serve_one(self, conn):
        try:
            with conn:
                msg = _recv_frame(conn, self.frame_timeout)
                if self._closed:
                    return      # killed mid-call: work done, reply lost
                reply = self._host.dispatch(msg)
                if _apply_recv_fault(self._host.host_index) == "redeliver":
                    reply = self._host.dispatch(msg)
                if self._closed:
                    return
                _send_frame(conn, reply, self.frame_timeout)
        except Exception:  # noqa: BLE001 (drops this connection only; the
            # client's retries are the recovery)
            return

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=5.0)

    kill = close


class SocketTransport:
    """Client side of the localhost TCP transport: a connection a call to
    ``address``, one framed request, one framed reply. ``rpc.send`` faults
    apply here as on loopback (the ``rpc.recv`` ones in
    :class:`SocketHostServer`)."""

    def __init__(self, address, host_index: int = 0):
        self.address = (str(address[0]), int(address[1]))
        self.host_index = int(host_index)
        self._dead = False

    def kill(self):
        self._dead = True

    @property
    def dead(self) -> bool:
        return self._dead

    def call_once(self, msg: Message, timeout: float) -> Message:
        if self._dead:
            raise TransportUnreachableError(
                f"host {self.host_index} is dead")
        deliveries = _apply_send_fault(self.host_index)
        reply = None
        budget = max(0.01, float(timeout))
        for _ in range(deliveries):
            try:
                with socket.create_connection(
                        self.address, timeout=budget) as sock:
                    _send_frame(sock, msg, budget)
                    reply = _recv_frame(sock, budget)
            except (OSError, EOFError, pickle.UnpicklingError) as e:
                raise TransportUnreachableError(
                    f"socket call to host {self.host_index} at "
                    f"{self.address} failed: {e}") from e
        return reply

    def close(self):
        self.kill()


# ---- client ----------------------------------------------------------------


@dataclass
class RetrySchedule:
    """Capped exponential backoff with deterministic jitter: ``base``
    doubles an attempt up to ``cap``, times a factor drawn uniformly from
    [0.5, 1.0] off a PRNG seeded with ``seed``."""
    base: float = 0.02
    cap: float = 0.5
    seed: int = 0
    _rng: random.Random = field(default=None, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int) -> float:
        raw = min(self.cap, self.base * (2.0 ** max(0, attempt - 1)))
        return raw * (0.5 + 0.5 * self._rng.random())


class RpcClient:
    """Deadline-bounded, idempotent-retry client over one transport.

    Defaults come from the options database: ``-rpc_deadline_s`` (a call's
    budget), ``-rpc_retry_max`` (send attempts a call),
    ``-rpc_backoff_base_s`` / ``-rpc_backoff_cap_s`` (the backoff curve);
    each must be positive (``-rpc_backoff_base_s`` may be 0). ``sleep`` is
    injectable so that drills retry at once."""

    def __init__(self, transport, *, deadline: float | None = None,
                 retry_max: int | None = None, seed: int = 0,
                 sleep=time.sleep):
        opt = global_options()
        self.transport = transport
        self.deadline = float(
            opt.get_real("rpc_deadline_s", 30.0)
            if deadline is None else deadline)
        self.retry_max = int(
            opt.get_int("rpc_retry_max", 4)
            if retry_max is None else retry_max)
        self.schedule = RetrySchedule(
            base=opt.get_real("rpc_backoff_base_s", 0.02),
            cap=opt.get_real("rpc_backoff_cap_s", 0.5),
            seed=seed)
        if (self.deadline <= 0 or self.retry_max < 1
                or self.schedule.base < 0 or self.schedule.cap <= 0):
            raise ValueError(
                f"RpcClient: deadline {self.deadline}, retry_max "
                f"{self.retry_max}, backoff base {self.schedule.base} / cap "
                f"{self.schedule.cap}: each must be positive (the base may "
                "be 0)")
        self._sleep = sleep
        self._seq = 0
        self._lock = threading.Lock()
        self.host_index = int(getattr(transport, "host_index", -1))

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _idem(self, method: str, seq: int) -> str:
        return f"c{id(self):x}.{method}.{seq}"

    def call(self, method: str, payload=None, *,
             deadline: float | None = None,
             idem_key: str | None = None):
        """One logical call: up to ``retry_max`` send attempts of one
        idempotency key under one ``deadline`` budget. Raises
        :class:`RpcDeadlineError` when the budget runs out,
        :class:`TransportUnreachableError` when the attempts run out with
        budget left, or the handler's own exception."""
        _host_only(payload, f"request {method!r}")
        budget = self.deadline if deadline is None else float(deadline)
        seq0 = self._next_seq()
        idem = idem_key if idem_key else self._idem(method, seq0)
        t0 = time.perf_counter()
        attempts = 0
        last_exc = None
        with _telemetry.span("rpc.call", method=method,
                             host=self.host_index) as sp:
            while attempts < self.retry_max:
                remaining = budget - (time.perf_counter() - t0)
                if remaining <= 0.0:
                    break
                attempts += 1
                if attempts > 1:
                    _metrics.registry.counter("rpc.retries").inc(
                        label=method)
                msg = Message(kind="request", method=method,
                              seq=self._next_seq(), idem=idem,
                              payload=payload, host=self.host_index)
                try:
                    reply = self.transport.call_once(msg, timeout=remaining)
                except TransportUnreachableError as e:
                    last_exc = e
                    remaining = budget - (time.perf_counter() - t0)
                    if attempts < self.retry_max and remaining > 0.0:
                        self._sleep(min(self.schedule.delay(attempts),
                                        max(0.0, remaining)))
                    continue
                sp.set_attrs(attempts=attempts)
                _metrics.registry.histogram("rpc.call_seconds").observe(
                    time.perf_counter() - t0)
                if reply.error is not None:
                    raise reply.error
                return reply.payload
            sp.set_attrs(attempts=attempts, failed=True)
        _metrics.registry.histogram("rpc.call_seconds").observe(
            time.perf_counter() - t0)
        if time.perf_counter() - t0 >= budget:
            raise RpcDeadlineError(method, self.host_index, attempts,
                                   budget) from last_exc
        raise TransportUnreachableError(
            f"RPC {method!r} to host {self.host_index}: "
            f"{self.retry_max} attempt(s) exhausted "
            f"({last_exc})") from last_exc
