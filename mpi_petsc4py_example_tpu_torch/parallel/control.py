"""One leader, one ordered command stream: how the serving layer and the
asynchronous tier drive a ``ProcessComm`` of several processes.

A server's coalescing window is a host clock: two ranks scheduling for
themselves would form different blocks and deadlock in their first
collective. So global rank 0 alone takes requests, coalesces, schedules,
sheds, expires and retries, and holds the futures; every call that touches
the communicator (registering an operator, a block's solve, a migration's
checkpoint reload, a persistent launch, shutdown) reaches every rank as one
command of one ordered stream, which each rank executes in the same order:

* :meth:`CommandStream.call` on rank 0 broadcasts ``(tag, method, args)``
  over the idle group and scatters the command's host rows (each rank only
  its own rows of a right-hand-side block) over the control group
  (``parallel/mesh.py``: gloo groups of their own, never the data group),
  then runs the method here;
* on every other rank one follower thread receives the commands and runs
  each under the stream's lock (the card lock of every server of the
  process);
* every command but a close ends with the ranks agreeing on its outcome
  (``DeviceComm.agree_error``): what it raised on any rank, rank 0 raises
  and reports, so no rank goes on alone after a failure of another. A
  follower drops its own copy of an agreed failure. A follower whose
  stream itself fails (a peer gone, a collective past its timeout) ends
  its process, and the launcher (``run.py``) ends its peers;
* a command that calls another stream method runs it in place on every
  rank (:func:`..parallel.mesh.in_stream`), so a migration's registration
  is one command, not two.

Objects join the stream in the order every rank builds them (the user's
script is SPMD: every rank builds the comm, the servers and the operators,
and calls ``shutdown``), so a tag names the same object on every rank.
:meth:`CommandStream.close` ends an object on every rank; the follower
thread stops with the last. On a ``DeviceComm``, and on a ``ProcessComm`` of
one process, the stream is the identity: :meth:`CommandStream.call` runs
the method, so one code path serves both.

While objects of the stream are open, the script's other ranks make no
collective of their own: the follower thread holds the communicator.
"""

from __future__ import annotations

import os
import sys
import threading

from .mesh import bind_thread, in_stream, stream_scope

__all__ = ["CommandStream", "Mailbox", "stream_for"]


class CommandStream:
    """The ordered command stream of one process (module docstring).
    ``comm`` gives the control group; ``lock`` (an ``RLock``) is the card
    lock every command runs under."""

    def __init__(self, comm, lock=None):
        self.comm = comm
        self.lock = threading.RLock() if lock is None else lock
        self._targets: dict[int, tuple] = {}
        self._closed: dict[int, threading.Event] = {}
        self._serial = 0
        self._cv = threading.Condition()
        self._thread: threading.Thread | None = None
        self._world = None      # the process group of a shared stream

    @property
    def multiprocess(self) -> bool:
        return bool(self.comm is not None and self.comm.multiprocess)

    @property
    def leader(self) -> bool:
        """Global rank 0: the one rank that sends commands."""
        return self.comm is None or self.comm.rank == 0

    def attach(self, obj, comm=None) -> int:
        """Join ``obj`` to the stream (every rank in the same order) and
        return its tag; ``comm`` lays out its commands' rows (default the
        stream's)."""
        with self._cv:
            tag = self._serial
            self._serial += 1
            self._targets[tag] = (obj, comm or self.comm)
            self._closed[tag] = threading.Event()
            self._cv.notify_all()
            if (self.multiprocess and not self.leader
                    and self._thread is None):
                self._thread = threading.Thread(
                    target=self._follow, name="CommandStream-follower",
                    daemon=True)
                self._thread.start()
        return tag

    def call(self, tag: int, method: str, *args, rows=None):
        """Run ``method`` of object ``tag`` with ``args`` on every rank;
        ``rows`` (a host array of rank 0) is scattered, each rank receiving
        its own rows, and passed last. Returns rank 0's result, or raises
        what the command raised on any rank (the agreed outcome). Rank 0
        only, outside a command; inside one, or on a single-process comm,
        it runs here alone."""
        with self.lock:
            if not self.multiprocess or in_stream():
                return self._run(tag, method, args, rows)
            if not self.leader:
                raise RuntimeError(
                    f"CommandStream: rank {self.comm.rank} sent "
                    f"{method!r}; rank 0 alone sends commands")
            comm = self._targets[tag][1]
            comm.bcast_obj((tag, method, args, rows is not None), idle=True)
            if rows is not None:
                comm.scatter_rows(rows)
            if method == "__close__":
                # cannot fail, and a follower's script may end once closed
                return self._run(tag, method, args, rows)
            out = exc = None
            try:
                out = self._run(tag, method, args, rows)
            except Exception as e:  # noqa: BLE001 (agreed, then raised)
                exc = e
            exc = comm.agree_error(exc)
            if exc is not None:
                raise exc
            return out

    def close(self, tag: int):
        """End object ``tag`` on every rank (rank 0's call; a no-op for a
        closed tag)."""
        if tag in self._targets:
            self.call(tag, "__close__")

    def wait_closed(self, tag: int, timeout: float | None = None) -> bool:
        """Block until object ``tag`` was closed here (a follower's
        ``shutdown`` waits for rank 0's)."""
        return self._closed[tag].wait(timeout)

    def _run(self, tag, method, args, rows):
        with stream_scope():
            if method == "__close__":
                with self._cv:
                    self._targets.pop(tag, None)
                self._closed[tag].set()
                return None
            obj = self._targets[tag][0]
            extra = () if rows is None else (rows,)
            return getattr(obj, method)(*args, *extra)

    def _follow(self):
        """A follower rank's thread: receive and run every command, in
        order, until the last object closes."""
        bind_thread(self.comm)
        while True:
            try:
                self._follow_one()
            except Exception as exc:  # noqa: BLE001 (the stream is broken)
                print(f"rank {self.comm.rank}: the command stream failed "
                      f"({type(exc).__name__}: {exc}); ending this rank",
                      file=sys.stderr, flush=True)
                os._exit(1)
            with self._cv:
                if not self._targets:
                    self._thread = None
                    return

    def _follow_one(self):
        """Receive one command, run it and agree on its outcome; raises
        only when the stream itself fails."""
        tag, method, args, has_rows = self.comm.bcast_obj(None, idle=True)
        with self._cv:
            # rank 0 may have built the object first: its command waits for
            # this rank's own construction
            while tag not in self._targets:
                self._cv.wait()
            comm = self._targets[tag][1]
        rows = comm.scatter_rows(None) if has_rows else None
        if method == "__close__":
            with self.lock:
                self._run(tag, method, args, rows)
            return
        exc = None
        with self.lock:
            try:
                self._run(tag, method, args, rows)
            except Exception as e:  # noqa: BLE001 (agreed below)
                exc = e
        if comm.agree_error(exc) is not None and exc is not None:
            print(f"rank {self.comm.rank}: command {method!r} raised "
                  f"{type(exc).__name__}: {exc} (agreed; rank 0 reports it)",
                  file=sys.stderr)


class Mailbox:
    """Where an SPMD call meets rank 0's command: every rank posts its own
    argument under a key (a follower's call then waits for what the
    command made of it), and the command, on every rank, takes this rank's
    argument (waiting for the call when the command came first)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._posted: dict = {}
        self._landed: dict = {}

    def post(self, key, value):
        with self._cv:
            self._posted[key] = value
            self._cv.notify_all()

    def post_and_wait(self, key, value):
        """A follower's call: post, then return what the command made (or
        raise what it raised)."""
        with self._cv:
            self._posted[key] = value
            self._cv.notify_all()
            while key not in self._landed:
                self._cv.wait()
            out = self._landed.pop(key)
        if isinstance(out, BaseException):
            raise out
        return out

    def run(self, key, fn, hand_on: bool):
        """The command's side: ``fn(value)`` of this rank's posted value;
        with ``hand_on`` (a follower) the result, or the error, goes to the
        waiting call too. Raises what ``fn`` raised."""
        with self._cv:
            while key not in self._posted:
                self._cv.wait()
            value = self._posted.pop(key)
        try:
            out = fn(value)
        except Exception as exc:  # noqa: BLE001 (handed on, then raised)
            out = exc
        if hand_on:
            with self._cv:
                self._landed[key] = out
                self._cv.notify_all()
        if isinstance(out, BaseException):
            raise out
        return out


_SHARED: CommandStream | None = None
_SHARED_LOCK = threading.Lock()


def stream_for(comm, lock=None) -> CommandStream:
    """The command stream of ``comm``: the process's one stream on a
    ``ProcessComm`` of several processes (its lock the card lock of every
    server of the process; ``lock`` is then ignored), else an identity
    stream under ``lock``."""
    global _SHARED
    if comm is None or not comm.multiprocess:
        return CommandStream(comm, lock)
    from .mesh import control_group
    import torch.distributed as dist
    with _SHARED_LOCK:
        if _SHARED is None or _SHARED._world is not dist.group.WORLD:
            control_group()
            _SHARED = CommandStream(comm)
            _SHARED._world = dist.group.WORLD
        return _SHARED


def live_targets() -> int:
    """Objects open on this process's shared stream (0 without one)."""
    s = _SHARED
    if s is None:
        return 0
    with s._cv:
        return len(s._targets)
