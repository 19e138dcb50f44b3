"""Flight recorder: a bounded ring of recent span trees and fault events.

The port's copy of ``mpi_petsc4py_example_tpu/telemetry/flight.py``: a
``collections.deque(maxlen=...)`` of the most recent completed root span
trees, fired fault-injection events and recovery-ladder events, so the
autopsy of a failed run needs no re-execution. The ring length is
``-telemetry_flight_len`` (default 256 entries); the ring is fed only while
telemetry is enabled.

Dumps: :meth:`FlightRecorder.dump` on demand (JSON; by default
``<tmpdir>/tpu_solve_flight_<pid>.json``), and :func:`auto_dump`, which the
resilience wrappers call when an error escapes unrecovered.

Fault events arrive through :func:`record_fault`, which
``resilience/faults.py`` calls for every fired clause at every fault point
(``names.FLIGHT_FAULT_POINTS``). The ``fault.count`` counter increments even
while telemetry is disabled, like every registry metric.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time

DEFAULT_FLIGHT_LEN = 256


class FlightRecorder:
    def __init__(self, maxlen: int = DEFAULT_FLIGHT_LEN):
        self._lock = threading.Lock()
        self._entries = collections.deque(maxlen=int(maxlen))
        self.last_dump_path = None

    @property
    def maxlen(self) -> int:
        return self._entries.maxlen

    def set_maxlen(self, n: int):
        """Resize the ring, keeping the newest entries."""
        with self._lock:
            self._entries = collections.deque(self._entries,
                                              maxlen=max(1, int(n)))

    # ---- feeding ------------------------------------------------------------
    def record_span(self, tree: dict):
        with self._lock:
            self._entries.append({"type": "span", "wall": time.time(),
                                  "span": tree})

    def record_event(self, kind: str, **data):
        with self._lock:
            self._entries.append({"type": "event", "kind": str(kind),
                                  "wall": time.time(), "data": data})

    # ---- views --------------------------------------------------------------
    def entries(self) -> list:
        with self._lock:
            return list(self._entries)

    def spans(self) -> list:
        """The recorded root span trees, oldest first."""
        return [e["span"] for e in self.entries() if e["type"] == "span"]

    def events(self, kind: str | None = None) -> list:
        return [e for e in self.entries()
                if e["type"] == "event"
                and (kind is None or e["kind"] == kind)]

    def clear(self):
        with self._lock:
            self._entries.clear()
        self.last_dump_path = None

    # ---- dumping ------------------------------------------------------------
    def dump(self, path: str | None = None, reason: str = "on demand"):
        """Write the ring as JSON; returns the path written."""
        path = path or os.path.join(
            tempfile.gettempdir(), f"tpu_solve_flight_{os.getpid()}.json")
        payload = {"reason": reason, "dumped_at": time.time(),
                   "flight_len": self.maxlen, "pid": os.getpid(),
                   "entries": self.entries()}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)         # atomic, like utils/checkpoint
        self.last_dump_path = path
        return path


recorder = FlightRecorder()


def record_fault(point: str, kind: str, **data):
    """One fired fault (injected or classified-real) at a registered
    fault point. Counter always; ring entry only while telemetry is
    armed. Never raises — a telemetry failure must not mask the fault
    being recorded."""
    from .metrics import registry
    try:
        registry.counter("fault.count").inc(label=point)
        from .spans import enabled
        if enabled():
            recorder.record_event("fault", point=point, fault_kind=kind,
                                  **data)
    # last-resort guard: the fault path is already unwinding a failure;
    # recording it must never replace the real error with a telemetry one
    except Exception:  # noqa: BLE001
        pass


def auto_dump(reason: str):
    """Dump the ring when an error escapes unrecovered (resilience
    wrappers / serving dispatcher). No-op while telemetry is disabled;
    returns the dump path or None."""
    from .spans import enabled
    if not enabled():
        return None
    try:
        return recorder.dump(reason=reason)
    except OSError:
        return None
