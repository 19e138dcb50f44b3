"""Chrome/Perfetto trace-event export of the recorded span trees.

The port's copy of ``mpi_petsc4py_example_tpu/telemetry/export.py``:
:func:`export_trace` writes the Trace Event Format JSON
(``{"traceEvents": [...]}``) that chrome://tracing and ui.perfetto.dev load:

* every span is a ``ph: "X"`` (complete) event on a per-thread track,
  ``ts``/``dur`` in microseconds of the process's monotonic clock, its
  attributes as ``args``;
* every counter and gauge sample the registry took (one per completed root
  span) is a ``ph: "C"`` counter track point;
* ``ph: "M"`` metadata events name the process and the threads.

The spans come from the flight recorder's ring, so exporting costs nothing
during a solve. ``utils.profiling.trace`` writes the device side (a
``torch.profiler`` Chrome trace) beside it.
"""

from __future__ import annotations

import json
import os
import threading


def trace_events() -> list:
    """The Trace Event list for the current flight ring + samples."""
    from .flight import recorder
    from .metrics import registry
    pid = os.getpid()
    events = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
               "args": {"name": "tpu-sparse-solve"}}]
    tids = {}

    def tid_of(thread_ident) -> int:
        # compact per-thread track ids (raw idents are unwieldy in the UI)
        if thread_ident not in tids:
            tids[thread_ident] = len(tids) + 1
        return tids[thread_ident]

    def emit(span: dict):
        t0, t1 = float(span["t0"]), float(span["t1"])
        events.append({
            "name": span["name"], "ph": "X", "cat": "solve",
            "ts": t0 * 1e6, "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": pid, "tid": tid_of(span["thread"]),
            "args": dict(span["attrs"], span_id=span["span_id"])})
        for c in span["children"]:
            emit(c)

    for tree in recorder.spans():
        emit(tree)
    main_ident = threading.main_thread().ident
    for ident, tid in tids.items():
        events.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": ("main" if ident == main_ident
                              else f"thread-{ident}")}})
    for ts, vals in registry.samples():
        for name, v in vals.items():
            events.append({"name": name, "ph": "C", "ts": ts * 1e6,
                           "pid": pid, "args": {"value": v}})
    return events


def export_trace(path: str) -> dict:
    """Write (and return) the Chrome/Perfetto trace JSON for the
    recorded spans + counter samples."""
    doc = {"traceEvents": trace_events(), "displayTimeUnit": "ms",
           "otherData": {"producer": "mpi_petsc4py_example_tpu_torch.telemetry"}}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return doc
