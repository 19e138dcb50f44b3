"""Structured solve telemetry: spans, metrics registry, flight recorder,
trace export.

The port's counterpart of ``mpi_petsc4py_example_tpu/telemetry/``:

* **spans** (:mod:`.spans`): hierarchical, thread-local spans with wall and
  monotonic timestamps and structured attributes, emitted from
  ``KSP.solve``/``solve_many``, ``RefinedKSP``, ``resilient_solve`` (the
  recovery-ladder stages as child spans), ``EPS.solve`` and ``PC.set_up``;
* **metrics registry** (:mod:`.metrics`): typed counters, gauges and
  histograms, written through the ``record_*`` shims of
  ``utils/profiling.py``, with :func:`snapshot` JSON and a Prometheus text
  exporter;
* **flight recorder** (:mod:`.flight`): a bounded ring of recent span trees
  and fault/recovery events, dumped on unrecovered errors and on demand;
* **trace export** (:mod:`.export`): Chrome/Perfetto trace-event JSON.

Every name is registered in :mod:`.names` and validated at run time.

Gating: the metrics registry is always on (host dict updates). Spans, the
flight ring and the trace are armed by :func:`enable` or ``-telemetry``;
disabled, :func:`span` returns the shared no-op. Neither state reads a
tensor, launches a kernel or makes a collective.

Runtime flags (``utils/options.py``): ``-telemetry`` (arm spans and the
ring), ``-telemetry_flight_len N`` (ring length), ``-telemetry_dump
<path>`` (at-exit JSON dump of the metrics snapshot and the ring).

Processes: on a ``ProcessComm`` each process keeps its own registry and
ring. ``-telemetry_dump <path>`` writes ``<path>`` on global rank 0 and
``<path>.rank<r>`` on rank ``r``, so ranks never write one file.
"""

from __future__ import annotations

import atexit
import json

from .export import export_trace, trace_events
from .flight import auto_dump, recorder as flight_recorder
from .metrics import Histogram, percentile, registry
from .names import FLIGHT_FAULT_POINTS, NAMES
from .spans import (NOOP, Span, current_span, disable, enable, enabled,
                    span, start_span)

__all__ = [
    "NAMES", "FLIGHT_FAULT_POINTS", "NOOP", "Span", "Histogram",
    "auto_dump", "configure_from_options", "current_span", "disable",
    "enable", "enabled", "export_trace", "flight_recorder", "percentile",
    "prometheus_text", "registry", "reset", "snapshot", "span",
    "start_span", "trace_events",
]


def snapshot() -> dict:
    """JSON-able snapshot of every registry metric."""
    return registry.snapshot()


def prometheus_text() -> str:
    """The registry in Prometheus text exposition format."""
    return registry.prometheus_text()


def reset():
    """Clear metrics + flight ring (test isolation; spans' enabled flag
    is left as-is — use :func:`disable`)."""
    registry.reset()
    flight_recorder.clear()


_dump_armed = False


def process_rank() -> int:
    """This process's global rank in ``torch.distributed`` (0 outside a
    process group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def dump_path(path: str, rank: int | None = None) -> str:
    """The per-process dump path: ``path`` on rank 0, ``path.rank<r>``
    elsewhere."""
    rank = process_rank() if rank is None else int(rank)
    return path if rank == 0 else f"{path}.rank{rank}"


def _atexit_dump(path: str):
    payload = {"metrics": snapshot(),
               "flight": flight_recorder.entries()}
    with open(dump_path(path), "w") as f:
        json.dump(payload, f, indent=1)


def configure_from_options():
    """Apply the ``-telemetry*`` runtime flags (called from
    ``utils.options.init`` after argv parsing, and safe to call again —
    the PETSc setFromOptions idiom)."""
    global _dump_armed
    from ..utils.options import global_options
    opt = global_options()
    if opt.get_bool("telemetry", False):
        enable()
    flen = opt.get_int("telemetry_flight_len", 0)
    if flen > 0:
        flight_recorder.set_maxlen(flen)
    dump = opt.get_string("telemetry_dump")
    if dump and not _dump_armed:
        _dump_armed = True
        atexit.register(_atexit_dump, dump)
