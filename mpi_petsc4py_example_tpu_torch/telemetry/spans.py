"""Hierarchical spans: context-propagated timing with attributes.

The port's copy of ``mpi_petsc4py_example_tpu/telemetry/spans.py``. A
:class:`Span` is one timed operation with structured attributes; spans
opened while another span is active on the same thread become its children,
so a solve produces a tree::

    ksp.solve {ksp_type, pc, n, devices, precision, ...}
    ├─ ksp.setup
    ├─ ksp.dispatch
    ├─ ksp.fetch
    └─ ksp.verify

Completed root spans go to the flight recorder's ring (and from there to the
trace export). Per-thread stacks make each thread's spans roots of their own
trees; :func:`start_span` makes a detached span, finished explicitly.

The disabled path is free by construction: :func:`span` returns the shared
no-op :data:`NOOP`, with no allocation and no clock read. Armed or not, a
span never touches a tensor: its attributes are host values the solve
already holds, so arming adds no host sync, kernel launch or collective
(``tests/test_torch_telemetry.py`` counts them). Timestamps are dual:
``wall`` (epoch seconds) and ``t0``/``t1`` (``perf_counter``, what
durations and trace ``ts`` use).

A captured CUDA graph replays without running Python: the fused program
(``solvers/megasolve.py``) opens its spans around the replay loop, never
around a capture.
"""

from __future__ import annotations

import itertools
import threading
import time

from .names import name_kind

_ENABLED = False
_ids = itertools.count(1)


class _Stacks(threading.local):
    def __init__(self):
        self.stack = []


_tls = _Stacks()


def enabled() -> bool:
    return _ENABLED


def enable(flight_len: int | None = None):
    """Arm spans + flight recorder (+ optionally resize the ring)."""
    global _ENABLED
    if flight_len is not None:
        from .flight import recorder
        recorder.set_maxlen(int(flight_len))
    _ENABLED = True


def disable():
    global _ENABLED
    _ENABLED = False
    _tls.stack = []


class Span:
    """One timed operation. Use via :func:`span` (context manager) or
    :func:`start_span` (detached, explicit :meth:`end`)."""

    __slots__ = ("name", "span_id", "parent", "attrs", "wall", "t0", "t1",
                 "thread", "children", "_pushed")

    def __init__(self, name: str, parent=None, attrs=None):
        if name_kind(name) != "span":
            raise ValueError(f"telemetry name {name!r} is not registered "
                             "as a span")
        self.name = name
        self.span_id = next(_ids)
        self.parent = parent
        self.attrs = dict(attrs) if attrs else {}
        self.wall = time.time()
        self.t0 = time.perf_counter()
        self.t1 = None
        self.thread = threading.get_ident()
        self.children = []
        self._pushed = False

    # ---- attributes ---------------------------------------------------------
    def set_attr(self, key, value):
        self.attrs[key] = value
        return self

    def set_attrs(self, **kw):
        self.attrs.update(kw)
        return self

    # ---- context-manager protocol -------------------------------------------
    def __enter__(self):
        _tls.stack.append(self)
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False

    # ---- lifecycle ----------------------------------------------------------
    def end(self):
        if self.t1 is not None:
            return self               # idempotent
        self.t1 = time.perf_counter()
        if self._pushed:
            st = _tls.stack
            if st and st[-1] is self:
                st.pop()
            elif self in st:          # unbalanced exit: drop through to it
                del st[st.index(self):]
        if self.parent is not None:
            self.parent.children.append(self)
        else:
            _finish_root(self)
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "wall": self.wall, "t0": self.t0,
                "t1": self.t1 if self.t1 is not None else self.t0,
                "thread": self.thread,
                "attrs": {k: _jsonable(v) for k, v in self.attrs.items()},
                "children": [c.to_dict() for c in self.children]}

    def __repr__(self):
        dur = (f"{(self.t1 - self.t0) * 1e3:.2f}ms"
               if self.t1 is not None else "open")
        return f"Span({self.name}, id={self.span_id}, {dur}, {self.attrs})"


class _NoopSpan:
    """The disabled path: one shared, stateless instance."""

    __slots__ = ()
    name = ""
    span_id = 0
    children = ()
    attrs: dict = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, key, value):
        return self

    def set_attrs(self, **kw):
        return self

    def end(self):
        return self


NOOP = _NoopSpan()


def span(name: str, **attrs):
    """Open a span as a context manager; nests under the current thread's
    active span. Returns the shared no-op when telemetry is disabled."""
    if not _ENABLED:
        return NOOP
    parent = _tls.stack[-1] if _tls.stack else None
    return Span(name, parent=parent, attrs=attrs)


def start_span(name: str, **attrs):
    """A DETACHED span: no parent, not on any stack — finished by an
    explicit :meth:`Span.end`, possibly on another thread (the serving
    per-request span). No-op singleton when disabled."""
    if not _ENABLED:
        return NOOP
    return Span(name, parent=None, attrs=attrs)


def current_span():
    """The active span on this thread (None when none / disabled)."""
    st = _tls.stack
    return st[-1] if st else None


def record_program_dispatch(kind: str, count: int = 1):
    """Count one compiled-program launch (a ``prog(...)`` execute call).

    Two sinks: the always-on metrics counter ``dispatch.programs``
    (labeled by program kind — ksp / ksp_many / megasolve /
    megasolve_many), and — when spans are armed — the ``dispatches``
    attribute of THIS thread's current ROOT span, so every ``ksp.solve``
    / ``serving.dispatch`` tree reports how many launches served the
    request. That per-root attribute is the megasolve acceptance gate's
    measurement: a fused solve must report exactly 1.
    """
    from .metrics import registry
    registry.counter("dispatch.programs").inc(count, label=kind)
    if _ENABLED and _tls.stack:
        root = _tls.stack[0]
        root.attrs["dispatches"] = root.attrs.get("dispatches", 0) + count


def _finish_root(sp: Span):
    if not _ENABLED:
        # a span opened while armed may finish after disable() (e.g. a
        # detached serving.request resolved later on the dispatcher
        # thread) — drop it: the flight ring is only fed while
        # telemetry is enabled (flight.py's contract), and the cfg12
        # off-measurement must see a truly silent path
        return
    # lazy imports: flight/metrics import spans for enabled() — the
    # function-level import breaks the cycle at module-load time
    from .flight import recorder
    from .metrics import registry
    recorder.record_span(sp.to_dict())
    registry.sample()


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    try:                              # numpy scalars and friends
        return v.item()
    except (AttributeError, ValueError):
        return str(v)
