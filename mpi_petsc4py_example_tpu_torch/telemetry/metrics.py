"""Typed metrics registry: counters, gauges, fixed-bucket histograms.

The port's copy of ``mpi_petsc4py_example_tpu/telemetry/metrics.py``. Every
instrument is created by name against :mod:`.names` (an unknown name or a
kind mismatch raises); :meth:`MetricsRegistry.snapshot` returns the whole
state as a JSON-able dict and :meth:`MetricsRegistry.prometheus_text` the
Prometheus text exposition format, both in the JAX package's schema and
spelling (metric names keep the ``tpu_solve_`` prefix, so one scrape
configuration reads either package).

Instruments are host dict and float updates under a lock: no tensor, no
kernel launch, no collective. ``utils/profiling.py`` writes into this
registry through its ``record_*`` shims, and ``log_view`` renders from it.

Histograms carry fixed log-spaced buckets (stable across processes, so a
fleet can sum them) and a bounded reservoir for exact percentiles:
:meth:`Histogram.summary` is the one percentile helper.

On a ``ProcessComm`` each process keeps its own registry.
"""

from __future__ import annotations

import collections
import math
import threading
import time

from .names import NAMES, name_kind

#: fixed histogram buckets (upper bounds, seconds). Log-spaced and
#: STABLE: changing them breaks cross-process aggregation, so add — never
#: reorder — and note the change in README "Observability".
LATENCY_BUCKETS_S = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 0.1, 0.3, 1.0,
                     3.0, 10.0, 30.0, 120.0)
PER_ITER_BUCKETS_S = (1e-7, 3e-7, 1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4,
                      1e-3, 3e-3, 1e-2, 0.1)
QUEUE_WAIT_BUCKETS_S = LATENCY_BUCKETS_S
#: staleness ages are small integers (versions behind the reader), not
#: seconds — integer bucket bounds up to the largest plausible
#: -multisplit_max_stale, then +Inf for runaway staleness
STALE_AGE_BUCKETS = (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 32.0)
#: requests riding one persistent launch are small integers bounded by
#: the slot capacity (-solve_server_max_k), not seconds
REQUESTS_PER_LAUNCH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
                               128.0)

#: default buckets by histogram name (callers may still pass their own)
DEFAULT_BUCKETS = {
    "solve.latency_seconds": LATENCY_BUCKETS_S,
    "solve.per_iter_seconds": PER_ITER_BUCKETS_S,
    "serving.queue_wait_seconds": QUEUE_WAIT_BUCKETS_S,
    "multisplit.stale_age": STALE_AGE_BUCKETS,
    "dispatch.requests_per_launch": REQUESTS_PER_LAUNCH_BUCKETS,
}

#: bounded reservoir size per histogram — the exact-percentile window
#: (the serving layer's old 10000-wait cap, made a registry property)
RESERVOIR_LEN = 10000


class Counter:
    """Monotone float counter with one optional label dimension."""

    kind = "counter"

    def __init__(self, name: str, desc: str = ""):
        self.name = name
        self.desc = desc
        self._lock = threading.Lock()
        self._values: dict = {}     # label (or None) -> float

    def inc(self, value: float = 1.0, label=None):
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment "
                             f"{value!r} (counters are monotone)")
        with self._lock:
            self._values[label] = self._values.get(label, 0.0) + value

    def value(self, label=None) -> float:
        with self._lock:
            return float(self._values.get(label, 0.0))

    def total(self) -> float:
        with self._lock:
            return float(sum(self._values.values()))

    def items(self) -> dict:
        with self._lock:
            return dict(self._values)


class Gauge:
    """Point-in-time value with one optional label dimension."""

    kind = "gauge"

    def __init__(self, name: str, desc: str = ""):
        self.name = name
        self.desc = desc
        self._lock = threading.Lock()
        self._values: dict = {}

    def set(self, value: float, label=None):
        with self._lock:
            self._values[label] = float(value)

    def value(self, label=None) -> float:
        with self._lock:
            return float(self._values.get(label, 0.0))

    def total(self) -> float:
        """Sum over all labels — the single-number aggregate the trace
        counter tracks sample (a labeled-only gauge would otherwise
        read as its 0.0 unlabeled default)."""
        with self._lock:
            return float(sum(self._values.values()))

    def items(self) -> dict:
        with self._lock:
            return dict(self._values)


class Histogram:
    """Fixed-bucket histogram + bounded reservoir for exact percentiles.

    ``buckets`` are inclusive upper bounds; one implicit +Inf bucket
    catches overflow. :meth:`summary` computes mean/max/percentiles from
    the reservoir (exact over the last ``reservoir`` observations — the
    documented approximation window for long-running processes).
    """

    kind = "histogram"

    def __init__(self, name: str, buckets=None, desc: str = "",
                 reservoir: int = RESERVOIR_LEN):
        self.name = name
        self.desc = desc
        self.buckets = tuple(float(b) for b in
                             (buckets or DEFAULT_BUCKETS.get(
                                 name, LATENCY_BUCKETS_S)))
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"histogram {name}: buckets must ascend")
        self._lock = threading.Lock()
        self.counts = [0] * (len(self.buckets) + 1)   # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        # LIFETIME max — an early worst-case spike must survive 10k
        # later fast observations; mean is likewise lifetime sum/count,
        # only the percentiles are reservoir-windowed
        self.max = 0.0
        self._reservoir = collections.deque(maxlen=int(reservoir))

    def observe(self, value: float):
        v = float(value)
        if math.isnan(v):
            return                  # a NaN wall is a bug upstream, not data
        with self._lock:
            i = 0
            for i, b in enumerate(self.buckets):
                if v <= b:
                    break
            else:
                i = len(self.buckets)
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            self.max = max(self.max, v)
            self._reservoir.append(v)

    def reservoir(self) -> list:
        with self._lock:
            return list(self._reservoir)

    def summary(self, percentiles=(50, 99)) -> dict:
        """The shared percentile/stat computation. count/mean/
        max are LIFETIME; percentiles are exact over the reservoir
        window (the last ``reservoir`` observations)."""
        with self._lock:
            vals = sorted(self._reservoir)
            count, total, vmax = self.count, self.sum, self.max
        out = {"count": count,
               "mean": (total / count) if count else 0.0,
               "max": vmax}
        for q in percentiles:
            out[f"p{q}"] = percentile(vals, q)
        return out

    def bucket_counts(self) -> list:
        with self._lock:
            return list(self.counts)


def percentile(sorted_values, q: float) -> float:
    """Nearest-rank-interpolated percentile of an already-sorted list
    (numpy.percentile's default 'linear' method, without numpy — the
    registry stays importable from stdlib-only contexts)."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return float(sorted_values[0])
    pos = (len(sorted_values) - 1) * (float(q) / 100.0)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1.0 - frac)
                 + sorted_values[hi] * frac)


#: samples of counter/gauge totals taken when root spans finish — the
#: bounded time series the Perfetto counter tracks are built from
_SAMPLE_LEN = 2048


class MetricsRegistry:
    """Named instruments, validated against :mod:`.names`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}
        self._samples = collections.deque(maxlen=_SAMPLE_LEN)

    # ---- instrument accessors (create-on-first-use) -------------------------
    def _get(self, name: str, kind: str, factory):
        want = name_kind(name)      # raises on unregistered names
        if want != kind:
            raise ValueError(
                f"telemetry name {name!r} is registered as a {want}, "
                f"not a {kind}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, "counter",
                         lambda: Counter(name, NAMES[name][1]))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, "gauge",
                         lambda: Gauge(name, NAMES[name][1]))

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, "histogram",
                         lambda: Histogram(name, buckets, NAMES[name][1]))

    def metrics(self) -> dict:
        with self._lock:
            return dict(self._metrics)

    def reset(self):
        with self._lock:
            self._metrics.clear()
            self._samples.clear()

    # ---- counter-track sampling (telemetry/export.py) -----------------------
    def sample(self):
        """Record one timestamped sample of every counter total and gauge
        value — called when a root span finishes, so the Perfetto counter
        tracks get one point per top-level operation (bounded deque; a
        per-increment series would be unbounded)."""
        vals = {}
        for name, m in self.metrics().items():
            if m.kind in ("counter", "gauge"):
                vals[name] = m.total()
        self._samples.append((time.perf_counter(), vals))

    def samples(self) -> list:
        with self._lock:
            return list(self._samples)

    # ---- export -------------------------------------------------------------
    def snapshot(self) -> dict:
        """The whole registry as a JSON-able dict (stable schema:
        ``{name: {type, ...}}`` — tests/test_telemetry.py pins it)."""
        out = {}
        for name, m in sorted(self.metrics().items()):
            if m.kind == "counter":
                out[name] = {
                    "type": "counter", "total": m.total(),
                    "values": {_label_key(k): v
                               for k, v in m.items().items()}}
            elif m.kind == "gauge":
                out[name] = {
                    "type": "gauge",
                    "values": {_label_key(k): v
                               for k, v in m.items().items()}}
            else:
                s = m.summary()
                out[name] = {
                    "type": "histogram", "count": s["count"],
                    "sum": m.sum, "mean": s["mean"], "p50": s["p50"],
                    "p99": s["p99"], "max": s["max"],
                    "buckets": [{"le": b, "count": c} for b, c in
                                zip(list(m.buckets) + ["+Inf"],
                                    m.bucket_counts())]}
        return out

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition format (content type
        ``text/plain; version=0.0.4``) — the ``metrics_endpoint()``
        payload."""
        lines = []
        for name, m in sorted(self.metrics().items()):
            pname = "tpu_solve_" + name.replace(".", "_")
            lines.append(f"# HELP {pname} {m.desc}")
            lines.append(f"# TYPE {pname} {m.kind}")
            if m.kind in ("counter", "gauge"):
                for label, v in sorted(m.items().items(),
                                       key=lambda kv: _label_key(kv[0])):
                    lab = ("" if label is None
                           else '{label="%s"}' % _escape(label))
                    lines.append(f"{pname}{lab} {_fmt(v)}")
            else:
                cum = 0
                for b, c in zip(m.buckets, m.bucket_counts()):
                    cum += c
                    lines.append(
                        f'{pname}_bucket{{le="{_fmt(b)}"}} {cum}')
                lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{pname}_sum {_fmt(m.sum)}")
                lines.append(f"{pname}_count {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _label_key(label) -> str:
    return "" if label is None else str(label)


def _escape(label) -> str:
    return str(label).replace("\\", "\\\\").replace('"', '\\"')


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


#: the process-wide registry (utils/profiling shims + all span sites)
registry = MetricsRegistry()
