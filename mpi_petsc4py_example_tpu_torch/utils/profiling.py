"""Profiling and observability: the solve-event log, ``-log_view``, traces.

The port's counterpart of ``mpi_petsc4py_example_tpu/utils/profiling.py``:

* a solve-event log: every KSP/EPS solve records (solver, n, iterations,
  wall, reason); :func:`log_view` prints the PETSc ``-log_view``-style
  summary, automatically at exit when ``-log_view`` is set (on global rank 0
  only when the process is one rank of a ``ProcessComm``);
* the ``record_*`` shims, which write into the telemetry metrics registry
  (:mod:`..telemetry.metrics`), and ``log_view``, which renders from it, so
  ``telemetry.snapshot()``, the Prometheus text and ``log_view`` never
  disagree; the only state kept here is the per-entry logs ``log_view``
  prints (the solve events, the mesh shrinks and re-grows);
* device tracing: :func:`trace` wraps ``torch.profiler.profile`` (CPU and
  CUDA activities) and writes a Chrome trace into its directory, and
  :func:`annotate` is ``torch.profiler.record_function``.

``record_sync`` counts the host reads the port really makes (a solve's count
equals its result's ``host_syncs``), which differ from the JAX package's
one fetch per solve. ``log_view`` renders every row of the JAX package's:
the serving rows from ``record_serving``, ``record_admission``,
``record_qos`` and ``record_requests_per_launch`` (``serving/``), the
migration row from ``record_migration`` (``serving/fleet.py``); the
kernel-traffic and collective-latency rows stay empty until the port's
benchmark brings their recorders.
"""

from __future__ import annotations

import atexit
import contextlib
import sys
from dataclasses import dataclass

from .options import global_options
from ..telemetry import metrics as _metrics
from ..telemetry import flight as _flight
from ..telemetry import spans as _spans

_REG = _metrics.registry


@dataclass
class SolveEvent:
    what: str          # e.g. "KSPSolve(cg+jacobi)"
    n: int
    iterations: int
    wall: float
    reason: int


_EVENTS: list[SolveEvent] = []
_atexit_armed = False


def record_event(what: str, n: int, iterations: int, wall: float,
                 reason: int):
    global _atexit_armed
    _EVENTS.append(SolveEvent(what, n, iterations, wall, reason))
    _REG.counter("solve.count").inc(label=what)
    _REG.counter("solve.iterations").inc(int(iterations))
    _REG.histogram("solve.latency_seconds").observe(float(wall))
    if iterations > 0 and wall > 0:
        _REG.histogram("solve.per_iter_seconds").observe(
            float(wall) / int(iterations))
    _REG.gauge("solve.programs").set(program_count())
    if not _atexit_armed and global_options().get_bool("log_view", False):
        _atexit_armed = True
        atexit.register(_log_view_at_exit)


def _log_view_at_exit():
    """The ``-log_view`` report at exit, from global rank 0 only."""
    from ..telemetry import process_rank
    if process_rank() == 0:
        log_view()


def record_sdc(checks: int = 0, detections: int = 0, replacements: int = 0):
    """Accumulate silent-error-detection activity for the -log_view row:
    ABFT checksum checks performed, detectors fired, and true-residual
    replacements executed (solvers/ksp.py guarded solves)."""
    if checks:
        _REG.counter("abft.checks").inc(int(checks))
    if detections:
        _REG.counter("abft.detections").inc(int(detections))
    if replacements:
        _REG.counter("abft.replacements").inc(int(replacements))


def sdc_counts() -> dict:
    return {"abft_checks": int(_REG.counter("abft.checks").total()),
            "detections": int(_REG.counter("abft.detections").total()),
            "replacements": int(
                _REG.counter("abft.replacements").total())}


# solve-server coalescing totals (serving/server.py): the process-wide twin
# of SolveServer.stats(); both compute their wait statistics through the
# registry's Histogram.summary
def record_serving(width: int, waits=(), padded: int = 0):
    """Accumulate one dispatched coalesced batch: ``width`` real requests
    (padding excluded), their queue waits in seconds, and the zero columns
    the pow2 padding added."""
    _REG.counter("serving.requests").inc(int(width))
    _REG.counter("serving.batches").inc()
    if padded:
        _REG.counter("serving.padded_cols").inc(int(padded))
    _REG.counter("serving.width").inc(label=int(width))
    h = _REG.histogram("serving.queue_wait_seconds")
    for w in waits:
        h.observe(float(w))


def record_requests_per_launch(width: int):
    """Accumulate one ``persistent_serve`` launch: ``width`` real request
    slots riding it (slot padding excluded), the -log_view
    requests-per-launch row (serving/persistent.py)."""
    _REG.histogram("dispatch.requests_per_launch").observe(float(width))


def record_admission(rejected: int = 0, expired: int = 0, shed: int = 0):
    """Accumulate serving admission-control outcomes: submissions rejected
    by the queue bound, requests expired by their deadline, and requests
    shed (resolved with the typed overload error) to admit more urgent
    traffic (serving/qos.py)."""
    if rejected:
        _REG.counter("serving.rejected").inc(int(rejected))
    if expired:
        _REG.counter("serving.expired").inc(int(expired))
    if shed:
        _REG.counter("serving.shed").inc(int(shed))


def record_qos(qos_class: str):
    """Count one admitted request by its QoS class ('default' for
    unlabeled submissions)."""
    _REG.counter("qos.requests").inc(label=str(qos_class or "default"))


def serving_stats() -> dict:
    """Process-wide coalescing stats: batch-width histogram + queue-wait
    aggregates (per-server percentiles live on SolveServer.stats() —
    same Histogram.summary code path)."""
    h = _REG.histogram("serving.queue_wait_seconds")
    s = h.summary((50, 99))
    requests = int(_REG.counter("serving.requests").total())
    batches = int(_REG.counter("serving.batches").total())
    return {"requests": requests, "batches": batches,
            "padded_cols": int(_REG.counter("serving.padded_cols").total()),
            "width_hist": {int(k): int(v) for k, v in
                           _REG.counter("serving.width").items().items()},
            "wait_sum_s": float(h.sum),
            "wait_max_s": s["max"],
            "mean_width": (requests / batches) if batches else 0.0,
            "wait_mean_s": s["mean"],
            "wait_p50_s": s["p50"],
            "wait_p99_s": s["p99"]}


# elastic degraded-mesh recoveries (resilience/elastic.py + retry.py
# mesh_shrink stage): one entry per executed shrink, printed as a
# -log_view row — losing hardware mid-run is exactly the event an
# operator reading the log needs to see
_MESH_SHRINKS: list[dict] = []


def record_mesh_shrink(old_devices: int, new_devices: int,
                       rebuild_seconds: float):
    """Record one executed degraded-mesh rebuild: the mesh went from
    ``old_devices`` to ``new_devices`` and re-placing operands / PC
    factors / programs took ``rebuild_seconds``."""
    entry = {"old_devices": int(old_devices),
             "new_devices": int(new_devices),
             "rebuild_s": float(rebuild_seconds)}
    _MESH_SHRINKS.append(entry)
    _REG.counter("elastic.mesh_shrinks").inc()
    if _spans.enabled():
        _flight.recorder.record_event("mesh_shrink", **entry)


def mesh_shrinks() -> list[dict]:
    return [dict(e) for e in _MESH_SHRINKS]


# the ladder's upward twin (resilience/elastic.py grown_comm + the
# serving re-grow adoption): one entry per executed re-grow — recovered
# capacity is as operator-relevant as lost capacity
_MESH_REGROWS: list[dict] = []


def record_mesh_regrow(old_devices: int, new_devices: int,
                       rebuild_seconds: float):
    """Record one executed mesh RE-GROW: healed hardware brought the
    mesh from ``old_devices`` back up to ``new_devices``; re-placing
    operands / PC factors / programs took ``rebuild_seconds``."""
    entry = {"old_devices": int(old_devices),
             "new_devices": int(new_devices),
             "rebuild_s": float(rebuild_seconds)}
    _MESH_REGROWS.append(entry)
    _REG.counter("elastic.mesh_regrows").inc()
    if _spans.enabled():
        _flight.recorder.record_event("mesh_regrow", **entry)


def mesh_regrows() -> list[dict]:
    return [dict(e) for e in _MESH_REGROWS]


def admission_counts() -> dict:
    return {"rejected": int(_REG.counter("serving.rejected").total()),
            "expired": int(_REG.counter("serving.expired").total()),
            "shed": int(_REG.counter("serving.shed").total())}


def qos_counts() -> dict[str, int]:
    return {str(k): int(v) for k, v in
            _REG.counter("qos.requests").items().items()}


def record_migration(op: str, src: str, dst: str, seconds: float):
    """Record one fleet session migration (``serving/fleet.py``; JAX
    ``profiling.py:216``): operator ``op`` moved from replica ``src`` to
    ``dst`` in ``seconds``."""
    _REG.counter("fleet.migrations").inc()
    if _spans.enabled():
        _flight.recorder.record_event("fleet_migration", op=str(op),
                                      src=str(src), dst=str(dst),
                                      seconds=float(seconds))


def migration_count() -> int:
    return int(_REG.counter("fleet.migrations").total())


def collective_latency() -> dict[str, dict]:
    """label -> {reduce_sites, per_iter_s (mean), episodes}."""
    sums = _REG.counter("collective.per_iter_seconds").items()
    eps = _REG.counter("collective.episodes").items()
    sites = _REG.gauge("collective.reduce_sites").items()
    out = {}
    for k, n in eps.items():
        out[k] = {"reduce_sites": float(sites.get(k, 0)),
                  "episodes": int(n),
                  "per_iter_s": (sums.get(k, 0.0) / n) if n else 0.0}
    return out


def record_sync(kind: str, count: int = 1):
    """Count ``count`` host<->device synchronization points (blocking
    device-to-host reads) of kind ``kind``. The port counts the reads it
    makes: a KSP solve's count equals its result's ``host_syncs`` (one a
    loop iteration on the eager paths, the flag reads and the result read of
    a fused solve); an EPS restart's its reads of the projected matrix."""
    _REG.counter("sync.count").inc(int(count), label=str(kind))


def sync_counts() -> dict[str, int]:
    return {k: int(v) for k, v in
            _REG.counter("sync.count").items().items()}


def kernel_traffic() -> dict[str, dict]:
    """kernel -> {model_bytes, seconds, episodes, achieved_gbps}."""
    bts = _REG.counter("kernel.model_bytes").items()
    secs = _REG.counter("kernel.seconds").items()
    eps = _REG.counter("kernel.episodes").items()
    out = {}
    for k, n in eps.items():
        b, s = bts.get(k, 0.0), secs.get(k, 0.0)
        out[k] = {"model_bytes": b, "seconds": s, "episodes": int(n),
                  "achieved_gbps": (b / s / 1e9) if s > 0 else 0.0}
    return out


def events() -> list[SolveEvent]:
    return list(_EVENTS)


def clear_events():
    """Reset the process-wide observability state (event logs AND the
    telemetry metrics registry — the single source of truth)."""
    _EVENTS.clear()
    _MESH_SHRINKS.clear()
    _MESH_REGROWS.clear()
    _REG.reset()


def log_view(file=None):
    """Print the accumulated solve log, -log_view style — rendered FROM
    the telemetry metrics registry (plus the two per-entry event logs),
    the same data ``telemetry.snapshot()`` and the Prometheus exporter
    serve."""
    file = file or sys.stderr
    syncs = sync_counts()
    sdc = sdc_counts()
    serving = serving_stats()
    admission = admission_counts()
    collectives = collective_latency()
    kernels = kernel_traffic()
    per_iter = _REG.histogram("solve.per_iter_seconds")
    if (not _EVENTS and not kernels and not syncs
            and not any(sdc.values()) and not serving["batches"]
            and not collectives and not _MESH_SHRINKS
            and not _MESH_REGROWS and not migration_count()
            and not any(admission.values())):
        print("log_view: no solve events recorded", file=file)
        return
    if _EVENTS:
        total = sum(e.wall for e in _EVENTS)
        print("-" * 72, file=file)
        print(f"{'event':32s} {'n':>10s} {'iters':>6s} {'wall (s)':>10s} "
              f"{'it/s':>8s}", file=file)
        print("-" * 72, file=file)
        for e in _EVENTS:
            its = e.iterations / e.wall if e.wall > 0 else 0.0
            print(f"{e.what:32s} {e.n:10d} {e.iterations:6d} "
                  f"{e.wall:10.4f} {its:8.1f}", file=file)
        print("-" * 72, file=file)
        print(f"{len(_EVENTS)} solve(s), total wall {total:.4f} s",
              file=file)
    if syncs:
        parts = ", ".join(f"{k}: {v}" for k, v in sorted(syncs.items()))
        print(f"host-device sync points: {parts}", file=file)
    if any(sdc.values()):
        print(f"silent-error detection: {sdc['abft_checks']} ABFT "
              f"check(s), {sdc['detections']} detection(s), "
              f"{sdc['replacements']} residual replacement(s)", file=file)
    if serving["batches"]:
        hist = ", ".join(f"k={k}: {v}"
                         for k, v in sorted(serving["width_hist"].items()))
        print(f"solve server: {serving['batches']} coalesced "
              f"dispatch(es), {serving['requests']} request(s), mean "
              f"width {serving['mean_width']:.1f} [{hist}], queue wait "
              f"mean {serving['wait_mean_s'] * 1e3:.1f} ms / max "
              f"{serving['wait_max_s'] * 1e3:.1f} ms, "
              f"{serving['padded_cols']} padded column(s)", file=file)
    if any(admission.values()):
        print(f"serving admission control: {admission['rejected']} "
              f"rejected (queue bound), {admission['expired']} "
              f"deadline-expired, {admission['shed']} shed (QoS)",
              file=file)
    qos = qos_counts()
    if qos:
        parts = ", ".join(f"{k}: {v}" for k, v in sorted(qos.items()))
        print(f"QoS classes served: {parts}", file=file)
    if _MESH_SHRINKS:
        shr = ", ".join(f"{e['old_devices']}->{e['new_devices']} "
                        f"({e['rebuild_s'] * 1e3:.0f} ms)"
                        for e in _MESH_SHRINKS)
        print(f"elastic recovery: {len(_MESH_SHRINKS)} mesh shrink(s) "
              f"[{shr}]", file=file)
    if _MESH_REGROWS:
        gr = ", ".join(f"{e['old_devices']}->{e['new_devices']} "
                       f"({e['rebuild_s'] * 1e3:.0f} ms)"
                       for e in _MESH_REGROWS)
        print(f"elastic recovery: {len(_MESH_REGROWS)} mesh re-grow(s) "
              f"[{gr}]", file=file)
    if migration_count():
        print(f"fleet: {migration_count()} session migration(s)",
              file=file)
    if collectives:
        print("collective latency itemization (reduce sites x per-iter "
              "wall):", file=file)
        for k, info in sorted(collectives.items()):
            print(f"  {k:36s} {info['reduce_sites']:4.2f} site(s) "
                  f"{info['per_iter_s'] * 1e6:10.1f} us/iter "
                  f"({info['episodes']} episode(s))", file=file)
    if kernels:
        print("kernel traffic (model bytes / measured time = achieved "
              "GB/s):", file=file)
        for k, info in sorted(kernels.items()):
            print(f"  {k:30s} {info['model_bytes'] / 1e9:10.3f} GB "
                  f"{info['seconds']:9.4f} s "
                  f"{info['achieved_gbps']:8.1f} GB/s "
                  f"({info['episodes']} episode(s))", file=file)
    dispatches = dispatch_counts()
    if dispatches:
        # the megasolve measurement row: launches by program kind — a
        # fused solve contributes exactly one 'megasolve' launch where
        # the unfused refinement path pays one 'ksp' per outer step
        parts = ", ".join(f"{k}: {int(v)}"
                          for k, v in sorted(dispatches.items()))
        total_d = int(sum(dispatches.values()))
        print(f"compiled-program dispatches: {total_d} [{parts}]",
              file=file)
    rpl = _REG.histogram("dispatch.requests_per_launch")
    if rpl.count:
        # the persistent-serving amortization row: requests riding each
        # persistent_serve launch — mean > 1 is the measured
        # ≪1-dispatch-per-request claim (serving/persistent.py)
        s = rpl.summary((50, 99))
        occupied = [(b, c) for b, c in
                    zip(list(rpl.buckets) + [float("inf")],
                        rpl.bucket_counts()) if c]
        cells = "  ".join(
            (f">{rpl.buckets[-1]:g}: {c}" if b == float("inf")
             else f"<={b:g}: {c}") for b, c in occupied)
        print(f"persistent requests-per-launch histogram ({rpl.count} "
              f"launch(es), mean {s['mean']:.2f}, p50 {s['p50']:.1f}, "
              f"p99 {s['p99']:.1f}): {cells}", file=file)
    if per_iter.count:
        # the fixed-bucket per-iteration latency histogram (cfg12's
        # -log_view row): only occupied buckets, cumulative-free
        s = per_iter.summary((50, 99))
        occupied = [(b, c) for b, c in
                    zip(list(per_iter.buckets) + [float("inf")],
                        per_iter.bucket_counts()) if c]
        cells = "  ".join(
            (f">{per_iter.buckets[-1]:g}s: {c}" if b == float("inf")
             else f"<={b:g}s: {c}") for b, c in occupied)
        print(f"per-iteration latency histogram ({per_iter.count} "
              f"solve(s), p50 {s['p50'] * 1e6:.1f} us, p99 "
              f"{s['p99'] * 1e6:.1f} us): {cells}", file=file)
    stale = _REG.histogram("multisplit.stale_age")
    if stale.count:
        # the async-tier staleness row: the age (versions behind the
        # reader) of every exchange read the multisplit block workers
        # consumed, plus the bound enforcement counters — the tier's
        # degradation budget made visible
        s = stale.summary((50, 99))
        occupied = [(b, c) for b, c in
                    zip(list(stale.buckets) + [float("inf")],
                        stale.bucket_counts()) if c]
        cells = "  ".join(
            (f">{stale.buckets[-1]:g}: {c}" if b == float("inf")
             else f"<={b:g}: {c}") for b, c in occupied)
        resyncs = int(_REG.counter("multisplit.resyncs").total())
        lost = int(_REG.counter("multisplit.block_lost").total())
        steps = int(_REG.counter("multisplit.step").total())
        print(f"multisplit staleness histogram ({stale.count} read(s), "
              f"{steps} step(s), p50 age {s['p50']:.1f}, p99 "
              f"{s['p99']:.1f}, {resyncs} resync(s), {lost} block(s) "
              f"lost): {cells}", file=file)
    print(f"compiled programs held: {program_count()}", file=file)


def dispatch_counts() -> dict[str, float]:
    """Compiled-program launches by program kind (ksp / ksp_many /
    megasolve / megasolve_many / persistent_serve) — the
    ``dispatch.programs`` registry counter the per-root-span
    ``dispatches`` attribute mirrors."""
    return {str(k): v for k, v in
            _REG.counter("dispatch.programs").items().items()}


def program_count() -> int:
    """Solver programs cached in this process. The port's KSP and EPS
    programs are Python closures built per solve, with no cache; the fused
    programs of ``solvers/megasolve.py`` are cached (each with its captured
    CUDA graphs), so this is their count."""
    from ..solvers import megasolve
    return len(megasolve._CACHE) + len(megasolve._PERSISTENT_CACHE)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA activity when a card is present) and write its Chrome trace to
    ``<log_dir>/torch_trace_<pid>.json``; yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"torch_trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in device traces (``torch.profiler.record_function``)."""
    from torch.profiler import record_function

    with record_function(name):
        yield
