"""Deterministic fault injection at the port's solve boundaries.

The port's copy of ``mpi_petsc4py_example_tpu/resilience/faults.py``: the
same spec grammar, fault points (:data:`FAULT_POINTS`), kinds, messages, hit
counters, seeded schedules, sticky ``device.lost`` registry with
:func:`heal`/:func:`heal_epoch`, :func:`mesh_fault` and
:class:`HealthMonitor`, so one spec injects the same fault into either
package and ``utils.errors.classify_failure`` gives it the same class.

Activation, by either route::

    with inject_faults("ksp.program=unavailable:iter=5"):
        resilient_solve(ksp, b, x)

    TPU_SOLVE_FAULTS="ksp.solve=oom" python driver.py

The environment variable is read through the options module's environment
reader (``utils/options.py`` ``env_value``), as every ``TPU_SOLVE_*``
variable is.

Spec grammar (comma-separated clauses)::

    clause := point '=' kind (':' param '=' value)*
    params := at=N  times=M|*  iter=K  seed=S  prob=P  mag=M  mean=T
              device=D

**Trace-time points.** ``spmv.result``, ``pc.apply`` and ``comm.psum`` act in
the JAX package while a solve program is TRACED: the hit counter advances
once per traced site (the initial residual's apply, the loop body's, the
replacement branch's, ...), so ``at=N`` picks a site, and the corruption is
baked into every execution of that program until a retry traces a clean one
(a program is traced anew while a trace-time clause is live, JAX
``trace_key``). The port's loops are eager, so a program resolves its sites
when it is built, once per solve: :func:`trace_sites` walks the program's
sites in the JAX package's trace order, counting one hit each, and the
returned :class:`SiteFaults` corrupts every call from a hit site for the rest
of that solve. When no trace-time clause is live nothing is counted, as a
cached JAX program traces nothing. The sites of each program are listed where
it is built (``solvers/krylov.py``).

``rpc.send`` and ``rpc.recv`` fire in the RPC transport
(``serving/transport.py``: the client before a request leaves, the host
after its handler ran). ``exchange.put`` fires in the stale exchange's
publish (``parallel/exchange.py``), and ``comm.delay``, the one timing
point, is read through :func:`delay_seconds` by each multisplit block
before its step (``solvers/multisplit.py``).

This module imports nothing of torch. Every fired clause is recorded in the
telemetry flight recorder (``Fault.flight_record``, JAX ``faults.py:208-233``,
``:385``).
"""

from __future__ import annotations

import contextlib
import random
import re
import threading

from ..utils.options import env_value

# Registry of named fault points and the fault kinds each supports.
FAULT_POINTS = {
    "ksp.solve":   ("unavailable", "oom"),   # KSP.solve entry (all paths)
    "ksp.program": ("unavailable", "oom"),   # around the compiled solve
    "ksp.result":  ("nan", "inf"),           # poison the fetched residual
    "eps.solve":   ("unavailable", "oom"),   # EPS.solve entry
    "comm.put":    ("unavailable", "oom"),   # device_put data placement
    "comm.fetch":  ("unavailable", "drop", "corrupt"),  # host gather
    "comm.psum":   ("drop", "corrupt"),      # traced in-program collective
    # SILENT data corruption (no crash, no NaN): applied at TRACE time to
    # the operator/preconditioner apply inside the compiled solve, so the
    # corruption bakes into every execution of that program — the SDC
    # model the ABFT/monitor layer (resilience/abft.py) must catch.
    # 'bitflip' flips a high exponent bit of one element (a localized,
    # huge error); 'scale' multiplies the whole result by (1 + mag) (a
    # systematic small relative error — mag= spec param, default 1e-3).
    # Hit counters advance once per TRACED apply site (init residual,
    # loop body, replacement branch, ...), so at=N selects WHICH site of
    # the program is corrupted; a clause that is spent no longer forces
    # cache isolation and retries get a clean program (trace_key()).
    "spmv.result": ("bitflip", "scale"),     # operator apply, in-program
    "pc.apply":    ("bitflip", "scale"),     # PC apply, in-program
    # PERSISTENT device loss (sticky until heal()): a fired clause marks
    # its device= in the module's lost registry; solves and placements on
    # meshes containing a lost device keep failing 'unavailable' until
    # faults.heal() — or until the elastic layer rebuilds onto a smaller
    # mesh that excludes it (resilience/elastic.py). Hit counters advance
    # once per SOLVE-PROGRAM boundary on a mesh containing the device
    # (solvers/ksp.py mesh_fault site), so at=N picks the Nth solve and
    # iter=K leaves K iterations of real partial state, like ksp.program.
    "device.lost": ("unavailable",),         # permanent worker/chip loss
    # 'comm.delay' is a per-device latency (a TIMING fault: the multisplit
    # blocks sleep what delay_seconds() returns before each step) and
    # 'exchange.put' a stale-exchange publish (parallel/exchange.py).
    # 'rpc.send'/'rpc.recv' are the RPC transport's client and host sides
    # (serving/transport.py).
    "comm.delay":  ("delay",),               # per-device latency jitter
    "exchange.put": ("drop", "partition"),   # stale-exchange publish
    "rpc.send": ("drop", "delay", "duplicate", "reorder", "partition"),
    "rpc.recv": ("drop", "delay", "duplicate", "reorder", "partition"),
}

RAISING_KINDS = ("unavailable", "oom")

_KIND_MESSAGES = {
    "unavailable": ("UNAVAILABLE: TPU worker process crashed (injected "
                    "fault at {point!r})"),
    "oom": ("RESOURCE_EXHAUSTED: Out of memory while running program "
            "(injected fault at {point!r})"),
}


class XlaRuntimeError(RuntimeError):
    """Synthetic device failure, named like the JAX runtime's error (the
    JAX package's name), so :func:`..utils.errors.wrap_device_errors`
    classifies injected faults by the path real device failures take."""


class FaultSpecError(ValueError):
    """A malformed ``TPU_SOLVE_FAULTS`` / ``inject_faults`` spec."""


class Fault:
    """One parsed fault clause with its own deterministic trigger state."""

    def __init__(self, point: str, kind: str, at: int = 1, times: int = 1,
                 forever: bool = False, iter_k: int | None = None,
                 seed: int | None = None, prob: float = 1.0,
                 mag: float = 1e-3, device: int | None = None,
                 mean: float = 0.01):
        self.point = point
        self.kind = kind
        self.at = at
        self.times = times
        self.forever = forever
        self.iter_k = iter_k
        self.prob = prob
        self.mag = mag       # relative magnitude of 'scale' corruption
        self.mean = mean     # mean latency in seconds ('delay' clauses)
        self.device = device  # device id (device.lost/delay/partition)
        self._rng = random.Random(seed) if seed is not None else None
        self.hits = 0      # times the point was reached
        self.fired = 0     # times this fault actually triggered

    def check(self) -> bool:
        """Count one hit of the point; True when the fault triggers."""
        self.hits += 1
        if self._rng is not None:
            fire = self._rng.random() < self.prob
        else:
            fire = (self.hits >= self.at
                    and (self.forever or self.hits < self.at + self.times))
        if fire:
            self.fired += 1
        return fire

    def spent(self) -> bool:
        """True when no FUTURE hit can fire (counter window passed).
        Seeded and ``times=*`` schedules are never spent."""
        return (self._rng is None and not self.forever
                and self.hits >= self.at + self.times - 1)

    def error(self) -> XlaRuntimeError:
        self.flight_record()
        msg = _KIND_MESSAGES[self.kind].format(point=self.point)
        if self.device is not None:
            # name the device: HealthMonitor attributes repeated failures
            # by parsing this (real runtimes name failing chips too)
            msg += (f"; device {self.device} is LOST — persistent until "
                    "faults.heal() or a mesh rebuild excludes it")
        err = XlaRuntimeError(msg)
        # iter=K clauses leave K iterations of real partial state in the
        # caller's iterate; carry that so the resilience layer checkpoints
        # the true progress (retry.py records/resumes the iteration)
        err.iteration = int(self.iter_k or 0)
        return err

    def flight_record(self):
        """Record this fault in the telemetry flight recorder (JAX
        ``faults.py:222-233``): every fired clause at every fault point
        (``telemetry/names.FLIGHT_FAULT_POINTS``); recording never masks the
        fault itself."""
        from ..telemetry import flight as _flight
        _flight.record_fault(self.point, self.kind, device=self.device,
                             iteration=int(self.iter_k or 0),
                             hits=self.hits)

    def __repr__(self):
        sched = (f"seed prob={self.prob}" if self._rng is not None else
                 f"at={self.at} times={'*' if self.forever else self.times}")
        return (f"Fault({self.point}={self.kind}, {sched}, "
                f"hits={self.hits}, fired={self.fired})")


def _parse_clause(clause: str) -> Fault:
    head, _, tail = clause.partition(":")
    point, eq, kind = head.partition("=")
    point, kind = point.strip(), kind.strip()
    if not eq or not point or not kind:
        raise FaultSpecError(
            f"fault clause {clause!r}: expected '<point>=<kind>[:k=v...]'")
    if point not in FAULT_POINTS:
        raise FaultSpecError(
            f"unknown fault point {point!r}; known: {sorted(FAULT_POINTS)}")
    if kind not in FAULT_POINTS[point]:
        raise FaultSpecError(
            f"fault point {point!r} supports kinds {FAULT_POINTS[point]}, "
            f"not {kind!r}")
    kw = {}
    for param in filter(None, (p.strip() for p in tail.split(":"))):
        key, eq, value = param.partition("=")
        if not eq:
            raise FaultSpecError(
                f"fault clause {clause!r}: parameter {param!r} is not "
                "'key=value'")
        try:
            if key == "at":
                kw["at"] = int(value)
            elif key == "times":
                if value == "*":
                    kw["forever"] = True
                else:
                    kw["times"] = int(value)
            elif key == "iter":
                kw["iter_k"] = int(value)
            elif key == "seed":
                kw["seed"] = int(value)
            elif key == "prob":
                kw["prob"] = float(value)
            elif key == "mag":
                kw["mag"] = float(value)
            elif key == "mean":
                kw["mean"] = float(value)
            elif key == "device":
                kw["device"] = int(value)
            else:
                raise FaultSpecError(
                    f"fault clause {clause!r}: unknown parameter {key!r} "
                    "(have: at, times, iter, seed, prob, mag, mean, "
                    "device)")
        except ValueError as e:
            if isinstance(e, FaultSpecError):
                raise
            raise FaultSpecError(
                f"fault clause {clause!r}: bad value for {key!r}: {e}") from e
    if "prob" in kw and "seed" not in kw:
        raise FaultSpecError(
            f"fault clause {clause!r}: prob= needs seed= (schedules must "
            "be reproducible)")
    return Fault(point, kind, **kw)


def parse_spec(spec: str) -> list[Fault]:
    """Parse a full fault spec into armed :class:`Fault` clauses."""
    faults = [_parse_clause(c.strip())
              for c in spec.split(",") if c.strip()]
    if not faults:
        raise FaultSpecError(f"empty fault spec {spec!r}")
    return faults


# ---- active plan ----------------------------------------------------------
# _UNSET: the env var has not been consulted yet. None: no faults active.
_UNSET = object()
_PLAN = _UNSET
_LOCK = threading.Lock()
_TRACE_NONCE = 0


def _active_plan():
    global _PLAN
    if _PLAN is _UNSET:
        with _LOCK:
            if _PLAN is _UNSET:
                spec = (env_value("faults") or "").strip()
                _PLAN = parse_spec(spec) if spec else None
    return _PLAN


def active() -> bool:
    """Whether any fault plan is armed (env var or context manager)."""
    return _active_plan() is not None


def reset():
    """Forget the cached env-var plan (re-read on next fault-point hit)."""
    global _PLAN
    with _LOCK:
        _PLAN = _UNSET


@contextlib.contextmanager
def inject_faults(spec: str):
    """Arm a fault plan for the duration of the block (replaces any
    env-var plan; restores it after). Yields the parsed fault list so
    tests can assert on ``hits``/``fired`` counters."""
    global _PLAN
    plan = parse_spec(spec)
    with _LOCK:
        saved, _PLAN = _PLAN, plan
    try:
        yield plan
    finally:
        with _LOCK:
            _PLAN = saved


def triggered(point: str, device: int | None = None):
    """Hot-path hook: count a hit of ``point`` against the active plan.

    Returns the :class:`Fault` that fired (the call site applies its
    effect — raise, poison, drop) or None. Near-no-op when no plan is
    armed. ``device`` identifies WHO hit the point (the publishing
    block/device id at ``exchange.put``): a clause carrying ``device=D``
    then only counts — and only fires — for that id, the sticky
    partitioned-peer model; clauses without ``device=`` match everyone.
    """
    plan = _active_plan()
    if plan is None:
        return None
    with _LOCK:
        fired = None
        for fault in plan:
            if fault.point != point:
                continue
            if (device is not None and fault.device is not None
                    and fault.device != int(device)):
                continue
            if fault.check():
                fired = fault
                break
    if fired is not None and fired.kind not in RAISING_KINDS:
        # the other kinds (poison, drops, silent corruption) never reach
        # Fault.error(), which records the raising ones
        fired.flight_record()
    return fired


def check(point: str):
    """Raising-kind fault points: raise the synthetic device error if a
    fault fires at ``point`` (no-op otherwise)."""
    fault = triggered(point)
    if fault is not None and fault.kind in RAISING_KINDS:
        raise fault.error()


def delay_seconds(point: str, device: int | None = None) -> float:
    """Hot-path hook for TIMING fault points (``comm.delay``): seconds
    of injected latency the caller must sleep before its communication
    step — 0.0 with no armed delay clause (near-no-op, like
    :func:`triggered`).

    ``device`` is the id doing the communicating; a clause with
    ``device=D:times=*`` is a STICKY slow device (only D's hits count,
    every one fires), the straggler model asynchronous multisplitting
    (``solvers/multisplit.py``) is built to absorb. A seeded clause draws
    each delay from an exponential distribution with mean ``mean=``
    seconds (``random.Random(seed).expovariate`` — reproducible jitter);
    an unseeded clause injects exactly ``mean`` seconds. Hit windows
    (``at``/``times``/``prob``) gate each draw like any other fault.
    Multiple matching clauses add up.
    """
    plan = _active_plan()
    if plan is None:
        return 0.0
    total = 0.0
    fired = []
    with _LOCK:
        for fault in plan:
            if fault.point != point or fault.kind != "delay":
                continue
            if (device is not None and fault.device is not None
                    and fault.device != int(device)):
                continue
            if not fault.check():
                continue
            if fault._rng is not None and fault.mean > 0:
                total += fault._rng.expovariate(1.0 / fault.mean)
            else:
                total += max(0.0, fault.mean)
            fired.append(fault)
    for fault in fired:
        fault.flight_record()
    return total


# fault points whose effect applies while a program is being TRACED in the
# JAX package (and therefore bakes into the compiled artifact)
TRACE_TIME_POINTS = ("comm.psum", "spmv.result", "pc.apply")


def trace_time_live() -> bool:
    """Whether an armed clause at a trace-time point can still fire (JAX
    ``trace_key`` is not None): only then does a program count hits at its
    sites, as only then does the JAX package trace one anew."""
    plan = _active_plan()
    if plan is None:
        return False
    with _LOCK:
        return any(f.point in TRACE_TIME_POINTS and not f.spent()
                   for f in plan)


class SiteFaults:
    """The trace-time faults one solve program carries: which of its named
    sites a fired clause hit (:func:`trace_sites`). ``hit(name)`` is the
    :class:`Fault` at site ``name``, or None; every call from that site
    applies it for the rest of the solve, as a traced JAX program carries
    the corruption in every execution."""

    def __init__(self, hits=None):
        self.hits = dict(hits or {})

    def __bool__(self):
        return bool(self.hits)

    def hit(self, name: str):
        return self.hits.get(name)


NO_SITES = SiteFaults()


def trace_sites(sites) -> SiteFaults:
    """Resolve a program's trace-time sites against the armed plan.

    ``sites`` maps each trace-time point to the program's site names in the
    order the JAX package traces them (for example ``{"spmv.result":
    ["init", "body", "replace"]}``); each site counts one hit of its point,
    as :func:`triggered` counts one per traced site in JAX. With no live
    trace-time clause nothing is counted (:func:`trace_time_live`)."""
    if not trace_time_live():
        return NO_SITES
    hits = {}
    for point in TRACE_TIME_POINTS:
        for name in sites.get(point, ()):
            fault = triggered(point)
            if fault is not None:
                hits[name] = fault
    return SiteFaults(hits)


# ---- persistent device loss ----------------------------------------------
# Unlike the hit-count one-shots, a lost device is STICKY process state:
# device id -> description, populated by a fired 'device.lost' clause or
# mark_lost(), cleared only by heal(). Every solve-program boundary and
# data placement consults it, so a mesh containing a lost device keeps
# failing 'unavailable' — the failure model where same-mesh retries are
# futile and only the elastic shrink (resilience/elastic.py) helps.
_LOST: dict[int, str] = {}

# Monotonic heal generation: bumped by every heal() that actually cleared
# a lost mark. Consumers that want to react to 'hardware came back' (the
# elastic regrow of resilience/elastic.py, HealthMonitor) poll this
# instead of the registry itself: an empty registry cannot distinguish
# 'never lost' from 'lost and repaired', the epoch can.
_HEAL_EPOCH = 0


def lost_devices() -> frozenset:
    """Device ids currently marked lost (sticky until :func:`heal`)."""
    with _LOCK:
        return frozenset(_LOST)


def mark_lost(device_id: int, reason: str = "marked via faults.mark_lost"):
    """Mark a device as persistently lost (the programmatic route — a
    health monitor that classified real repeated failures uses this)."""
    with _LOCK:
        _LOST[int(device_id)] = str(reason)


def heal(device_id: int | None = None) -> tuple:
    """Clear the lost mark from one device (or all, when ``device_id`` is
    None) — the explicit 'hardware was replaced/repaired' signal. Returns
    the ids that were healed. A heal that actually cleared something
    bumps the process heal epoch (:func:`heal_epoch`) — the signal the
    elastic regrow (resilience/elastic.py) keys on."""
    global _HEAL_EPOCH
    with _LOCK:
        if device_id is None:
            healed = tuple(sorted(_LOST))
            _LOST.clear()
        else:
            healed = ((int(device_id),)
                      if _LOST.pop(int(device_id), None) is not None
                      else ())
        if healed:
            _HEAL_EPOCH += 1
        return healed


def heal_epoch() -> int:
    """Monotonic count of effective :func:`heal` calls this process.
    Cheap to poll (one lock acquisition, no device work): the
    HealthMonitor compares it against a remembered value to detect
    'devices came back since I last looked' without scanning device
    state."""
    with _LOCK:
        return _HEAL_EPOCH


def check_lost(device_ids):
    """Raise the 'unavailable' loss error if any of ``device_ids`` is in
    the sticky lost registry. Registry-only (never consumes armed
    clauses) — the placement-boundary guard (parallel/mesh.py), so data
    cannot be placed onto a mesh containing a lost device."""
    if not _LOST:               # lock-free fast path: empty registry
        return
    with _LOCK:
        down = sorted(d for d in device_ids if d in _LOST)
    if down:
        raise Fault("device.lost", "unavailable", device=down[0]).error()


def mesh_fault(point, device_ids):
    """Hot-path hook for the solve-program boundary (solvers/ksp.py):
    returns the :class:`Fault` to apply when the mesh over ``device_ids``
    has (or just) lost a device, else None.

    Two routes produce a fault: an armed ``device.lost`` clause whose
    device is in the mesh fires (counting one hit per call — at=N picks
    the Nth solve; the device goes into the sticky registry, and the
    returned clause may carry ``iter=K`` partial-progress semantics), or
    the registry already holds a mesh member (every later solve fails
    until heal()/shrink). Near-no-op with no plan and an empty registry.
    """
    plan = _active_plan()
    if plan is None and not _LOST:
        return None
    ids = tuple(int(i) for i in device_ids)
    fired = None
    if plan is not None:
        with _LOCK:
            for fault in plan:
                if fault.point != point:
                    continue
                dev = fault.device
                if dev is None:
                    dev = max(ids) if ids else 0
                if dev not in ids:
                    continue
                if fault.check():
                    fault.device = dev
                    _LOST[dev] = f"injected {point}={fault.kind}"
                    if fired is None:
                        fired = fault
    if fired is not None:
        return fired
    with _LOCK:
        down = sorted(d for d in ids if d in _LOST)
    if down:
        return Fault(point, "unavailable", device=down[0])
    return None


# ---- health monitoring ----------------------------------------------------
_DEVICE_ID_RE = re.compile(r"device\s+(\d+)", re.IGNORECASE)


def device_from_error(exc) -> int | None:
    """Device id named by a failure, or None when unattributable. Looks
    at the ORIGINAL runtime error when the exception is a classified
    wrapper (utils.errors.DeviceExecutionError keeps it on
    ``.original``) — the wrapper's own message is the hint, not the
    device-naming runtime text."""
    msg = str(getattr(exc, "original", None) or exc)
    m = _DEVICE_ID_RE.search(msg)
    return int(m.group(1)) if m else None


class HealthMonitor:
    """Classifies repeated ``unavailable`` failures as persistent loss.

    A transient worker crash recovers after one backoff; a device that
    keeps failing is GONE and waiting on it is futile. The monitor
    counts consecutive unavailable failures per attributed device (or
    per mesh, when the error names no device); once a device reaches
    ``threshold`` it is classified lost (:meth:`lost_devices` — the set
    the elastic MeshRebuilder excludes), and :meth:`persistent` reports
    when same-mesh retrying has used up its evidence either way. A
    successful solve calls :meth:`healthy` — the evidence is
    consecutive-failure evidence, success resets it.
    """

    def __init__(self, threshold: int = 2):
        self.threshold = max(1, int(threshold))
        self._counts: dict = {}       # device id (or None) -> failures
        self.failures = 0             # total recorded since last healthy()
        self._heal_epoch = heal_epoch()   # heal generation last observed

    def record(self, exc) -> int | None:
        """Count one unavailable failure; returns the attributed device
        id (None when the error names no device)."""
        dev = device_from_error(exc)
        self.failures += 1
        self._counts[dev] = self._counts.get(dev, 0) + 1
        return dev

    def healthy(self):
        """A solve succeeded on the current mesh: reset the evidence."""
        self._counts.clear()
        self.failures = 0

    def lost_devices(self) -> frozenset:
        """Devices classified lost: attributed failure count reached the
        threshold."""
        return frozenset(d for d, c in self._counts.items()
                         if d is not None and c >= self.threshold)

    def persistent(self) -> bool:
        """True once ANY attribution (a device, or the unattributed mesh
        bucket) has failed ``threshold`` times — the same-mesh-retries-
        are-futile classification that triggers the shrink escalation."""
        return any(c >= self.threshold for c in self._counts.values())

    def heal_observed(self) -> bool:
        """True when :func:`heal` cleared a lost device since this
        monitor was constructed (or since this method last returned
        True) — the classification that turns the elastic ladder UPWARD:
        a previously shrunk session may re-grow onto the repaired
        hardware (resilience/elastic.MeshRebuilder.grown_comm). The
        observation is consuming, like the failure evidence: one heal
        triggers one re-grow attempt, not a re-grow per retry."""
        ep = heal_epoch()
        if ep != self._heal_epoch:
            self._heal_epoch = ep
            return True
        return False

    def __repr__(self):
        return (f"HealthMonitor(threshold={self.threshold}, "
                f"counts={self._counts})")
