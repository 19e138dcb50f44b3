"""Measured-latency reduction-plan selection (``-ksp_reduction_auto``).

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/autoselect.py``.
The CG family has three reduction plans: classic (3 reductions an
iteration), pipelined (1, overlapped) and s-step (1 per ``s`` iterations, at
about twice the operator applies). Which is fastest is a property of the
communicator, not of the operator: on one device a reduction is a fold of
a few shard partials and classic CG wins; over an interconnect whose
reduction costs tens of microseconds the one-reduction plans win by the
latency they stop paying. This module measures instead of guessing:

* :func:`measure_psum_latency_us`: 256 dependent scalar ``comm.psum``s (each
  divided by the mesh size, so the value is kept and the chain cannot be
  folded), best of 3, ended by a synchronise: on ``DeviceComm`` the
  in-process fold of the shard partials, on ``ProcessComm`` the real
  collective.
* :func:`probe_psum_latency_us`: the same behind an on-disk cache keyed by
  the machine, the card, the communicator's kind, backend and size, outside
  the repository (``$XDG_CACHE_HOME`` or ``~/.cache``); writes are atomic
  (a temporary file and ``os.replace``), a read that fails re-measures, and
  ``-ksp_reduction_probe_refresh`` re-measures.
* :func:`measure_apply_latency_us`: 16 chained ``M(A v) * 0.5`` on the real
  operator and PC, best of 3: one operator + PC application.
* :func:`select_reduction_plan`: ranks {cg, pipecg, sstep s in {2, 4, 8}}
  by the additive model ``cost = applies apply_us + sites psum_us`` (the
  JAX constants, :func:`_plan_model`) and keeps classic CG unless a plan
  beats it by ``margin`` (25%) of its modeled cost: the model omits each
  plan's own bookkeeping.

On a ``ProcessComm`` of several processes every process measures its own
latencies, and two processes that ranked by their own could pick plans
whose collectives do not match (cg's 3 psums an iteration against
pipecg's 1), and the solve would hang or sum the wrong values. So the
processes first agree on the latencies (:func:`_agree`: the largest of
each across the processes, the pace of the slowest, which sets a
collective solve's) and all rank the same numbers. The JAX package runs
one controller and has no such step.

The measured (or probe-cached) reduction latency is also the telemetry
gauge ``autoselect.psum_latency_us``, this process's own measurement, as in
the JAX module; the numbers the processes agreed on stay on the
:class:`SelectionReport`.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import socket
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

#: candidate reduction plans: ("cg", None), ("pipecg", None), ("sstep", s)
DEFAULT_CANDIDATES = (("cg", None), ("pipecg", None),
                      ("sstep", 2), ("sstep", 4), ("sstep", 8))


def _plan_model(ksp_type: str, s):
    """``(applies, reduction sites)`` an iteration: cg the 3-phase schedule,
    pipecg one fused site (its overlap not credited), sstep the two-basis
    monomial CA-CG's ``(2s-1)/s`` applies and ``1/s`` sites."""
    if ksp_type == "cg":
        return 1.0, 3.0
    if ksp_type == "pipecg":
        return 1.0, 1.0
    if ksp_type == "sstep":
        s = int(s)
        return (2.0 * s - 1.0) / s, 1.0 / s
    raise ValueError(f"no reduction-plan model for KSP {ksp_type!r}")


def _sync(comm):
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)


def _best_of_3(comm, run, chain: int) -> float:
    """Microseconds a link of ``run``'s chain, best of 3 after a warm-up;
    the communicator's collective counts are left as they were."""
    saved = dict(comm.collectives)
    run()
    _sync(comm)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        _sync(comm)
        best = min(best, time.perf_counter() - t0)
    comm.collectives.update(saved)
    return best / chain * 1e6


def measure_psum_latency_us(comm, chain: int = 256) -> float:
    """The measured latency of one reduction on ``comm``: ``chain``
    dependent scalar psums, each divided by the mesh size (JAX
    ``autoselect.py:68``)."""
    L, size = comm.local_shards, comm.size
    v = comm.put_rows(np.ones(8 * size)).view(L, -1)

    def run():
        a = comm.psum([v[i].sum() for i in range(L)]) / size
        for _ in range(chain - 1):
            a = comm.psum([a] * L) / size
        return a

    return _best_of_3(comm, run, chain)


def _probe_dir() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(base, "mpi_petsc4py_example_tpu_torch", "probe")


def _probe_path(comm) -> str:
    card = (torch.cuda.get_device_name(comm.device)
            if comm.device.type == "cuda" else "cpu")
    payload = repr((socket.gethostname(), platform.machine(), card,
                    type(comm).__name__, getattr(comm, "backend", None),
                    comm.size, comm.local_shards))
    digest = hashlib.sha256(payload.encode()).hexdigest()[:24]
    return os.path.join(_probe_dir(), f"psum_{digest}.json")


def probe_psum_latency_us(comm, chain: int = 256,
                          refresh: bool = False) -> tuple:
    """``(psum_us, cached)``: the reduction latency from the on-disk cache,
    or measured and stored (JAX ``autoselect.py:117``). A read that fails
    (missing, corrupt, another chain) re-measures; a write that fails
    leaves the measurement standing; ``refresh`` re-measures and
    overwrites."""
    path = _probe_path(comm)
    if not refresh:
        try:
            with open(path, encoding="utf-8") as fh:
                blob = json.load(fh)
            if blob.get("chain") == int(chain):
                return float(blob["psum_us"]), True
        except (OSError, ValueError, TypeError, KeyError, AttributeError):
            pass
    psum_us = measure_psum_latency_us(comm, chain=chain)
    try:
        os.makedirs(_probe_dir(), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=_probe_dir(), suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump({"psum_us": psum_us, "chain": int(chain),
                       "devices": int(comm.size)}, fh)
        os.replace(tmp, path)
    except OSError:
        pass
    return psum_us, False


def measure_apply_latency_us(comm, operator, pc, chain: int = 16) -> float:
    """The measured time of one operator + PC application on the real
    operands, halo exchange included: ``chain`` chained ``M(A v) * 0.5``
    (JAX ``autoselect.py:149``). Not cached: it depends on the operand."""
    n = operator.shape[0]
    pc.set_up(pc._mat if pc._mat is not None else operator)
    spmv = operator.local_spmv(comm)
    pc_apply = pc.local_apply(comm, n)
    v = comm.put_rows(np.ones(n), operator.dtype).view(comm.local_shards, -1)

    def run():
        u = v
        for _ in range(chain):
            u = pc_apply(spmv(u)) * 0.5
        return u

    return _best_of_3(comm, run, chain)


def rank_reduction_plans(psum_us: float, apply_us: float,
                         candidates=DEFAULT_CANDIDATES) -> list:
    """The candidates ranked by ``cost_us = applies apply_us + sites
    psum_us``, cheapest first, one dict each with the model's inputs (JAX
    ``autoselect.py:187``)."""
    ranked = []
    for ksp_type, s in candidates:
        applies, sites = _plan_model(ksp_type, s)
        ranked.append({
            "ksp_type": ksp_type, "s": int(s) if s else 0,
            "applies_per_iter": applies, "sites_per_iter": sites,
            "model_cost_us": applies * apply_us + sites * psum_us,
        })
    ranked.sort(key=lambda r: r["model_cost_us"])
    return ranked


@dataclass
class SelectionReport:
    """What :func:`select_reduction_plan` chose, and from what."""
    ksp_type: str
    s: int
    psum_us: float
    apply_us: float
    probe_cached: bool
    margin: float
    model: str = "additive: applies*apply_us + sites*psum_us"
    ranking: list = field(default_factory=list)

    def as_dict(self) -> dict:
        return {"choice": self.ksp_type, "s": self.s,
                "psum_us": self.psum_us, "apply_us": self.apply_us,
                "probe_cached": self.probe_cached, "margin": self.margin,
                "model": self.model, "ranking": self.ranking}


def choose(ranking: list, margin: float) -> dict:
    """The margin rule: the cheapest plan, unless it is not classic CG and
    fails to beat classic CG's modeled cost by ``margin``."""
    cg_cost = next(r["model_cost_us"] for r in ranking
                   if r["ksp_type"] == "cg")
    best = ranking[0]
    if (best["ksp_type"] != "cg"
            and best["model_cost_us"] > (1.0 - margin) * cg_cost):
        best = {"ksp_type": "cg", "s": 0}
    return best


def _agree(comm, psum_us: float, apply_us: float) -> tuple:
    """``(psum_us, apply_us)`` as every process of ``comm`` ranks them: on
    several processes the largest of each across the processes (one
    ``pmax``), so that all of them choose the same plan; on one process
    the measurements themselves."""
    if comm.nprocs == 1:
        return psum_us, apply_us
    mine = torch.tensor([psum_us, apply_us], dtype=torch.float64,
                        device=comm.device)
    both = comm.pmax([mine] * comm.local_shards).tolist()
    return float(both[0]), float(both[1])


def select_reduction_plan(comm, operator, pc, *,
                          candidates=DEFAULT_CANDIDATES,
                          refresh: bool = False,
                          margin: float = 0.25) -> SelectionReport:
    """The reduction plan for (communicator, operator, PC) from measured
    latencies (JAX ``autoselect.py:227``), the same on every process: the
    report's latencies are those the processes agreed on (:func:`_agree`);
    ``probe_cached`` is this process's own."""
    from ..telemetry.metrics import registry
    psum_us, cached = probe_psum_latency_us(comm, refresh=refresh)
    registry.gauge("autoselect.psum_latency_us").set(psum_us)
    apply_us = measure_apply_latency_us(comm, operator, pc)
    psum_us, apply_us = _agree(comm, psum_us, apply_us)
    ranking = rank_reduction_plans(psum_us, apply_us, candidates)
    best = choose(ranking, margin)
    return SelectionReport(ksp_type=best["ksp_type"],
                           s=int(best.get("s", 0) or 0),
                           psum_us=float(psum_us),
                           apply_us=float(apply_us),
                           probe_cached=bool(cached), margin=margin,
                           ranking=ranking)
