"""Serving and the asynchronous tier across processes: one scenario
definition, run on any communicator, so a run on a ``ProcessComm`` of
several processes is held against the same run on a ``DeviceComm`` of the
same shard count.

:func:`run_case` runs one case and returns plain values. It takes the
package's modules as an argument (:func:`port_api` gives the port's), so a
caller can run the same scenario on another package with the same surface.
As a driver under the runner's process mode it runs a list of cases, each
on a ``ProcessComm`` of the case's ``local_shards`` per process, and every
rank writes one pickle per case (``<case>.rank<r>.pkl``)::

    python -m mpi_petsc4py_example_tpu_torch.run -n 2 --procs --device cpu \\
        mpi_petsc4py_example_tpu_torch/facade/drivers/serving_procs.py \\
        CASES.json OUT_DIR

The script is SPMD, as a serving script across processes is: every rank
builds the comm, the server (router, fleet, solver) and the operators;
rank 0 alone submits, and every rank shuts down.

Case kinds (``case["kind"]``):

* ``serve``: a ``SolveServer`` (``autostart=False``) with the operators of
  ``ops`` (a 3-D stencil ``grid`` or an assembled ``op``, with the
  registration keywords ``reg``), the ``requests`` (``op``, ``seed``,
  ``rtol``, ``qos``, ``deadline``) submitted on rank 0, the indices of
  ``cancel`` cancelled, then started; ``faults`` armed on every rank,
  ``faults_rank0`` on rank 0 alone; another rank's submit is tried and
  its error kept; with ``reg_rank1`` each operator is first registered
  with those keywords added on rank 1 alone, and the error kept;
* ``route``: a 2-replica ``SolveRouter`` (``max_k``, default 4): the
  ``requests`` (one at a time, or all at once with ``concurrent``), the
  session ``migrate`` migrated, then the ``after`` requests (default the
  same);
* ``fleet``: a ``FleetManager`` of two loopback hosts: a solve, a lease
  round, the owner killed, a solve that fails over;
* ``multisplit``: ``MultisplitSolver`` with ``blocks`` blocks on cfg16's
  tridiagonal operator, cold, then warm from the cold answer; ``faults``
  armed on every rank;
* ``load``: cfg9's shape under load: ``requests`` seeded right-hand sides
  of the stencil on ``grid`` submitted on rank 0 at seeded exponential
  gaps of mean ``1 / rate`` s, ``faults`` armed on every rank; every
  rank's kernel launches counted over the served run (zeroed and read by
  commands of the stream, so at the same point of every rank's work), the
  blocks, latencies, rates and each answer's fp64 true relative residual.

An operator spec's ``dtype`` (``f32``/``f64``, default fp64) is the
stencil's precision.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import sys
import time

import numpy as np
import scipy.sparse as sp

import mpi_petsc4py_example_tpu_torch as pt
from mpi_petsc4py_example_tpu_torch.models.poisson import (poisson2d_csr,
                                                           poisson3d_csr)

TIMEOUT_S = 60.0

# the assembled operators: the 16 x 16 and 64^3 Poissons and cfg16's
# tridiagonal
AIJ = {"p2d16": lambda: poisson2d_csr(16),
       "p3d16": lambda: poisson3d_csr(16),
       "p3d64": lambda: poisson3d_csr(64),
       "tri256": lambda: tridiag(256),
       "tri4096": lambda: tridiag(4096)}


def tridiag(n: int, diag: float = 4.0):
    """cfg16's block-diagonally-dominant operator."""
    return sp.diags([-1.0, diag, -1.0], [-1, 0, 1], shape=(n, n),
                    format="csr")


def port_api() -> dict:
    """The port's modules, as :func:`run_case` takes them."""
    from mpi_petsc4py_example_tpu_torch.resilience import faults
    from mpi_petsc4py_example_tpu_torch.serving import (fleet, remote,
                                                        server)
    from mpi_petsc4py_example_tpu_torch.solvers.multisplit import (
        MultisplitSolver)
    return {"P": pt, "server": server, "fleet": fleet, "remote": remote,
            "multisplit": MultisplitSolver, "faults": faults,
            "stencil": pt.StencilPoisson3D}


def operator(api, comm, spec):
    """A case's operator: the stencil on ``grid``, or the scipy matrix
    ``op`` of :data:`AIJ` (the server places it)."""
    if "grid" in spec:
        kw = ({} if "dtype" not in spec else
              {"dtype": {"f32": np.float32, "f64": np.float64}[spec["dtype"]]})
        if kw and api["P"] is pt:
            kw["dtype"] = pt.parallel.mesh.torch_dtype(kw["dtype"])
        return api["stencil"](comm, *spec["grid"], **kw)
    return AIJ[spec["op"]]()


def rhs(spec, seed: int, device="cpu") -> np.ndarray:
    """The seeded right-hand side of an operator spec: ``A x`` of a seeded
    ``x``, in fp64 (a stencil's product on ``device``)."""
    rng = np.random.default_rng(seed)
    if "grid" in spec:
        x = rng.random(int(np.prod(spec["grid"])))
        return stencil_apply(spec["grid"], x[None], device)[0]
    A = AIJ[spec["op"]]()
    return np.asarray(A @ rng.random(A.shape[0]))


def _stencil_apply(grid, X, device):
    """``A x`` of the 7-point Dirichlet stencil on ``grid`` for each row of
    ``X``: an fp64 tensor on ``device``, one row a right-hand side."""
    import torch
    nx, ny, nz = grid
    U = torch.as_tensor(np.asarray(X), device=device).to(
        torch.float64).reshape(-1, nz, ny, nx)
    Y = 6.0 * U
    for ax in (1, 2, 3):
        n = U.shape[ax]
        Y.narrow(ax, 1, n - 1).sub_(U.narrow(ax, 0, n - 1))
        Y.narrow(ax, 0, n - 1).sub_(U.narrow(ax, 1, n - 1))
    return Y.reshape(len(U), -1)


def stencil_apply(grid, X, device="cpu") -> np.ndarray:
    """``A x`` of the 7-point Dirichlet stencil on ``grid`` for each row of
    ``X``, in fp64 torch operations on ``device`` (the card keeps the
    load case's 64 products at 128^3 off the host's clock)."""
    return _stencil_apply(grid, X, device).cpu().numpy()


def _policy(api):
    return api["P"].RetryPolicy(sleep=lambda d: None, base_delay=0.0)


def _outcome(fut) -> dict:
    """A future's outcome as plain values."""
    try:
        r = fut.result(TIMEOUT_S)
    except Exception as exc:  # noqa: BLE001 (the outcome is compared)
        return {"status": type(exc).__name__, "error": str(exc)}
    return {"status": "ok", "iterations": int(r.iterations),
            "reason": int(r.reason), "attempts": int(r.attempts),
            "width": int(r.batch_width), "x": np.asarray(r.x),
            "events": [e.kind for e in r.recovery_events]}


@contextlib.contextmanager
def _armed(api, spec):
    if spec:
        with api["P"].inject_faults(spec):
            yield
    else:
        yield


def _faults_of(case, rank):
    specs = [case.get("faults")]
    if rank == 0:
        specs.append(case.get("faults_rank0"))
    return ",".join(s for s in specs if s)


def _case_serve(api, comm, case, rank):
    srv = api["server"].SolveServer(
        comm, window=0.0, max_k=case.get("max_k", 8), autostart=False,
        retry_policy=_policy(api))
    ops = {o["name"]: o for o in case["ops"]}
    out = {}
    try:
        for o in case["ops"]:
            if "reg_rank1" in case:
                # first a registration that fails on rank 1 alone: every
                # rank takes its error, and no rank keeps the session
                bad = dict(o.get("reg", {}),
                           **(case["reg_rank1"] if rank == 1 else {}))
                try:
                    srv.register_operator(o["name"], operator(api, comm, o),
                                          **bad)
                except ValueError as exc:
                    out["register_error"] = str(exc)
                out["operators_after_error"] = srv.operators()
            srv.register_operator(o["name"], operator(api, comm, o),
                                  **o.get("reg", {}))
        with _armed(api, _faults_of(case, rank)):
            if rank == 0:
                futs = []
                for rq in case["requests"]:
                    kw = {k: rq[k] for k in ("rtol", "qos", "deadline")
                          if k in rq}
                    futs.append(srv.submit(
                        rq["op"], rhs(ops[rq["op"]], rq["seed"]), **kw))
                for j in case.get("cancel", ()):
                    futs[j].cancel()
                if any("deadline" in rq for rq in case["requests"]):
                    time.sleep(0.01)      # past every tiny deadline
                srv.start()
                out["outcomes"] = [_outcome(f) for f in futs]
                srv.drain(TIMEOUT_S)
                st = srv.stats()
                out["stats"] = {k: st[k] for k in (
                    "requests", "batches", "expired", "width_hist",
                    "qos_hist")}
            else:
                try:
                    srv.submit(case["ops"][0]["name"],
                               rhs(case["ops"][0], 0))
                except ValueError as exc:
                    out["submit_error"] = str(exc)
            srv.shutdown()
    finally:
        srv.shutdown()
        api["faults"].heal()
    out["blocks_run"] = getattr(srv, "_blocks_run", None)
    out["cols_run"] = getattr(srv, "_cols_run", None)
    return out


def _case_route(api, comm, case, rank):
    rt = api["fleet"].SolveRouter(2, comm, window=0.0,
                                  max_k=case.get("max_k", 4),
                                  retry_policy=_policy(api))
    ops = {o["name"]: o for o in case["ops"]}
    out = {}
    steps = out["steps_s"] = {}
    t0 = time.perf_counter()
    try:
        for o in case["ops"]:
            rt.register_operator(o["name"], operator(api, comm, o),
                                 **o.get("reg", {}))
        steps["register"] = time.perf_counter() - t0
        if rank == 0:
            def solve_all(requests):
                # one at a time (each block one request wide), or all at
                # once with ``concurrent``
                if case.get("concurrent"):
                    futs = [rt.submit(rq["op"], rhs(ops[rq["op"]],
                                                    rq["seed"]))
                            for rq in requests]
                    return [_outcome(f) for f in futs]
                return [_outcome(rt.submit(rq["op"],
                                           rhs(ops[rq["op"]], rq["seed"])))
                        for rq in requests]
            t0 = time.perf_counter()
            out["before"] = solve_all(case["requests"])
            steps["before"] = time.perf_counter() - t0
            mig = case["migrate"]
            src = rt.owner(mig)
            dst = [n for n in rt.replicas() if n != src][0]
            t0 = time.perf_counter()
            rt.migrate(mig, dst)
            steps["migrate"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            out["after"] = solve_all(case.get("after", case["requests"]))
            steps["after"] = time.perf_counter() - t0
            out["placement"] = (src, dst, rt.owner(mig),
                                sorted(rt.replica(dst).operators()),
                                sorted(rt.replica(src).operators()))
    finally:
        rt.shutdown()
    return out


def _case_fleet(api, comm, case, rank):
    mgr = api["remote"].FleetManager(
        2, comm, window=0.0, max_k=4, retry_policy=_policy(api),
        client_sleep=lambda _d: None)
    spec = case["ops"][0]
    out = {}
    try:
        sess = mgr.register_operator(spec["name"], operator(api, comm, spec),
                                     **spec.get("reg", {}))
        out["registered"] = sess is not None
        if rank == 0:
            b = rhs(spec, 0)
            out["first"] = _outcome(mgr.submit(spec["name"], b))
            mgr.lease_step()                   # pull the warm checkpoint
            owner = mgr.router.owner(spec["name"])
            mgr.kill_host(owner)
            out["second"] = _outcome(mgr.submit(spec["name"], b))
            ev = mgr.failovers[0]
            out["failover"] = (owner, mgr.router.owner(spec["name"]),
                               ev.host, ev.dst, tuple(ev.sessions),
                               int(ev.resumed_iteration))
    finally:
        mgr.shutdown(wait=False)
    return out


def _case_multisplit(api, comm, case, rank):
    A = AIJ[case["op"]]()
    x_true = np.random.default_rng(case.get("seed", 0)).random(A.shape[0])
    b = np.asarray(A @ x_true)
    ms = api["multisplit"](comm, nblocks=case["blocks"],
                           rtol=case.get("rtol", 1e-10),
                           inner_rtol=case.get("inner_rtol", 1e-4))
    ms.set_operator(A)
    out = {}
    psum0 = dict(getattr(comm, "collectives", {})).get("psum", 0)
    try:
        with _armed(api, case.get("faults")):
            results = [ms.solve(b)]
            results.append(ms.solve(b, x0=results[0].x))
    except Exception as exc:  # noqa: BLE001 (the outcome is compared)
        out["error"] = (type(exc).__name__, str(exc))
        results = []
    finally:
        api["faults"].heal()
    for tag, r in zip(("cold", "warm"), results):
        out[tag] = {"reason": int(r.reason), "cut": int(r.cut_version),
                    "cuts": [int(v) for v, _ in r.history],
                    "relres": float(np.linalg.norm(b - A @ r.x)
                                    / np.linalg.norm(b)),
                    "steps": tuple(int(s) for s in r.block_steps),
                    "x": np.asarray(r.x)}
    if results and hasattr(comm, "collectives"):
        out["psum_calls"] = comm.collectives["psum"] - psum0
        out["checks"] = sum(len(r.history) for r in results)
    return out


def stencil_relres(grid, B, X, device="cpu") -> np.ndarray:
    """fp64 true relative residuals ``||b - A x|| / ||b||`` of the 7-point
    Dirichlet stencil on ``grid`` for the rows of ``B``/``X`` (one request
    a row), the products on ``device``."""
    import torch
    out = []
    for j in range(0, len(B), 8):
        b = torch.as_tensor(np.asarray(B[j:j + 8], np.float64),
                            device=device)
        r = b - _stencil_apply(grid, X[j:j + 8], device)
        out.append((r.norm(dim=1) / b.norm(dim=1)).cpu().numpy())
    return np.concatenate(out)


class _Probe:
    """Every rank's kernel counters, zeroed and read by commands of the
    stream (so at the same point of every rank's work)."""

    def __init__(self):
        self.launches = None

    def reset(self):
        from mpi_petsc4py_example_tpu_torch.ops import stencil as st
        st.reset_launches()

    def read(self):
        from mpi_petsc4py_example_tpu_torch.ops import stencil as st
        self.launches = {name: int(w.launches)
                         for name, w in st.KERNELS.items() if w.launches}
        return self.launches


def _case_load(api, comm, case, rank):
    from mpi_petsc4py_example_tpu_torch.parallel.control import stream_for
    spec = case["ops"][0]
    srv = api["server"].SolveServer(
        comm, window=case.get("window", 0.003), max_k=case.get("max_k", 8),
        retry_policy=api["P"].RetryPolicy(base_delay=0.01, max_delay=0.1))
    stream = stream_for(comm)
    probe = _Probe()
    tag = stream.attach(probe, comm)
    out = {}
    steps = out["steps_s"] = {}
    t0 = time.perf_counter()
    try:
        srv.register_operator(spec["name"], operator(api, comm, spec),
                              **spec.get("reg", {}))
        steps["register"] = time.perf_counter() - t0
        with _armed(api, case.get("faults")):
            if rank == 0:
                m = int(case["requests"])
                t0 = time.perf_counter()
                rows = np.stack([rhs(spec, case.get("seed", 9) + j,
                                     comm.device) for j in range(m)])
                steps["rows"] = time.perf_counter() - t0
                gaps = np.random.default_rng(case.get("seed", 9)).exponential(
                    1.0 / float(case["rate"]), m)
                blocks, t_sub, t_done, futs = [], {}, {}, []
                srv._dispatch_hook = lambda reqs: blocks.append(
                    [id(r.future) for r in reqs])
                stream.call(tag, "reset")
                t_start = nxt = time.monotonic()
                for j in range(m):
                    nxt += gaps[j]
                    delay = nxt - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    t_sub[j] = time.monotonic()
                    f = srv.submit(spec["name"], rows[j])
                    f.add_done_callback(
                        lambda _f, i=j: t_done.__setitem__(i,
                                                           time.monotonic()))
                    futs.append(f)
                res = [f.result(600) for f in futs]
                t_end = time.monotonic()
                srv.drain(600)
                stream.call(tag, "read")
                steps["serve"] = t_end - t_start
                t0 = time.perf_counter()
                index = {id(f): j for j, f in enumerate(futs)}
                lat = sorted(t_done[j] - t_sub[j] for j in range(m))
                st = srv.stats()
                out.update(
                    iterations=[int(r.iterations) for r in res],
                    reasons=[int(r.reason) for r in res],
                    attempts=[int(r.attempts) for r in res],
                    blocks=[[index[i] for i in b] for b in blocks],
                    wall_s=t_end - t_start, solves_per_s=m / (t_end - t_start),
                    p50_ms=lat[int(round(0.5 * (m - 1)))] * 1e3,
                    p99_ms=lat[int(round(0.99 * (m - 1)))] * 1e3,
                    width_hist=dict(st["width_hist"]),
                    relres=stencil_relres(spec["grid"], rows,
                                          np.stack([r.x for r in res]),
                                          comm.device))
                steps["relres"] = time.perf_counter() - t0
            srv.shutdown()
    finally:
        srv.shutdown()
        if stream.multiprocess:
            if rank == 0:
                stream.close(tag)
            else:
                stream.wait_closed(tag)
        api["faults"].heal()
    out["launches"] = probe.launches
    out["cols_run"] = srv._cols_run
    out["local_shards"] = int(comm.local_shards)
    return out


_KINDS = {"serve": _case_serve, "route": _case_route, "fleet": _case_fleet,
          "multisplit": _case_multisplit, "load": _case_load}


def run_case(api, comm, case: dict) -> dict:
    """Run ``case`` (module docstring) with the package ``api`` on
    ``comm``; returns this rank's plain values."""
    rank = int(getattr(comm, "rank", 0))
    pt_opts = api["P"].global_options()
    pt_opts.clear()
    for k, v in case.get("options", {}).items():
        pt_opts.set(k, v)
    try:
        return _KINDS[case["kind"]](api, comm, case, rank)
    finally:
        pt_opts.clear()


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="serving_procs.py")
    ap.add_argument("cases", help="JSON list of case dicts")
    ap.add_argument("out", help="directory of the per-case pickles")
    opts = ap.parse_args(argv[1:])
    t_main = time.time()        # the start-up ends here (the wall clock)
    with open(opts.cases) as f:
        cases = json.load(f)
    from mpi4py import MPI          # the runner's facade: the process group
    base = MPI.COMM_WORLD.device_comm
    rank = base.rank
    os.makedirs(opts.out, exist_ok=True)
    api = port_api()
    for case in cases:
        comm = pt.ProcessComm(case.get("local_shards", 2), base.device)
        t0 = time.perf_counter()
        res = run_case(api, comm, case)
        res["case_wall_s"] = time.perf_counter() - t0
        res["t_main"], res["t_end"] = t_main, time.time()
        res["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib")
                                  for m in sys.modules)
        with open(os.path.join(opts.out,
                               f"{case['name']}.rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
