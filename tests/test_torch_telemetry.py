"""The port's telemetry layer (``telemetry/``, ``utils/profiling.py``,
``utils/phases.py``, the ``-telemetry*``/``-log_view`` flags) against the
JAX package's.

* the name registry: the port's ``NAMES`` equals JAX's, key for key and
  kind for kind, and ``FLIGHT_FAULT_POINTS`` covers every fault point;
* the registry: the same operations give the same ``prometheus_text()``
  string and the same ``snapshot()`` in both packages;
* the same solves through both packages (fp64, 1 and 2 shards): KSP cg +
  jacobi with a true-residual gate re-entry, ``RefinedKSP`` on the host
  loop and fused, EPS Krylov-Schur, and ``resilient_solve`` with a device
  loss and a shrink: equal span trees (names, nesting, every attribute but
  the times; the float attributes, residual norms near 1e-10 of ``||b||``,
  within 1e-6 relative: the packages' reductions sum in other orders, and
  differences up to 2e-7 show after a few hundred iterations; or within
  1e-9 absolutely, where a norm sits at fp64's rounding floor of these
  O(1-100) right-hand sides), equal ``dispatch.programs`` and SDC
  counters; the sync counter equals the port's ``host_syncs``;
* the disabled span is the shared ``NOOP``; an armed solve adds no kernel
  launch, collective or host sync; the flags act and the dump files land
  where they should.

Every test resets both packages' registries and disables their spans.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu import telemetry as jtel  # noqa: E402
from mpi_petsc4py_example_tpu.models import (  # noqa: E402
    poisson2d_csr, poisson3d_csr)
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa
from mpi_petsc4py_example_tpu.resilience import retry as jretry  # noqa
from mpi_petsc4py_example_tpu.resilience import elastic as jelastic  # noqa
from mpi_petsc4py_example_tpu.utils import profiling as jprof  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch import telemetry as ptel  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import (  # noqa: E402
    elastic, faults, retry)
from mpi_petsc4py_example_tpu_torch.solvers import megasolve  # noqa: E402
from mpi_petsc4py_example_tpu_torch.telemetry.flight import (  # noqa: E402
    DEFAULT_FLIGHT_LEN)
from mpi_petsc4py_example_tpu_torch.utils import (  # noqa: E402
    phases, profiling)

TEL = {"jax": (tps, jtel, jprof, jfaults, jretry, jelastic),
       "torch": (pt, ptel, profiling, faults, retry, elastic)}
# span attributes that are times, or host-dependent measurements
_VOLATILE = {"psum_us", "apply_us", "probe_cached", "checkpoint"}
_FLOAT_RTOL = 1e-6
_FLOAT_ATOL = 1e-9


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    monkeypatch.setenv("TPU_SOLVE_EPS_FUSED", "0")
    for _, tel, prof, flt, _, _ in TEL.values():
        tel.disable()
        tel.reset()
        prof.clear_events()
        flt.heal()
        flt.reset()
    pt.global_options().clear()
    tps.global_options().clear()
    yield
    for _, tel, prof, flt, _, _ in TEL.values():
        tel.disable()
        tel.reset()
        tel.flight_recorder.set_maxlen(DEFAULT_FLIGHT_LEN)
        prof.clear_events()
        flt.heal()
        flt.reset()
    pt.global_options().clear()
    tps.global_options().clear()
    megasolve.clear_cache()


def _comm(pkg, n):
    return (tps.DeviceComm(n_devices=n) if pkg == "jax"
            else pt.DeviceComm(n, device="cpu"))


def _ksp(pkg, n, A, rtol=1e-10, ksp_type="cg", pc="jacobi"):
    P = TEL[pkg][0]
    comm = _comm(pkg, n)
    M = P.Mat.from_scipy(comm, A)
    ksp = P.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol)
    return ksp, M


def _tree(span):
    """A span tree without its times and ids."""
    attrs = {k: v for k, v in span["attrs"].items() if k not in _VOLATILE}
    return (span["name"], attrs, [_tree(c) for c in span["children"]])


def _same_tree(a, b, path="root", rtol=_FLOAT_RTOL):
    assert a[0] == b[0], (path, a[0], b[0])
    assert set(a[1]) == set(b[1]), (path, a[0], a[1], b[1])
    for k, va in a[1].items():
        vb = b[1][k]
        if isinstance(va, float) and isinstance(vb, float):
            assert va == pytest.approx(vb, rel=rtol, abs=_FLOAT_ATOL), \
                (path, a[0], k, va, vb)
        else:
            assert va == vb, (path, a[0], k, va, vb)
    assert [c[0] for c in a[2]] == [c[0] for c in b[2]], (path, a[0])
    for i, (ca, cb) in enumerate(zip(a[2], b[2])):
        _same_tree(ca, cb, f"{path}/{a[0]}[{i}]", rtol)


def _armed(pkg, fn):
    """Run ``fn(pkg)`` with the package's spans armed; returns its result,
    the recorded root trees and the registry snapshot."""
    tel = TEL[pkg][1]
    tel.enable()
    try:
        out = fn(pkg)
    finally:
        tel.disable()
    return out, [_tree(t) for t in tel.flight_recorder.spans()], \
        tel.snapshot()


def _counter(snap, name):
    return snap.get(name, {}).get("values", {})


def _both(fn, rtol=_FLOAT_RTOL):
    res = {pkg: _armed(pkg, fn) for pkg in TEL}
    (jo, jt, js), (po, ptr, ps) = res["jax"], res["torch"]
    assert len(jt) == len(ptr)
    for a, b in zip(jt, ptr):
        _same_tree(a, b, rtol=rtol)
    for name in ("dispatch.programs", "abft.checks", "abft.detections",
                 "abft.replacements", "solve.count", "solve.iterations",
                 "sstep.demotions", "elastic.mesh_shrinks"):
        assert _counter(js, name) == _counter(ps, name), name
    return jo, po, ps


def _port_syncs(snap):
    return sum(_counter(snap, "sync.count").values())


# ---- the registry -------------------------------------------------------------

def test_names_and_flight_fault_points_match_jax():
    assert ptel.NAMES == jtel.NAMES
    assert ptel.FLIGHT_FAULT_POINTS == jtel.FLIGHT_FAULT_POINTS
    assert set(faults.FAULT_POINTS) <= set(ptel.FLIGHT_FAULT_POINTS)
    with pytest.raises(KeyError, match="not registered"):
        ptel.registry.counter("no.such.metric")
    with pytest.raises(ValueError, match="registered as a counter"):
        ptel.registry.gauge("abft.checks")


def _registry_ops(tel):
    reg = tel.registry
    reg.counter("abft.checks").inc(5)
    reg.counter("sync.count").inc(2, label="KSP result fetch/solve")
    reg.counter("dispatch.programs").inc(label="megasolve")
    reg.gauge("solve.programs").set(3)
    reg.gauge("collective.reduce_sites").set(0.25, label="sstep s=4")
    h = reg.histogram("serving.queue_wait_seconds", buckets=(0.1, 1.0))
    h.observe(0.05)
    h.observe(0.5)
    h2 = reg.histogram("solve.per_iter_seconds")
    for v in (3e-6, 2e-5, 1.5e-4, float("nan")):
        h2.observe(v)


def test_prometheus_text_and_snapshot_equal_jax():
    for tel in (jtel, ptel):
        _registry_ops(tel)
    assert ptel.prometheus_text() == jtel.prometheus_text()
    assert ptel.snapshot() == jtel.snapshot()
    json.dumps(ptel.snapshot())
    assert ptel.percentile([1.0, 2.0, 3.0], 50) == 2.0
    s = ptel.registry.histogram("solve.per_iter_seconds").summary()
    assert s == jtel.registry.histogram("solve.per_iter_seconds").summary()


# ---- the solves ------------------------------------------------------------------

A2 = poisson2d_csr(16)


@pytest.mark.parametrize("n", [1, 2])
def test_ksp_span_tree_matches_jax(n):
    """fp64 cg + jacobi with the true-residual gate: ``ksp.solve`` with its
    setup (the PC build nested in the first), dispatch, fetch and verify
    children, and one ``ksp`` dispatch."""
    def run(pkg):
        ksp, M = _ksp(pkg, n, A2, rtol=1e-8)
        ksp.set_true_residual_check(True)
        x, b = M.get_vecs()
        b.set_global(A2 @ np.linspace(1.0, 2.0, A2.shape[0]))
        return ksp.solve(b, x)
    jr, pr, ps = _both(run)
    assert pr.iterations == jr.iterations
    assert _port_syncs(ps) == pr.host_syncs
    root = _tree(ptel.flight_recorder.spans()[-1])
    assert [c[0] for c in root[2]] == ["ksp.setup", "ksp.setup",
                                       "ksp.dispatch", "ksp.fetch",
                                       "ksp.verify"]
    assert root[1]["dispatches"] == 1
    assert _counter(ps, "dispatch.programs") == {"ksp": 1.0}


def _reentry_run(n):
    """fp32 cg + jacobi on the 64^2 Poisson problem, the case where the
    recurrence claims convergence and the true residual misses ``rtol``
    (``tests/test_torch_ksp_general.py``): no fp64 problem of this size
    drifts far enough to re-enter."""
    def run(pkg):
        P = TEL[pkg][0]
        comm = _comm(pkg, n)
        A = poisson2d_csr(64)
        M = P.Mat.from_scipy(comm, A, dtype=np.float32 if pkg == "jax"
                             else torch.float32)
        ksp = P.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-6, max_it=20000)
        ksp.set_true_residual_check(True)
        x, b = M.get_vecs()
        b.set_global(A @ np.random.default_rng(0).random(A.shape[0]))
        return ksp.solve(b, x), ksp._last_reentries
    return run


@pytest.mark.parametrize("n", [1, 4])
def test_gate_reentries_nest_and_count(n):
    """The re-entered solve nests under ``ksp.verify`` as a child
    ``ksp.solve`` (``reentry`` true), in both packages; fp32, so the float
    attributes agree within 1e-2: the residual norms sit at fp32's rounding
    floor (about 1e-6 of ``||b||``), where the sums' order shows in the
    third digit."""
    (jr, jre), (pr, pre), ps = _both(_reentry_run(n), rtol=1e-2)
    assert (pr.iterations, pre) == (jr.iterations, jre) and pre == 1
    assert _port_syncs(ps) == pr.host_syncs
    root = ptel.flight_recorder.spans()[-1]
    assert root["name"] == "ksp.solve" and root["attrs"]["dispatches"] == 2
    verify = [c for c in root["children"] if c["name"] == "ksp.verify"]
    assert len(verify) == 1
    assert verify[0]["attrs"]["reentries"] == pre
    sub = [c for c in verify[0]["children"]]
    assert [c["name"] for c in sub] == ["ksp.solve"]
    assert sub[0]["attrs"]["reentry"] is True


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_refined_ksp_span_tree_matches_jax(n, fused):
    A = poisson3d_csr(8)
    b = A @ np.random.default_rng(7).random(A.shape[0])

    def run(pkg):
        P = TEL[pkg][0]
        rk = P.RefinedKSP().create(_comm(pkg, n))
        rk.set_inner_precision("f64")
        rk.set_operators(A)
        rk.set_type("cg")
        rk.get_pc().set_type("jacobi")
        rk.set_tolerances(rtol=1e-10)
        rk.megasolve = fused
        x, res = rk.solve(b)
        return (rk.refine_steps, res.iterations,
                getattr(res, "host_syncs", None))
    jo, po, ps = _both(run)
    assert po[:2] == jo[:2]
    assert _port_syncs(ps) == sum(
        v for k, v in _counter(ps, "sync.count").items())
    root = ptel.flight_recorder.spans()[-1]
    assert root["name"] == "refine.outer"
    if fused:
        assert root["attrs"]["dispatches"] == 1
        assert _port_syncs(ps) == po[2]


@pytest.mark.parametrize("n", [1, 2])
def test_eps_span_tree_matches_jax(n):
    A = poisson2d_csr(12)

    def run(pkg):
        P = TEL[pkg][0]
        comm = _comm(pkg, n)
        M = P.Mat.from_scipy(comm, A)
        E = P.EPS().create(comm)
        E.set_operators(M)
        E.set_problem_type("hep")
        E.set_dimensions(nev=2, ncv=8)
        E.solve()
        return E.result
    jr, pr, ps = _both(run)
    assert pr.iterations == jr.iterations
    assert _port_syncs(ps) == pr.host_syncs
    labels = set(_counter(ps, "sync.count"))
    assert labels <= {"EPS H fetch/restart", "EPS basis fetch/solve"}


def test_resilient_shrink_chain_matches_jax():
    """JAX ``test_retry_shrink_chain_with_resumed_iteration``: a device
    lost mid-solve gives ``resilient.solve -> resilient.shrink`` with the
    resumed iteration, and the fault and the recovery ladder in the ring,
    in both packages alike."""
    def run(pkg):
        P, tel, _, flt, ret, el = TEL[pkg]
        ksp, M = _ksp(pkg, 8, A2, rtol=1e-10)
        x, b = M.get_vecs()
        b.set_global(A2 @ np.ones(A2.shape[0]))
        with P.inject_faults("device.lost=unavailable:device="
                             f"{ksp.comm.device_ids[-1]}:iter=15"):
            res = ret.resilient_solve(
                ksp, b, x, ret.RetryPolicy(sleep=lambda _d: None),
                elastic=el.ElasticPolicy(max_same_mesh_retries=1))
        flt.heal()
        stages = [e["data"]["stage"]
                  for e in tel.flight_recorder.events("recovery")]
        points = [e["data"]["point"]
                  for e in tel.flight_recorder.events("fault")]
        return res.iterations, res.attempts, stages, points
    jo, po, ps = _both(run)
    assert po == jo
    assert "device.lost" in po[3] and "mesh_shrink" in po[2]
    root = ptel.flight_recorder.spans()[-1]
    assert root["name"] == "resilient.solve"
    sh = [c for c in root["children"] if c["name"] == "resilient.shrink"]
    assert sh and sh[-1]["attrs"]["resumed_iteration"] > 0
    assert _counter(ps, "elastic.mesh_shrinks") == {"": 1.0}
    assert profiling.mesh_shrinks()[0]["new_devices"] < 8


# ---- the contracts of the disabled and armed paths -----------------------------

def test_disabled_span_is_the_shared_noop():
    assert ptel.span("ksp.solve") is ptel.NOOP
    assert ptel.start_span("serving.request") is ptel.NOOP
    with ptel.span("ksp.solve") as sp:
        sp.set_attr("x", 1).set_attrs(y=2)
    assert ptel.flight_recorder.entries() == []
    ptel.enable()
    with pytest.raises(KeyError, match="not registered"):
        ptel.span("ksp.solv")


def _counts(comm):
    return ({k: w.launches for k, w in st.KERNELS.items()},
            dict(comm.collectives))


@pytest.mark.parametrize("fused", [False, True])
def test_armed_solve_adds_no_launch_collective_or_sync(fused):
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 12)
    b0 = np.random.default_rng(2).random(12 ** 3)
    out = []
    for armed in (False, True):
        (ptel.enable if armed else ptel.disable)()
        ksp = pt.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-8)
        ksp.megasolve = fused
        x, b = op.get_vecs()
        b.set_global(b0)
        before = _counts(comm)
        res = ksp.solve(b, x)
        after = _counts(comm)
        out.append(({k: after[0][k] - v for k, v in before[0].items()},
                    {k: after[1].get(k, 0) - v
                     for k, v in before[1].items()},
                    res.iterations, res.host_syncs, x.to_numpy()))
    ptel.disable()
    off, on = out
    assert off[:4] == on[:4]
    assert np.array_equal(off[4], on[4])
    assert len(ptel.flight_recorder.spans()) == 1


def test_flags_configure_telemetry_and_log_view(tmp_path, capsys):
    pt.init(["prog", "-telemetry", "-telemetry_flight_len", "7"])
    assert ptel.enabled() and ptel.flight_recorder.maxlen == 7
    ksp, M = _ksp("torch", 2, A2, rtol=1e-8)
    x, b = M.get_vecs()
    b.set_global(np.ones(A2.shape[0]))
    res = ksp.solve(b, x)
    profiling.log_view(file=sys.stdout)
    text = capsys.readouterr().out
    assert "KSPSolve(cg+jacobi)" in text
    assert f"host-device sync points: KSP result fetch/solve: " \
           f"{res.host_syncs}" in text
    assert "compiled-program dispatches: 1 [ksp: 1]" in text
    trace = tmp_path / "trace.json"
    doc = ptel.export_trace(str(trace))
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"ksp.solve", "ksp.dispatch"} <= names
    assert doc["traceEvents"][0]["ph"] == "M"
    assert ptel.dump_path("out.json", 0) == "out.json"
    assert ptel.dump_path("out.json", 3) == "out.json.rank3"


def test_log_view_and_dump_flags_act_at_exit(tmp_path):
    """``-log_view`` prints the report at exit and ``-telemetry_dump``
    writes the snapshot and the ring (a process of its own: both are
    at-exit hooks)."""
    dump = tmp_path / "tel.json"
    code = (
        "import numpy as np, torch\n"
        "import mpi_petsc4py_example_tpu_torch as pt\n"
        "from mpi_petsc4py_example_tpu_torch.models.poisson import "
        "poisson3d_csr\n"
        f"pt.init(['p', '-log_view', '-telemetry', '-telemetry_dump', "
        f"{str(dump)!r}])\n"
        "comm = pt.DeviceComm(1, device='cpu')\n"
        "A = poisson3d_csr(6)\n"
        "M = pt.Mat.from_scipy(comm, A)\n"
        "k = pt.KSP().create(comm); k.set_operators(M); k.set_type('cg')\n"
        "x, b = M.get_vecs(); b.set_global(np.ones(A.shape[0]))\n"
        "k.solve(b, x)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert "KSPSolve(cg+" in out.stderr
    assert "compiled-program dispatches: 1 [ksp: 1]" in out.stderr
    payload = json.loads(dump.read_text())
    assert payload["metrics"]["dispatch.programs"]["total"] == 1.0
    assert payload["flight"][0]["span"]["name"] == "ksp.solve"


def test_phase_stamps_and_trace(tmp_path, monkeypatch):
    log = tmp_path / "phases.json"
    monkeypatch.setenv("TPU_SOLVE_PHASE_LOG", str(log))
    monkeypatch.setattr(phases, "_STAMPS", [])
    phases.stamp("tpurun_main")
    phases.stamp("driver_exec")
    assert [n for n, _ in json.loads(log.read_text())] == [
        "tpurun_main", "driver_exec"]
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("one solve"):
            torch.ones(4).sum()
    files = list((tmp_path / "prof").glob("torch_trace_*.json"))
    assert files and "one solve" in files[0].read_text()
    assert profiling.program_count() == len(megasolve._CACHE)
