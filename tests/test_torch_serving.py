"""The port's solve server (``serving/``: ``coalescer``, ``qos``, ``server``)
against the JAX package's.

Every check runs the same seeded inputs through both packages: the pure
grouping and scheduling logic on seeded request populations, and servers
built with ``autostart=False``, fed the same burst and then started, on
the 16^2 Poisson ``Mat`` (``poisson2d_csr(16)``) and a 12 x 10 x 8 stencil,
in fp64 on 8 shards (``DeviceComm(8, device="cpu")`` beside JAX's
``DeviceComm(n_devices=8)``). Held equal: block widths (``stats()
["width_hist"]``), iterations, reasons, attempts, recovery events,
admission outcomes, counters and span trees; iterates within 1e-10
relative. Behaviours (shutdown, drain, the batching window, RHS copies)
run the same test on each package. Every future is waited on with a
timeout, and every server is shut down in ``finally``.
"""

import ast
import contextlib
import io
import pathlib
import re
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.serving import (  # noqa: E402
    coalescer as jcoalescer)
from mpi_petsc4py_example_tpu.serving import qos as jqos  # noqa: E402
from mpi_petsc4py_example_tpu.serving import server as jserver  # noqa: E402
from mpi_petsc4py_example_tpu.telemetry import flight as jflight  # noqa: E402
from mpi_petsc4py_example_tpu.telemetry import spans as jspans  # noqa: E402
from mpi_petsc4py_example_tpu.utils import (  # noqa: E402
    profiling as jprofiling)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import coalescer  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import qos  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import server  # noqa: E402
from mpi_petsc4py_example_tpu_torch.telemetry import flight  # noqa: E402
from mpi_petsc4py_example_tpu_torch.telemetry import spans  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import profiling  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-8
TIMEOUT = 120
X_TOL = 1e-10
A2D = poisson2d_csr(16)
PKGS = ("jax", "torch")
MOD = {"jax": (tps, jcoalescer, jqos, jserver, jfaults, jprofiling, jspans,
               jflight),
       "torch": (pt, coalescer, qos, server, faults, profiling, spans,
                 flight)}


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, jfaults):
        f.reset()
        f.heal()
    pt.global_options().clear()
    yield
    pt.global_options().clear()
    for f in (faults, jfaults):
        assert not f.active()
        f.reset()
        f.heal()


def _rhs(k, seed=0, A=A2D):
    X = np.random.default_rng(seed).random((A.shape[0], k))
    return A @ X


def _comm(pkg):
    return (tps.DeviceComm(n_devices=8) if pkg == "jax"
            else pt.DeviceComm(8, device="cpu"))


def _operator(pkg, comm, kind):
    if kind == "mat":
        return A2D
    return (JaxStencil(comm, 12, 10, 8) if pkg == "jax"
            else pt.StencilPoisson3D(comm, 12, 10, 8))


def _policy(pkg):
    return MOD[pkg][0].RetryPolicy(sleep=lambda d: None, base_delay=0.0)


def _outcome(fut):
    try:
        return fut.result(TIMEOUT)
    except Exception as exc:  # noqa: BLE001 (the outcome is compared)
        return exc


def _serve(pkg, reqs, *, kind="mat", server_kw=None, reg_kw=None,
           spec=None):
    """One server of ``pkg`` (``autostart=False``): register operator "p",
    submit ``reqs`` (``(b, submit kwargs)`` pairs), start, and return
    (outcomes, stats)."""
    P, _, _, srvmod, _, _, _, _ = MOD[pkg]
    comm = _comm(pkg)
    kw = dict(window=0.0, max_k=8, autostart=False,
              retry_policy=_policy(pkg))
    kw.update(server_kw or {})
    srv = srvmod.SolveServer(comm, **kw)
    try:
        reg = dict(pc_type="jacobi", rtol=RTOL)
        reg.update(reg_kw or {})
        srv.register_operator("p", _operator(pkg, comm, kind), **reg)
        ctx = P.inject_faults(spec) if spec else contextlib.nullcontext()
        with ctx:
            futs = [srv.submit("p", b, **skw) for b, skw in reqs]
            srv.start()
            out = [_outcome(f) for f in futs]
        stats = srv.stats()
    finally:
        srv.shutdown()
    return out, stats


def _same_result(rj, rt):
    assert type(rt).__name__ == type(rj).__name__ == "ServedSolveResult"
    assert (rt.iterations, rt.reason, rt.attempts, rt.batch_width,
            rt.op) == (rj.iterations, rj.reason, rj.attempts,
                       rj.batch_width, rj.op)
    assert ([e.kind for e in rt.recovery_events]
            == [e.kind for e in rj.recovery_events])
    assert rt.sdc_detections == rj.sdc_detections
    err = np.linalg.norm(rt.x - rj.x) / max(np.linalg.norm(rj.x), 1e-300)
    assert err <= X_TOL, err


def _same_stats(sj, st):
    for key in ("requests", "batches", "padded_cols", "width_hist",
                "qos_hist", "rejected", "expired", "shed", "devices"):
        assert st[key] == sj[key], key


def _parity(reqs, **kw):
    oj, sj = _serve("jax", reqs, **kw)
    ot, st = _serve("torch", reqs, **kw)
    _same_stats(sj, st)
    for rj, rt in zip(oj, ot):
        _same_result(rj, rt)
    return ot, st


# ---- the pure logic: coalescer and QoS -------------------------------------

def _population(pkg, seed, n=40):
    """A seeded request population of ``pkg``'s SolveRequest: a few
    operators, tolerance classes, priorities, deadlines and arrival times."""
    rng = np.random.default_rng(seed)
    SR = MOD[pkg][1].SolveRequest
    out = []
    for i in range(n):
        prio = int(rng.choice([0, 50, 100]))
        r = SR(op=str(rng.choice(["a", "b"])), b=None,
               rtol=float(rng.choice([1e-6, 1e-8])),
               atol=float(rng.choice([0.0, 1e-12])),
               max_it=int(rng.choice([100, 200])), future=Future(),
               precision=str(rng.choice(["float64", "float32"])),
               schedule=str(rng.choice(["cg", "sstep:4"])),
               qos={0: "interactive", 50: "", 100: "bulk"}[prio],
               priority=prio, t_submit=float(i) * 1e-3)
        if rng.random() < 0.3:
            r.t_deadline = r.t_submit + float(rng.random())
        out.append(r)
    return out


def _indices(batches, pop):
    pos = {id(r): i for i, r in enumerate(pop)}
    return [[pos[id(r)] for r in b] for b in batches]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("max_k", [1, 3, 8])
def test_coalesce_and_schedule_match_jax(seed, max_k):
    pj, pp = _population("jax", seed), _population("torch", seed)
    assert (_indices(coalescer.coalesce(pp, max_k), pp)
            == _indices(jcoalescer.coalesce(pj, max_k), pj))
    assert (_indices(qos.schedule(pp, max_k), pp)
            == _indices(jqos.schedule(pj, max_k), pj))
    # compatibility keys never mix, and FIFO holds inside each batch
    for b in _indices(coalescer.coalesce(pp, max_k), pp):
        assert len({pp[i].key for i in b}) == 1 and b == sorted(b)


@pytest.mark.parametrize("seed", range(4))
def test_shed_victim_matches_jax(seed):
    pj, pp = _population("jax", seed, 12), _population("torch", seed, 12)
    for prio in (0, 50, 100):
        vj, vp = jqos.shed_victim(pj, prio), qos.shed_victim(pp, prio)
        assert (vp is None) == (vj is None)
        if vp is not None:
            assert _indices([[vp]], pp) == _indices([[vj]], pj)


def test_padded_width_matches_jax():
    for k in range(0, 20):
        for max_k in (1, 4, 5, 8, 16):
            for pad in (False, True):
                assert (coalescer.padded_width(k, max_k, pad)
                        == jcoalescer.padded_width(k, max_k, pad))


@pytest.mark.parametrize("case", ["hot", "cold", "skew", "steady", "empty",
                                  "unsampled", "disabled"])
def test_autoscale_decisions_match_jax(case):
    p99 = {"hot": [0.9, 0.02], "cold": [0.001, 0.002], "skew": [0.3, 0.01],
           "steady": [0.05, 0.04], "empty": [], "unsampled": [None, 0.3],
           "disabled": [0.9]}[case]
    stats = {f"r{i}": ({} if v is None else {"queue_wait_p99_s": v})
             for i, v in enumerate(p99)}
    pj, pp = jqos.AutoscalePolicy(), qos.AutoscalePolicy()
    if case == "disabled":
        pj.enabled = pp.enabled = False
    dj, dp = pj.decide(stats), pp.decide(stats)
    assert (dp.action, dp.replica, dp.reason) == (dj.action, dj.replica,
                                                  dj.reason)


def test_qos_classes_and_options_match_jax():
    for opts in (tps.global_options(), pt.global_options()):
        opts.set("qos_interactive_deadline", "0.25")
        opts.set("qos_default_class", "bulk")
        opts.set("autoscale_high_p99", "0.75")
        opts.set("autoscale_min_replicas", "2")
    assert qos.builtin_classes() == {
        k: qos.QoSClass(**vars(v)) for k, v in jqos.builtin_classes().items()}
    assert qos.default_class_name() == jqos.default_class_name() == "bulk"
    assert vars(qos.AutoscalePolicy.from_options()) == vars(
        jqos.AutoscalePolicy.from_options())
    classes = qos.builtin_classes()
    assert qos.resolve(None, classes).name == "bulk"
    with pytest.raises(ValueError, match="unknown QoS class"):
        qos.resolve("urgent", classes)


# ---- served blocks against the JAX package's --------------------------------

SCENARIOS = {
    # five requests ride one block padded to 8
    "burst": dict(k=5),
    # seven requests at max_k 3 without padding: 3 + 3 + 1
    "chunks": dict(k=7, server_kw=dict(max_k=3, pad_pow2=False)),
    # the 12 x 10 x 8 stencil, the stencil fast path of the block CG
    "stencil": dict(k=4, kind="stencil"),
    "pipecg": dict(k=3, reg_kw=dict(ksp_type="pipecg")),
    "sstep": dict(k=3, reg_kw=dict(ksp_type="sstep")),
    # the fused program serves the block
    "megasolve": dict(k=4, reg_kw=dict(megasolve=True)),
    # resilient dispatch off: the plain solve_many
    "plain": dict(k=2, server_kw=dict(resilient=False)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_served_blocks_match_jax(name, monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    sc = SCENARIOS[name]
    A = A2D if sc.get("kind", "mat") == "mat" else None
    B = (_rhs(sc["k"], 1) if A is not None
         else np.random.default_rng(1).random((960, sc["k"])))
    reqs = [(B[:, j], {}) for j in range(sc["k"])]
    out, st = _parity(reqs, kind=sc.get("kind", "mat"),
                      server_kw=sc.get("server_kw"),
                      reg_kw=sc.get("reg_kw"))
    assert all(r.converged for r in out)
    if name == "burst":
        assert st["width_hist"] == {5: 1} and st["padded_cols"] == 3
    if name == "chunks":
        assert st["width_hist"] == {3: 2, 1: 1}


def test_mixed_tolerances_never_batch():
    B = _rhs(4, 2)
    reqs = ([(B[:, j], {"rtol": 1e-6}) for j in (0, 1)]
            + [(B[:, j], {"rtol": 1e-10}) for j in (2, 3)])
    out, st = _parity(reqs)
    assert st["width_hist"] == {2: 2}
    assert min(r.iterations for r in out[2:]) > max(
        r.iterations for r in out[:2])


def test_overrides_and_session_defaults_match_jax():
    """Per-request rtol/atol/max_it overrides coalesce apart, and a request
    without overrides gets the registered defaults, not the last batch's."""
    B = _rhs(4, 3)
    reqs = [(B[:, 0], {"rtol": 1e-3}), (B[:, 1], {}),
            (B[:, 2], {"atol": 1e-3}), (B[:, 3], {"max_it": 5})]
    out, st = _parity(reqs, reg_kw=dict(rtol=1e-10))
    assert st["width_hist"] == {1: 4}
    assert out[3].reason == pt.ConvergedReason.DIVERGED_MAX_IT
    assert out[1].iterations > out[0].iterations


@pytest.mark.parametrize("spec", [
    "ksp.program=unavailable:at=1:iter=4",
    "spmv.result=bitflip:at=2:times=1"], ids=["crash", "bitflip"])
def test_fault_recovery_matches_jax(spec):
    """A crash mid-block checkpoints, backs off and resumes; a bitflip in
    one column is detected by the ABFT guard, rolled back and re-verified;
    every batch-mate converges, with JAX's events."""
    reg = dict(abft=True) if "bitflip" in spec else None
    out, _ = _parity([(b, {}) for b in _rhs(4, 4).T], reg_kw=reg, spec=spec)
    kinds = [e.kind for e in out[0].recovery_events]
    if "bitflip" in spec:
        assert out[0].sdc_detections == 1
        assert kinds == ["fault", "checkpoint", "rollback", "resume",
                         "verify"]
    else:
        assert kinds == ["fault", "checkpoint", "backoff", "resume"]
    assert all(r.converged and r.attempts == 2 for r in out)


@pytest.mark.parametrize("pkg", PKGS)
def test_non_retriable_failure_reaches_futures(pkg):
    """An ``oom`` the policy does not retry resolves the block's futures
    with the error, and the dispatcher serves the next request."""
    P, _, _, srvmod = MOD[pkg][:4]
    srv = srvmod.SolveServer(_comm(pkg), window=0.0, autostart=False,
                             retry_policy=_policy(pkg))
    try:
        srv.register_operator("p", A2D, rtol=RTOL)
        B = _rhs(2, 5)
        with P.inject_faults("ksp.solve=oom"):
            futs = [srv.submit("p", B[:, j]) for j in range(2)]
            srv.start()
            errs = [_outcome(f) for f in futs]
        assert all(isinstance(e, P.DeviceExecutionError)
                   and e.failure_class == "oom" for e in errs)
        assert srv.solve("p", B[:, 0], timeout=TIMEOUT).converged
    finally:
        srv.shutdown()


def test_device_loss_shrinks_and_regrows_like_jax():
    """A persistent shard loss mid-block: the resilient dispatch reshards
    onto 4 shards, the server adopts the smaller mesh (every session
    rebuilt), and after ``heal()`` the dispatcher grows it back to 8."""
    outs = {}
    for pkg in PKGS:
        P, _, _, srvmod, flt = MOD[pkg][:5]
        comm = _comm(pkg)
        srv = srvmod.SolveServer(comm, window=0.0, max_k=4,
                                 autostart=False, retry_policy=_policy(pkg))
        try:
            srv.register_operator("p", A2D, rtol=RTOL)
            srv.register_operator("q", A2D, pc_type="none", rtol=RTOL)
            B = _rhs(3, 6)
            victim = comm.device_ids[-1]
            with P.inject_faults(f"device.lost=unavailable:device={victim}"
                                 ":at=1:iter=10"):
                futs = [srv.submit("p", B[:, j]) for j in range(2)]
                srv.start()
                res = [_outcome(f) for f in futs]
            shrunk = srv.stats()
            q1 = srv.solve("q", B[:, 2], timeout=TIMEOUT)
            flt.heal()
            r2 = srv.solve("p", B[:, 2], timeout=TIMEOUT)
            grown = srv.stats()
        finally:
            srv.shutdown()
            flt.heal()
        outs[pkg] = (res + [q1, r2], shrunk, grown)
    (oj, sj, gj), (ot, s_t, gt) = outs["jax"], outs["torch"]
    for rj, rt in zip(oj, ot):
        _same_result(rj, rt)
    assert "mesh_shrink" in [e.kind for e in ot[0].recovery_events]
    assert s_t["devices"] == sj["devices"] == 4
    assert gt["devices"] == gj["devices"] == 8
    for key in ("old_devices", "new_devices", "resumed_iteration",
                "rebuild_failures"):
        assert s_t["mesh_shrinks"][0][key] == sj["mesh_shrinks"][0][key]
    assert ([(e["old_devices"], e["new_devices"]) for e in gt["mesh_regrows"]]
            == [(e["old_devices"], e["new_devices"])
                for e in gj["mesh_regrows"]] == [(4, 8)])


def _admission(pkg):
    """The same overload sequence: max_queue 2, two bulk requests, two
    interactive arrivals (each sheds the newest bulk), then a neutral one
    (rejected); a deadline that expires in the queue; then start."""
    _, _, _, srvmod = MOD[pkg][:4]
    P = MOD[pkg][0]
    srv = srvmod.SolveServer(_comm(pkg), window=0.0, max_queue=2,
                             autostart=False)
    B = _rhs(6, 7)
    try:
        srv.register_operator("p", A2D, rtol=RTOL)
        futs = [srv.submit("p", B[:, 0], qos="bulk"),
                srv.submit("p", B[:, 1], qos="bulk"),
                srv.submit("p", B[:, 2], qos="interactive"),
                srv.submit("p", B[:, 3], qos="interactive",
                           deadline=1e-3)]
        with pytest.raises(P.ServerOverloadedError) as rej:
            srv.submit("p", B[:, 4])
        time.sleep(0.02)
        srv.start()
        out = [_outcome(f) for f in futs]
        stats = srv.stats()
    finally:
        srv.shutdown()
    return out, stats, rej.value


def test_overload_shedding_and_deadlines_match_jax():
    (oj, sj, ej), (ot, st, et) = _admission("jax"), _admission("torch")
    _same_stats(sj, st)
    assert (st["shed"], st["rejected"], st["expired"]) == (2, 1, 1)
    assert (et.pending, et.limit, et.shed) == (ej.pending, ej.limit,
                                               ej.shed) == (2, 2, False)
    for rj, rt in zip(oj, ot):
        assert type(rt).__name__ == type(rj).__name__
        if isinstance(rt, pt.ServerOverloadedError):
            assert (rt.shed, rt.pending, rt.limit) == (rj.shed, rj.pending,
                                                       rj.limit)
        elif isinstance(rt, pt.DeadlineExceededError):
            assert rt.deadline == pytest.approx(rj.deadline)
            assert rt.deadline == pytest.approx(1e-3)
        else:
            _same_result(rj, rt)
    assert [type(r).__name__ for r in ot] == [
        "ServerOverloadedError", "ServerOverloadedError",
        "ServedSolveResult", "DeadlineExceededError"]


def test_options_flags_configure_server_like_jax():
    for opts in (tps.global_options(), pt.global_options()):
        opts.set("solve_server_window", "0.25")
        opts.set("solve_server_max_k", "16")
        opts.set("solve_server_pad_pow2", "false")
        opts.set("solve_server_resilient", "false")
        opts.set("solve_server_retry_delay", "0.125")
        opts.set("solve_server_max_queue", "7")
        opts.set("solve_server_deadline", "2.5")
    got = []
    for pkg in PKGS:
        policy = MOD[pkg][0].RetryPolicy.serving()
        srv = MOD[pkg][3].SolveServer(_comm(pkg), window=0.001, max_k=4,
                                      retry_policy=policy, autostart=False)
        try:
            got.append((srv.window, srv.max_k, srv.pad_pow2, srv.resilient,
                        srv.retry_policy.base_delay,
                        srv.retry_policy.max_delay, srv.max_queue,
                        srv.deadline))
            assert policy.base_delay == 0.05       # replaced, not mutated
        finally:
            srv.shutdown()
    assert got[0] == got[1] == (0.25, 16, False, False, 0.125, 1.0, 7, 2.5)


def test_serving_retry_policy_matches_jax():
    assert vars(pt.RetryPolicy.serving()) == vars(tps.RetryPolicy.serving())


def _span_shape(d):
    return (d["name"], tuple(sorted(_span_shape(c)
                                    for c in d.get("children", []))))


def _traced(pkg):
    """A telemetry-armed burst of three: the flight ring's span trees,
    the serving and dispatch counters, and the -log_view serving rows."""
    _, _, _, _, _, prof, sp, fl = MOD[pkg]
    prof.clear_events()
    fl.recorder.clear()
    sp.enable()
    try:
        out, stats = _serve(pkg, [(b, {}) for b in _rhs(3, 8).T],
                            server_kw=dict(max_k=4))
        trees = fl.recorder.spans()
    finally:
        sp.disable()
    buf = io.StringIO()
    prof.log_view(file=buf)
    rows = [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("solve server:", "serving admission",
                              "QoS classes", "compiled-program"))]
    counters = (prof.serving_stats(), prof.qos_counts(),
                prof.dispatch_counts(), prof.admission_counts())
    return out, trees, counters, rows


def test_spans_counters_and_log_view_match_jax():
    oj, tj, cj, rj = _traced("jax")
    ot, tt, ct, rt = _traced("torch")
    for a, b in zip(oj, ot):
        _same_result(a, b)
    shape = lambda trees: sorted(_span_shape(t) for t in trees
                                 if t["name"].startswith("serving."))
    assert shape(tt) == shape(tj)
    reqs = [t for t in tt if t["name"] == "serving.request"]
    disp = [t for t in tt if t["name"] == "serving.dispatch"]
    assert len(reqs) == 3 and len(disp) == 1
    assert {t["attrs"]["batch_span"] for t in reqs} == {disp[0]["span_id"]}
    assert all(t["attrs"]["outcome"] == "ok" for t in reqs)
    assert disp[0]["attrs"]["dispatches"] == 1
    for key in ("requests", "batches", "padded_cols", "width_hist",
                "mean_width"):
        assert ct[0][key] == cj[0][key], key
    assert ct[1:] == cj[1:]
    # the rows, their timings blanked
    blank = lambda rows: [re.sub(r"queue wait .* ms, ", "", r) for r in rows]
    assert blank(rt) == blank(rj)
    assert any(r.startswith("solve server: 1 coalesced dispatch(es), 3 "
                            "request(s), mean width 3.0 [k=3: 1]")
               for r in rt)


def test_stats_and_metrics_endpoint():
    out, st = _serve("torch", [(b, {}) for b in _rhs(3, 9).T])
    assert st["requests"] == 3 and st["batches"] == 1
    assert st["mean_width"] == 3.0
    assert st["queue_wait_p99_s"] >= st["queue_wait_p50_s"] >= 0.0
    srv = server.SolveServer(_comm("torch"), autostart=False)
    try:
        assert "tpu_solve_serving_requests" in srv.metrics_endpoint()
    finally:
        srv.shutdown()


@pytest.mark.parametrize("nsh", [1, 3, 8])
def test_served_block_places_and_fetches_its_columns(nsh):
    """A served block is the ``(n, width)`` block of the requests'
    right-hand sides with zero padding columns, and it travels to the
    shards and back unchanged, on shard counts that pad the rows."""
    comm = pt.DeviceComm(nsh, device="cpu")
    n, k, width = 100, 5, 8
    rhs = np.random.default_rng(15).random((k, n))
    sess = type("Sess", (), {"n": n, "dtype": np.float64})()
    reqs = [type("Req", (), {"b": b})() for b in rhs]
    B = server._block(sess, reqs, width)
    assert B.shape == (n, width)
    np.testing.assert_array_equal(B[:, :k], rhs.T)
    assert not B[:, k:].any()
    np.testing.assert_array_equal(comm.fetch_cols(comm.put_cols(B), n), B)


# ---- behaviours, the same test on each package ------------------------------

def _server(pkg, **kw):
    kw.setdefault("window", 0.0)
    kw.setdefault("autostart", False)
    return MOD[pkg][3].SolveServer(_comm(pkg), **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_submitted_rhs_buffer_can_be_reused(pkg):
    B = _rhs(2, 10)
    srv = _server(pkg)
    try:
        srv.register_operator("p", A2D, rtol=RTOL)
        buf = B[:, 0].copy()
        f1 = srv.submit("p", buf)
        buf[:] = B[:, 1]
        f2 = srv.submit("p", buf)
        srv.start()
        r1, r2 = f1.result(TIMEOUT), f2.result(TIMEOUT)
    finally:
        srv.shutdown()
    X = np.linalg.solve(A2D.toarray(), B)
    np.testing.assert_allclose(r1.x, X[:, 0], atol=1e-6)
    np.testing.assert_allclose(r2.x, X[:, 1], atol=1e-6)


@pytest.mark.parametrize("pkg", PKGS)
def test_request_arriving_mid_flight_lands_in_next_window(pkg):
    seen, started, release = [], threading.Event(), threading.Event()

    def hook(reqs):
        seen.append(list(reqs))
        started.set()
        if len(seen) == 1:
            assert release.wait(TIMEOUT)

    B = _rhs(2, 11)
    srv = _server(pkg, max_k=8)
    try:
        srv.register_operator("p", A2D, rtol=RTOL)
        srv._dispatch_hook = hook
        f1 = srv.submit("p", B[:, 0])
        srv.start()
        assert started.wait(TIMEOUT)
        f2 = srv.submit("p", B[:, 1])
        release.set()
        r1, r2 = f1.result(TIMEOUT), f2.result(TIMEOUT)
    finally:
        release.set()
        srv.shutdown()
    assert [len(b) for b in seen] == [1, 1]
    assert seen[1][0].future is f2 and r1.converged and r2.converged


@pytest.mark.parametrize("pkg", PKGS)
def test_shutdown_flushes_or_fails_pending(pkg):
    B = _rhs(3, 12)
    srv = _server(pkg, max_k=4)
    srv.register_operator("p", A2D, rtol=RTOL)
    futs = [srv.submit("p", B[:, j]) for j in range(3)]
    srv.shutdown(wait=True)            # never started: flushes
    assert all(f.result(0).converged for f in futs)
    with pytest.raises(MOD[pkg][3].ServerClosedError):
        srv.submit("p", B[:, 0])
    srv = _server(pkg)
    srv.register_operator("p", A2D)
    futs = [srv.submit("p", B[:, j]) for j in range(2)]
    srv.shutdown(wait=False)
    for f in futs:
        with pytest.raises(MOD[pkg][3].ServerClosedError):
            f.result(0)


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_and_validation(pkg):
    B = _rhs(1, 13)
    srv = _server(pkg, autostart=True)
    try:
        srv.register_operator("p", A2D, rtol=RTOL)
        f = srv.submit("p", B[:, 0])
        assert srv.drain(timeout=TIMEOUT) and f.done()
        assert srv.drain_operator("p", timeout=TIMEOUT)
        assert srv.solve("p", B[:, 0], timeout=TIMEOUT).converged
        with pytest.raises(ValueError, match="unknown operator"):
            srv.submit("nope", B[:, 0])
        with pytest.raises(ValueError, match="must be"):
            srv.submit("p", B[:-1, 0])
        with pytest.raises(ValueError, match="already registered"):
            srv.register_operator("p", A2D)
        with pytest.raises(ValueError, match="unknown QoS class"):
            srv.submit("p", B[:, 0], qos="urgent")
        assert srv.unregister_operator("p").name == "p"
        assert srv.operators() == []
    finally:
        srv.shutdown()


@pytest.mark.parametrize("pkg", PKGS)
def test_no_batched_kernel_warns(pkg):
    srv = _server(pkg)
    try:
        with pytest.warns(UserWarning, match="no batched kernel"):
            srv.register_operator("p", A2D, ksp_type="gmres")
        # the session still serves, column by column
        f = srv.submit("p", _rhs(1, 14)[:, 0])
        srv.start()
        assert f.result(TIMEOUT).converged
    finally:
        srv.shutdown()


# ---- what the port raises ---------------------------------------------------

def test_multiprocess_comm_raises_naming_its_item():
    """A ProcessComm of two processes (its state, without joining a group:
    the server refuses before any collective) raises naming ROADMAP.md
    Queue A item 7.3."""
    from mpi_petsc4py_example_tpu_torch.parallel.mesh import ProcessComm
    comm = ProcessComm.__new__(ProcessComm)
    comm._nprocs, comm._rank, comm._local = 2, 0, 1
    pt.DeviceComm.__init__(comm, 2, "cpu")
    assert comm.multiprocess
    with pytest.raises(NotImplementedError, match="item 7.3"):
        server.SolveServer(comm, autostart=False)


def test_default_comm_is_the_card():
    """``SolveServer()`` takes the default communicator, which is the
    card's: without CUDA it raises, as every entry point does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default comm is valid")
    pt.set_default_comm(None)
    with pytest.raises(RuntimeError):
        server.SolveServer(autostart=False)


def test_serving_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "mpi_petsc4py_example_tpu_torch" / "serving")
                   .glob("*.py"))
    assert {p.name for p in files} == {"__init__.py", "coalescer.py",
                                       "qos.py", "server.py",
                                       "persistent.py", "fleet.py",
                                       "transport.py", "remote.py"}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names if n.split(".")[0] in
                        ("jax", "jaxlib", "mpi_petsc4py_example_tpu")], path


def test_package_exports_match_jax():
    for name in ("SolveServer", "ServedSolveResult", "ServerClosedError",
                 "ServerOverloadedError", "DeadlineExceededError"):
        assert getattr(pt, name).__name__ == getattr(tps, name).__name__
    assert pt.SolveServer is server.SolveServer
    e = pt.ServerOverloadedError(3, 2, shed=True)
    j = tps.ServerOverloadedError(3, 2, shed=True)
    assert str(e) == str(j)
    assert str(pt.DeadlineExceededError(0.5, 0.25)) == str(
        tps.DeadlineExceededError(0.5, 0.25))
