"""The port's persistent serving (``serving/persistent.py`` and the
``persistent_serve`` variant of ``solvers/megasolve.py``) against the JAX
package's ``tests/test_persistent.py``.

Each case runs the same seeded burst through both packages' servers
(``autostart=False``, then started) on the 10^2 Poisson ``Mat`` in fp64 on 8
shards (``DeviceComm(8, device="cpu")`` beside JAX's
``DeviceComm(n_devices=8)``), and holds equal: the ``persistent_serve``
dispatches, the runner's stats (launches, requests, padded slots,
fallbacks, rebuilds, turnovers), iterations, reasons, attempts and recovery
events; iterates within 1e-10 relative, each slot's fp64 relative residual
within its own tolerance. The JAX programs run with their disk cache off
(``TPU_SOLVE_AOT=0``). On the CPU the port's program runs its pieces
uncaptured, the plain version of its CUDA graphs; the captured launch is
held bit for bit against it by ``chip_smoke.py --serving`` on the card.
"""

import contextlib
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.serving import server as jserver  # noqa: E402
from mpi_petsc4py_example_tpu.utils import (  # noqa: E402
    profiling as jprofiling)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import server  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import megasolve  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import profiling  # noqa: E402

RTOL = 1e-8
TIMEOUT = 120
X_TOL = 1e-10
A = poisson2d_csr(10)
PKGS = ("jax", "torch")
MOD = {"jax": (tps, jserver, jfaults, jprofiling),
       "torch": (pt, server, faults, profiling)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    for f in (faults, jfaults):
        f.reset()
        f.heal()
    pt.global_options().clear()
    yield
    pt.global_options().clear()
    megasolve.clear_cache()
    for f in (faults, jfaults):
        assert not f.active()
        f.reset()
        f.heal()


def _rhs(k, seed=0):
    return A @ np.random.default_rng(seed).random((A.shape[0], k))


def _comm(pkg):
    return (tps.DeviceComm(n_devices=8) if pkg == "jax"
            else pt.DeviceComm(8, device="cpu"))


def _outcome(fut):
    try:
        return fut.result(TIMEOUT)
    except Exception as exc:  # noqa: BLE001 (the outcome is compared)
        return exc


def _launches(pkg):
    return MOD[pkg][3].dispatch_counts().get("persistent_serve", 0)


def _serve(pkg, B, *, rtols=None, max_k=8, qos=None, reg_kw=None,
           spec=None, hook=None, after=None):
    """A persistent session of ``pkg``: submit the columns of ``B`` (with
    ``rtols``/``qos`` per request), start, wait; ``after(srv)`` runs before
    the shutdown. Returns (outcomes, runner stats, persistent_serve
    dispatches, what ``after`` returned)."""
    P, srvmod = MOD[pkg][:2]
    srv = srvmod.SolveServer(_comm(pkg), window=0.0, max_k=max_k,
                             autostart=False,
                             retry_policy=P.RetryPolicy(
                                 sleep=lambda d: None, base_delay=0.0))
    extra = None
    try:
        reg = dict(pc_type="jacobi", rtol=RTOL, persistent=True)
        reg.update(reg_kw or {})
        srv.register_operator("p", A, **reg)
        srv._dispatch_hook = hook
        d0 = _launches(pkg)
        ctx = P.inject_faults(spec) if spec else contextlib.nullcontext()
        futs = []
        with ctx:
            for j in range(B.shape[1]):
                kw = {}
                if rtols is not None:
                    kw["rtol"] = rtols[j]
                if qos is not None:
                    kw["qos"] = qos[j]
                futs.append(srv.submit("p", B[:, j], **kw))
            srv.start()
            out = [_outcome(f) for f in futs]
        d = _launches(pkg) - d0
        if after is not None:
            extra = after(srv)
        st = srv.stats()["persistent"]["p"] if srv.operators() else {}
    finally:
        srv.shutdown()
    return out, st, d, extra


def _same(rj, rt):
    assert type(rt).__name__ == type(rj).__name__ == "ServedSolveResult"
    assert (rt.iterations, rt.reason, rt.attempts, rt.batch_width) == (
        rj.iterations, rj.reason, rj.attempts, rj.batch_width)
    assert ([e.kind for e in rt.recovery_events]
            == [e.kind for e in rj.recovery_events])
    err = np.linalg.norm(rt.x - rj.x) / max(np.linalg.norm(rj.x), 1e-300)
    assert err <= X_TOL, err


def _parity(B, **kw):
    oj, sj, dj, ej = _serve("jax", B, **kw)
    ot, st, dt, et = _serve("torch", B, **kw)
    assert st == sj
    assert dt == dj
    for rj, rt in zip(oj, ot):
        _same(rj, rt)
    return ot, st, dt, (ej, et)


def _relres(B, out):
    return [np.linalg.norm(B[:, j] - A @ r.x) / np.linalg.norm(B[:, j])
            for j, r in enumerate(out)]


# ---- basics -----------------------------------------------------------------

def test_burst_rides_one_launch_with_slot_parity():
    """Six requests ride one launch (padded to 8) in both packages, with
    equal persistent_serve counts; each slot equals the port's direct
    fused solve of its column."""
    B = _rhs(6)
    out, st, d, _ = _parity(B)
    assert d == 1 and st["launches"] == 1 and st["requests"] == 6
    assert st["padded_slots"] == 2 and st["fallbacks"] == 0
    comm = pt.DeviceComm(8, device="cpu")
    ksp = pt.KSP().create(comm)
    ksp.set_operators(pt.Mat.from_scipy(comm, A))
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=RTOL, max_it=100)
    ksp.megasolve = True
    for j, r in enumerate(out):
        assert r.converged and r.batch_width == 6
        X = np.zeros((A.shape[0], 1))
        ksp.solve_many(B[:, j:j + 1], X)
        err = np.linalg.norm(r.x - X[:, 0]) / np.linalg.norm(X[:, 0])
        assert err < 1e-10, (j, err)


def test_ragged_final_launch_resolves_everything():
    out, st, d, _ = _parity(_rhs(7), max_k=4)
    assert st["launches"] == d == 2 and st["requests"] == 7
    assert st["padded_slots"] == 1
    assert all(r.converged for r in out)


def test_mixed_tolerance_groups_share_one_launch():
    """Three tolerance groups, two launches: the first batch opens launch 1
    alone, groups 2 and 3 stage into launch 2 together; each slot meets its
    own tolerance, and the 1e-10 slots iterate past the 1e-6 ones."""
    B = _rhs(6, 2)
    rtols = [1e-4, 1e-4, 1e-6, 1e-6, 1e-10, 1e-10]
    out, st, d, _ = _parity(B, rtols=rtols)
    assert d == st["launches"] == 2 and st["requests"] == 6
    for j, rel in enumerate(_relres(B, out)):
        assert out[j].converged and rel <= rtols[j] * 1.05, (j, rel)
    assert min(r.iterations for r in out[4:]) > max(
        r.iterations for r in out[2:4])


def test_mixed_difficulty_slots_each_meet_tolerance():
    B = _rhs(4, 3)
    B[:, 1] *= 1e6
    B[:, 3] *= 1e-6
    out, st, _, _ = _parity(B, max_k=4)
    assert st["launches"] == 1
    for j, rel in enumerate(_relres(B, out)):
        assert out[j].converged and rel <= RTOL * 1.05, (j, rel)


@pytest.mark.parametrize("pkg", PKGS)
def test_options_flag_enables_persistent(pkg):
    MOD[pkg][0].global_options().set("solve_server_persistent", "true")
    try:
        srv = MOD[pkg][1].SolveServer(_comm(pkg), window=0.0,
                                      autostart=False)
        try:
            srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL)
            assert srv._sessions["p"].persistent is not None
            assert srv._sessions["p"].ksp.megasolve
            f = srv.submit("p", _rhs(1)[:, 0])
            srv.start()
            assert f.result(TIMEOUT).converged
        finally:
            srv.shutdown()
    finally:
        MOD[pkg][0].global_options().clear("solve_server_persistent")


@pytest.mark.parametrize("pkg", PKGS)
def test_guarded_session_falls_back_to_per_batch(pkg):
    srv = MOD[pkg][1].SolveServer(_comm(pkg), window=0.0, autostart=False)
    try:
        with pytest.warns(UserWarning, match="falling back"):
            srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                                  abft=True, persistent=True)
        assert srv._sessions["p"].persistent is None
        f = srv.submit("p", _rhs(1)[:, 0])
        srv.start()
        assert f.result(TIMEOUT).converged
    finally:
        srv.shutdown()


def test_late_guard_warns_once_and_matches_jax():
    """A guard armed after registration sends every launch to the per-batch
    fallback, warning once a registration."""
    got = {}
    for pkg in PKGS:
        srv = MOD[pkg][1].SolveServer(
            _comm(pkg), window=0.0, max_k=4, autostart=False,
            retry_policy=MOD[pkg][0].RetryPolicy(sleep=lambda d: None))
        try:
            srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                                  persistent=True)
            srv._sessions["p"].ksp.abft = True
            B = _rhs(2)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                f0 = srv.submit("p", B[:, 0])
                srv.start()
                r0 = f0.result(TIMEOUT)
                r1 = srv.solve("p", B[:, 1], timeout=TIMEOUT)
            n_warn = sum("guard was enabled after registration"
                         in str(w.message) for w in caught)
            got[pkg] = (r0, r1, n_warn, dict(srv.stats()["persistent"]["p"]))
        finally:
            srv.shutdown()
    for rj, rt in zip(got["jax"][:2], got["torch"][:2]):
        _same(rj, rt)
    assert got["torch"][2:] == got["jax"][2:]
    assert got["torch"][2] == 1 and got["torch"][3]["fallbacks"] == 2


def test_complex_slots_match_jax():
    """complex128 slots (the Hermitian Poisson matrix, complex right-hand
    sides) ride one launch; the iterate's real and imaginary parts travel
    in the launch's one read."""
    got = {}
    rng = np.random.default_rng(12)
    B = rng.random((A.shape[0], 3)) + 1j * rng.random((A.shape[0], 3))
    for pkg in PKGS:
        P, srvmod = MOD[pkg][:2]
        comm = _comm(pkg)
        op = P.Mat.from_scipy(comm, A.astype(np.complex128),
                              dtype=np.complex128 if pkg == "jax"
                              else torch.complex128)
        srv = srvmod.SolveServer(comm, window=0.0, max_k=4, autostart=False)
        try:
            srv.register_operator("p", op, pc_type="jacobi", rtol=RTOL,
                                  persistent=True)
            futs = [srv.submit("p", B[:, j]) for j in range(3)]
            srv.start()
            got[pkg] = ([f.result(TIMEOUT) for f in futs],
                        dict(srv.stats()["persistent"]["p"]))
        finally:
            srv.shutdown()
    for rj, rt in zip(got["jax"][0], got["torch"][0]):
        _same(rj, rt)
        assert np.iscomplexobj(rt.x)
    assert got["torch"][1] == got["jax"][1]
    for j, rel in enumerate(_relres(B, got["torch"][0])):
        assert rel <= RTOL * 1.05, (j, rel)


# ---- overlap and ordering ---------------------------------------------------

def test_double_buffer_turnover_under_backlog():
    """Eight staged requests at capacity 4: the second batch turns the
    buffer over, launch 2 opening before launch 1 resolves; two launches
    for eight requests in both packages."""
    seen = {}
    for pkg in PKGS:
        overlap, futs = [], []

        def hook(reqs, overlap=overlap, futs=futs):
            if len(overlap) == 1:
                overlap.append(all(not f.done() for f in futs[:4]))
            elif not overlap:
                overlap.append(True)

        P, srvmod = MOD[pkg][:2]
        srv = srvmod.SolveServer(_comm(pkg), window=0.0, max_k=4,
                                 autostart=False)
        try:
            srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                                  persistent=True)
            srv._dispatch_hook = hook
            d0 = _launches(pkg)
            B = _rhs(8)
            futs.extend(srv.submit("p", B[:, j]) for j in range(8))
            srv.start()
            res = [f.result(TIMEOUT) for f in futs]
            seen[pkg] = (res, overlap, _launches(pkg) - d0,
                         dict(srv.stats()["persistent"]["p"]))
        finally:
            srv.shutdown()
    for rj, rt in zip(seen["jax"][0], seen["torch"][0]):
        _same(rj, rt)
    assert seen["torch"][1:] == seen["jax"][1:]
    assert seen["torch"][1] == [True, True] and seen["torch"][2] == 2
    assert seen["torch"][3]["turnovers"] >= 1


def test_qos_order_fills_slots_interactive_first():
    for pkg in PKGS:
        order, done = [], []
        P, srvmod = MOD[pkg][:2]
        srv = srvmod.SolveServer(_comm(pkg), window=0.0, max_k=2,
                                 autostart=False)
        try:
            srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                                  persistent=True)
            srv._dispatch_hook = lambda reqs: order.append(
                [r.qos for r in reqs])
            B = _rhs(4)
            fb = [srv.submit("p", B[:, j], qos="bulk") for j in range(2)]
            fi = [srv.submit("p", B[:, j + 2], qos="interactive")
                  for j in range(2)]
            for tag, fs in (("bulk", fb), ("interactive", fi)):
                for f in fs:
                    f.add_done_callback(
                        lambda _f, tag=tag: done.append(tag))
            srv.start()
            [f.result(TIMEOUT) for f in fb + fi]
            assert srv.stats()["persistent"]["p"]["requests"] == 4
        finally:
            srv.shutdown()
        assert order[0] == ["interactive", "interactive"], pkg
        assert done[:2] == ["interactive", "interactive"], pkg


def test_turnover_resolves_the_launch_in_flight_first(monkeypatch):
    """The port's launch runs to its end when it opens, so a turnover
    resolves the launch in flight before the next one runs: launch 2 of
    eight requests at capacity 4 finds launch 1's futures resolved."""
    from mpi_petsc4py_example_tpu_torch.serving.persistent import (
        PersistentRunner)
    done_at_launch, futs = [], []
    launch = PersistentRunner._launch_device

    def recording(self, rec):
        done_at_launch.append(sum(f.done() for f in futs))
        return launch(self, rec)

    monkeypatch.setattr(PersistentRunner, "_launch_device", recording)
    srv = server.SolveServer(pt.DeviceComm(8, device="cpu"), window=0.0,
                             max_k=4, autostart=False)
    try:
        srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                              persistent=True)
        B = _rhs(8)
        futs.extend(srv.submit("p", B[:, j]) for j in range(8))
        srv.start()
        assert all(f.result(TIMEOUT).converged for f in futs)
        st = srv.stats()["persistent"]["p"]
    finally:
        srv.shutdown()
    assert done_at_launch == [0, 4]
    assert st["launches"] == 2 and st["turnovers"] == 1


# ---- resilience -------------------------------------------------------------

def test_fault_resolves_every_slot_future():
    """An armed fault plan sends the launch through the resilient per-batch
    path: the fault fires at the program boundary, the retry tier recovers,
    every slot converges with JAX's events."""
    out, st, _, _ = _parity(_rhs(4, 3), max_k=4,
                            spec="ksp.program=unavailable:at=1:iter=4")
    assert st["fallbacks"] == 1 and st["launches"] == 1
    assert all(r.converged and r.attempts == 2 for r in out)
    assert [e.kind for e in out[0].recovery_events] == [
        "fault", "checkpoint", "backoff", "resume"]


def test_device_loss_shrinks_then_rebuilds_resident_program():
    """A shard lost mid-launch: every slot resolves through the elastic
    tier, the server adopts the smaller mesh, and the next launch builds
    the persistent program for it (``rebuilds``), with no second
    fallback."""
    B = _rhs(3, 5)

    def after(srv):
        r2 = srv.solve("p", B[:, 2], timeout=TIMEOUT)
        return r2, srv.comm.size, dict(srv.stats()["persistent"]["p"])

    out, st, _, (ej, et) = _parity(
        B[:, :2], max_k=4, after=after,
        spec="device.lost=unavailable:device=7:at=1:iter=10")
    assert "mesh_shrink" in {e.kind for e in out[0].recovery_events}
    assert all(r.converged and r.iterations > 0 for r in out)
    _same(ej[0], et[0])
    assert et[1:] == ej[1:]
    assert et[1] == 4
    assert et[2]["rebuilds"] == 1 and et[2]["fallbacks"] == 1


def test_fallback_failure_resolves_every_slot_with_the_error():
    """A failure the retry policy does not recover resolves every slot's
    future with the error; nothing runs elsewhere and nothing hangs."""
    got = {}
    for pkg in PKGS:
        out, st, _, _ = _serve(pkg, _rhs(3), max_k=4,
                               spec="ksp.solve=oom:times=*")
        got[pkg] = ([(type(e).__name__, e.failure_class) for e in out], st)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [("DeviceExecutionError", "oom")] * 3


@pytest.mark.parametrize("pkg", PKGS)
def test_drain_flushes_staged_and_inflight(pkg):
    srv = MOD[pkg][1].SolveServer(_comm(pkg), window=0.0, max_k=4,
                                  autostart=False)
    try:
        srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                              persistent=True)
        B = _rhs(5)
        futs = [srv.submit("p", B[:, j]) for j in range(5)]
        srv.start()
        assert srv.drain(timeout=TIMEOUT)
        assert all(f.done() and f.result(0).converged for f in futs)
        assert srv._persistent_unresolved() == 0
        assert srv.solve("p", B[:, 0], timeout=TIMEOUT).converged
    finally:
        srv.shutdown()


# ---- the persistent program of the port -------------------------------------

def _program(k, stencil=False):
    comm = pt.DeviceComm(4, device="cpu")
    op = (pt.StencilPoisson3D(comm, 8) if stencil
          else pt.Mat.from_scipy(comm, A))
    pc = pt.PC(comm)
    pc.set_type("jacobi")
    pc.set_operators(op)
    pc.set_up()
    prog = megasolve.build_megasolve_program_many(
        comm, "cg", pc, op, nrhs=k, persistent=True,
        stencil_fastpath=stencil)
    return comm, op, pc, prog


def _launch(prog, comm, Bh, rt, at, dtype=torch.float64):
    Bd = comm.put_cols(Bh, dtype)
    out = prog.launch(Bd, None, rt, at, np.asarray(rt).copy(), 1e4, 500,
                      megasolve.GATE_REFINE_MAX, -3)
    return (out["x"].clone(), out["head"].tolist(),
            out["cols"].tolist())


@pytest.mark.parametrize("stencil", [False, True], ids=["mat", "stencil"])
def test_tolerances_change_without_a_new_program(stencil):
    """The per-slot tolerances are runtime buffers: another set of them
    takes the same cached program (no new capture on the card), and a
    padding slot (zero RHS, zero tolerances) freezes at outer step 0."""
    comm, op, pc, prog = _program(4, stencil)
    n = op.shape[0]
    B = np.zeros((n, 4))
    B[:, :3] = np.random.default_rng(7).random((n, 3))
    _, _, cols1 = _launch(prog, comm, B, [1e-4, 1e-6, 1e-10, 0.0],
                          [0.0] * 4)
    again = megasolve.build_megasolve_program_many(
        comm, "cg", pc, op, nrhs=4, persistent=True,
        stencil_fastpath=stencil)
    assert again is prog and len(megasolve._PERSISTENT_CACHE) == 1
    _, _, cols2 = _launch(prog, comm, B, [1e-10, 1e-6, 1e-4, 0.0],
                          [0.0] * 4)
    ii1, rn1, rs1 = cols1
    ii2, rn2, rs2 = cols2
    assert ii1[0] < ii1[1] < ii1[2] and ii2[2] < ii2[1] < ii2[0]
    assert (ii1[0], ii1[2]) == (ii2[2], ii2[0])
    assert ii1[3] == ii2[3] == 0 and rn1[3] == 0.0
    assert all(r > 0 for r in rs1 + rs2)


@pytest.mark.parametrize("stencil", [False, True], ids=["mat", "stencil"])
def test_uniform_tolerances_equal_the_batched_program(stencil):
    """With one tolerance in every slot the persistent variant is the
    batched fused program bit for bit."""
    comm, op, pc, prog = _program(4, stencil)
    n = op.shape[0]
    B = np.random.default_rng(8).random((n, 4))
    x, head, cols = _launch(prog, comm, B, [1e-9] * 4, [0.0] * 4)
    many = megasolve.build_megasolve_program_many(
        comm, "cg", pc, op, nrhs=4, stencil_fastpath=stencil)
    assert many is not prog
    res = many(comm.put_cols(B, torch.float64), None, 1e-9, 0.0, 1e-9, 1e4,
               500, megasolve.GATE_REFINE_MAX, -3)
    assert torch.equal(res.x, x)
    assert head[0] == res.steps and cols[0] == res.iters
    assert cols[1] == res.rnorm and cols[2] == res.reason


def test_persistent_program_refuses_the_guard():
    comm, op, pc, _ = _program(2)
    with pytest.raises(ValueError, match="persistent"):
        megasolve.build_megasolve_program_many(
            comm, "cg", pc, op, nrhs=2, persistent=True, rr=True, rr_n=5)


def test_persistent_launch_reads_the_host_once(monkeypatch):
    """A launch's resolve makes one host read (its iterate and per-slot
    results in one copy), counted with the flag reads of its replays."""
    reads = []
    orig = torch.Tensor.cpu

    def counting(self, *a, **kw):
        reads.append(tuple(self.shape))
        return orig(self, *a, **kw)

    srv = server.SolveServer(pt.DeviceComm(8, device="cpu"), window=0.0,
                             max_k=4, autostart=False)
    try:
        srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                              persistent=True)
        syncs0 = profiling.sync_counts().get("persistent launch", 0)
        B = _rhs(3)
        futs = [srv.submit("p", B[:, j]) for j in range(3)]
        monkeypatch.setattr(torch.Tensor, "cpu", counting)
        srv.start()
        res = [f.result(TIMEOUT) for f in futs]
        srv.drain(TIMEOUT)
    finally:
        monkeypatch.undo()
        srv.shutdown()
    assert len(reads) == 1
    assert (profiling.sync_counts()["persistent launch"] - syncs0
            == res[0].host_syncs)


def test_stats_threads_and_log_view_row():
    """The requests-per-launch row of -log_view, and concurrent client
    threads staging into shared launches."""
    import io
    profiling.clear_events()
    srv = server.SolveServer(pt.DeviceComm(8, device="cpu"), window=0.01,
                             max_k=8)
    B = _rhs(8, 9)
    futs = [None] * 8
    try:
        srv.register_operator("p", A, pc_type="jacobi", rtol=RTOL,
                              persistent=True)

        def client(j):
            futs[j] = srv.submit("p", B[:, j], rtol=RTOL * (1 + j / 16))

        ts = [threading.Thread(target=client, args=(j,)) for j in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(TIMEOUT)
            assert not t.is_alive()
        res = [f.result(TIMEOUT) for f in futs]
        assert srv.drain(TIMEOUT)
        st = srv.stats()["persistent"]["p"]
    finally:
        srv.shutdown()
    for j, rel in enumerate(_relres(B, res)):
        assert res[j].converged and rel <= RTOL * (1 + j / 16) * 1.05
    assert st["requests"] == 8 and st["launches"] < 8
    buf = io.StringIO()
    profiling.log_view(file=buf)
    assert (f"persistent requests-per-launch histogram ({st['launches']} "
            "launch(es)") in buf.getvalue()
