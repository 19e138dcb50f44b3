"""The port's fleet router (``serving/fleet.py``: ``HashRing``,
``SolveRouter``) against the JAX package's.

Every check runs the same seeded inputs through both packages: the hash
ring's placement on 1000 keys, and routers of 1-3 replicas serving the 10^2
Poisson ``Mat`` of ``tests/test_fleet.py`` (``poisson2d_csr(10)``) and a
12 x 10 x 8 stencil, in fp64 on 8 shards (``DeviceComm(8, device="cpu")``
beside JAX's ``DeviceComm(n_devices=8)``). Held equal: owners and moved
sessions, iterations, reasons, decisions and counters; iterates within
1e-10 relative. Every future is waited on with a timeout and every router
is shut down in ``finally``.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.serving import fleet as jfleet  # noqa: E402
from mpi_petsc4py_example_tpu.serving import qos as jqos  # noqa: E402
from mpi_petsc4py_example_tpu.telemetry import flight as jflight  # noqa: E402
from mpi_petsc4py_example_tpu.telemetry import metrics as jmetrics  # noqa: E402
from mpi_petsc4py_example_tpu.telemetry import spans as jspans  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import fleet  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import qos  # noqa: E402
from mpi_petsc4py_example_tpu_torch.telemetry import flight  # noqa: E402
from mpi_petsc4py_example_tpu_torch.telemetry import metrics  # noqa: E402
from mpi_petsc4py_example_tpu_torch.telemetry import spans  # noqa: E402

RTOL = 1e-8
TIMEOUT = 120
X_TOL = 1e-10
A2D = poisson2d_csr(10)
PKGS = ("jax", "torch")
MOD = {"jax": (tps, jfleet, jqos, jfaults, jmetrics, jspans, jflight),
       "torch": (pt, fleet, qos, faults, metrics, spans, flight)}


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


def _comm(pkg):
    return (tps.DeviceComm(n_devices=8) if pkg == "jax"
            else pt.DeviceComm(8, device="cpu"))


def _problem(k=4, seed=0):
    Xt = np.random.default_rng(seed).random((A2D.shape[0], k))
    return Xt, np.asarray(A2D @ Xt)


def _policy(pkg):
    return MOD[pkg][0].RetryPolicy(sleep=lambda d: None, base_delay=0.0)


def _router(pkg, n, **kw):
    kw.setdefault("window", 0.0)
    kw.setdefault("max_k", 4)
    return MOD[pkg][1].SolveRouter(n, _comm(pkg), **kw)


def _same(rj, rt):
    assert (rt.iterations, rt.reason, rt.batch_width) == (
        rj.iterations, rj.reason, rj.batch_width)
    err = np.linalg.norm(rt.x - rj.x) / max(np.linalg.norm(rj.x), 1e-300)
    assert err <= X_TOL, err


def _both(fn):
    """``fn(pkg)`` for each package, the JAX result first."""
    return fn("jax"), fn("torch")


# ---- the hash ring ------------------------------------------------------------

KEYS = [f"op{i}" for i in range(1000)]


@pytest.mark.parametrize("vnodes", [16, 64])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_hash_ring_owners_match_jax(vnodes, n):
    names = [f"r{i}" for i in range(n)]
    jr = jfleet.HashRing(names, vnodes=vnodes)
    pr = fleet.HashRing(names, vnodes=vnodes)
    assert [pr.owner(k) for k in KEYS] == [jr.owner(k) for k in KEYS]
    assert len({pr.owner(k) for k in KEYS}) == n
    # a replica added takes keys only onto itself; one removed gives up
    # only its own; both exactly as JAX's ring
    before = [pr.owner(k) for k in KEYS]
    jr.add("rX")
    pr.add("rX")
    after = [pr.owner(k) for k in KEYS]
    assert after == [jr.owner(k) for k in KEYS]
    assert all(a == b or a == "rX" for a, b in zip(after, before))
    jr.remove("r0")
    pr.remove("r0")
    gone = [pr.owner(k) for k in KEYS]
    assert gone == [jr.owner(k) for k in KEYS]
    assert all(g == a for g, a in zip(gone, after) if a != "r0")
    assert "r0" not in gone and pr.replicas() == jr.replicas()


@pytest.mark.parametrize("key", ["", "p", "op0", "ünïcode", "a#3"])
def test_stable_hash_matches_jax(key):
    assert fleet._stable_hash(key) == jfleet._stable_hash(key)


def test_hash_ring_membership_errors():
    for pkg in PKGS:
        ring = MOD[pkg][1].HashRing(["r0"], vnodes=4)
        with pytest.raises(ValueError, match="already on the ring"):
            ring.add("r0")
        with pytest.raises(ValueError, match="not on the ring"):
            ring.remove("r9")
        ring.remove("r0")
        with pytest.raises(ValueError, match="empty hash ring"):
            ring.owner("p")
        assert len(ring) == 0


# ---- routing ------------------------------------------------------------------

def _route(pkg):
    Xt, B = _problem(k=3)
    rt = _router(pkg, 2)
    try:
        rt.register_operator("p", A2D, pc_type="jacobi", rtol=RTOL)
        res = [rt.solve("p", B[:, j], timeout=TIMEOUT) for j in range(3)]
        owner = rt.owner("p")
        served = rt.replica(owner).stats()["requests"]
    finally:
        rt.shutdown()
    return owner, served, res, Xt


def test_routes_to_owner_and_answers_like_jax():
    (oj, sj, rj, _), (ot, st, rt, Xt) = _both(_route)
    assert ot == oj and st == sj == 3
    for a, b, j in zip(rj, rt, range(3)):
        _same(a, b)
        assert b.converged
        np.testing.assert_allclose(b.x, Xt[:, j], atol=1e-6)


def _shard(pkg):
    rt = _router(pkg, 3)
    try:
        for i in range(16):
            rt.register_operator(f"op{i}", A2D, rtol=RTOL)
        return {f"op{i}": rt.owner(f"op{i}") for i in range(16)}
    finally:
        rt.shutdown()


def test_sessions_shard_across_replicas_like_jax():
    oj, ot = _both(_shard)
    assert ot == oj and len(set(ot.values())) > 1


@pytest.mark.parametrize("pkg", PKGS)
def test_unknown_operator_and_duplicate(pkg):
    _, B = _problem()
    rt = _router(pkg, 2)
    try:
        rt.register_operator("p", A2D, rtol=RTOL)
        with pytest.raises(ValueError, match="unknown operator"):
            rt.submit("nope", B[:, 0])
        with pytest.raises(ValueError, match="already registered"):
            rt.register_operator("p", A2D)
        with pytest.raises(ValueError, match="unknown operator"):
            rt.owner("nope")
        with pytest.raises(ValueError, match="unknown replica"):
            rt.migrate("p", "r9")
        assert rt.operators() == ["p"]
    finally:
        rt.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        rt.submit("p", B[:, 0])


def test_fleet_flags_like_jax():
    """``-fleet_replicas``/``-fleet_vnodes`` win over the arguments, are
    read (``Options.unused`` does not list them), and the placement they
    give is JAX's."""
    out = {}
    for pkg in PKGS:
        opt = MOD[pkg][0].global_options()
        opt.set("fleet_replicas", "3")
        opt.set("fleet_vnodes", "8")
        try:
            rt = _router(pkg, 1, vnodes=64)
            try:
                for i in range(6):
                    rt.register_operator(f"op{i}", A2D, rtol=RTOL)
                out[pkg] = (rt.replicas(), rt.vnodes,
                            {op: rt.owner(op) for op in rt.operators()})
                left = opt.unused()
            finally:
                rt.shutdown()
        finally:
            opt.clear()
        assert "fleet_replicas" not in left and "fleet_vnodes" not in left
    assert out["torch"] == out["jax"]
    assert out["torch"][:2] == (["r0", "r1", "r2"], 8)


@pytest.mark.parametrize("flag,value", [("fleet_replicas", "0"),
                                        ("fleet_vnodes", "0")])
def test_fleet_flags_below_one_raise(flag, value):
    """JAX clamps these to 1 without a word; the port refuses a value it
    cannot honour."""
    pt.global_options().set(flag, value)
    with pytest.raises(ValueError, match="at least 1"):
        _router("torch", 2)


# ---- migration ----------------------------------------------------------------

def _migrate(pkg):
    Xt, B = _problem(k=3, seed=7)
    P, _, _, _, reg = MOD[pkg][:5]
    moved0 = reg.registry.counter("fleet.migrations").total()
    rt = _router(pkg, 2)
    try:
        rt.register_operator("p", A2D, pc_type="jacobi", rtol=RTOL)
        src = rt.owner("p")
        dst = [n for n in rt.replicas() if n != src][0]
        before = rt.solve("p", B[:, 0], timeout=TIMEOUT)
        rt.migrate("p", dst)
        after = rt.solve("p", B[:, 1], timeout=TIMEOUT)
        placed = (rt.owner("p"), "p" in rt.replica(dst).operators(),
                  "p" in rt.replica(src).operators(),
                  rt.replica(dst).stats()["requests"], src, dst)
        rt.migrate("p", dst)                 # already there: nothing moves
    finally:
        rt.shutdown()
    moved = reg.registry.counter("fleet.migrations").total() - moved0
    # the uninterrupted direct solve of the same column
    comm = _comm(pkg)
    M = P.Mat.from_scipy(comm, A2D)
    ksp = P.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=RTOL)
    x, bv = M.get_vecs()
    bv.set_global(B[:, 1])
    ref = ksp.solve(bv, x)
    return before, after, placed, moved, ref.iterations, x.to_numpy(), Xt


def test_migration_round_trip_matches_jax():
    """Solves before and after a move agree with JAX's and with an
    uninterrupted direct solve: iterations equal, x within 1e-10."""
    (bj, aj, pj, mj, _, _, _), (bt, at, ptab, mt, its, xref, Xt) = \
        _both(_migrate)
    _same(bj, bt)
    _same(aj, at)
    assert ptab == pj
    owner, on_dst, on_src, served, src, dst = ptab
    assert owner == dst and on_dst and not on_src and served == 1
    assert mt == mj == 1
    assert at.iterations == its == bt.iterations
    err = np.linalg.norm(at.x - xref) / np.linalg.norm(xref)
    assert err <= X_TOL
    np.testing.assert_allclose(at.x, Xt[:, 1], atol=1e-6)


def _held(pkg):
    """A submission landing mid-migration is held and replayed on the
    destination: the source dispatcher is pinned in a block so that
    migrate()'s drain really waits while a client submits."""
    Xt, B = _problem(k=3, seed=9)
    rt = _router(pkg, 2)
    try:
        rt.register_operator("p", A2D, pc_type="jacobi", rtol=RTOL)
        src = rt.owner("p")
        dst = [n for n in rt.replicas() if n != src][0]
        src_srv = rt.replica(src)
        in_flight, release = threading.Event(), threading.Event()

        def hook(reqs):
            in_flight.set()
            assert release.wait(60)

        src_srv._dispatch_hook = hook
        f0 = rt.submit("p", B[:, 0])
        assert in_flight.wait(60)
        mig = threading.Thread(target=rt.migrate, args=("p", dst))
        mig.start()
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            with rt._lock:
                if "p" in rt._migrating:
                    break
            time.sleep(0.005)
        f1 = rt.submit("p", B[:, 1])
        held = not f1.done()
        src_srv._dispatch_hook = None
        release.set()
        mig.join(TIMEOUT)
        assert not mig.is_alive()
        r0, r1 = f0.result(TIMEOUT), f1.result(TIMEOUT)
        return (held, rt.owner("p") == dst,
                rt.replica(dst).stats()["requests"], r0, r1, Xt)
    finally:
        rt.shutdown(wait=False)


def test_submissions_held_during_migration_replay_like_jax():
    (hj, oj, sj, r0j, r1j, _), (ht, ot, st, r0t, r1t, Xt) = _both(_held)
    assert (ht, ot, st) == (hj, oj, sj) == (True, True, 1)
    _same(r0j, r0t)
    _same(r1j, r1t)
    np.testing.assert_allclose(r1t.x, Xt[:, 1], atol=1e-6)


def _stencil_migrate(pkg):
    """A stencil session cannot be checkpointed (no ``to_scipy``): its
    migration fails, rolls back, and it keeps serving on the source."""
    P = MOD[pkg][0]
    comm = _comm(pkg)
    op = (JaxStencil(comm, 12, 10, 8) if pkg == "jax"
          else pt.StencilPoisson3D(comm, 12, 10, 8))
    b = np.random.default_rng(3).random(op.shape[0])
    rt = _router(pkg, 2)
    try:
        rt.register_operator("s", op, pc_type="jacobi", rtol=RTOL)
        src = rt.owner("s")
        dst = [n for n in rt.replicas() if n != src][0]
        with pytest.raises(AttributeError, match="to_scipy"):
            rt.migrate("s", dst)
        kept = (rt.owner("s") == src, "s" in rt.replica(src).operators(),
                "s" not in rt.replica(dst).operators(),
                dict(rt._overrides))
        res = rt.solve("s", b, timeout=TIMEOUT)
    finally:
        rt.shutdown()
    assert P is not None
    return kept, res


def test_stencil_session_migrate_fails_and_keeps_serving_like_jax():
    (kj, rj), (kt, rt) = _both(_stencil_migrate)
    assert kt == kj == (True, True, True, {})
    _same(rj, rt)
    assert rt.converged


def _grow(pkg):
    rt = _router(pkg, 2)
    try:
        for i in range(8):
            rt.register_operator(f"op{i}", A2D, rtol=RTOL)
        before = {op: rt.owner(op) for op in rt.operators()}
        name = rt.add_replica()
        after = {op: rt.owner(op) for op in rt.operators()}
        landed = sorted(rt.replica(name).operators())
    finally:
        rt.shutdown()
    return name, before, after, landed


def test_add_replica_migrates_the_minimum_like_jax():
    (nj, bj, aj, lj), (nt, bt, at, lt) = _both(_grow)
    assert (nt, bt, at, lt) == (nj, bj, aj, lj)
    moved = sorted(op for op in bt if at[op] != bt[op])
    assert moved == lt and all(at[op] == nt for op in moved)
    assert len(moved) < len(bt)


def _remove(pkg):
    Xt, B = _problem(k=1)
    rt = _router(pkg, 3)
    try:
        for i in range(6):
            rt.register_operator(f"op{i}", A2D, pc_type="jacobi",
                                 rtol=RTOL)
        victim = rt.owner("op0")
        rt.remove_replica(victim)
        placed = {op: rt.owner(op) for op in rt.operators()}
        res = rt.solve("op0", B[:, 0], timeout=TIMEOUT)
        with pytest.raises(KeyError):
            rt.remove_replica("r9")
        return victim, rt.replicas(), placed, res, Xt
    finally:
        rt.shutdown()


def test_remove_replica_rehomes_sessions_like_jax():
    (vj, rj, pj, sj, _), (vt, rt, ptab, st, Xt) = _both(_remove)
    assert (vt, rt, ptab) == (vj, rj, pj)
    assert vt not in rt and vt not in ptab.values()
    _same(sj, st)
    np.testing.assert_allclose(st.x, Xt[:, 0], atol=1e-6)


@pytest.mark.parametrize("pkg", PKGS)
def test_cannot_remove_the_last_replica(pkg):
    rt = _router(pkg, 1)
    try:
        with pytest.raises(ValueError, match="last replica"):
            rt.remove_replica("r0")
    finally:
        rt.shutdown()


# ---- autoscale and heal ---------------------------------------------------------

def _scale(pkg, high, low, solve):
    _, B = _problem()
    q = MOD[pkg][2]
    pol = q.AutoscalePolicy(high_p99_s=high, low_p99_s=low, max_replicas=3)
    rt = _router(pkg, 2, autoscale=pol)
    try:
        rt.register_operator("p", A2D, rtol=RTOL)
        if solve:
            rt.solve("p", B[:, 0], timeout=TIMEOUT)   # a queue wait
        d = rt.autoscale_step()
        return d.action, rt.replicas(), rt.owner("p")
    finally:
        rt.shutdown()


@pytest.mark.parametrize("case", ["grow", "hold"])
def test_autoscale_step_executes_like_jax(case):
    args = (1e-9, 0.0, True) if case == "grow" else (1e9, 0.0, False)
    dj, dt = _both(lambda pkg: _scale(pkg, *args))
    assert dt == dj
    assert dt[0] == case
    assert len(dt[1]) == (3 if case == "grow" else 2)


def _rebalance(pkg):
    """A rebalance decision migrates one session of the busiest replica to
    the idlest (the decision injected, the execution the router's)."""
    q = MOD[pkg][2]

    class Fixed:
        def decide(self, stats):
            return q.ScaleDecision("rebalance", ("r0", "r1"), "injected")

    rt = _router(pkg, 2, autoscale=Fixed())
    try:
        for i in range(4):
            rt.register_operator(f"op{i}", A2D, rtol=RTOL)
        before = {op: rt.owner(op) for op in rt.operators()}
        d = rt.autoscale_step()
        return d.action, before, {op: rt.owner(op) for op in rt.operators()}
    finally:
        rt.shutdown()


def test_autoscale_rebalance_migrates_one_session_like_jax():
    oj, ot = _both(_rebalance)
    assert ot == oj
    _, before, after = ot
    moved = [op for op in before if after[op] != before[op]]
    assert len(moved) <= 1
    if moved:
        assert (before[moved[0]], after[moved[0]]) == ("r0", "r1")


def _heal(pkg):
    P, _, _, flt = MOD[pkg][:4]
    Xt, B = _problem(k=4, seed=6)
    comm = _comm(pkg)
    victim = comm.device_ids[-1]
    rt = MOD[pkg][1].SolveRouter(1, comm, window=0.003, max_k=4,
                                 retry_policy=_policy(pkg))
    try:
        rt.register_operator("p", A2D, pc_type="jacobi", rtol=RTOL)
        with P.inject_faults(f"device.lost=unavailable:device={victim}"
                             ":at=1:iter=4"):
            futs = [rt.submit("p", B[:, j]) for j in range(4)]
            res = [f.result(TIMEOUT) for f in futs]
        shrunk = rt.stats()["mesh_shrinks"]
        none = rt.heal_check()
        flt.heal()
        one = rt.heal_check()
        grown = rt.stats()
        r = rt.solve("p", B[:, 0], timeout=TIMEOUT)
    finally:
        rt.shutdown(wait=False)
        flt.heal()
    return (shrunk, none, one, grown["mesh_regrows"],
            grown["per_replica"]["r0"]["devices"]), res, r, Xt


def test_heal_check_after_a_device_loss_like_jax():
    """The fleet's heal hook: a device loss shrinks the replica's mesh;
    ``heal_check`` grows it back only after ``heal()``."""
    (cj, resj, rj, _), (ct, rest, rt, Xt) = _both(_heal)
    assert ct == cj == (1, 0, 1, 1, 8)
    assert all(r.converged for r in rest)
    assert sorted(r.iterations for r in rest) == sorted(
        r.iterations for r in resj)
    _same(rj, rt)
    np.testing.assert_allclose(rt.x, Xt[:, 0], atol=1e-6)


# ---- telemetry ------------------------------------------------------------------

def _traced_migration(pkg):
    _, _, _, _, reg, sp, fl = MOD[pkg]
    fl.recorder.clear()
    g0 = reg.registry.counter("fleet.scale_decisions").total()
    sp.enable()
    try:
        _migrate(pkg)
        trees = fl.recorder.spans()
        events = fl.recorder.events("fleet_migration")
    finally:
        sp.disable()
    names = sorted(t["name"] for t in trees if t["name"].startswith("fleet"))
    return (names, len(events), reg.registry.gauge("fleet.replicas").value(),
            reg.registry.counter("fleet.scale_decisions").total() - g0)


def test_migration_span_event_and_gauge_like_jax():
    oj, ot = _both(_traced_migration)
    assert ot == oj
    assert ot[0] == ["fleet.migrate"] and ot[1] == 1 and ot[2] == 2


# ---- what the port keeps of its own ---------------------------------------------

def test_replicas_share_one_session_lock():
    """Replicas the router builds share its ``card_lock`` (every CUDA call
    of every replica exclusive: no graph capture meets another replica's
    work); a replica added later joins it."""
    rt = _router("torch", 2)
    try:
        locks = {id(rt.replica(n)._session_lock) for n in rt.replicas()}
        assert locks == {id(rt.card_lock)}
        name = rt.add_replica()
        assert rt.replica(name)._session_lock is rt.card_lock
    finally:
        rt.shutdown()
