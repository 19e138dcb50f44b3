"""The port's RPC transport and remote replicas (``serving/transport.py``,
``serving/remote.py``) against the JAX package's.

The scenarios of ``tests/test_fleet.py``'s ``TestTransport`` run through both
packages' ``FleetManager`` on the loopback transport, on the 10^2 Poisson
``Mat`` (``poisson2d_csr(10)``) in fp64 on 8 shards: exactly-once execution
under a dropped reply and a duplicated request, a partitioned migration and
its reconcile, a failover resumed past iteration 0, and the suspected
host's quartered deadline. Held equal: host call counts, placements,
resumed iterations and iterations; iterates within 1e-10 relative. The
socket transport runs in-process (a ``SocketHostServer`` thread on
127.0.0.1), skipped only where that address cannot be bound.
"""

import pickle
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.serving import remote as jremote  # noqa: E402
from mpi_petsc4py_example_tpu.serving import transport as jtransport  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import remote  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import transport  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import errors  # noqa: E402

TIMEOUT = 120
X_TOL = 1e-10
A2D = poisson2d_csr(10)
PKGS = ("jax", "torch")
MOD = {"jax": (tps, jremote, jtransport, jfaults),
       "torch": (pt, remote, transport, faults)}


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


def _problem(k=1, seed=0):
    Xt = np.random.default_rng(seed).random((A2D.shape[0], k))
    return Xt, np.asarray(A2D @ Xt)


def _fleet(pkg, hosts, **kw):
    P, rem = MOD[pkg][:2]
    return rem.FleetManager(
        hosts, _comm(pkg), window=0.0, max_k=4,
        retry_policy=P.RetryPolicy(sleep=lambda d: None, base_delay=0.0),
        client_sleep=lambda _d: None, **kw)


def _same(rj, rt):
    assert (rt.iterations, rt.reason) == (rj.iterations, rj.reason)
    err = np.linalg.norm(rt.x - rj.x) / max(np.linalg.norm(rj.x), 1e-300)
    assert err <= X_TOL, err


def _both(fn):
    return fn("jax"), fn("torch")


# ---- the exactly-once contract --------------------------------------------------

def _exactly_once(pkg):
    P = MOD[pkg][0]
    Xt, B = _problem()
    b = B[:, 0]
    mgr = _fleet(pkg, 1)
    try:
        mgr.register_operator("a", A2D, pc_type="jacobi", rtol=1e-10)
        host = mgr.hosts["r0"]
        calls0 = host.rpc.stats["calls"]
        with P.inject_faults("rpc.recv=drop:at=1:times=1"):
            r1 = mgr.submit("a", b).result(timeout=TIMEOUT)
        d1 = host.rpc.stats["calls"] - calls0
        dup = host.rpc.stats["duplicates"]
        calls1 = host.rpc.stats["calls"]
        with P.inject_faults("rpc.send=duplicate:at=1:times=1"):
            r2 = mgr.submit("a", b).result(timeout=TIMEOUT)
        d2 = host.rpc.stats["calls"] - calls1
        requests = mgr.stubs["r0"].stats()["requests"]
    finally:
        mgr.shutdown(wait=False)
    return (d1, dup >= 1, d2, requests), r1, r2, Xt


def test_duplicate_delivery_never_double_solves_like_jax():
    """A reply dropped after the handler ran (the retry joins the cache)
    and a duplicated request each run the solve once: the host's calls
    move by one a logical request, and the queue saw two requests."""
    (cj, r1j, r2j, _), (ct, r1t, r2t, Xt) = _both(_exactly_once)
    assert ct == cj == (1, True, 1, 2)
    _same(r1j, r1t)
    _same(r2j, r2t)
    np.testing.assert_allclose(r2t.x, Xt[:, 0], atol=1e-6)


def _partition(pkg):
    P, _, tr = MOD[pkg][:3]
    Xt, B = _problem()
    b = B[:, 0]
    mgr = _fleet(pkg, 2)
    try:
        mgr.register_operator("p", A2D, pc_type="jacobi", rtol=1e-10)
        src = mgr.router.owner("p")
        dst = next(n for n in mgr.stubs if n != src)
        with P.inject_faults(
                f"rpc.recv=partition:device={int(dst[1:])}:times=*"):
            with pytest.raises((tr.TransportError,
                                P.DeadlineExceededError)):
                mgr.router.migrate("p", dst)
            truthful = mgr.router.owner("p") == src
            r1 = mgr.submit("p", b).result(timeout=TIMEOUT)
        rep = mgr.reconcile()
        after = (mgr.router.owner("p") == src,
                 "p" in mgr.stubs[dst].client.call("resident", {},
                                                   deadline=10.0))
        r2 = mgr.submit("p", b).result(timeout=TIMEOUT)
    finally:
        mgr.shutdown(wait=False)
    return (truthful, rep["orphans_removed"], rep["rehomed"], after), \
        r1, r2, Xt


def test_migration_under_partition_reconciles_like_jax():
    """A partitioned destination: the move fails, placement stays on the
    source (which keeps serving), and reconcile() removes the orphaned
    copy: one owner."""
    (cj, r1j, r2j, _), (ct, r1t, r2t, Xt) = _both(_partition)
    assert ct == cj
    truthful, orphans, rehomed, after = ct
    assert truthful and len(orphans) == 1 and orphans[0][0] == "p"
    assert rehomed == [] and after == (True, False)
    _same(r1j, r1t)
    _same(r2j, r2t)
    np.testing.assert_allclose(r2t.x, Xt[:, 0], atol=1e-6)


def _failover(pkg):
    Xt, B = _problem()
    b = B[:, 0]
    mgr = _fleet(pkg, 2)
    try:
        mgr.register_operator("a", A2D, pc_type="jacobi", rtol=1e-10)
        r1 = mgr.submit("a", b).result(timeout=TIMEOUT)
        table = mgr.lease_step()                 # pull the warm checkpoint
        owner = mgr.router.owner("a")
        mgr.kill_host(owner)
        r2 = mgr.submit("a", b).result(timeout=TIMEOUT)
        ev = mgr.failovers[0]
        st = mgr.stats()
        out = (owner, mgr.router.owner("a"), ev.host, ev.dst, ev.sessions,
               ev.resumed_iteration, st["lease"][owner]["status"],
               [f["resumed_iteration"] for f in st["failovers"]],
               {k: v["status"] for k, v in table.items()})
    finally:
        mgr.shutdown(wait=False)
    return out, r1, r2, Xt


def test_failover_resumes_past_iteration_zero_like_jax():
    """Kill the owner after its checkpoint was pulled: the next submit
    fails over in flight, the survivor resumes from the checkpoint past
    iteration 0, at JAX's iteration, and fp64 parity holds across."""
    (cj, r1j, r2j, _), (ct, r1t, r2t, Xt) = _both(_failover)
    assert ct == cj
    owner, now, host, dst, sessions, resumed, status, evs, table = ct
    assert now != owner and host == owner and dst == now
    assert sessions == ("a",) and resumed > 0 and resumed == r1t.iterations
    assert status == "dead" and evs == [resumed]
    _same(r1j, r1t)
    _same(r2j, r2t)
    np.testing.assert_allclose(r2t.x, Xt[:, 0], atol=1e-6)
    b = _problem()[1][:, 0]
    assert np.linalg.norm(b - A2D @ r2t.x) / np.linalg.norm(b) <= 1.05e-10


def _suspect(pkg):
    mgr = _fleet(pkg, 2)
    try:
        stub = mgr.stubs["r1"]
        full = stub._deadline()
        mgr.transports["r1"].kill()
        tables = [mgr.lease_step() for _ in range(mgr.suspect_after)]
        degraded = (stub.degraded, stub._deadline() / full)
        # two more misses confirm the loss (nothing to re-home)
        tables += [mgr.lease_step()
                   for _ in range(mgr.confirm_after - mgr.suspect_after)]
        return ([{k: dict(v) for k, v in t.items()} for t in tables],
                degraded, len(mgr.failovers))
    finally:
        mgr.shutdown(wait=False)


def test_suspected_host_gets_degraded_deadline_like_jax():
    """The lease ladder: missed pings make the host suspected, which
    quarters its per-call budget; more make it dead."""
    oj, ot = _both(_suspect)
    assert ot == oj
    tables, (degraded, ratio), failovers = ot
    assert tables[1]["r1"]["status"] == "suspected" and degraded
    assert ratio == pytest.approx(0.25)
    assert tables[-1]["r1"]["status"] == "dead" and failovers == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_lease_options_are_read(pkg):
    opt = MOD[pkg][0].global_options()
    opt.set("fleet_transport_lease_s", "0.25")
    opt.set("fleet_transport_suspect_after", "1")
    opt.set("fleet_transport_confirm_after", "2")
    opt.set("fleet_transport", "loopback")
    try:
        mgr = _fleet(pkg, 1)
        try:
            assert (mgr.lease_s, mgr.suspect_after, mgr.confirm_after,
                    mgr.transport_kind) == (0.25, 1, 2, "loopback")
            left = opt.unused()
        finally:
            mgr.shutdown(wait=False)
    finally:
        opt.clear()
    assert not [k for k in left if k.startswith("fleet_")]


@pytest.mark.parametrize("flag,value", [
    ("fleet_transport", "carrier-pigeon"),
    ("fleet_transport_lease_s", "0"),
    ("fleet_transport_suspect_after", "0"),
    ("fleet_transport_confirm_after", "-1"),
    ("rpc_deadline_s", "0"),
    ("rpc_retry_max", "0"),
    ("rpc_backoff_cap_s", "0")])
def test_flags_the_port_cannot_honour_raise(flag, value):
    """JAX takes these silently (an unknown transport becomes loopback);
    the port refuses them."""
    pt.global_options().set(flag, value)
    with pytest.raises(ValueError):
        _fleet("torch", 1)


# ---- the transport itself -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_retry_schedule_matches_jax(seed):
    js = jtransport.RetrySchedule(base=0.02, cap=0.5, seed=seed)
    ps = transport.RetrySchedule(base=0.02, cap=0.5, seed=seed)
    assert [ps.delay(a) for a in range(1, 9)] == [js.delay(a)
                                                 for a in range(1, 9)]


class _Dead:
    """A transport whose every attempt is lost."""
    host_index = 3

    def __init__(self, tr):
        self.tr = tr
        self.attempts = 0

    def call_once(self, msg, timeout):
        self.attempts += 1
        raise self.tr.TransportUnreachableError("lost")


@pytest.mark.parametrize("case", ["attempts", "deadline"])
def test_rpc_client_retries_and_deadline_match_jax(case):
    """Against a host that never answers: ``retry_max`` attempts with the
    schedule's backoffs (``rpc.retries`` each), then
    ``TransportUnreachableError``; or ``RpcDeadlineError`` once the
    budget is spent. The options set the defaults."""
    out = {}
    for pkg in PKGS:
        P, _, tr = MOD[pkg][:3]
        opt = P.global_options()
        opt.set("rpc_retry_max", "5")
        opt.set("rpc_backoff_base_s", "0.01")
        opt.set("rpc_backoff_cap_s", "0.04")
        slept = []
        dead = _Dead(tr)
        try:
            if case == "attempts":
                c = tr.RpcClient(dead, seed=4, sleep=slept.append)
                with pytest.raises(tr.TransportUnreachableError) as ei:
                    c.call("ping", {})
            else:
                c = tr.RpcClient(dead, deadline=0.03, seed=4,
                                 sleep=lambda d: (slept.append(d),
                                                  __import__("time").sleep(d)))
                with pytest.raises(tr.RpcDeadlineError) as ei:
                    c.call("ping", {})
            left = opt.unused()
        finally:
            opt.clear()
        assert not [k for k in left if k.startswith("rpc_")]
        out[pkg] = (type(ei.value).__name__, dead.attempts,
                    c.retry_max, c.deadline)
        if case == "attempts":
            out[pkg] += (slept,)
        else:
            assert ei.value.host == 3 and ei.value.method == "ping"
    assert out["torch"][:1] == out["jax"][:1]
    if case == "attempts":
        assert out["torch"] == out["jax"]
        assert out["torch"][1] == 5 and len(out["torch"][4]) == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_rpc_host_cache_and_unknown_method(pkg):
    tr = MOD[pkg][2]
    runs = []
    host = tr.RpcHost({"echo": lambda p: runs.append(p) or p},
                      host_index=2, cache_cap=2)
    msg = lambda key, p=1: tr.Message(kind="request", method="echo",
                                      idem=key, payload=p)
    assert host.dispatch(msg("a", 1)).payload == 1
    assert host.dispatch(msg("a", 9)).payload == 1      # cached, not re-run
    host.dispatch(msg("b"))
    host.dispatch(msg("c"))                               # evicts "a"
    assert host.dispatch(msg("a", 5)).payload == 5
    assert runs == [1, 1, 1, 5]
    assert host.stats == {"calls": 4, "duplicates": 1, "errors": 0}
    reply = host.dispatch(tr.Message(kind="request", method="nope"))
    assert isinstance(reply.error, KeyError) and reply.host == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_loopback_kill_and_revive(pkg):
    tr = MOD[pkg][2]
    host = tr.RpcHost({"ping": lambda p: "pong"})
    lb = tr.LoopbackTransport(host)
    c = tr.RpcClient(lb, deadline=1.0, retry_max=2, sleep=lambda d: None)
    assert c.call("ping") == "pong"
    lb.kill()
    assert lb.dead
    with pytest.raises(tr.TransportUnreachableError):
        c.call("ping")
    lb.revive()
    assert c.call("ping") == "pong"


def _error_cases():
    return [
        errors.DeadlineExceededError(0.5, 0.25),
        errors.ServerOverloadedError(3, 2, shed=True),
        errors.SilentCorruptionError("KSPSolve", "abft", 7, "col 2"),
        errors.DeviceExecutionError(
            "KSPSolve", RuntimeError("CUDA error: out of memory")),
        transport.RpcDeadlineError("solve", 1, 3, 0.5),
        transport.TransportUnreachableError("host 1 is dead"),
    ]


@pytest.mark.parametrize("i", range(6))
def test_port_errors_survive_marshalling(i):
    """The port's error types cross the wire as themselves, attributes and
    message included (JAX's first four degrade to a ``RuntimeError``
    naming them)."""
    exc = _error_cases()[i]
    out = transport._marshal_exc(exc)
    assert out is exc
    back = pickle.loads(pickle.dumps(out))
    assert type(back) is type(exc) and str(back) == str(exc)
    assert {k: str(v) for k, v in vars(back).items()} == {
        k: str(v) for k, v in vars(exc).items()}


def test_unpicklable_error_degrades_like_jax():
    class Odd(Exception):
        def __init__(self, a, b):
            super().__init__(f"{a}/{b}")

    for tr in (transport, jtransport):
        out = tr._marshal_exc(Odd(1, 2))
        assert type(out) is RuntimeError and str(out) == "Odd: 1/2"


def test_tensor_payloads_are_refused():
    """No ``torch.Tensor`` crosses the wire: a request holding one raises
    before it leaves, a reply holding one reaches the client as the
    handler's error."""
    host = transport.RpcHost({"bad": lambda p: {"x": torch.zeros(2)},
                              "ok": lambda p: {"x": np.zeros(2)}})
    c = transport.RpcClient(transport.LoopbackTransport(host), deadline=1.0,
                            sleep=lambda d: None)
    with pytest.raises(TypeError, match="torch.Tensor"):
        c.call("ok", {"b": [torch.ones(3)]})
    with pytest.raises(TypeError, match="torch.Tensor"):
        c.call("bad", {})
    assert isinstance(c.call("ok", {})["x"], np.ndarray)


def _bindable():
    try:
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.bind(("127.0.0.1", 0))
        probe.close()
        return True
    except OSError:
        return False


def test_socket_round_trip_in_process():
    """A ReplicaHost behind a ``SocketHostServer`` thread on 127.0.0.1: the
    stub registers by shipping the checkpoint bytes, solves to fp64 parity
    with the JAX package's answer, and no frame holds a tensor."""
    if not _bindable():
        pytest.skip("127.0.0.1 cannot be bound here")
    Xt, B = _problem()
    seen = []
    real = transport._send_frame

    def spy(sock, obj, timeout):
        seen.append(obj)
        return real(sock, obj, timeout)

    comm = pt.DeviceComm(8, device="cpu")
    host = remote.ReplicaHost(comm=comm, host_index=0, window=0.0, max_k=4)
    srv = transport.SocketHostServer(host.rpc)
    transport._send_frame = spy
    try:
        assert srv.address[0] == "127.0.0.1"
        client = transport.RpcClient(
            transport.SocketTransport(srv.address, 0), deadline=60.0,
            retry_max=2)
        stub = remote.RemoteReplica(client, name="r0", comm=comm)
        assert stub.hello()["mesh"]["size"] == 8
        stub.register_operator("a", A2D, pc_type="jacobi", rtol=1e-10)
        res = stub.submit("a", B[:, 0]).result(timeout=TIMEOUT)
        assert stub.operators() == ["a"]
        stub.shutdown(wait=False)
    finally:
        transport._send_frame = real
        srv.close()
        host.server.shutdown(wait=False)
    rel = np.linalg.norm(B[:, 0] - A2D @ res.x) / np.linalg.norm(B[:, 0])
    assert rel <= 1.05e-10
    # the JAX package's stub over its loopback, the same request
    jhost = jremote.ReplicaHost(comm=tps.DeviceComm(n_devices=8),
                                host_index=0, window=0.0, max_k=4)
    try:
        jstub = jremote.RemoteReplica(
            jtransport.RpcClient(jtransport.LoopbackTransport(jhost.rpc),
                                 deadline=60.0), name="r0",
            comm=tps.DeviceComm(n_devices=8))
        jstub.register_operator("a", A2D, pc_type="jacobi", rtol=1e-10)
        jres = jstub.submit("a", B[:, 0]).result(timeout=TIMEOUT)
        jstub.shutdown(wait=False)
    finally:
        jhost.server.shutdown(wait=False)
    _same(jres, res)
    kinds = sorted({(m.kind, m.method) for m in seen})
    assert ("request", "solve") in kinds and ("reply", "solve") in kinds
    for m in seen:
        transport._host_only(m.payload, "frame")
        assert not isinstance(m.error, torch.Tensor)
    assert len(host.refresh_seconds) == 1


def test_replica_host_handlers_take_the_session_lock():
    """The register handler's placement, warm solve and checkpoint, and the
    refresh after a solve, run under the server's session lock (the card's
    rule: every CUDA call of a server under its lock)."""
    import threading
    comm = pt.DeviceComm(8, device="cpu")
    lock = threading.RLock()
    held = []

    class Spy:
        def __enter__(self):
            lock.acquire()
            held.append(threading.current_thread().name)

        def __exit__(self, *a):
            lock.release()

    host = remote.ReplicaHost(comm=comm, window=0.0, max_k=4)
    try:
        host.server._session_lock = Spy()
        client = transport.RpcClient(transport.LoopbackTransport(host.rpc),
                                     deadline=60.0)
        stub = remote.RemoteReplica(client, name="r0", comm=comm)
        stub.register_operator("a", A2D, pc_type="jacobi", rtol=1e-10)
        n_reg = len(held)
        stub.submit("a", _problem()[1][:, 0]).result(timeout=TIMEOUT)
    finally:
        host.server.shutdown(wait=False)
    assert n_reg >= 2          # the handler, then register_operator inside
    assert len(held) > n_reg   # the dispatch and the refresh


def test_fleet_manager_shares_one_card_lock():
    mgr = _fleet("torch", 2)
    try:
        locks = {id(h.server._session_lock) for h in mgr.hosts.values()}
        locks |= {id(s._session_lock) for s in mgr.stubs.values()}
        assert locks == {id(mgr.card_lock)}
    finally:
        mgr.shutdown(wait=False)
