"""Serving and the asynchronous tier across processes: the port's
``SolveServer``, ``SolveRouter``, ``FleetManager`` and ``MultisplitSolver``
on a ``ProcessComm`` of two processes of a gloo group on 127.0.0.1, each
holding two of four shards, against ``DeviceComm(4, "cpu")`` in this
process and the JAX package's 4-device CPU mesh.

The scenarios are ``facade/drivers/serving_procs.py``'s, one definition
run on every mesh (this process passes the JAX package's modules to the
same ``run_case``). The serving cases ride one launch of ``run.py -n 2
--procs --device cpu`` (a module-scoped fixture), the asynchronous tier's
one more; each launch has a hard timeout well under a minute, so a
deadlock fails its tests instead of hanging the run. Held: every case with
a virtual-mesh twin is bit-equal to ``DeviceComm(4, "cpu")`` (iterations,
reasons, attempts, recovery events, block widths, iterates), and matches
the JAX package's 4-device mesh (iterations and reasons equal, iterates
within 1e-10); JAX cannot itself run multi-process here
(``tests/test_torch_multiprocess.py``). The asynchronous solves are not
deterministic in either package (block threads interleave): they are held
to convergence, relres <= 1e-9, monotone cut versions and one ``psum`` a
convergence check.

Also here: the cross-process exchange (``StoreExchange``) against the
in-process one on the same scenarios, over a ``TCPStore`` of this
process, and the control primitives' identities on the virtual mesh.
"""

import datetime
import json
import os
import pathlib
import pickle
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.serving import fleet as jfleet  # noqa: E402
from mpi_petsc4py_example_tpu.serving import remote as jremote  # noqa: E402
from mpi_petsc4py_example_tpu.serving import server as jserver  # noqa: E402
from mpi_petsc4py_example_tpu.solvers.multisplit import (  # noqa: E402
    MultisplitSolver as JaxMultisplit)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.facade.drivers import (  # noqa: E402
    serving_procs as sp)
from mpi_petsc4py_example_tpu_torch.parallel import exchange  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
DRIVER = (REPO / "mpi_petsc4py_example_tpu_torch" / "facade" / "drivers"
          / "serving_procs.py")
X_TOL = 1e-10
# a launch's hard limit: a deadlock fails its tests, well under a minute
LAUNCH_TIMEOUT_S = 50
JAX_API = {"P": tps, "server": jserver, "fleet": jfleet, "remote": jremote,
           "multisplit": JaxMultisplit, "faults": jfaults,
           "stencil": JaxStencil}

S16 = {"name": "s", "grid": [16, 16, 16],
       "reg": {"pc_type": "jacobi", "rtol": 1e-8}}
P2D = {"name": "a", "op": "p2d16", "reg": {"pc_type": "jacobi", "rtol": 1e-8}}
TRI = {"name": "t", "op": "tri256",
       "reg": {"pc_type": "jacobi", "rtol": 1e-10, "multisplit": True}}


def _reqs(op, seeds, **kw):
    return [dict(op=op, seed=s, **kw) for s in seeds]


# the served cases, each with a twin on DeviceComm(4) and on JAX's mesh
SERVE_CASES = [
    # two operators, per-request rtol, both QoS classes
    dict(name="serve_mixed", kind="serve", ops=[S16, P2D],
         requests=[{"op": "s", "seed": 1},
                   {"op": "a", "seed": 2, "qos": "interactive"},
                   {"op": "s", "seed": 3, "rtol": 1e-10, "qos": "bulk"},
                   {"op": "a", "seed": 4}, {"op": "s", "seed": 5},
                   {"op": "a", "seed": 6, "rtol": 1e-6, "qos": "bulk"}]),
    # cfg9's crash, armed on both ranks: the third block's first attempt
    dict(name="serve_crash_both", kind="serve", ops=[S16], max_k=2,
         requests=_reqs("s", range(6)),
         faults="ksp.program=unavailable:at=3:iter=8"),
    # a fault on rank 0 alone (its twin arms it on the one process)
    dict(name="serve_fault_rank0", kind="serve", ops=[S16], max_k=2,
         requests=_reqs("s", range(4)),
         faults_rank0="ksp.program=unavailable:at=2:iter=5"),
    dict(name="serve_expired_cancelled", kind="serve", ops=[P2D],
         requests=[{"op": "a", "seed": 1},
                   {"op": "a", "seed": 2, "deadline": 1e-6},
                   {"op": "a", "seed": 3}, {"op": "a", "seed": 4}],
         cancel=[2]),
    dict(name="serve_fused", kind="serve",
         ops=[dict(S16, reg=dict(S16["reg"], megasolve=True))],
         requests=_reqs("s", range(4))),
    dict(name="serve_persistent", kind="serve", max_k=4,
         ops=[dict(S16, reg=dict(S16["reg"], persistent=True))],
         requests=_reqs("s", range(6)))]
ROUTE_CASE = dict(name="route_migrate", kind="route", ops=[S16, P2D],
                  requests=_reqs("s", [1]) + _reqs("a", [2, 3]),
                  migrate="a")
FLEET_CASE = dict(name="fleet_failover", kind="fleet",
                  ops=[dict(P2D, reg={"pc_type": "jacobi", "rtol": 1e-10})])
LOST_SERVE_CASE = dict(name="lost_serve", kind="serve", ops=[S16],
                       requests=_reqs("s", range(2)),
                       faults="device.lost=unavailable:at=1")
# a registration that fails on rank 1 alone, then the good one
REG_RANK1_CASE = dict(name="serve_reg_rank1", kind="serve", ops=[S16],
                      requests=_reqs("s", range(2)),
                      reg_rank1={"pc_type": "nosuchpc"})
TWINNED = SERVE_CASES + [ROUTE_CASE, FLEET_CASE]
LAUNCH_A = TWINNED + [LOST_SERVE_CASE, REG_RANK1_CASE]
# the asynchronous tier: cfg16's operator, 2 and 4 blocks on two ranks
MS_CASES = [dict(name=f"ms_{nb}", kind="multisplit", op="tri256", blocks=nb)
            for nb in (2, 4)]
SERVE_MS_CASE = dict(name="serve_ms", kind="serve", ops=[TRI],
                     requests=[{"op": "t", "seed": 1},
                               {"op": "t", "seed": 2, "qos": "interactive"}])
LOST_MS_CASE = dict(name="lost_ms", kind="multisplit", op="tri256",
                    blocks=4, faults="device.lost=unavailable:device=3:at=2")
LAUNCH_B = MS_CASES + [SERVE_MS_CASE, LOST_MS_CASE]


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, jfaults):
        f.reset()
        f.heal()
    yield
    for f in (faults, jfaults):
        f.reset()
        f.heal()


def _launch(tmp, cases):
    """One launch of 2 processes x 2 local shards for ``cases``: each
    case's results on both ranks."""
    (tmp / "cases.json").write_text(json.dumps(cases))
    # a session of its own: a timeout kills the runner and its ranks
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run", "-n",
         "2", "--procs", "--device", "cpu", str(DRIVER),
         str(tmp / "cases.json"), str(tmp / "out")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1",
                           MKL_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        _, err = proc.communicate(timeout=LAUNCH_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, err[-4000:]
    out = {}
    for c in cases:
        out[c["name"]] = [pickle.loads(
            (tmp / "out" / f"{c['name']}.rank{r}.pkl").read_bytes())
            for r in (0, 1)]
    return out


@pytest.fixture(scope="module")
def procs_a(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("serving_procs"), LAUNCH_A)


@pytest.fixture(scope="module")
def procs_b(tmp_path_factory):
    return _launch(tmp_path_factory.mktemp("multisplit_procs"), LAUNCH_B)


@pytest.fixture(scope="module")
def virtual():
    """The twinned cases on ``DeviceComm(4, "cpu")`` in this process, with
    the workers' one thread (the CPU's reductions may round otherwise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {c["name"]: sp.run_case(sp.port_api(),
                                       pt.DeviceComm(4, device="cpu"), c)
                for c in TWINNED}
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_ref():
    """The twinned cases on the JAX package's 4-device CPU mesh."""
    return {c["name"]: sp.run_case(JAX_API, tps.DeviceComm(n_devices=4), c)
            for c in TWINNED}


def _bits(got, want):
    """Equal values, iterates bit for bit."""
    assert got["status"] == want["status"], (got, want)
    if got["status"] != "ok":
        return
    for key in ("iterations", "reason", "attempts", "width", "events"):
        assert got[key] == want[key], key
    assert got["x"].dtype == want["x"].dtype
    assert np.array_equal(got["x"], want["x"])


def _close(got, want):
    """The JAX package's: iterations, reasons and attempts equal, the
    iterate within 1e-10."""
    assert got["status"] == want["status"], (got, want)
    if got["status"] != "ok":
        return
    for key in ("iterations", "reason", "attempts", "events"):
        assert got[key] == want[key], key
    err = (np.linalg.norm(got["x"] - want["x"])
           / max(np.linalg.norm(want["x"]), 1e-300))
    assert err <= X_TOL, err


# ---- the served cases -------------------------------------------------------

@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: c["name"])
def test_served_blocks_bit_equal_to_the_virtual_mesh(case, procs_a,
                                                     virtual):
    lead, _ = procs_a[case["name"]]
    want = virtual[case["name"]]
    assert len(lead["outcomes"]) == len(case["requests"])
    for got, ref in zip(lead["outcomes"], want["outcomes"]):
        _bits(got, ref)
    assert lead["stats"] == want["stats"]


@pytest.mark.parametrize("case", SERVE_CASES, ids=lambda c: c["name"])
def test_served_blocks_match_jax(case, procs_a, jax_ref):
    lead, _ = procs_a[case["name"]]
    want = jax_ref[case["name"]]
    for got, ref in zip(lead["outcomes"], want["outcomes"]):
        _close(got, ref)
    for key in ("requests", "batches", "expired", "width_hist"):
        assert lead["stats"][key] == want["stats"][key], key


def test_every_rank_runs_every_block(procs_a):
    """The followers ran the same block commands, column for column."""
    for c in SERVE_CASES:
        lead, follower = procs_a[c["name"]]
        assert follower["blocks_run"] == lead["blocks_run"]
        assert follower["cols_run"] == lead["cols_run"]
        assert not follower["jax_imported"] and not lead["jax_imported"]


def test_fault_on_both_ranks_and_on_rank0_alone_retries_everywhere(
        procs_a):
    """cfg9's crash armed on both ranks, and a crash armed on rank 0
    alone: the faulted block's columns took a second attempt on every rank
    (the retry was agreed), and nothing hung."""
    for name, block in (("serve_crash_both", 2), ("serve_fault_rank0", 1)):
        lead, follower = procs_a[name]
        outs = lead["outcomes"]
        retried = [j for j, o in enumerate(outs) if o["attempts"] == 2]
        assert retried == [2 * block, 2 * block + 1], name
        assert outs[retried[0]]["events"] == ["fault", "backoff", "resume"]
        assert all(o["reason"] > 0 for o in outs)
        assert follower["blocks_run"] == lead["blocks_run"] == len(outs) // 2


def test_expired_and_cancelled_requests_never_reach_a_follower(procs_a):
    lead, follower = procs_a["serve_expired_cancelled"]
    status = [o["status"] for o in lead["outcomes"]]
    assert status == ["ok", "DeadlineExceededError", "CancelledError", "ok"]
    assert lead["stats"]["expired"] == 1
    assert follower["cols_run"] == lead["cols_run"] == 2


def test_submit_on_rank_1_raises(procs_a):
    for c in SERVE_CASES:
        msg = procs_a[c["name"]][1]["submit_error"]
        assert "rank 0 takes the requests" in msg


def test_router_migration_across_processes(procs_a, virtual, jax_ref):
    """A 2-replica router: the assembled session migrates (its checkpoint
    reload, registration and departure one command on every rank) and
    answers as before, bit for bit as on the virtual mesh."""
    lead, _ = procs_a["route_migrate"]
    want, jref = virtual["route_migrate"], jax_ref["route_migrate"]
    src, dst, owner, on_dst, on_src = lead["placement"]
    assert owner == dst and "a" in on_dst and "a" not in on_src
    assert lead["placement"] == want["placement"]
    for phase in ("before", "after"):
        for got, ref, jr in zip(lead[phase], want[phase], jref[phase]):
            _bits(got, ref)
            _close(got, jr)
    for got, again in zip(lead["before"], lead["after"]):
        assert np.array_equal(got["x"], again["x"])


def test_fleet_failover_across_processes(procs_a, virtual, jax_ref):
    """Two loopback hosts: the owner killed after a lease round, the next
    solve fails over and resumes past iteration 0; rank 1's registration
    came through the stream."""
    lead, follower = procs_a["fleet_failover"]
    want, jref = virtual["fleet_failover"], jax_ref["fleet_failover"]
    assert lead["registered"] and not follower["registered"]
    owner, now, host, dst, sessions, resumed = lead["failover"]
    assert now != owner and host == owner and dst == now
    assert sessions == ("a",) and resumed == lead["first"]["iterations"] > 0
    assert lead["failover"] == want["failover"] == tuple(jref["failover"])
    for key in ("first", "second"):
        _bits(lead[key], want[key])
        _close(lead[key], jref[key])


def test_device_loss_of_a_served_block_raises_naming_item_6_4(procs_a):
    lead, follower = procs_a["lost_serve"]
    for o in lead["outcomes"]:
        assert o["status"] == "NotImplementedError"
        assert "item 6.4" in o["error"]
    assert follower["blocks_run"] == lead["blocks_run"] == 1


# ---- the asynchronous tier --------------------------------------------------

@pytest.fixture(scope="module")
def jax_ms():
    """cfg16's operator on the JAX package's 4-device mesh, 2 and 4
    blocks, cold then warm."""
    return {c["name"]: sp.run_case(JAX_API, tps.DeviceComm(n_devices=4), c)
            for c in MS_CASES}


@pytest.mark.parametrize("case", MS_CASES, ids=lambda c: c["name"])
def test_multisplit_across_processes(case, procs_b, jax_ms):
    """2 and 4 blocks on two ranks (block i on the rank of shard i % 4),
    cold then warm from the cold answer: converged to relres <= 1e-9 at a
    consistent cut, cut versions strictly increasing, one psum a check,
    the same verdict and iterate on both ranks, as JAX's mesh converges."""
    lead, follower = procs_b[case["name"]]
    jref = jax_ms[case["name"]]
    assert "error" not in lead, lead.get("error")
    for tag in ("cold", "warm"):
        got = lead[tag]
        assert got["reason"] > 0 and got["relres"] <= 1e-9
        assert got["cuts"] == sorted(set(got["cuts"]))
        assert got["cut"] == got["cuts"][-1]
        assert np.array_equal(got["x"], follower[tag]["x"])
        assert got["cuts"] == follower[tag]["cuts"]
        assert jref[tag]["reason"] > 0 and jref[tag]["relres"] <= 1e-9
        err = (np.linalg.norm(got["x"] - jref[tag]["x"])
               / np.linalg.norm(jref[tag]["x"]))
        assert err <= 1e-8, err
    assert lead["psum_calls"] == lead["checks"] == follower["psum_calls"]
    assert all(s > 0 for s in lead["cold"]["steps"])


def test_served_multisplit_class_across_processes(procs_b):
    lead, follower = procs_b["serve_ms"]
    A = sp.AIJ["tri256"]()
    for j, o in enumerate(lead["outcomes"]):
        assert o["status"] == "ok" and o["reason"] > 0
        b = sp.rhs(TRI, SERVE_MS_CASE["requests"][j]["seed"])
        assert np.linalg.norm(b - A @ o["x"]) / np.linalg.norm(b) <= 1e-9
    assert follower["cols_run"] == lead["cols_run"] == 2


def test_device_loss_of_a_block_raises_naming_item_6_4(procs_b):
    """Block 3 lives on rank 1: its loss ends the solve on every rank."""
    for res in procs_b["lost_ms"]:
        kind, msg = res["error"]
        assert kind == "NotImplementedError" and "item 6.4" in msg


# ---- the cross-process exchange and the control primitives ------------------

@pytest.fixture(scope="module")
def store():
    return torch.distributed.TCPStore(
        "127.0.0.1", 0, 1, True, datetime.timedelta(seconds=30),
        wait_for_workers=False)


_SERIAL = iter(range(10 ** 6))


def _exchanges(store, nblocks, history=8):
    return (exchange.StaleExchange(nblocks, history=history),
            exchange.StoreExchange(store, f"test/{next(_SERIAL)}", nblocks,
                                   history=history))


def _scenario_publish_read(ex):
    out = [ex.publish(0, np.zeros(2)), ex.publish(0, np.ones(2))]
    r = ex.read(0, reader_version=5)
    u = ex.read(1, reader_version=3)
    out += [r.version, r.age, r.payload.tolist(), u.payload, u.version,
            u.age, ex.versions(), sorted(ex.read_all(0, 1))]
    return out


def _scenario_cut(ex):
    out = [ex.consistent_cut()]
    ex.publish(0, np.full(1, 1.0))
    out.append(ex.consistent_cut())
    ex.publish(1, np.full(1, 2.0))
    ex.publish(1, np.full(1, 3.0))
    v, pay = ex.consistent_cut()
    out.append((v, {k: p.tolist() for k, p in pay.items()}))
    return out


def _scenario_lost(ex):
    ex.publish(0, np.full(1, 1.0))
    ex.publish(1, np.full(1, 2.0))
    ex.publish(1, np.full(1, 3.0))
    ex.mark_lost(0)
    out = [sorted(ex.lost())]
    with pytest.raises(RuntimeError, match="marked lost"):
        ex.publish(0, np.zeros(1))
    v, pay = ex.consistent_cut()
    out.append((v, {k: p.tolist() for k, p in pay.items()}))
    ex.republish(0, np.full(1, 9.0))
    out += [sorted(ex.lost()), ex.version(0), ex.latest(0).payload.tolist()]
    with pytest.raises(ValueError, match="BACKWARD"):
        ex.republish(1, np.zeros(1), version=1)
    return out


def _scenario_waits(ex):
    ex.publish(1, np.zeros(1))
    return [ex.wait_for(1, 1, timeout=0.05), ex.wait_for(0, 1, timeout=0.05)]


def _scenario_pruned(ex):
    ex.publish(0, np.zeros(1))
    for _ in range(4):
        ex.publish(1, np.zeros(1))
    ex.publish(0, np.zeros(1))       # the cut moves to 2: pruned from 1's
    return [ex.consistent_cut(), ex.versions()]


def _scenario_drop(ex):
    with faults.inject_faults("exchange.put=drop:at=2:times=1"):
        out = [ex.publish(0, np.zeros(1)), ex.publish(0, np.zeros(1)),
               ex.publish(0, np.zeros(1))]
    return out + [ex.drops, ex.version(0)]


@pytest.mark.parametrize("scenario", [
    _scenario_publish_read, _scenario_cut, _scenario_lost, _scenario_waits,
    _scenario_pruned, _scenario_drop], ids=lambda f: f.__name__[10:])
def test_store_exchange_keeps_the_exchange_contract(scenario, store):
    """The cross-process exchange answers every scenario as the in-process
    one does (history 3 for the pruned cut)."""
    hist = 3 if scenario is _scenario_pruned else 8
    local, shared = _exchanges(store, 2, history=hist)
    assert scenario(shared) == scenario(local)


@pytest.mark.parametrize("which", [0, 1], ids=["local", "store"])
def test_store_exchange_resync_wait_ends_at_stop(which, store):
    """A resync wait on a partner that never publishes again (it ended on
    another rank) returns once the solve's stop is set, not at its
    timeout; the in-process exchange takes the same ``stop``."""
    import time
    ex = _exchanges(store, 2)[which]
    stop = threading.Event()
    threading.Timer(0.05, stop.set).start()
    t0 = time.monotonic()
    assert ex.wait_for(0, 5, timeout=30.0, stop=stop) is False
    assert time.monotonic() - t0 < 10.0


def test_store_exchange_records_ends_and_errors(store):
    _, ex = _exchanges(store, 3)
    assert ex.finished() == 0 and ex.error() is None
    ex.finish()
    ex.finish(ValueError("block 2 failed"))
    assert ex.finished() == 2
    err = ex.error()
    assert isinstance(err, ValueError) and "block 2" in str(err)
    ex.clear()
    assert ex.finished() == 0 and ex.error() is None


def test_in_process_exchange_finish_records_nothing():
    """``finish`` is one surface of both exchanges: the in-process one has
    nothing to record (its supervisor reads the solver's own state)."""
    ex = exchange.StaleExchange(2)
    assert ex.finish() is None and ex.finish(ValueError("x")) is None
    assert tuple(ex.versions()) == (0, 0) and not ex.lost()


def test_registration_failing_on_rank_1_alone_is_agreed(procs_a):
    """A registration that fails on rank 1 alone raises its error on
    every rank, no rank keeps the session, and the stream goes on in
    lockstep: the good registration after it serves every request."""
    for rec in procs_a["serve_reg_rank1"]:
        assert "unknown PC type 'nosuchpc'" in rec["register_error"]
        assert rec["operators_after_error"] == []
    lead, follower = procs_a["serve_reg_rank1"]
    assert [o["status"] for o in lead["outcomes"]] == ["ok", "ok"]
    assert all(o["reason"] > 0 for o in lead["outcomes"])
    assert lead["blocks_run"] == follower["blocks_run"] >= 1


class _FakeComm:
    """A rank of a two-process comm for the stream's own logic: headers
    come from ``headers``, and ``peer_error`` is what another rank raised
    in the command."""
    multiprocess = True
    device = torch.device("cpu")

    def __init__(self, rank, headers=(), peer_error=None):
        self.rank, self.headers = rank, list(headers)
        self.peer_error, self.sent = peer_error, []
        self.gate = threading.Event()     # a follower's first header waits
        self.gate.set()

    def bcast_obj(self, obj, idle=False):
        if self.rank == 0:
            self.sent.append((obj, idle))
            return obj
        self.gate.wait(30)
        if not self.headers:
            raise RuntimeError("the peer is gone")
        return self.headers.pop(0)

    def agree_error(self, exc):
        return exc if exc is not None else self.peer_error


class _Target:
    def __init__(self):
        self.seen = []

    def hello(self, a):
        self.seen.append(a)
        return a + 1

    def boom(self):
        raise KeyError("no such session on this rank")


def test_leader_raises_what_a_follower_raised_in_a_command():
    """Every command ends with the ranks agreeing on its outcome: rank 0
    raises a follower's failure even where its own run succeeded, and the
    header went over the idle group."""
    from mpi_petsc4py_example_tpu_torch.parallel import control
    comm = _FakeComm(0, peer_error=KeyError("rank 1's session"))
    s, target = control.CommandStream(comm), _Target()
    tag = s.attach(target)
    with pytest.raises(KeyError, match="rank 1's session"):
        s.call(tag, "hello", 1)
    assert target.seen == [1]
    assert comm.sent == [((tag, "hello", (1,), False), True)]


def test_follower_agrees_on_a_command_error_and_goes_on(capsys):
    """A follower's command error is agreed (rank 0 raises it) and the
    follower runs the next command; it stops when the last object
    closes."""
    from mpi_petsc4py_example_tpu_torch.parallel import control
    comm = _FakeComm(1, headers=[(0, "boom", (), False),
                                 (0, "hello", (5,), False),
                                 (0, "__close__", (), False)])
    s, target = control.CommandStream(comm), _Target()
    comm.gate.clear()
    s.attach(target)                    # starts the follower thread
    thread = s._thread
    comm.gate.set()
    assert s.wait_closed(0, 30)
    thread.join(30)
    assert target.seen == [5] and not thread.is_alive()
    assert "command 'boom' raised KeyError" in capsys.readouterr().err


def test_follower_whose_stream_fails_ends_its_process(monkeypatch):
    """A follower that loses the stream (a peer gone, a collective past its
    timeout) ends its process with code 1, so the launcher ends its peers,
    instead of leaving them in a collective."""
    from mpi_petsc4py_example_tpu_torch.parallel import control
    codes = []

    class Ended(Exception):
        pass

    def fake_exit(code):
        codes.append(code)
        raise Ended

    monkeypatch.setattr(control.os, "_exit", fake_exit)
    s = control.CommandStream(_FakeComm(1))
    with pytest.raises(Ended):
        s._follow()
    assert codes == [1]


def test_control_primitives_are_identities_on_the_virtual_mesh():
    comm = pt.DeviceComm(4, device="cpu")
    a = np.arange(12.0).reshape(6, 2)
    assert comm.bcast_obj({"k": 1}) == {"k": 1}
    assert comm.bcast_obj({"k": 2}, idle=True) == {"k": 2}
    assert comm.gather_obj(3) == [3]
    assert comm.scatter_rows(a) is a and comm.gather_to_root(a) is a
    err = ValueError("x")
    assert comm.agree_error(err) is err and comm.agree_error(None) is None
    assert comm.agree_fault(None) is None
    x = torch.arange(8.0).reshape(4, 1, 2)
    with comm.answers_to_root():
        assert np.array_equal(comm.fetch_cols(x, 7),
                              np.arange(7.0).reshape(7, 1))
    assert not comm._root_answers


def test_identity_stream_runs_in_place():
    """On one process the command stream is the identity: a command runs
    here, inside the stream's scope, under its lock."""
    from mpi_petsc4py_example_tpu_torch.parallel import control, mesh
    seen = []

    class Target:
        def hello(self, a, rows=None):
            seen.append((a, mesh.in_stream(), rows))
            return a + 1

    s = control.stream_for(pt.DeviceComm(2, device="cpu"))
    tag = s.attach(Target())
    assert s.call(tag, "hello", 1) == 2
    assert s.call(tag, "hello", 2, rows="r") == 3
    assert seen == [(1, True, None), (2, True, "r")]
    assert not mesh.in_stream() and s.leader and not s.multiprocess


def test_mailbox_meets_every_call_under_contention():
    """SPMD calls and their commands meet in any order: 64 calls race 64
    commands on more threads than cores under a short switch interval, and
    every call returns what its own command made of its own argument."""
    import random
    from mpi_petsc4py_example_tpu_torch.parallel.control import Mailbox
    box, n, got = Mailbox(), 64, {}

    def call(i):
        got[i] = box.post_and_wait(i, 10 * i)

    def command(i):
        box.run(i, lambda v: v + 1, hand_on=True)

    threads = ([threading.Thread(target=call, args=(i,)) for i in range(n)]
               + [threading.Thread(target=command, args=(i,))
                  for i in range(n)])
    random.Random(24).shuffle(threads)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert got == {i: 10 * i + 1 for i in range(n)}


def test_mailbox_hands_a_command_error_to_the_call():
    from mpi_petsc4py_example_tpu_torch.parallel.control import Mailbox
    box, seen = Mailbox(), []

    def call():
        try:
            box.post_and_wait("op", 1)
        except ValueError as exc:
            seen.append(str(exc))

    def boom(v):
        raise ValueError(f"registration of {v} failed")

    t = threading.Thread(target=call)
    t.start()
    with pytest.raises(ValueError, match="registration of 1 failed"):
        box.run("op", boom, hand_on=True)
    t.join(timeout=30)
    assert not t.is_alive() and seen == ["registration of 1 failed"]
