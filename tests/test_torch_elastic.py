"""Elastic recovery of ROADMAP.md Queue A item 6 against the JAX package:
the sticky ``device.lost`` registry, the ``HealthMonitor``, the
``MeshRebuilder`` ladder, the shrink and regrow of a resilient solve, and
the guarded solve on a ``ProcessComm``.

The cases of ``tests/test_elastic.py`` (the solver ones; the serving cases
come with ROADMAP.md Queue A item 7): the port's ``DeviceComm`` shards play
the JAX mesh's devices, and each recovery runs through both packages on the
same seeded problem (``poisson2d_csr``, the 8x12x16 stencil) in fp64 on 8,
4 or 2 shards: the recovery events (kind, attempt, devices before and
after, the resumed iteration), the iterations and the final shard count
equal, the answers within 1e-12 relative. A ``ProcessComm`` cannot drop a
process: its shrink raises naming Queue A item 6.4, while the guard and the
retry run on 2 gloo processes bit for bit against ``DeviceComm(4)``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.resilience import elastic as jelastic  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import retry as jretry  # noqa: E402
from mpi_petsc4py_example_tpu.utils.errors import (  # noqa: E402
    DeviceExecutionError as JaxDeviceExecutionError)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import elastic  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import retry  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.checkpoint import (  # noqa: E402
    load_solve_state)
from mpi_petsc4py_example_tpu_torch.utils.errors import (  # noqa: E402
    DeviceExecutionError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOSLEEP = {"sleep": lambda _d: None}
GRID = (8, 12, 16)
PKG = {"jax": (tps, jfaults, jelastic, jretry),
       "torch": (pt, faults, elastic, retry)}


@pytest.fixture(autouse=True)
def _clean():
    for f in (faults, jfaults):
        f.heal()
        f.reset()
    pt.global_options().clear()
    yield
    for f in (faults, jfaults):
        f.heal()
        f.reset()
    pt.global_options().clear()


def _comm(pkg, n):
    return (tps.DeviceComm(n_devices=n) if pkg == "jax"
            else pt.DeviceComm(n, device="cpu"))


def _setup(pkg, n, n_side=16, op="mat", pc="jacobi", rtol=1e-10):
    P = PKG[pkg][0]
    comm = _comm(pkg, n)
    if op == "stencil":
        M = (JaxStencil(comm, *GRID) if pkg == "jax"
             else pt.StencilPoisson3D(comm, *GRID))
        A = None
    else:
        A = poisson2d_csr(n_side)
        M = P.Mat.from_scipy(comm, A)
    ksp = P.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("cg")
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol)
    x, b = M.get_vecs()
    b.set_global(np.random.default_rng(7).random(M.shape[0]))
    return ksp, A, x, b


def _events(res):
    return [(e.kind, e.attempt, e.old_devices, e.new_devices, e.iterations)
            for e in res.recovery_events]


# ------------------------------------------------------- the lost registry

def test_mark_heal_roundtrip_and_epoch():
    e0 = faults.heal_epoch()
    faults.mark_lost(3)
    faults.mark_lost(5, reason="test")
    assert faults.lost_devices() == frozenset({3, 5})
    assert faults.heal(3) == (3,) and faults.heal(3) == ()
    assert faults.heal() == (5,) and faults.lost_devices() == frozenset()
    assert faults.heal_epoch() == e0 + 2


def test_check_lost_raises_only_on_overlap():
    faults.check_lost((0, 1, 2))
    faults.mark_lost(2)
    faults.check_lost((0, 1))
    with pytest.raises(faults.XlaRuntimeError, match="device 2"):
        faults.check_lost((0, 1, 2))


@pytest.mark.parametrize("spec,ids,calls", [
    ("device.lost=unavailable:device=3:at=2", (0, 1, 2, 3), 3),
    ("device.lost=unavailable", (4, 1, 2), 2),
    ("device.lost=unavailable:device=6:iter=9", (0, 1), 2)])
def test_mesh_fault_counts_solves_and_sticks_like_jax(spec, ids, calls):
    """At=N picks the Nth solve on a mesh holding the device; a fired
    loss sticks in the registry until heal(); the default device is the
    mesh's highest id."""
    out = []
    for mod in (faults, jfaults):
        got = []
        with mod.inject_faults(spec):
            for _ in range(calls):
                f = mod.mesh_fault("device.lost", ids)
                got.append(None if f is None else (f.device, f.iter_k))
        got.append(sorted(mod.lost_devices()))
        f = mod.mesh_fault("device.lost", ids)
        got.append(None if f is None else f.device)
        mod.heal()
        got.append(mod.mesh_fault("device.lost", ids))
        out.append(got)
    assert out[0] == out[1]


def test_lost_device_blocks_placement():
    comm = pt.DeviceComm(4, device="cpu")
    faults.mark_lost(comm.device_ids[-1])
    with pytest.raises(faults.XlaRuntimeError, match="LOST"):
        pt.Mat.from_scipy(comm, poisson2d_csr(6))


# ------------------------------------------------------------ HealthMonitor

def _unavailable(pkg, device=None):
    mod = PKG[pkg][1]
    f = mod.Fault("ksp.program", "unavailable", device=device)
    cls = JaxDeviceExecutionError if pkg == "jax" else DeviceExecutionError
    return cls("KSPSolve", f.error())


@pytest.mark.parametrize("devices", [[5, 5], [None, None], [1, "ok", 1],
                                     [7]])
def test_health_monitor_matches_jax(devices):
    """Attributed failures classify a loss at the threshold; unattributed
    ones are persistent but exclude nothing; a success resets the
    evidence; the device is read from the wrapped runtime error."""
    out = []
    for pkg in PKG:
        mon = PKG[pkg][1].HealthMonitor(threshold=2)
        seen = []
        for d in devices:
            if d == "ok":
                mon.healthy()
            else:
                seen.append(mon.record(_unavailable(pkg, d)))
        exc = _unavailable(pkg, devices[-1] if devices[-1] != "ok" else 1)
        out.append((seen, mon.persistent(), sorted(mon.lost_devices()),
                    PKG[pkg][1].device_from_error(exc)))
    assert out[0] == out[1]
    mon = faults.HealthMonitor()
    assert not mon.heal_observed()
    faults.mark_lost(1)
    faults.heal()
    assert mon.heal_observed() and not mon.heal_observed()


# ------------------------------------------------------------ MeshRebuilder

@pytest.mark.parametrize("case", [
    "pow2", "all_survivors", "unattributed", "speculative", "min_floor",
    "one_device", "survivors_and_argument", "grow_rung"])
def test_mesh_rebuilder_matches_jax(case):
    """The ladder: 7 survivors of 8 land on 4 (all 7 without pow2), an
    unattributed failure shrinks only when speculative halving is on, the
    floor and a 1-device mesh stop it, survivors exclude the registry and
    the monitor's set, and regrow needs a strictly larger rung."""
    out = []
    for pkg in PKG:
        P, mod, el, _ret = PKG[pkg]
        comm8 = _comm(pkg, 8)
        pol = el.ElasticPolicy(
            prefer_pow2=case != "all_survivors",
            shrink_unattributed=case == "speculative",
            min_devices=8 if case == "min_floor" else 1)
        rb = el.MeshRebuilder(pol)
        if case not in ("unattributed", "speculative", "one_device"):
            mod.mark_lost(comm8.device_ids[-1])
        if case == "survivors_and_argument":
            surv = rb.survivors(comm8, lost={comm8.device_ids[0]})
            out.append(sorted(int(getattr(d, "id", d)) for d in surv))
        elif case == "grow_rung":
            mod.heal()
            comm2 = _comm(pkg, 2)
            g = rb.grown_comm(comm2, comm8)
            mod.mark_lost(5)
            mod.mark_lost(6)
            mod.mark_lost(7)
            g2 = rb.grown_comm(comm2, comm8)
            g3 = rb.grown_comm(_comm(pkg, 4), comm8)
            out.append((g.size, list(g.device_ids), g2.size, g3))
        else:
            c = rb.shrunk_comm(_comm(pkg, 1) if case == "one_device"
                               else comm8)
            out.append(None if c is None else (c.size, list(c.device_ids)))
        mod.heal()
    assert out[0] == out[1]


def test_policy_from_options_matches_jax():
    for opt in (tps.global_options(), pt.global_options()):
        for k, v in (("elastic_enable", "0"),
                     ("elastic_max_same_mesh_retries", "7"),
                     ("elastic_min_devices", "2"),
                     ("elastic_shrink_unattributed", "1"),
                     ("elastic_regrow", "0")):
            opt.set(k, v)
    a, p = jelastic.ElasticPolicy.from_options(), \
        elastic.ElasticPolicy.from_options()
    from dataclasses import asdict
    assert asdict(a) == asdict(p)
    assert p.enabled is False and p.max_same_mesh_retries == 7
    tps.global_options().clear()
    assert elastic.ElasticPolicy().regrow is True


def test_rebuild_operator_requires_a_hook():
    class Opaque:
        dtype = torch.float64
    with pytest.raises(ValueError, match="cannot be rebuilt"):
        elastic.rebuild_operator(Opaque(), pt.DeviceComm(2, device="cpu"))
    op = pt.StencilPoisson3D(pt.DeviceComm(4, device="cpu"), *GRID)
    op2 = elastic.rebuild_operator(op, pt.DeviceComm(2, device="cpu"))
    assert op2.comm.size == 2 and op2.grid3d == (8, 12, 8)
    assert op.assemble() is op and op.assembled


# ------------------------------------------------------ elastic recovery

def _elastic_run(pkg, spec, n, tmp_path=None, many=False, op="mat",
                 max_same=1, enabled=True, sleep=None, rtol=1e-10):
    P, mod, el, ret = PKG[pkg]
    ksp, A, x, b = _setup(pkg, n, op=op, rtol=rtol,
                          pc="none" if op == "stencil" else "jacobi")
    policy = ret.RetryPolicy(sleep=sleep or (lambda _d: None))
    kw = dict(elastic=el.ElasticPolicy(max_same_mesh_retries=max_same,
                                       enabled=enabled))
    if tmp_path is not None:
        kw["checkpoint_path"] = str(tmp_path / f"{pkg}.npz")
    with mod.inject_faults(spec):
        if many:
            B = np.random.default_rng(5).random((b.n, 3))
            res = ret.resilient_solve_many(ksp, B, None, policy, **kw)
            xs = np.asarray(res.X)
        else:
            res = ret.resilient_solve(ksp, b, x, policy, **kw)
            xs = x.to_numpy()
    return res, xs, ksp


@pytest.mark.parametrize("spec,n,many,op,ckpt", [
    ("device.lost=unavailable:device={last}:iter=20", 8, False, "mat", False),
    ("device.lost=unavailable:device=3:iter=25,"
     "device.lost=unavailable:device=4,device.lost=unavailable:device=5,"
     "device.lost=unavailable:device=6,device.lost=unavailable:device=7",
     8, False, "mat", True),
    ("device.lost=unavailable:device={last}:iter=10", 8, True, "mat", False),
    ("device.lost=unavailable:device={last}:iter=5", 8, False, "stencil",
     False),
    ("device.lost=unavailable:device={last}:iter=8", 4, False, "mat", False),
    ("ksp.program=unavailable:iter=4", 4, False, "mat", False)])
def test_elastic_recovery_matches_jax(tmp_path, spec, n, many, op, ckpt):
    """A permanent loss mid-solve rebuilds on a strictly smaller mesh and
    resumes from the checkpointed iteration (from memory on the
    matrix-free stencil); most of the machine lost lands on 2; a block
    replays every column; a transient crash keeps the same-mesh trail."""
    spec = spec.format(last=n - 1)
    out = []
    for pkg in PKG:
        res, xs, ksp = _elastic_run(pkg, spec, n, tmp_path if ckpt
                                    else None, many=many, op=op)
        its = list(res.iterations) if many else res.iterations
        out.append((_events(res), its, res.attempts, ksp.comm.size,
                    list(ksp.comm.device_ids), bool(res.converged), xs))
        if pkg == "torch" and ckpt:
            it = load_solve_state(str(tmp_path / "torch.npz"), ksp.comm)[3]
            assert it == 25
        PKG[pkg][1].heal()
    assert out[0][:6] == out[1][:6]
    assert out[1][5]
    np.testing.assert_allclose(out[1][6], out[0][6], rtol=0,
                               atol=1e-12 * np.abs(out[0][6]).max())
    shrinks = [e for e in out[1][0] if e[0] == "mesh_shrink"]
    if "device.lost" in spec:
        assert shrinks and shrinks[0][3] < shrinks[0][2]


def test_disabled_policy_reraises_original():
    out = []
    for pkg in PKG:
        with pytest.raises((DeviceExecutionError, JaxDeviceExecutionError),
                           match="worker") as ei:
            _elastic_run(pkg, "device.lost=unavailable:device=3", 4,
                         enabled=False)
        out.append(ei.value.failure_class)
        PKG[pkg][1].heal()
    assert out == ["unavailable", "unavailable"]


def test_regrow_after_heal_matches_jax(tmp_path):
    """Shrink on a loss, heal during the next transient's backoff, regrow
    to the provisioned mesh at the following failure, resuming from its
    checkpoint each time."""
    out = []
    for pkg in PKG:
        mod = PKG[pkg][1]
        healed = []

        def sleep_heals(_d):
            if not healed:
                healed.append(mod.heal())

        res, xs, ksp = _elastic_run(
            pkg, "device.lost=unavailable:device=3:at=1:iter=10,"
            "ksp.program=unavailable:at=2:times=2:iter=20", 4, tmp_path,
            max_same=2, sleep=sleep_heals)
        out.append((_events(res), res.iterations, ksp.comm.size, xs))
    assert out[0][:3] == out[1][:3]
    kinds = [e[0] for e in out[1][0]]
    assert "mesh_shrink" in kinds and "mesh_regrow" in kinds
    assert out[1][2] == 4
    np.testing.assert_allclose(out[1][3], out[0][3], rtol=0,
                               atol=1e-12 * np.abs(out[0][3]).max())


def test_session_helpers_reshard_in_place():
    """``shrink_solve_session``/``regrow_solve_session`` rebind the
    caller's Vecs and ``warm`` runs the rebuilt session at zero cost."""
    ksp, A, x, b = _setup("torch", 4)
    xh = x.to_numpy().copy()
    elastic.shrink_solve_session(ksp, pt.DeviceComm(2, device="cpu"), b=b,
                                 x=x)
    assert ksp.comm.size == 2 and x.comm.size == 2 and b.comm.size == 2
    np.testing.assert_array_equal(x.to_numpy(), xh)
    elastic.regrow_solve_session(ksp, pt.DeviceComm(4, device="cpu"), b=b,
                                 x=x)
    assert ksp.comm.size == 4 and x.comm.size == 4
    elastic.warm(ksp, widths=(2,))
    assert ksp.result.iterations == 0
    assert ksp.solve(b, x).converged


def test_package_surface_matches_jax():
    assert pt.ElasticPolicy is elastic.ElasticPolicy
    assert pt.resilience.MeshRebuilder is elastic.MeshRebuilder
    for name in ("rebuild_operator", "rebuild_ksp", "rebind_vec",
                 "replant_vectors", "warm", "shrink_solve_session",
                 "regrow_solve_session"):
        assert callable(getattr(elastic, name)) and \
            callable(getattr(jelastic, name))


# ----------------------------------------------------------- across processes

CASES = [dict(name="sdc", kind="sdc", grid=list(GRID),
              spec="spmv.result=bitflip:at=2:times=1", local_shards=2),
         dict(name="sdc_many", kind="sdc", grid=list(GRID), k=3,
              spec="pc.apply=bitflip:at=2:times=1", local_shards=2)]


def test_guard_and_retry_on_process_comm_bit_equal(tmp_path):
    """2 gloo processes x 2 shards: every rank parses the spec and fires
    at the same site, so the detector, the detection iteration, the
    rolled-back iterate, the recovery and its answer are DeviceComm(4)'s,
    bit for bit."""
    cases = str(tmp_path / "cases.json")
    with open(cases, "w") as f:
        json.dump(CASES, f)
    script = os.path.join(REPO, "mpi_petsc4py_example_tpu_torch", "facade",
                          "drivers", "parity.py")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    run = lambda args: subprocess.run(
        [sys.executable, *args], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    r = run(["-m", "mpi_petsc4py_example_tpu_torch.run", "-n", "2",
             "--procs", "--device", "cpu", script, cases,
             str(tmp_path / "procs")])
    assert r.returncode == 0, r.stderr[-2000:]
    r = run([script, cases, str(tmp_path / "virtual"), "--virtual", "4",
             "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    for c in CASES:
        got = np.load(str(tmp_path / "procs" / f"{c['name']}.npz"))
        ref = np.load(str(tmp_path / "virtual" / f"{c['name']}.npz"))
        for key in ("detector", "det_it", "its", "events", "x", "attempts"):
            np.testing.assert_array_equal(got[key], ref[key])
        assert str(got["detector"]) in ("abft", "abft_pc")


def test_process_comm_elastic_raises_naming_its_item():
    """A lost process cannot leave a torch.distributed group unless the
    survivors form a new one: the elastic calls raise on a ProcessComm."""
    class FakeProcessComm:
        multiprocess = True
        size = 4
        device_ids = (0, 1, 2, 3)
        device = torch.device("cpu")
    rb = elastic.MeshRebuilder()
    faults.mark_lost(3)
    with pytest.raises(NotImplementedError, match="item 6.4"):
        rb.shrunk_comm(FakeProcessComm())
    with pytest.raises(NotImplementedError, match="item 6.4"):
        elastic.rebuild_operator(pt.StencilPoisson3D(
            pt.DeviceComm(4, device="cpu"), *GRID), FakeProcessComm())
