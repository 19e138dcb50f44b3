"""The port's process communicator against its virtual mesh and the JAX
package: two processes of a gloo group on 127.0.0.1, each holding two of
four shards (``ProcessComm(2)``), against ``DeviceComm(4, "cpu")`` in this
process and the JAX package's 4-device CPU mesh.

The workers run ``facade/drivers/parity.py`` under the runner's process mode, one
launch for every case of a geometry (a module-scoped fixture), with one
thread each; each case is then one test. Held: iterations and reasons equal
to both meshes, iterates bit-equal to the port's virtual mesh (preonly + lu
within 1e-12) and within 1e-10 of the JAX package's. JAX cannot itself run
multi-process here (``tests/test_multihost.py`` skips under jaxlib 0.4.x),
so the parity is against both packages' virtual meshes.

Also: every collective of the communicator, the ``test.py`` flow through
``run.py --procs``, a failing rank, the NCCL rank check, and the modules
outside the slice, which raise on a communicator of several processes.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.parallel import mesh  # noqa: E402
from mpi_petsc4py_example_tpu_torch.facade.drivers.parity import (  # noqa: E402
    AIJ_OPERATORS, rhs)

REPO = pathlib.Path(__file__).resolve().parent.parent
PARITY = (REPO / "mpi_petsc4py_example_tpu_torch" / "facade" / "drivers"
          / "parity.py")
DRIVER = (REPO / "mpi_petsc4py_example_tpu_torch" / "facade" / "drivers"
          / "solve_linear.py")
X_TOL = 1e-10
LAUNCH_TIMEOUT_S = 400

CG_CASES = [dict(name=f"cg_{pc}_{'x'.join(map(str, grid))}", kind="cg",
                 grid=list(grid), pc=pc)
            for grid in ((16, 16, 16), (8, 12, 16))
            for pc in ("none", "jacobi")]
MG_CASES = [dict(name="cg_mg_16", kind="cg", grid=[16, 16, 16], pc="mg")]
MANY_CASES = [dict(name=f"many_{route}", kind="many", grid=[16, 16, 16],
                   pc="jacobi", k=3, route=route)
              for route in ("fast", "general")]
AIJ_CASES = [dict(name=f"aij_{ksp}_{pc}", kind="aij", op=op, ksp=ksp, pc=pc)
             for op, ksp in (("cfg1", "cg"), ("cfg3", "gmres"),
                             ("cfg4", "bcgs"))
             for pc in ("jacobi", "bjacobi")] + [
    dict(name="aij_fgmres_jacobi", kind="aij", op="cfg3", ksp="fgmres",
         pc="jacobi"),
    dict(name="aij_gmres_jacobi_gated", kind="aij", op="cfg3", ksp="gmres",
         pc="jacobi", gate=True),
    # the set-up program that runs on the card, each process its blocks
    dict(name="aij_bcgs_bjacobi_device_setup", kind="aij", op="cfg4",
         ksp="bcgs", pc="bjacobi", setup_device="1"),
    dict(name="aij_preonly_lu_device_setup", kind="aij", op="testpy",
         ksp="preonly", pc="lu", setup_device="1"),
    dict(name="aij_preonly_lu", kind="aij", op="testpy", ksp="preonly",
         pc="lu")]
SOLVE_CASES = CG_CASES + MG_CASES + MANY_CASES + AIJ_CASES
COMM_CASE = dict(name="comm", kind="comm", n=37)
COLLECTIVES = ["put_fetch", "psum", "pmax", "shift_up", "shift_down",
               "open_up", "open_down", "all_gather", "cols", "replicated"]
OUT_OF_SLICE = ["EPS", "RefinedKSP", "ShellMat", "NullSpace",
                "mult_transpose", "petsc_io", "ST", "KSP lsqr", "KSP bicg",
                "KSP cgne", "PC sor", "PC ssor", "PC ilu", "PC icc",
                "PC asm", "PC shell", "PC composite"]


def _env():
    """The workers' environment: one thread each; nothing of the JAX
    settings this process made matters to them (they import no JAX)."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _runner(*args, timeout=LAUNCH_TIMEOUT_S):
    return subprocess.run(
        [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run", *args],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=timeout)


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    """One launch of 2 processes x 2 local shards for every case."""
    tmp = tmp_path_factory.mktemp("procs")
    cases = [dict(c, local_shards=2) for c in SOLVE_CASES + [COMM_CASE]]
    cases.append(dict(name="out_of_slice", kind="out_of_slice"))
    (tmp / "cases.json").write_text(json.dumps(cases))
    proc = _runner("-n", "2", "--procs", "--device", "cpu", str(PARITY),
                   str(tmp / "cases.json"), str(tmp / "out"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {c["name"]: dict(np.load(tmp / "out" / f"{c['name']}.npz"))
            for c in cases}


@pytest.fixture(scope="module")
def virtual(tmp_path_factory):
    """Every case on ``DeviceComm(4, "cpu")``, run in one process with
    the workers' thread settings (LAPACK's inverses and the CPU's products
    may round differently on another thread count)."""
    tmp = tmp_path_factory.mktemp("virtual")
    cases = SOLVE_CASES + [COMM_CASE]
    (tmp / "cases.json").write_text(json.dumps(cases))
    proc = subprocess.run(
        [sys.executable, str(PARITY), str(tmp / "cases.json"),
         str(tmp / "out"), "--virtual", "4", "--device", "cpu"],
        cwd=REPO, env=dict(_env(), PYTHONPATH=str(REPO)),
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = {c["name"]: dict(np.load(tmp / "out" / f"{c['name']}.npz"))
               for c in cases}
    return lambda case: results[case["name"]]


def _jax(case):
    """The same case on the JAX package's 4-device CPU mesh."""
    comm = tps.DeviceComm(n_devices=4)
    ksp = tps.KSP().create(comm)
    if case["kind"] == "aij":
        A = AIJ_OPERATORS[case["op"]]()
        op = tps.Mat.from_scipy(comm, A)
        ksp.set_type(case["ksp"])
        ksp.set_tolerances(rtol=1e-8, atol=0.0, max_it=5000)
        ksp.set_true_residual_check(case.get("gate", False))
        b = rhs(A.shape[0], 3)
    else:
        grid = case["grid"]
        op = JaxStencil(comm, *grid, dtype=jnp.float64)
        ksp.set_type("cg")
        ksp.set_tolerances(rtol=1e-8, atol=0.0, max_it=10000)
        b = rhs(op.shape[0], 0, case.get("k"))
    pmat = (JaxStencil(comm, *case["grid"], dtype=jnp.float64)
            if case.get("route") == "general" else None)
    ksp.set_operators(op, pmat)
    ksp.get_pc().set_type(case["pc"])
    ksp.get_pc().setup_device = case.get("setup_device", "auto")
    if case["kind"] == "many":
        res = ksp.solve_many(b)
        return (list(res.iterations), [int(r) for r in res.reasons],
                np.asarray(res.X))
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return [res.iterations], [int(res.reason)], x.to_numpy()


def _its(res):
    return [int(v) for v in np.atleast_1d(res["its"])]


def _reasons(res):
    return [int(v) for v in np.atleast_1d(res["reason"])]


# ---- the collectives -------------------------------------------------------

@pytest.mark.parametrize("key", COLLECTIVES)
def test_collective_matches_virtual_mesh(worker_results, virtual, key):
    got = worker_results["comm"]
    want = virtual(COMM_CASE)
    np.testing.assert_array_equal(got[key], want[key])
    # gloo on the CPU moves no payload through the host a second time
    assert int(got["host_copies_total"]) == 0


# ---- solves: the port's virtual mesh and the JAX package --------------------

@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda c: c["name"])
def test_solve_matches_virtual_mesh(worker_results, virtual, case):
    got, want = worker_results[case["name"]], virtual(case)
    assert _its(got) == _its(want)
    assert _reasons(got) == _reasons(want)
    assert all(r > 0 for r in _reasons(got))
    if case["pc"] == "lu":
        scale = max(np.abs(want["x"]).max(), 1.0)
        np.testing.assert_allclose(got["x"], want["x"], rtol=0,
                                   atol=1e-12 * scale)
    else:
        np.testing.assert_array_equal(got["x"], want["x"])
    if case["kind"] == "aij":
        assert str(got["route"]) == str(want["route"])


@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda c: c["name"])
def test_solve_matches_jax_4_devices(worker_results, case):
    got = worker_results[case["name"]]
    its, reasons, x = _jax(case)
    assert _its(got) == its
    assert _reasons(got) == reasons
    scale = max(np.abs(x).max(), 1.0)
    np.testing.assert_allclose(got["x"], x, rtol=0, atol=X_TOL * scale)


def test_workers_import_no_jax(worker_results):
    assert not any(bool(r["jax_imported"]) for r in worker_results.values())


# ---- the rest of the stack raises on several processes ----------------------

@pytest.mark.parametrize("what", OUT_OF_SLICE)
def test_out_of_slice_raises_naming_item_4b(worker_results, what):
    msg = str(worker_results["out_of_slice"][what])
    assert msg.startswith("NotImplementedError"), msg
    assert "Queue A item 4b" in msg


# ---- the runner's process mode ------------------------------------------------

@pytest.mark.parametrize("nprocs", [2, 4])
def test_testpy_flow_prints_true(nprocs):
    proc = _runner("-n", str(nprocs), "--procs", "--device", "cpu",
                   str(DRIVER))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["True"]


TAGS_DRIVER = """\
import numpy as np
from mpi4py import MPI
comm = MPI.COMM_WORLD
if comm.Get_rank() == 0:
    comm.send("first", dest=1, tag=1)
    comm.Send(np.arange(4.0), dest=1, tag=2)
    comm.send({"k": 3}, dest=1, tag=3)
    comm.send("object", dest=1, tag=2)
else:
    last = comm.recv(source=0, tag=3)
    obj = comm.recv(source=0, tag=2)
    buf = np.zeros(4)
    comm.Recv(buf, source=0, tag=2)
    first = comm.recv(source=0, tag=1)
    print(first, buf.tolist(), last, obj)
"""

GETARRAY_DRIVER = """\
import sys
import numpy as np
import petsc4py
petsc4py.init(sys.argv)
from mpi4py import MPI
from petsc4py import PETSc
comm = MPI.COMM_WORLD
rank = comm.Get_rank()
# rank 0's 7 rows span both processes' device rows (5 each)
rs, re = (0, 7) if rank == 0 else (7, 10)
m = re - rs
a = PETSc.Mat().createAIJ(
    comm=comm, size=(10, 10),
    csr=(np.arange(m + 1), np.arange(rs, re), np.ones(m)))
a.assemblyBegin()
a.assemblyEnd()
x, b = a.getVecs()
b.setArray(10.0 * np.arange(rs, re))
mine = b.getArray()
blocks = comm.gather(mine.tolist())
if rank == 0:
    print(blocks)
"""


@pytest.mark.parametrize("mode", ["threads", "procs"])
def test_tagged_messages_received_out_of_order(tmp_path, mode):
    """Each receive takes its own tag's message, whatever the order they
    were sent in, and a ``send`` and a ``Send`` of one tag stay apart: the
    same under rank processes as under threads."""
    script = tmp_path / "tags.py"
    script.write_text(TAGS_DRIVER)
    procs = ["--procs"] if mode == "procs" else []
    proc = _runner("-n", "2", *procs, "--device", "cpu", str(script),
                   timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip() == \
        "first [0.0, 1.0, 2.0, 3.0] {'k': 3} object"


@pytest.mark.parametrize("mode", ["threads", "procs"])
def test_get_array_on_every_rank_then_rank0_prints(tmp_path, mode):
    """``Vec.getArray`` is collective under rank processes: every rank
    calls it and gets its block of the uneven layout, also where the block
    lies in the other process's device rows; rank 0 alone prints."""
    script = tmp_path / "getarray.py"
    script.write_text(GETARRAY_DRIVER)
    procs = ["--procs"] if mode == "procs" else []
    proc = _runner("-n", "2", *procs, "--device", "cpu", str(script),
                   timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = [[10.0 * i for i in range(7)], [70.0, 80.0, 90.0]]
    assert proc.stdout.strip() == str(want)


def test_failing_rank_ends_the_run(tmp_path):
    """Rank 1 raises while rank 0 waits in a collective: the runner kills
    rank 0 and exits 1, well inside the group's timeout."""
    script = tmp_path / "fail.py"
    script.write_text(
        "from mpi4py import MPI\n"
        "comm = MPI.COMM_WORLD\n"
        "if comm.Get_rank() == 1:\n"
        "    raise RuntimeError('rank 1 fails')\n"
        "comm.barrier()\n")
    t0 = time.monotonic()
    proc = _runner("-n", "2", "--procs", "--device", "cpu", str(script),
                   timeout=120)
    assert proc.returncode == 1
    assert "rank 1 fails" in proc.stderr
    assert time.monotonic() - t0 < 60 < mesh.TIMEOUT_S


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="refuses two ranks on one card"):
        mesh.resolve_backend("nccl", "cuda", 2)
    with pytest.raises(ValueError, match="refuses two ranks on one card"):
        mesh.init_multihost(backend="nccl", device="cuda", rank=0,
                            world_size=2, init_method="tcp://127.0.0.1:1")
    assert not torch.distributed.is_initialized()
    assert mesh.resolve_backend(None, "cpu", 4) == "gloo"
    assert mesh.resolve_backend("nccl", "cuda", 1) == "nccl"


def test_runner_refuses_nccl_without_cuda():
    proc = _runner("-n", "2", "--procs", "--backend", "nccl", "--device",
                   "cpu", str(DRIVER), timeout=120)
    assert proc.returncode != 0
    assert "nccl" in proc.stderr


def test_virtual_mesh_holds_every_shard():
    comm = pt.DeviceComm(4, device="cpu")
    assert (comm.local_shards, comm.shard_offset, comm.nprocs, comm.rank,
            comm.multiprocess) == (4, 0, 1, 0, False)
    assert comm.local_row_range(10) == (0, 12)
    assert comm.fingerprint() == {"platform": "cpu", "size": 4, "nprocs": 1,
                                  "local_shards": 4}
