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

The rest of the stack rides the same launch: EPS and ST (krylovschur,
lanczos, lapack, lobpcg on its device route; HEP, GHEP, NHEP; shift,
sinvert, cayley), RefinedKSP
(stencil and assembled, f64/f32/bf16 inner, ``solve_many``), PC
sor/ssor/ilu/icc/asm/shell/composite and lu/cholesky in the
cyclic-reduction modes (the dense cap lowered to 64 rows, in the JAX
package too), ShellMat, NullSpace, KSP lsqr/bicg/cgne, the transpose
product on each of its routes and a PETSc binary round trip. Each is held
bit for bit against ``DeviceComm(4, "cpu")``, and against the JAX package's
4-device mesh: iterations, restarts and reasons equal, values within 1e-10
(eigenvectors up to sign; the f32 and bf16 refinements within the bands of
``tests/test_torch_refine.py``, their rounding being the storage
precision's).

Also: every collective of the communicator, the ``test.py`` flow, the
``test2.py`` flow and the advanced tour through ``run.py --procs`` (stdout
equal to thread mode's), ``getEigenpair`` on rank 0 alone, a failing rank
and the NCCL rank check.
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
from mpi_petsc4py_example_tpu.solvers import pc as jax_pc  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.parallel import mesh  # noqa: E402
from mpi_petsc4py_example_tpu_torch.facade.drivers.parity import (  # noqa: E402
    AIJ_OPERATORS, aij_rhs, configure_eps, configure_ksp, refine_rhs, rhs)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson3d_csr)

REPO = pathlib.Path(__file__).resolve().parent.parent
PARITY = (REPO / "mpi_petsc4py_example_tpu_torch" / "facade" / "drivers"
          / "parity.py")
DRIVERS = REPO / "mpi_petsc4py_example_tpu_torch" / "facade" / "drivers"
DRIVER = DRIVERS / "solve_linear.py"
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
# the Krylov types of Queue A item 5: pipelined and s-step CG (their one
# reduction an iteration or a block), batched too, TFQMR and LGMRES
KSP_CASES = [
    dict(name="ksp_pipecg_16", kind="cg", grid=[16, 16, 16], pc="jacobi",
         ksp="pipecg"),
    dict(name="ksp_sstep4_16", kind="cg", grid=[16, 16, 16], pc="jacobi",
         ksp="sstep", sstep_s=4),
    dict(name="ksp_pipecg_many", kind="many", grid=[16, 16, 16],
         pc="jacobi", k=3, route="fast", ksp="pipecg"),
    dict(name="ksp_sstep4_many", kind="many", grid=[16, 16, 16],
         pc="jacobi", k=3, route="fast", ksp="sstep", sstep_s=4),
    dict(name="aij_tfqmr_bjacobi", kind="aij", op="cfg4", ksp="tfqmr",
         pc="bjacobi"),
    dict(name="aij_lgmres_jacobi", kind="aij", op="cfg4", ksp="lgmres",
         pc="jacobi", restart=10, aug=2)]
SOLVE_CASES = CG_CASES + MG_CASES + MANY_CASES + AIJ_CASES + KSP_CASES
COMM_CASE = dict(name="comm", kind="comm", n=37)
COLLECTIVES = ["put_fetch", "psum", "pmax", "shift_up", "shift_down",
               "open_up", "open_down", "all_gather", "cols", "replicated"]
# the rest of the stack on the process communicator, fp64 unless a
# refinement's inner precision says otherwise
EPS_CASES = [
    dict(name="eps_krylovschur_stencil16", kind="eps", op="stencil",
         grid=[16, 16, 16]),
    dict(name="eps_lanczos_test2", kind="eps", op="test2",
         eps_type="lanczos", nev=4, ncv=12, tol=1e-9),
    dict(name="eps_lapack_ghep", kind="eps", op="p2d8", bop="mass64",
         ptype="ghep", eps_type="lapack", nev=3, which="smallest_real"),
    dict(name="eps_krylovschur_ghep", kind="eps", op="p2d8", bop="mass64",
         ptype="ghep", nev=2, tol=1e-9),
    dict(name="eps_st_sinvert", kind="eps", op="p1d120", st="sinvert",
         which="target_magnitude", target=0.0, tol=1e-10),
    dict(name="eps_st_cayley", kind="eps", op="p1d120", st="cayley",
         shift=0.0, antishift=1.0, which="target_magnitude", target=0.0,
         tol=1e-10),
    dict(name="eps_st_sinvert_ghep", kind="eps", op="p2d8", bop="mass64",
         ptype="ghep", st="sinvert", which="target_magnitude", target=0.0,
         tol=1e-9),
    dict(name="eps_nhep_cfg4", kind="eps", op="cfg4", ptype="nhep", nev=2,
         which="largest_real"),
    # LOBPCG's device route (the port's default): its Gram and projected
    # matrices are psums, every process takes the same host eigh
    dict(name="eps_lobpcg_p1d120", kind="eps", op="p1d120",
         eps_type="lobpcg", which="smallest_real", nev=3, tol=1e-8,
         max_it=500)]
REFINE_CASES = [
    dict(name="refine_cfg1_f64", kind="refine", op="cfg1", prec="f64"),
    dict(name="refine_stencil_f32", kind="refine", grid=[16, 16, 16],
         prec="f32"),
    dict(name="refine_stencil_bf16", kind="refine", grid=[8, 8, 8],
         prec="bf16"),
    dict(name="refine_many_f32", kind="refine", grid=[16, 16, 16],
         prec="f32", k=3)]
PC_CASES = [
    dict(name="pc_sor", kind="aij", op="cfg3", ksp="gmres", pc="sor"),
    dict(name="pc_ssor", kind="aij", op="cfg4", ksp="bcgs", pc="ssor"),
    dict(name="pc_ilu", kind="aij", op="cfg4", ksp="bcgs", pc="ilu"),
    dict(name="pc_icc", kind="aij", op="cfg1", ksp="cg", pc="icc"),
    dict(name="pc_asm", kind="aij", op="cfg3", ksp="gmres", pc="asm"),
    dict(name="pc_shell", kind="aij", op="cfg1", ksp="cg", pc="shell"),
    dict(name="pc_composite_additive", kind="aij", op="cfg3", ksp="gmres",
         pc="composite", children=["jacobi", "sor"]),
    dict(name="pc_composite_multiplicative", kind="aij", op="cfg4",
         ksp="fgmres", pc="composite", ctype="multiplicative",
         children=["jacobi", "sor"]),
    dict(name="pc_lu_crtri", kind="aij", op="tri", ksp="preonly", pc="lu",
         dense_cap=64),
    dict(name="pc_cholesky_crtri_gmres", kind="aij", op="tri", ksp="gmres",
         pc="cholesky", dense_cap=64),
    dict(name="pc_lu_crband", kind="aij", op="band", ksp="preonly",
         pc="lu", dense_cap=64),
    dict(name="pc_lu_crband_device_setup", kind="aij", op="band",
         ksp="preonly", pc="lu", dense_cap=64, setup_device="1"),
    # PC gamg: the V-cycle's gathered products and R = P^H restriction
    dict(name="pc_gamg", kind="aij", op="band", ksp="cg", pc="gamg"),
    dict(name="pc_amg_fcg", kind="aij", op="cfg3", ksp="fcg", pc="amg")]
SURFACE_CASES = [
    dict(name="shellmat_cg_jacobi", kind="aij", op="cfg3", ksp="cg",
         pc="jacobi", shellmat=True),
    dict(name="shellmat_lsqr", kind="aij", op="cd12", ksp="lsqr", pc="none",
         shellmat=True),
    dict(name="nullspace_cg", kind="aij", op="neumann", ksp="cg",
         pc="jacobi", nullspace=True),
    dict(name="nullspace_gmres", kind="aij", op="neumann", ksp="gmres",
         pc="none", nullspace=True),
    dict(name="ksp_lsqr_dia_banded", kind="aij", op="cd12", ksp="lsqr",
         pc="none"),
    dict(name="ksp_bicg_dia_banded", kind="aij", op="cfg4", ksp="bicg",
         pc="jacobi"),
    dict(name="ksp_cgne_ell", kind="aij", op="ell64", ksp="cgne",
         pc="none"),
    dict(name="ksp_bicg_dia_gathered", kind="aij", op="far", ksp="bicg",
         pc="bjacobi"),
    dict(name="ksp_bicg_lu", kind="aij", op="cfg4", ksp="bicg", pc="lu"),
    dict(name="mult_t_dia_banded", kind="mult_t", op="cfg4"),
    dict(name="mult_t_ell", kind="mult_t", op="ell64"),
    dict(name="mult_t_dia_gathered", kind="mult_t", op="far"),
    dict(name="petsc_io_roundtrip", kind="io", op="cfg4", ksp="bcgs",
         pc="jacobi")]
STACK_CASES = EPS_CASES + REFINE_CASES + PC_CASES + SURFACE_CASES
# the fused program (-ksp_megasolve; uncaptured on gloo) and the reduction
# plan selection (-ksp_reduction_auto)
FUSED_CASES = [
    dict(name="fused_cg_fast", kind="cg", grid=[16, 16, 16], pc="jacobi",
         megasolve=True, fastpath=True),
    dict(name="fused_pipecg", kind="cg", grid=[16, 16, 16], pc="jacobi",
         ksp="pipecg", megasolve=True),
    dict(name="fused_sstep4", kind="cg", grid=[16, 16, 16], pc="jacobi",
         ksp="sstep", sstep_s=4, megasolve=True),
    dict(name="fused_many", kind="many", grid=[16, 16, 16], pc="jacobi",
         k=3, route="fast", megasolve=True, fastpath=True),
    dict(name="fused_refine_f32_mg", kind="refine", grid=[16, 16, 16],
         prec="f32", pc="mg", megasolve=True)]
AUTO_CASE = dict(name="reduction_auto", kind="cg", grid=[16, 16, 16],
                 pc="jacobi", reduction_auto=True)
# the fused program's guarded mode under a trace-time fault (uncaptured on
# gloo): the detection, the rolled-back iterate and the recovery
GUARD_CASES = [dict(name="fused_sdc_spmv", kind="sdc", grid=[16, 16, 16],
                    spec="spmv.result=bitflip:at=2:times=1", rr=8,
                    megasolve=True)]


def _env():
    """The workers' environment: one thread each; nothing of the JAX
    settings this process made matters to them (they import no JAX)."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _runner(*args, timeout=LAUNCH_TIMEOUT_S, **env):
    return subprocess.run(
        [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run", *args],
        cwd=REPO, env=dict(_env(), **env), capture_output=True, text=True,
        timeout=timeout)


def _io_dir(cases, path):
    """The cases with the binary round trip's directory set."""
    return [dict(c, dir=str(path)) if c["kind"] == "io" else c
            for c in cases]


@pytest.fixture(scope="module")
def worker_results(tmp_path_factory):
    """One launch of 2 processes x 2 local shards for every case."""
    tmp = tmp_path_factory.mktemp("procs")
    cases = [dict(c, local_shards=2) for c in _io_dir(
        SOLVE_CASES + [COMM_CASE] + STACK_CASES + FUSED_CASES + GUARD_CASES
        + [AUTO_CASE], tmp / "io")]
    (tmp / "cases.json").write_text(json.dumps(cases))
    # -ksp_reduction_auto's probe cache goes to the test's directory
    proc = _runner("-n", "2", "--procs", "--device", "cpu", str(PARITY),
                   str(tmp / "cases.json"), str(tmp / "out"),
                   XDG_CACHE_HOME=str(tmp / "cache"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {c["name"]: dict(np.load(tmp / "out" / f"{c['name']}.npz"))
            for c in cases}


@pytest.fixture(scope="module")
def virtual(tmp_path_factory):
    """Every case on ``DeviceComm(4, "cpu")``, run in one process with
    the workers' thread settings (LAPACK's inverses and the CPU's products
    may round differently on another thread count)."""
    tmp = tmp_path_factory.mktemp("virtual")
    cases = _io_dir(SOLVE_CASES + [COMM_CASE] + STACK_CASES + FUSED_CASES
                    + GUARD_CASES, tmp / "io")
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
        configure_ksp(ksp, case)
        ksp.set_tolerances(rtol=1e-8, atol=0.0, max_it=5000)
        ksp.set_true_residual_check(case.get("gate", False))
        b = rhs(A.shape[0], 3)
    else:
        grid = case["grid"]
        op = JaxStencil(comm, *grid, dtype=jnp.float64)
        configure_ksp(ksp, case)
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


@pytest.mark.parametrize("case", [c for c in KSP_CASES
                                  if c["kind"] in ("cg", "many")],
                         ids=lambda c: c["name"])
def test_plan_reductions_match_virtual_mesh(worker_results, virtual, case):
    """pipecg and sstep issue the same collectives and host reads on 2
    processes as on the virtual mesh: two psums at start-up, one an
    iteration (pipecg) or a block (sstep), one for the final residual."""
    got, want = worker_results[case["name"]], virtual(case)
    calls = {k: int(v) for k, v in got.items() if k.startswith("calls_")}
    assert calls == {k: int(v) for k, v in want.items()
                     if k.startswith("calls_")}
    assert int(got["host_syncs"]) == int(want["host_syncs"])
    its = max(_its(got))
    if case["ksp"] == "pipecg":
        assert calls["calls_psum"] == 3 + its
    else:
        assert -(-its // 4) <= calls["calls_psum"] - 3 <= its
    assert int(got["host_syncs"]) == calls["calls_psum"] - 1


@pytest.mark.parametrize("case", SOLVE_CASES, ids=lambda c: c["name"])
def test_solve_matches_jax_4_devices(worker_results, case):
    got = worker_results[case["name"]]
    its, reasons, x = _jax(case)
    assert _its(got) == its
    assert _reasons(got) == reasons
    scale = max(np.abs(x).max(), 1.0)
    np.testing.assert_allclose(got["x"], x, rtol=0, atol=X_TOL * scale)


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: c["name"])
def test_fused_case_matches_virtual_mesh(worker_results, virtual, case):
    """The fused program on 2 gloo processes (uncaptured: gloo cannot be
    captured) against the virtual mesh: steps, replays, masked steps,
    iterations and reasons equal, the iterate bit for bit."""
    got, want = worker_results[case["name"]], virtual(case)
    for key in ("its", "reason", "steps", "replays", "masked_steps",
                "host_syncs"):
        np.testing.assert_array_equal(got[key], want[key])
    assert not bool(got["graph"]) and all(r > 0 for r in _reasons(got))
    np.testing.assert_array_equal(got["x"], want["x"])


@pytest.mark.parametrize("case", GUARD_CASES, ids=lambda c: c["name"])
def test_fused_guarded_case_matches_virtual_mesh(worker_results, virtual,
                                                 case):
    """The fused guarded program on 2 gloo processes (uncaptured) against
    the virtual mesh: the detector, its iteration, the rolled-back iterate,
    the recovery's events and iterations and its iterate bit for bit."""
    got, want = worker_results[case["name"]], virtual(case)
    assert str(got["detector"]) == str(want["detector"]) == "abft"
    for key in ("det_it", "its", "events", "attempts"):
        np.testing.assert_array_equal(got[key], want[key])
    for key in ("x", "x_rollback"):
        np.testing.assert_array_equal(got[key], want[key])
    assert not bool(got["graph"]) and not bool(want["graph"])


@pytest.mark.parametrize("case", FUSED_CASES, ids=lambda c: c["name"])
def test_fused_case_matches_jax_4_devices(worker_results, case):
    """The JAX package's fused program on its 4-device mesh: the outer
    steps, iterations and reasons equal, the iterate within 1e-10 (the f32
    refinement within 1e-9)."""
    got = worker_results[case["name"]]
    comm = tps.DeviceComm(n_devices=4)
    grid = case["grid"]
    if case["kind"] == "refine":
        rk = tps.RefinedKSP().create(comm)
        rk.megasolve = True
        rk.set_inner_precision(case["prec"])
        A = poisson3d_csr(*grid)
        rk.set_operators(A, inner_op=JaxStencil(comm, *grid,
                                                dtype=jnp.float32),
                         outer_op=JaxStencil(comm, *grid, dtype=jnp.float64))
        rk.set_type("cg")
        rk.get_pc().set_type(case["pc"])
        rk.set_tolerances(rtol=1e-10)
        x, res = rk.solve(refine_rhs(case, A))
        assert (int(got["steps"]), int(got["its"]), int(got["reason"])) == (
            rk.refine_steps, res.iterations, int(res.reason))
        assert np.linalg.norm(got["x"] - x) <= 1e-9 * np.linalg.norm(x)
        return
    op = JaxStencil(comm, *grid, dtype=jnp.float64)
    ksp = configure_ksp(tps.KSP().create(comm), case)
    ksp.set_tolerances(rtol=1e-8, atol=0.0, max_it=10000)
    ksp.set_operators(op)
    ksp.get_pc().set_type(case["pc"])
    ksp.megasolve = True
    ksp.megasolve_stencil_fastpath = case.get("fastpath", False)
    b = rhs(op.shape[0], 0, case.get("k"))
    if case["kind"] == "many":
        res = ksp.solve_many(b)
        its, reasons, x = (list(res.iterations),
                           [int(r) for r in res.reasons], np.asarray(res.X))
    else:
        xv, bv = op.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, xv)
        its, reasons, x = [res.iterations], [int(res.reason)], xv.to_numpy()
    assert (_its(got), _reasons(got), int(got["steps"])) == (
        its, reasons, res.megasolve_steps)
    _assert_close(got["x"], x)


def test_reduction_auto_on_two_processes(worker_results):
    """-ksp_reduction_auto on the gloo group: the probe measures the real
    collective; the choice is the JAX model's on the reported latencies,
    and the solve it picked converges."""
    from mpi_petsc4py_example_tpu.solvers import autoselect as jauto
    got = worker_results["reduction_auto"]
    psum_us, apply_us = float(got["psum_us"]), float(got["apply_us"])
    assert psum_us > 0 and apply_us > 0
    ranking = json.loads(str(got["ranking"]))
    assert ranking == jauto.rank_reduction_plans(psum_us, apply_us)
    cg_cost = next(r["model_cost_us"] for r in ranking
                   if r["ksp_type"] == "cg")
    best = ranking[0]
    if best["ksp_type"] != "cg" and best["model_cost_us"] > 0.75 * cg_cost:
        best = {"ksp_type": "cg", "s": 0}
    assert (str(got["auto_type"]), int(got["auto_s"])) == (
        best["ksp_type"], best["s"])
    assert _reasons(got)[0] > 0


PLANTED_DRIVER = """\
import sys
import numpy as np
from mpi4py import MPI
import mpi_petsc4py_example_tpu_torch as pt
from mpi_petsc4py_example_tpu_torch.solvers import autoselect
rank = MPI.COMM_WORLD.Get_rank()
# alone, rank 0 would keep cg (psum 1 us, apply 10 us) and rank 1 would
# take sstep s = 8 (psum 100 us, apply 11 us)
autoselect.probe_psum_latency_us = (
    lambda comm, chain=256, refresh=False: ((1.0, 100.0)[rank], False))
autoselect.measure_apply_latency_us = (
    lambda comm, op, pc, chain=16: 10.0 + rank)
comm = pt.ProcessComm(2, MPI.COMM_WORLD.device_comm.device)
op = pt.StencilPoisson3D(comm, 16)
ksp = pt.KSP().create(comm)
ksp.set_operators(op)
ksp.set_type("cg")
ksp.get_pc().set_type("jacobi")
ksp.set_tolerances(rtol=1e-8, max_it=500)
ksp.reduction_auto = True
x, b = op.get_vecs()
b.set_global(np.random.default_rng(0).random(op.shape[0]))
res = ksp.solve(b, x)
rep = ksp._reduction_report
with open(f"{sys.argv[1]}/rank{rank}.txt", "w") as f:
    f.write(f"{rep.ksp_type} {rep.s} {rep.psum_us} {rep.apply_us} "
            f"{res.iterations} {int(res.reason)}")
"""


def test_reduction_auto_ranks_agree_on_planted_latencies(tmp_path):
    """Each process measures its own latencies; planted so that each alone
    would choose another plan (cg against sstep s = 8, whose collectives do
    not match), both rank the largest of each and run the same plan, and
    the solve ends converged well inside the group's timeout."""
    script = tmp_path / "planted.py"
    script.write_text(PLANTED_DRIVER)
    t0 = time.monotonic()
    proc = _runner("-n", "2", "--procs", "--device", "cpu", str(script),
                   str(tmp_path), timeout=120,
                   XDG_CACHE_HOME=str(tmp_path / "cache"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert time.monotonic() - t0 < 60 < mesh.TIMEOUT_S
    rows = [(tmp_path / f"rank{r}.txt").read_text().split() for r in (0, 1)]
    assert rows[0] == rows[1]
    kind, s, psum_us, apply_us, its, reason = rows[0]
    assert (kind, int(s), float(psum_us), float(apply_us)) == (
        "sstep", 8, 100.0, 11.0)
    assert int(its) > 0 and int(reason) > 0


def test_workers_import_no_jax(worker_results):
    assert not any(bool(r["jax_imported"]) for r in worker_results.values())


# ---- the rest of the stack: the port's virtual mesh and the JAX package -----

_SCALARS = ("its", "reason", "nconv", "steps", "route", "pc_kind",
            "loaded_equal")


@pytest.mark.parametrize("case", STACK_CASES, ids=lambda c: c["name"])
def test_stack_case_matches_virtual_mesh(worker_results, virtual, case):
    """Iterations, restarts, reasons and the route taken equal; every
    result array (iterate, eigenpairs, errors) bit for bit."""
    got, want = worker_results[case["name"]], virtual(case)
    for key in _SCALARS:
        if key in want:
            assert str(got[key]) == str(want[key]), key
    if "reason" in want:
        assert _reasons(got)[0] > 0
    for key in ("x", "lam", "err"):
        if key in want:
            np.testing.assert_array_equal(got[key], want[key])
    if case["kind"] == "io":
        assert bool(got["loaded_equal"])
    launched = {k: int(v) for k, v in got.items()
                if k.startswith("launches_")}
    assert launched == {k: int(v) for k, v in want.items()
                        if k.startswith("launches_")}
    calls = {k: int(v) for k, v in got.items() if k.startswith("calls_")}
    assert calls == {k: int(v) for k, v in want.items()
                     if k.startswith("calls_")}


def _jax_op(comm, case, name, dtype=jnp.float64):
    if name == "stencil":
        return JaxStencil(comm, *case["grid"], dtype=dtype)
    return tps.Mat.from_scipy(comm, AIJ_OPERATORS[name]())


def _jax_eps(comm, case):
    A = _jax_op(comm, case, case["op"])
    B = _jax_op(comm, case, case["bop"]) if case.get("bop") else None
    E = tps.EPS().create(comm)
    E.set_operators(A, B)
    configure_eps(E, case).solve()
    return E


def _jax_shell_mat(comm, A):
    Ad = jnp.asarray(A.toarray())
    return tps.ShellMat(comm, A.shape, lambda v: Ad @ v,
                        mult_transpose=lambda v: Ad.T @ v,
                        diagonal=np.asarray(A.diagonal()))


def _jax_aij(comm, case, A, tmp_path):
    if case["kind"] == "io":
        path = tmp_path / "system.petsc"
        with open(path, "wb") as f:
            tps.petsc_io.write_mat(f, A)
            tps.petsc_io.write_vec(f, rhs(A.shape[0], 3))
        with open(path, "rb") as f:
            op = tps.petsc_io.load_mat(f, comm)
            b = tps.petsc_io.load_vec(f, comm).to_numpy()
    else:
        op = (_jax_shell_mat(comm, A) if case.get("shellmat")
              else tps.Mat.from_scipy(comm, A))
        b = aij_rhs(case, A)
    if case.get("nullspace"):
        op.set_nullspace(tps.NullSpace(constant=True))
    ksp = tps.KSP().create(comm)
    ksp.set_type(case["ksp"])
    pc = ksp.get_pc()
    pc.set_type(case["pc"])
    pc.setup_device = case.get("setup_device", "auto")
    if case["pc"] == "shell":
        d = jnp.asarray(1.0 / A.diagonal())
        pc.set_shell_apply(lambda r: d * r)
    if case["pc"] == "composite":
        pc.set_composite_type(case.get("ctype", "additive"))
        pc.set_composite_pcs(*case["children"])
    ksp.set_tolerances(rtol=case.get("rtol", 1e-8), atol=0.0, max_it=5000)
    ksp.set_operators(op)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return res.iterations, int(res.reason), x.to_numpy(), pc


def _jax_refine(comm, case):
    dt = {"f64": jnp.float64, "f32": jnp.float32,
          "bf16": jnp.bfloat16}[case["prec"]]
    if case.get("grid"):
        A = poisson3d_csr(*case["grid"])
        inner = JaxStencil(comm, *case["grid"], dtype=dt)
    else:
        A, inner = AIJ_OPERATORS[case["op"]](), None
    rk = tps.RefinedKSP().create(comm)
    rk.set_inner_precision(case["prec"])
    rk.set_operators(A, inner_op=inner)
    rk.set_type("cg")
    rk.get_pc().set_type("jacobi")
    rk.set_tolerances(rtol=1e-10)
    b = refine_rhs(case, A)
    x, res = rk.solve_many(b) if case.get("k") else rk.solve(b)
    return rk.refine_steps, res, np.asarray(x)


def _assert_close(got, want):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=X_TOL * scale)


@pytest.mark.parametrize("case", STACK_CASES, ids=lambda c: c["name"])
def test_stack_case_matches_jax_4_devices(worker_results, case, tmp_path,
                                          monkeypatch):
    """The JAX package's 4-device mesh on the same problem: iterations,
    restarts and reasons equal, values within 1e-10 (eigenvectors up to
    sign, at the 1e-8 of ``tests/test_torch_eps.py`` where a pair is only
    converged to ``tol``; the f32/bf16 refinements within the bands of
    ``tests/test_torch_refine.py``)."""
    got = worker_results[case["name"]]
    comm = tps.DeviceComm(n_devices=4)
    if case["kind"] == "eps":
        lobpcg = case.get("eps_type") == "lobpcg"
        if lobpcg:      # the device route: the JAX package's fused loop
            monkeypatch.delenv("TPU_SOLVE_EPS_FUSED", raising=False)
        else:           # the host loop, the loop the port's types have
            monkeypatch.setenv("TPU_SOLVE_EPS_FUSED", "0")
        E = _jax_eps(comm, case)
        # LOBPCG's count turns on rounding near its tolerance: within two,
        # and compute_error within tests/test_torch_eps_lobpcg.py's 1e-8
        band, err_tol = (2, 1e-8) if lobpcg else (0, X_TOL)
        assert abs(int(got["its"]) - E.get_iteration_number()) <= band
        assert (int(got["nconv"]), int(got["reason"])) == (
            E.get_converged(), int(E.result.reason))
        lam = np.asarray(E._eigenvalues)
        np.testing.assert_allclose(got["lam"], lam, rtol=X_TOL, atol=0)
        for i in range(min(E.get_converged(), len(lam))):
            vj, vp = np.asarray(E._eigenvectors[i]), got["x"][i]
            s = np.vdot(vp, vj)
            np.testing.assert_allclose(vp * (s / abs(s)), vj, rtol=0,
                                       atol=1e-8)
            assert abs(got["err"][i] - E.compute_error(i)) <= err_tol
        return
    if case["kind"] == "refine":
        steps, res, x = _jax_refine(comm, case)
        assert int(got["reason"]) == int(res.reason) > 0
        its, xp = int(got["its"]), got["x"]
        if case["prec"] == "f64":
            assert (int(got["steps"]), its) == (steps, res.iterations)
            _assert_close(xp, x)
        elif case["prec"] == "f32":
            assert int(got["steps"]) == steps
            assert abs(its - res.iterations) <= steps
            assert np.linalg.norm(xp - x) <= 1e-9 * np.linalg.norm(x)
        else:
            assert abs(int(got["steps"]) - steps) <= 1
            assert abs(its - res.iterations) <= 0.1 * res.iterations
        return
    A = AIJ_OPERATORS[case["op"]]()
    if case["kind"] == "mult_t":
        M = tps.Mat.from_scipy(comm, A)
        v = tps.Vec.from_global(comm, rhs(A.shape[0], 5))
        _assert_close(got["x"], M.mult_transpose(v).to_numpy())
        _assert_close(got["x"], A.T @ rhs(A.shape[0], 5))
        return
    if case.get("dense_cap"):
        monkeypatch.setattr(jax_pc, "_DENSE_CAP", case["dense_cap"])
    its, reason, x, pc = _jax_aij(comm, case, A, tmp_path)
    assert (int(got["its"]), int(got["reason"])) == (its, reason)
    assert str(got["pc_kind"]) == pc.kind
    _assert_close(got["x"], x)


# ---- the runner's process mode ------------------------------------------------

@pytest.mark.parametrize("nprocs", [2, 4])
def test_testpy_flow_prints_true(nprocs):
    proc = _runner("-n", str(nprocs), "--procs", "--device", "cpu",
                   str(DRIVER))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.split() == ["True"]


@pytest.mark.parametrize("nprocs", [2, 4])
@pytest.mark.parametrize("driver", ["eigensolve.py", "advanced.py"])
def test_driver_under_procs_prints_as_threads(driver, nprocs):
    """The ``test2.py`` flow (its eigenvalue lines) and the advanced tour
    print under rank processes what they print under thread ranks."""
    threads = _runner("-n", str(nprocs), "--device", "cpu",
                      str(DRIVERS / driver))
    procs = _runner("-n", str(nprocs), "--procs", "--device", "cpu",
                    str(DRIVERS / driver))
    assert threads.returncode == 0, threads.stderr[-4000:]
    assert procs.returncode == 0, procs.stderr[-4000:]
    assert procs.stdout == threads.stdout
    lines = threads.stdout.splitlines()
    if driver == "eigensolve.py":     # the largest of test2.py's matrix
        assert len(lines) == 1
        assert abs(complex(lines[0].split()[1]) - 558.404220547427) < 1e-9
    else:
        assert [ln.split(" ")[0] for ln in lines] == ["1.", "2.", "3.",
                                                     "4."]


EIGENPAIR_DRIVER = """\
import sys
import numpy as np
import slepc4py
slepc4py.init(sys.argv)
from mpi4py import MPI
from petsc4py import PETSc
from slepc4py import SLEPc
comm = MPI.COMM_WORLD
rank, nprocs = comm.Get_rank(), comm.Get_size()
n = 40
rs, re = rank * n // nprocs, (rank + 1) * n // nprocs
rows = np.arange(rs, re)
indptr = [0]
indices, data = [], []
for i in rows:
    for j, v in ((i - 1, -1.0), (i, 2.0), (i + 1, -1.0)):
        if 0 <= j < n:
            indices.append(j)
            data.append(v)
    indptr.append(len(indices))
A = PETSc.Mat().createAIJ(comm=comm, size=(n, n),
                          csr=(np.array(indptr), np.array(indices),
                               np.array(data)))
A.assemble()
E = SLEPc.EPS().create(comm=comm)
E.setOperators(A)
E.setProblemType(SLEPc.EPS.ProblemType.HEP)
E.solve()
vr, vi = A.getVecs()
if rank == 0:                    # rank 0 alone: no collective call
    lam = E.getEigenpair(0, vr, vi)
    print(f"{lam.real:.12f} {E.getEigenvalue(0).real:.12f}")
err = E.computeError(0)          # collective: every rank
comm.barrier()
if rank == 0:
    print(err < 1e-8)
"""


def test_get_eigenpair_on_rank0_alone_does_not_hang(tmp_path):
    """``getEigenpair`` reads host-replicated pairs: rank 0 calls it alone
    while the other rank goes on to the next collective, and the run ends
    well inside the group's timeout; ``computeError`` is collective."""
    script = tmp_path / "eigenpair.py"
    script.write_text(EIGENPAIR_DRIVER)
    t0 = time.monotonic()
    proc = _runner("-n", "2", "--procs", "--device", "cpu", str(script),
                   timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert time.monotonic() - t0 < 60 < mesh.TIMEOUT_S
    lam, again, ok = proc.stdout.split()
    want = 2 + 2 * np.cos(np.pi / 41)
    assert lam == again and abs(float(lam) - want) <= 1e-9 * want
    assert ok == "True"


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
