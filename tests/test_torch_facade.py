"""The PyTorch port's petsc4py/slepc4py/mpi4py facade and its runner, on
the CPU.

Every facade case runs in a subprocess through ``python -m
mpi_petsc4py_example_tpu_torch.run --device cpu``: the port's ``petsc4py``,
``slepc4py`` and ``mpi4py`` facades must never share a process with the JAX
package's (``tests/test_facade.py`` imports those, and a pytest worker
shares ``sys.modules`` between test files). The KSP-default case compares
the two packages' cores, which import no facade.
"""

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
DRIVERS = REPO / "mpi_petsc4py_example_tpu_torch" / "facade" / "drivers"
DRIVER = DRIVERS / "solve_linear.py"
EIGEN_DRIVER = DRIVERS / "eigensolve.py"


def run(script, nranks, *args, device="cpu", timeout=600):
    cmd = [sys.executable, "-m", "mpi_petsc4py_example_tpu_torch.run",
           "-n", str(nranks)]
    if device:
        cmd += ["--device", device]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(cmd + [str(script), *args], capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=REPO)


def eigenvalues(stdout):
    """The eigenvalues a ``test2.py``-style driver printed."""
    return [complex(line.split("Eigenvalue:")[1].strip())
            for line in stdout.splitlines() if "Eigenvalue:" in line]


@pytest.mark.parametrize("nranks", [1, 4])
def test_reference_flow_prints_true(nranks):
    """The test.py flow: rank 0 scatters CSR row blocks, preonly + lu
    ('mumps'), Gatherv with the true counts, np.allclose(X, X_actual)."""
    r = run(DRIVER, nranks)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "True", r.stdout


def test_options_override_the_drivers_solver():
    """``-ksp_type gmres -pc_type jacobi`` replaces the script's preonly +
    lu: GMRES(30) runs (the reason line counts whole restart cycles, where
    preonly counts 1). Jacobi is singular on this system (most of its
    diagonal is zero), so GMRES converges in the preconditioned norm to a
    wrong x and the script's closing allclose check fails, in the JAX
    package too."""
    r = run(DRIVER, 4, "-ksp_type", "gmres", "-pc_type", "jacobi",
            "-ksp_converged_reason")
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("Linear solve converged due to"), r.stdout
    iterations = int(lines[0].split()[-1])
    assert iterations > 1 and iterations % 30 == 0
    assert lines[-1] == "False" and r.returncode == 1
    # unpreconditioned GMRES with a long restart solves it
    r = run(DRIVER, 4, "-ksp_type", "gmres", "-pc_type", "none",
            "-ksp_rtol", "1e-12", "-ksp_max_it", "2000",
            "-ksp_gmres_restart", "100", "-ksp_converged_reason")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "True"


def test_runner_defaults_to_the_card():
    """Without ``--device`` the runner needs CUDA: it refuses on a machine
    without it rather than falling back to the CPU."""
    r = run(DRIVER, 1, device=None)
    if torch.cuda.is_available():
        assert r.returncode == 0 and "True" in r.stdout, r.stderr
    else:
        assert r.returncode != 0 and "no CUDA" in r.stderr
        assert "True" not in r.stdout


FACADE_API = textwrap.dedent("""
    import sys
    import numpy as np
    import scipy.sparse as sp
    import petsc4py
    petsc4py.init(sys.argv)
    from mpi4py import MPI
    from petsc4py import PETSc
    import petsc_funcs

    comm = MPI.COMM_WORLD
    rank, size = comm.Get_rank(), comm.Get_size()
    assert PETSc.__file__.startswith(sys.argv[1]), PETSc.__file__
    n = 30
    A = (sp.diags([-1.0, 4.0, -1.5], [-1, 0, 1], shape=(n, n))
         + sp.random(n, n, density=0.05, random_state=3)).tocsr()
    base, extra = divmod(n, size)
    counts = [base + (r < extra) for r in range(size)]
    rs = sum(counts[:rank])
    re = rs + counts[rank]
    csr = (A.indptr[rs:re + 1] - A.indptr[rs],
           A.indices[A.indptr[rs]:A.indptr[re]],
           A.data[A.indptr[rs]:A.indptr[re]])
    a = petsc_funcs.createPETScMat(comm, A.shape, csr)
    assert a.getSize() == (n, n) and a.getOwnershipRange() == (rs, re)
    assert a.isAssembled()

    # the setValues flow (each rank its own rows, then a duplicate that
    # ADD_VALUES sums) gives the same matrix
    s = PETSc.Mat().create(comm)
    s.setSizes(((None, n), (None, n)))
    s.setType("aij")
    for i in range(rs, re):
        cols = A.indices[A.indptr[i]:A.indptr[i + 1]]
        vals = A.data[A.indptr[i]:A.indptr[i + 1]]
        s.setValues([i], cols, vals / 2, addv=PETSc.InsertMode.ADD_VALUES)
        s.setValues([i], cols, vals / 2, addv=True)
    s.assemblyBegin()
    s.assemblyEnd()
    assert abs(s.core.to_scipy() - A).max() < 1e-15

    x, b = a.getVecs()
    b.set(2.0)
    assert np.all(b.array == 2.0) and b.getSize() == n
    assert b.getLocalSize() == counts[rank]
    y = b.duplicate()
    assert np.all(y.array == 0.0)
    a.mult(b, y)
    assert np.allclose(y.array, (A @ np.full(n, 2.0))[rs:re])
    c = y.copy()
    y.set(0.0)
    assert np.allclose(c.array, (A @ np.full(n, 2.0))[rs:re])
    y.copy(x)
    assert np.all(x.array == 0.0)
    d = a.getDiagonal()
    assert np.all(d.array == A.diagonal()[rs:re])
    assert abs(b.norm() - 2.0 * np.sqrt(n)) < 1e-12
    assert abs(a.norm() - sp.linalg.norm(A)) < 1e-12

    opts = PETSc.Options()
    assert opts.getString("ksp_type") == "bcgs" and opts.hasName("pc_type")
    opts.setValue("ksp_rtol", "1e-10")
    assert opts.getReal("ksp_rtol") == 1e-10 and opts.getInt("x", 3) == 3
    assert opts.getBool("ksp_converged_reason") is False
    ksp = PETSc.KSP().create(comm)
    ksp.setType("gmres")
    ksp.getPC().setType("none")
    ksp.setOperators(a)
    ksp.setTolerances(rtol=1e-6, max_it=100)
    ksp.setFromOptions()
    assert ksp.getType() == "bcgs" and ksp.getPC().getType() == "jacobi"
    b.setArray(A[rs:re] @ np.arange(n, dtype=float))
    ksp.setUp()
    ksp.solve(b, x)
    assert ksp.getConvergedReason() > 0 and ksp.getIterationNumber() > 0
    assert ksp.getResidualNorm() <= 1e-10 * np.linalg.norm(A @ np.arange(n))
    X = np.empty(n) if rank == 0 else None
    comm.Gatherv(x.array, X)
    if rank == 0:
        assert np.allclose(X, np.arange(n), atol=1e-8)
        print("facade ok", size)
""")


@pytest.mark.parametrize("nranks", [1, 4])
def test_facade_api(nranks, tmp_path):
    """The Mat, Vec, KSP, PC and Options surface the reference flows touch,
    on one rank and on four uneven row blocks (30 rows: 8, 8, 7, 7)."""
    script = tmp_path / "facade_api.py"
    script.write_text(FACADE_API)
    facade = REPO / "mpi_petsc4py_example_tpu_torch" / "facade"
    r = run(script, nranks, str(facade), "-ksp_type", "bcgs", "-pc_type",
            "jacobi", "-ksp_converged_reason", "0")
    assert r.returncode == 0, r.stderr
    assert f"facade ok {nranks}" in r.stdout


def test_a_failing_rank_fails_the_run(tmp_path):
    script = tmp_path / "fail.py"
    script.write_text(textwrap.dedent("""
        from mpi4py import MPI
        comm = MPI.COMM_WORLD
        if comm.Get_rank() == 1:
            raise RuntimeError("rank one fails")
        comm.barrier()
    """))
    r = run(script, 3)
    assert r.returncode == 1
    assert "rank 1 failed" in r.stderr and "rank one fails" in r.stderr


# ---- the eigensolver slice: slepc4py facade and the test2.py flow ------------------

def _tridiag_spectrum(n=100):
    i = np.arange(n)
    off = i[:-1] + i[1:] + 1.0
    A = np.diag(2.0 * i + 1.0) + np.diag(off, 1) + np.diag(off, -1)
    lam = np.linalg.eigvalsh(A)
    return lam[np.argsort(-np.abs(lam))]


@pytest.mark.parametrize("nranks", [1, 4])
def test_eigensolve_flow_prints_the_eigenvalue(nranks):
    """The test2.py flow: typed CSR row-block sends, createPETScMat,
    solveSLEPcEigenvalues (Krylov-Schur, nev 1, the largest magnitude) and
    getEigenpair on rank 0 only; the eigenvalue within 1e-8 of eigvalsh."""
    r = run(EIGEN_DRIVER, nranks, timeout=300)
    assert r.returncode == 0, r.stderr
    lam = eigenvalues(r.stdout)
    want = _tridiag_spectrum()[0]
    assert len(lam) == 1 and abs(lam[0].imag) == 0.0
    assert abs(lam[0].real - want) <= 1e-8 * abs(want), (lam, want)
    assert abs(want - 558.4042205474271) <= 1e-9 * want


def test_eigensolve_options_from_the_command_line():
    """``-eps_nev 4`` after the script reaches the solver through
    ``slepc4py.init(sys.argv)`` and ``setFromOptions``: four pairs."""
    r = run(EIGEN_DRIVER, 3, "-eps_nev", "4", "-eps_monitor", timeout=300)
    assert r.returncode == 0, r.stderr
    lam = eigenvalues(r.stdout)
    np.testing.assert_allclose([v.real for v in lam], _tridiag_spectrum()[:4],
                               rtol=1e-8)
    assert "EPS nconv=" in r.stdout


def test_eigensolve_runner_defaults_to_the_card():
    r = run(EIGEN_DRIVER, 2, device=None, timeout=300)
    if torch.cuda.is_available():
        assert r.returncode == 0 and "Eigenvalue:" in r.stdout, r.stderr
    else:
        assert r.returncode != 0 and "no CUDA" in r.stderr
        assert "Eigenvalue:" not in r.stdout


SLEPC_API = textwrap.dedent("""
    import sys
    import numpy as np
    import scipy.sparse as sp
    import slepc4py
    slepc4py.init(sys.argv)
    from mpi4py import MPI
    from petsc4py import PETSc
    from slepc4py import SLEPc
    import petsc_funcs

    comm = MPI.COMM_WORLD
    rank, size = comm.Get_rank(), comm.Get_size()
    assert SLEPc.__file__.startswith(sys.argv[1]), SLEPc.__file__
    n = 40
    A = sp.diags(np.arange(1.0, n + 1)).tocsr()
    base, extra = divmod(n, size)
    counts = [base + (r < extra) for r in range(size)]
    rs = sum(counts[:rank])
    re = rs + counts[rank]
    csr = (A.indptr[rs:re + 1] - A.indptr[rs],
           A.indices[A.indptr[rs]:A.indptr[re]],
           A.data[A.indptr[rs]:A.indptr[re]])
    a = petsc_funcs.createPETScMat(comm, A.shape, csr)

    E = SLEPc.EPS().create(comm=comm)
    E.setOperators(a)
    E.setProblemType(SLEPc.EPS.ProblemType.HEP)
    E.setDimensions(nev=2, ncv=12)
    E.setTolerances(tol=1e-10, max_it=200)
    E.setWhichEigenpairs(SLEPc.EPS.Which.TARGET_MAGNITUDE)
    E.setTarget(17.2)
    st = E.getST()
    st.setType(SLEPc.ST.Type.SINVERT)
    E.setFromOptions()             # -eps_type krylovschur from argv
    assert E.getType() == "krylovschur" and st.getType() == "sinvert"
    assert E.getDimensions() == (2, 12, 12)
    assert E.getTolerances() == (1e-10, 200)
    E.solve()
    assert E.getConverged() >= 2 and E.getIterationNumber() >= 1
    vr, vi = a.getVecs()
    # getEigenpair is not collective: one rank alone reads every pair
    # while the others wait at the barrier
    if rank == size - 1:
        got = sorted(E.getEigenpair(i, vr, vi).real for i in range(2))
        assert np.allclose(got, [17.0, 18.0], rtol=1e-10), got
        assert E.computeError(0) < 1e-8 and E.getErrorEstimate(0) < 1e-10
        assert np.all(vi.array == 0.0)
    comm.barrier()
    if rank == 0:
        print("slepc ok", size)
""")


@pytest.mark.parametrize("nranks", [1, 4])
def test_slepc_facade_api(nranks, tmp_path):
    """The EPS/ST surface of the facade, and ``getEigenpair`` called on one
    rank only: the run ends, inside a short timeout."""
    script = tmp_path / "slepc_api.py"
    script.write_text(SLEPC_API)
    facade = REPO / "mpi_petsc4py_example_tpu_torch" / "facade"
    r = run(script, nranks, str(facade), "-eps_type", "krylovschur",
            timeout=120)
    assert r.returncode == 0, r.stderr
    assert f"slepc ok {nranks}" in r.stdout


def test_default_ksp_type_is_gmres_as_in_jax():
    """A KSP that is never given a type runs GMRES in both packages (PETSc's
    default), on the unsymmetric cfg4-style convection-diffusion operator:
    the same iterations and reason."""
    import mpi_petsc4py_example_tpu as tps
    import mpi_petsc4py_example_tpu_torch as pt
    from mpi_petsc4py_example_tpu_torch.models.generators import convdiff2d
    A = convdiff2d(16, beta=0.4)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=4)),
                      (pt, pt.DeviceComm(4, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_tolerances(rtol=1e-8, max_it=2000)
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((ksp.get_type(), res.iterations, int(res.reason),
                    x.to_numpy()))
    assert out[1][:3] == out[0][:3]
    assert out[1][0] == "gmres" and out[1][2] > 0
    np.testing.assert_allclose(out[1][3], out[0][3], rtol=0, atol=1e-10)


# a checkout of the reference repository (its test.py, test2.py and
# petsc_funcs.py), when one is given
REFERENCE_DIR = os.environ.get("REFERENCE_DIR", "")


@pytest.mark.skipif(
    not REFERENCE_DIR
    or not os.path.exists(os.path.join(REFERENCE_DIR, "test.py")),
    reason="reference repo not given (set REFERENCE_DIR)")
class TestLiteralReferenceDrivers:
    """The reference drivers, unmodified, through the port's runner: the
    facade (petsc4py, slepc4py, mpi4py and petsc_funcs, which leads
    ``sys.path`` ahead of the driver's own directory) serves every import,
    and the drivers' own printed output is the oracle."""

    @pytest.mark.parametrize("nranks", [1, 2, 3, 4])
    def test_reference_test_py(self, nranks):
        r = run(os.path.join(REFERENCE_DIR, "test.py"), nranks)
        assert r.returncode == 0, r.stderr
        assert "True" in r.stdout, r.stdout

    @pytest.mark.parametrize("nranks", [1, 4])
    def test_reference_test2_py(self, nranks):
        r = run(os.path.join(REFERENCE_DIR, "test2.py"), nranks)
        assert r.returncode == 0, r.stderr
        lam = eigenvalues(r.stdout)
        want = _tridiag_spectrum()[0]
        assert lam and abs(lam[0].real - want) <= 1e-8 * abs(want)


# ---- the KSP/PC/Mat/Vec surface: shells, composites, null spaces, binary I/O ----

ADVANCED = DRIVERS / "advanced.py"


def test_advanced_flow_prints_what_the_jax_example_prints(monkeypatch,
                                                          capsys):
    """The four scenarios of ``examples/advanced.py`` (a ShellMat,
    composite jacobi+sor under FGMRES, a PETSc binary round trip, LOBPCG's
    3 smallest pairs): the port's driver prints the JAX example's lines,
    reasons, iteration counts, errors, pairs and smallest eigenvalue; the
    errors are at most 1e-8. The worst residual is the third pair's, which
    LOBPCG stops just under its tolerance 1e-8 at an iteration that turns on
    rounding (the JAX example prints 9.5e-09, 9.4e-09, 9.1e-09 and 9.0e-09
    on 1, 2, 4 and 8 devices), so both are held below 1e-8 instead."""
    import runpy
    monkeypatch.setattr(sys, "argv", ["advanced.py"])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(REPO / "examples" / "advanced.py"),
                       run_name="__main__")
    assert done.value.code == 0
    jax_lines = capsys.readouterr().out.strip().splitlines()[:4]
    from mpi_petsc4py_example_tpu_torch.facade.drivers import advanced
    assert advanced.main(["advanced.py"], device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:3] == jax_lines[:3]
    assert all("CONVERGED" in line for line in lines[:3])
    head, worst = lines[3].split("worst residual")
    jhead, jworst = jax_lines[3].split("worst residual")
    assert head == jhead and head.startswith("4. lobpcg: 3 pairs, lambda_m")
    assert float(worst) <= 1e-8 and float(jworst) <= 1e-8
    errs = [float(line.split("max err")[1]) for line in lines
            if "max err" in line]
    assert len(errs) == 2 and max(errs) <= 1e-8


def test_advanced_flow_refuses_without_cuda():
    """Without ``--device cpu`` the driver runs on the card, and refuses on
    a machine without one."""
    r = subprocess.run([sys.executable, str(ADVANCED)], capture_output=True,
                       text=True, cwd=REPO, timeout=300,
                       env={k: v for k, v in os.environ.items()
                            if k != "PYTHONPATH"} | {"PYTHONPATH": str(REPO)})
    if torch.cuda.is_available():
        assert r.returncode == 0 and r.stdout.count("CONVERGED") == 3
    else:
        assert r.returncode != 0 and "no CUDA" in r.stderr


SURFACE_API = textwrap.dedent("""
    import os
    import sys
    import numpy as np
    import scipy.sparse as sp
    import torch
    import petsc4py
    petsc4py.init(sys.argv)
    from mpi4py import MPI
    from petsc4py import PETSc

    comm = MPI.COMM_WORLD
    rank, size = comm.Get_rank(), comm.Get_size()
    tmp = sys.argv[1]
    n = 30
    main = 2 * np.ones(n)
    main[0] = main[-1] = 1.0
    N = sp.diags([-np.ones(n - 1), main, -np.ones(n - 1)], [-1, 0, 1]).tocsr()
    A = (N + sp.diags([0.3 * np.ones(n - 1)], [1]) + sp.eye(n)).tocsr()
    base, extra = divmod(n, size)
    counts = [base + (r < extra) for r in range(size)]
    rs = sum(counts[:rank])
    re = rs + counts[rank]
    csr = (A.indptr[rs:re + 1] - A.indptr[rs],
           A.indices[A.indptr[rs]:A.indptr[re]],
           A.data[A.indptr[rs]:A.indptr[re]])
    a = PETSc.Mat().createAIJ(comm=comm, size=A.shape, csr=csr)
    x, b = a.getVecs()
    b.set(1.0)
    y = b.duplicate()
    # Vec dot/scale/axpy, Mat multTranspose
    assert abs(b.dot(b) - n) < 1e-12
    b.scale(2.0)
    y.axpy(0.5, b)
    assert np.allclose(y.array, 1.0)
    a.multTranspose(y, x)
    assert np.allclose(x.array, (A.T @ np.ones(n))[rs:re])

    # a shell with the same product solves like the assembled matrix
    Ad = torch.tensor(A.toarray())
    s = PETSc.Mat().createShell(n, lambda v: Ad @ v,
                                mult_transpose=lambda v: Ad.T @ v,
                                diagonal=A.diagonal(), comm=comm)
    xs, bs = s.getVecs()
    bs.set(1.0)
    ksp = PETSc.KSP().create(comm)
    ksp.setOperators(s)
    ksp.setType("bicg")
    ksp.getPC().setType("jacobi")
    ksp.setTolerances(rtol=1e-10)
    assert ksp.getTolerances()[0] == 1e-10
    seen = []
    ksp.setMonitor(lambda k, it, rn: seen.append(it))
    ksp.setConvergenceHistory()
    ksp.solve(bs, xs)
    its = ksp.getIterationNumber()
    assert ksp.getConvergedReason() > 0
    if rank == 0:        # rank 0's KSP runs the solve and its monitors
        assert seen == list(range(its + 1))
    assert len(ksp.getConvergenceHistory()) == its + 1
    X = np.empty(n) if rank == 0 else None
    comm.Gatherv(xs.array, X)
    if rank == 0:
        assert np.allclose(A @ X, np.ones(n), atol=1e-8)

    # warm start: the converged x takes no iteration
    ksp.setInitialGuessNonzero(True)
    ksp.solve(bs, xs)
    assert ksp.getIterationNumber() == 0

    # PC shell and composite
    ksp2 = PETSc.KSP().create(comm)
    ksp2.setOperators(a)
    ksp2.setType("fgmres")
    pc = ksp2.getPC()
    pc.setType("composite")
    pc.setCompositeType("multiplicative")
    pc.setCompositePCs("jacobi", "sor")
    assert pc.getCompositePC(1).getType() == "sor"
    x.set(0.0)
    b.set(1.0)
    ksp2.solve(b, x)
    assert ksp2.getConvergedReason() > 0
    pc.setType("shell")
    d = torch.tensor(A.diagonal())
    pc.setShellApply(lambda r: r / d)
    x.set(0.0)
    ksp2.solve(b, x)
    assert ksp2.getConvergedReason() > 0

    # a null space on the singular Neumann operator
    na = PETSc.Mat().createAIJ(
        comm=comm, size=N.shape,
        csr=(N.indptr[rs:re + 1] - N.indptr[rs],
             N.indices[N.indptr[rs]:N.indptr[re]],
             N.data[N.indptr[rs]:N.indptr[re]]))
    ns = PETSc.NullSpace().create(constant=True, comm=comm)
    assert ns.test(na)
    na.setNullSpace(ns)
    assert na.getNullSpace().dim == 1      # rank 0's, set collectively
    ksp3 = PETSc.KSP().create(comm)
    ksp3.setOperators(na)
    ksp3.setType("cg")
    ksp3.setTolerances(rtol=1e-10)
    xn, bn = na.getVecs()
    bn.setArray((np.arange(n) - (n - 1) / 2.0)[rs:re])
    ksp3.solve(bn, xn)
    assert ksp3.getConvergedReason() > 0
    Xn = np.empty(n) if rank == 0 else None
    comm.Gatherv(xn.array, Xn)
    if rank == 0:
        assert abs(Xn.mean()) < 1e-10

    # binary round trip through a Viewer: Mat then Vec in one file
    path = os.path.join(tmp, "sys.petsc")
    vw = PETSc.Viewer().createBinary(path, "w", comm=comm)
    a.view(vw)
    b.view(vw)
    vw.destroy()
    vr = PETSc.Viewer().createBinary(path, "r", comm=comm)
    a2 = PETSc.Mat().create(comm)
    a2.load(vr)
    b2 = a2.getVecs()[1]
    b2.load(vr)
    vr.destroy()
    assert abs(a2.core.to_scipy() - A).max() == 0
    assert np.all(b2.array == 1.0)

    # zeroRows with x and b
    x.set(3.0)
    a2.zeroRows([0, n - 1], diag=2.0, x=x, b=b2)
    if rank == 0:
        assert b2.array[0] == 6.0
    if rank == 0:
        print("surface ok", size)
""")


@pytest.mark.parametrize("nranks", [1, 4])
def test_facade_surface_api(nranks, tmp_path):
    """Vec dot/scale/axpy/view/load, Mat createShell/multTranspose/
    setNullSpace/zeroRows/view/load, Viewer, NullSpace, PC shell/composite
    and KSP setMonitor/setConvergenceHistory/setInitialGuessNonzero/
    getTolerances, on one rank and on four uneven row blocks."""
    script = tmp_path / "surface_api.py"
    script.write_text(SURFACE_API)
    r = run(script, nranks, str(tmp_path), timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"surface ok {nranks}" in r.stdout
