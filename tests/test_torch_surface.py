"""The surface of ROADMAP.md Queue A item 5.7 against the JAX package:
``KSP.converged``/``destroy``, ``StencilPoisson3D.assemble``/``assembled``/
``with_comm``, ``poisson2d_ell``/``poisson3d_ell``, ``Options.get``/
``as_dict``/``unused``, the ``backend=`` keyword of the facade's
``createPETScMat``/``solveSLEPcEigenvalues`` and the top-level names of the
JAX package's ``__init__.py`` (the resilience ones included). Each entry
raised ``AttributeError`` or ``TypeError`` before; each is held here to the
JAX package's behaviour on the same numpy problem, fp64, 1/2/4 shards.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson as jpoisson  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CR = pt.ConvergedReason


@pytest.fixture(autouse=True)
def _clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _cg(P, comm, M, b, rtol=1e-10):
    ksp = P.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=rtol)
    x, bv = M.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return ksp, res, x.to_numpy()


def test_ksp_converged_and_destroy():
    A = jpoisson.poisson2d_csr(8)
    b = np.random.default_rng(0).random(A.shape[0])
    comm = pt.DeviceComm(2, device="cpu")
    ksp, res, _ = _cg(pt, comm, pt.Mat.from_scipy(comm, A), b)
    jksp, jres, _ = _cg(tps, tps.DeviceComm(n_devices=2),
                        tps.Mat.from_scipy(tps.DeviceComm(n_devices=2), A),
                        b)
    assert ksp.converged is jksp.converged is True
    ksp.set_tolerances(max_it=2)
    x, bv = ksp.get_operators()[0].get_vecs()
    bv.set_global(b)
    ksp.solve(bv, x)
    assert ksp.converged is False
    assert ksp.destroy() is ksp
    with pytest.raises(RuntimeError, match="no operators"):
        ksp.solve(bv, x)
    jksp.destroy()


@pytest.mark.parametrize("nsh", [1, 2, 4])
def test_stencil_assemble_and_with_comm(nsh):
    comm = pt.DeviceComm(4, device="cpu")
    op = pt.StencilPoisson3D(comm, 8, 12, 16)
    jop = JaxStencil(tps.DeviceComm(n_devices=4), 8, 12, 16)
    assert op.assemble() is op and op.assembled is True
    assert jop.assemble() is jop and jop.assembled is True
    op2 = op.with_comm(pt.DeviceComm(nsh, device="cpu"))
    jop2 = jop.with_comm(tps.DeviceComm(n_devices=nsh))
    assert (op2.comm.size, op2.grid3d, op2.dtype) == (nsh, jop2.grid3d,
                                                       torch.float64)
    u = np.random.default_rng(nsh).random(op.shape[0])
    y = op2.mult(pt.Vec.from_global(op2.comm, u)).to_numpy()
    jy = jop2.mult(tps.Vec.from_global(jop2.comm, u)).to_numpy()
    np.testing.assert_allclose(y, jy, rtol=1e-14, atol=1e-14)
    with pytest.raises(ValueError, match="divisible"):
        op.with_comm(pt.DeviceComm(3, device="cpu"))


@pytest.mark.parametrize("dim,nsh", [(2, 1), (2, 4), (3, 2), (3, 4)])
def test_poisson_ell_matches_jax(dim, nsh):
    """The ELL builders give the CSR models' operator (no scipy matrix in
    between, no host CSR kept), and CG on them matches the JAX package's
    ELL-built operator: iterations, reason, iterate within 1e-12."""
    nx = 10 if dim == 2 else 6
    comm, jcomm = pt.DeviceComm(nsh, device="cpu"), tps.DeviceComm(
        n_devices=nsh)
    build = pt.poisson2d_ell if dim == 2 else pt.poisson3d_ell
    jbuild = jpoisson.poisson2d_ell if dim == 2 else jpoisson.poisson3d_ell
    M, jM = build(comm, nx), jbuild(jcomm, nx)
    A = (jpoisson.poisson2d_csr(nx) if dim == 2
         else jpoisson.poisson3d_csr(nx))
    assert M.host_csr is None and M.assembled and M.shape == A.shape
    np.testing.assert_array_equal(M.to_scipy().toarray(), A.toarray())
    np.testing.assert_array_equal(M.diagonal(), jM.diagonal())
    b = np.random.default_rng(dim).random(A.shape[0])
    _, res, x = _cg(pt, comm, M, b)
    _, jres, jx = _cg(tps, jcomm, jM, b)
    assert (res.iterations, int(res.reason)) == (jres.iterations,
                                                 int(jres.reason))
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12 * np.abs(jx).max())
    M32 = build(comm, nx, dtype=np.float32)
    assert M32.dtype == torch.float32


def test_options_get_as_dict_unused_match_jax():
    """``get`` marks a key queried; ``unused`` lists the ones set and never
    queried (``-options_left``); ``clear`` drops the marks (JAX
    ``tests/test_vec_mat.py:350-365``)."""
    out = []
    for P in (tps, pt):
        opt = P.Options()
        opt.set("kps_type", "cg")            # a misspelled flag
        opt.set("ksp_rtol", "1e-8")
        opt.set("-pc_type", "jacobi")
        assert opt.get("ksp_rtol") == "1e-8"
        assert opt.get("absent", "d") == "d"
        assert opt.has("pc_type")
        out.append((opt.as_dict(), opt.unused()))
        opt.clear()
        assert opt.unused() == [] and opt.as_dict() == {}
    assert out[0] == out[1]
    assert out[1][1] == ["kps_type"]
    opt = pt.global_options()
    opt.set("kps_type", "cg")
    opt.set("ksp_rtol", "1e-8")
    pt.KSP().set_from_options()
    left = opt.unused()
    assert "kps_type" in left and "ksp_rtol" not in left


def test_top_level_names_match_jax():
    """Every name of the JAX ``__init__.py`` is exported (the multisplitting
    names, the last, came with ROADMAP.md Queue A item 7.4)."""
    later = set()
    missing = [n for n in tps.__all__
               if n not in later and not hasattr(pt, n)]
    assert missing == []
    assert set(tps.__all__) - later <= set(pt.__all__)
    comm = pt.DeviceComm(2, device="cpu")
    assert pt.as_comm(comm) is comm
    pt.set_default_comm(comm)
    try:
        assert pt.get_default_comm() is comm and pt.as_comm(None) is comm
    finally:
        pt.set_default_comm(None)
    with pytest.raises(TypeError):
        pt.as_comm(object())
    assert (pt.row_partition(10, 3)[0].tolist()
            == tps.row_partition(10, 3)[0].tolist())
    assert pt.ownership_range(10, 3, 1) == tps.ownership_range(10, 3, 1)
    assert [pt.RowLayout(10, 3).range(r) for r in range(3)] == \
        [tps.RowLayout(10, 3).range(r) for r in range(3)]


def test_device_comm_default_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pt.set_default_comm(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.get_default_comm()


BACKEND_DRIVER = '''
import numpy as np
from mpi4py import MPI
from petsc_funcs import createPETScMat, solveSLEPcEigenvalues
import scipy.sparse as sp
A = sp.diags([-np.ones(15), 2 * np.ones(16), -np.ones(15)], [-1, 0, 1],
             format="csr")
csr = (A.indptr, A.indices, A.data)
for backend in (None, "tpu", "torch", "petsc"):
    M = createPETScMat(MPI.COMM_WORLD, A.shape, csr, backend=backend)
    E = solveSLEPcEigenvalues(MPI.COMM_WORLD, M, backend=backend)
    print(backend, round(E.getEigenvalue(0).real, 10))
try:
    createPETScMat(MPI.COMM_WORLD, A.shape, csr, backend="nosuch")
except ValueError as e:
    print("refused", "nosuch" in str(e))
'''


def test_facade_backend_keyword(tmp_path):
    """``createPETScMat``/``solveSLEPcEigenvalues`` take the JAX wrapper's
    ``backend=`` (``compat/petsc_funcs.py:33``, ``:46``): every backend the
    JAX package names resolves to the facade first on the path; an
    unknown one raises. Runs under the runner, in a process of its own."""
    script = tmp_path / "backend.py"
    script.write_text(BACKEND_DRIVER)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "mpi_petsc4py_example_tpu_torch"
                            / "facade")
    r = subprocess.run([sys.executable, "-m",
                        "mpi_petsc4py_example_tpu_torch.run", "-n", "1",
                        "--device", "cpu", str(script)], capture_output=True,
                       text=True, env=env, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    lam = 2 + 2 * np.cos(np.pi / 17)
    assert [ln.split()[0] for ln in lines[:4]] == ["None", "tpu", "torch",
                                                   "petsc"]
    assert all(abs(float(ln.split()[1]) - lam) < 1e-8 for ln in lines[:4])
    assert lines[4] == "refused True"


def test_device_execution_error_keeps_the_kernel_signature():
    """The kernel wrappers' ``DeviceExecutionError(what, message)`` (a
    string) classifies like the JAX package's exception-wrapping form."""
    e = pt.DeviceExecutionError("stencil7_dot", "CUDA error 2: out of memory")
    assert (e.what, e.failure_class, e.retriable) == ("stencil7_dot", "oom",
                                                      False)
    assert "CUDA error 2" in e.message
    s = pt.SilentCorruptionError("KSPSolve", "abft", 3, detail="d")
    js = tps.SilentCorruptionError("KSPSolve", "abft", 3, detail="d")
    assert (s.failure_class, s.retriable, s.detector, s.iteration) == (
        js.failure_class, js.retriable, js.detector, js.iteration)
    assert str(s.original) == str(js.original)
