"""The PyTorch port's CG + Jacobi slice against the JAX package and scipy.

The same problem, made from ``np.random.default_rng`` and carried across as
plain values (``utils/carry.py``), is solved by both packages: the JAX side on
the forced 8-device CPU mesh of ``conftest.py``, the port on its CPU virtual
mesh with the same shard count. Also here: the rules the port keeps (no JAX
imports, entry points default to the card) and its small modules.
"""

import ast
import pathlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson3d_ell  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.parallel.partition import (  # noqa: E402
    RowLayout as JaxRowLayout)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.parallel.partition import (  # noqa: E402
    RowLayout)
from mpi_petsc4py_example_tpu_torch.solvers.krylov import (  # noqa: E402
    stencil_cg_eligible)
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    from_numpy_state)

REPO = pathlib.Path(__file__).resolve().parent.parent
CR = pt.ConvergedReason


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _configure(ksp, pc, rtol, max_it, norm_none):
    ksp.set_type("cg")
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol, max_it=max_it)
    if norm_none:
        ksp.set_norm_type("none")
    return ksp


def _jax_solve(ndev, grid, b, pc, dtype=jnp.float64, rtol=1e-8,
               max_it=10000, norm_none=False):
    comm = tps.DeviceComm(n_devices=ndev)
    op = JaxStencil(comm, *grid, dtype=dtype)
    ksp = _configure(tps.KSP().create(comm), pc, rtol, max_it, norm_none)
    ksp.set_operators(op)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return op, res, x.to_numpy()


def _port_solve(ndev, geometry, b, pc, dtype=torch.float64, rtol=1e-8,
                max_it=10000, norm_none=False):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op, bv, xv = from_numpy_state(comm, geometry, b, dtype=dtype)
    ksp = _configure(pt.KSP().create(comm), pc, rtol, max_it, norm_none)
    ksp.set_operators(op)
    res = ksp.solve(bv, xv)
    return res, xv.to_numpy()


def _rhs(grid, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(
        int(np.prod(grid))).astype(dtype)


# ---- slice vs the JAX package ------------------------------------------------

@pytest.mark.parametrize("pc", ["none", "jacobi"])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("grid", [(16, 16, 16), (8, 12, 16)],
                         ids=["16cube", "8x12x16"])
def test_cg_matches_jax_fp64(grid, ndev, pc):
    b = _rhs(grid, ndev)
    jop, jres, xj = _jax_solve(ndev, grid, b, pc)
    res, xp = _port_solve(ndev, jop.program_key(), b, pc)
    assert res.iterations == jres.iterations
    assert res.reason == jres.reason == CR.CONVERGED_RTOL
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= 1e-10
    assert abs(res.residual_norm - jres.residual_norm) <= \
        1e-8 * jres.residual_norm
    # one host read at set-up, one per iteration
    assert res.host_syncs == res.iterations + 1


def test_cg_matches_jax_fp32():
    grid = (16, 16, 16)
    b = _rhs(grid, 32, np.float32)
    jop, jres, xj = _jax_solve(1, grid, b, "jacobi", dtype=jnp.float32,
                               rtol=1e-5)
    res, xp = _port_solve(1, jop.program_key(), b, "jacobi",
                          dtype=torch.float32, rtol=1e-5)
    assert xp.dtype == np.float32
    assert res.reason == jres.reason == CR.CONVERGED_RTOL
    assert abs(res.iterations - jres.iterations) <= 1
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= 1e-4


@pytest.mark.parametrize("ndev", [1, 4])
def test_norm_none_runs_exactly_max_it(ndev):
    grid = (8, 12, 16)
    b = _rhs(grid, 7)
    jop, jres, xj = _jax_solve(ndev, grid, b, "jacobi", max_it=9,
                               norm_none=True)
    res, xp = _port_solve(ndev, jop.program_key(), b, "jacobi", max_it=9,
                          norm_none=True)
    assert res.iterations == jres.iterations == 9
    assert res.reason == jres.reason == CR.CONVERGED_ITS
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= 1e-12


def test_zero_rhs_exits_at_once_like_jax():
    grid = (8, 8, 8)
    b = np.zeros(512)
    jop, jres, _ = _jax_solve(2, grid, b, "jacobi")
    res, xp = _port_solve(2, jop.program_key(), b, "jacobi")
    assert res.iterations == jres.iterations == 0
    assert res.reason == jres.reason
    assert not xp.any()


def test_max_it_exit_matches_jax():
    grid = (16, 16, 16)
    b = _rhs(grid, 3)
    jop, jres, xj = _jax_solve(2, grid, b, "none", max_it=5)
    res, xp = _port_solve(2, jop.program_key(), b, "none", max_it=5)
    assert res.iterations == jres.iterations == 5
    assert res.reason == jres.reason == CR.DIVERGED_MAX_IT
    np.testing.assert_allclose(xp, xj, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("ndev", [1, 2])
def test_general_route_matches_jax_general_route(ndev):
    """The A/M plan route (no fused matvec-dot): the port on an operator that
    only offers ``local_spmv``, the JAX package on its ELL matrix; both run
    ``cg_kernel`` with a materialized Jacobi ``z``."""
    nx, ny, nz = 6, 5, 8
    b = _rhs((nx, ny, nz), 21)
    jcomm = tps.DeviceComm(n_devices=ndev)
    A = poisson3d_ell(jcomm, nx, ny, nz)
    jksp = _configure(tps.KSP().create(jcomm), "jacobi", 1e-8, 10000, False)
    jksp.set_operators(A)
    jx, jb = A.get_vecs()
    jb.set_global(b)
    jres = jksp.solve(jb, jx)

    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op = pt.StencilPoisson3D(comm, nx, ny, nz)
    plain_op = types.SimpleNamespace(
        comm=comm, shape=op.shape, dtype=op.dtype,
        local_spmv=op.local_spmv, diagonal=op.diagonal)
    ksp = _configure(pt.KSP().create(comm), "jacobi", 1e-8, 10000, False)
    ksp.set_operators(plain_op)
    assert not stencil_cg_eligible("cg", ksp.get_pc(), plain_op)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    assert res.iterations == jres.iterations
    assert res.reason == jres.reason
    np.testing.assert_allclose(x.to_numpy(), jx.to_numpy(), rtol=1e-10,
                               atol=1e-12)


def test_scipy_oracle_residual_parity_fp32():
    """bench.py's parity rule (bench.py:334) at 24^3 fp32, CG + Jacobi to
    rtol 1e-6, against scipy's fp64 CG on the port's own CSR matrix."""
    import scipy.sparse.linalg as spla
    nx, rtol = 24, 1e-6
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.float32)
    x_true = np.random.default_rng(7).random(nx ** 3).astype(np.float32)
    b = op.mult(pt.Vec.from_global(comm, x_true)).to_numpy()
    ksp = _configure(pt.KSP().create(comm), "jacobi", rtol, 20000, False)
    ksp.set_tolerances(atol=0.0)
    ksp.set_operators(op)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    assert res.converged
    A = pt.poisson3d_csr(nx).astype(np.float64)
    bb = b.astype(np.float64)
    M = spla.LinearOperator(A.shape, matvec=lambda v: v / 6.0)
    x_cpu, info = spla.cg(A, bb, rtol=rtol, atol=0.0, maxiter=20000, M=M)
    assert info == 0
    r_port = np.linalg.norm(bb - A @ x.to_numpy().astype(np.float64))
    r_cpu = np.linalg.norm(bb - A @ x_cpu)
    assert r_port <= 10 * max(r_cpu, rtol * np.linalg.norm(bb))


# ---- KSP / PC surface ------------------------------------------------------------

def test_set_from_options_subset():
    pt.init(["prog", "-ksp_type", "cg", "-pc_type", "jacobi", "-ksp_rtol",
             "1e-9", "-ksp_atol", "1e-30", "-ksp_max_it", "7",
             "-ksp_norm_type", "none"])
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, 6)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_from_options()
    assert (ksp.get_type(), ksp.get_pc().get_type()) == ("cg", "jacobi")
    assert (ksp.rtol, ksp.atol, ksp.max_it) == (1e-9, 1e-30, 7)
    assert ksp.get_norm_type() == "none"
    x, b = op.get_vecs()
    b.set_global(_rhs((6, 6, 6), 1))
    res = ksp.solve(b, x)
    assert (res.iterations, res.reason) == (7, CR.CONVERGED_ITS)


def test_env_seeding(monkeypatch):
    """``TPU_SOLVE_<KEY>`` variables seed the options database as in the
    JAX package (``tests/test_aux.py`` ``test_env_seeding``): the key
    lower-cased, every variable but ``TPU_SOLVE_BACKEND``, argv overriding;
    the process's database reads them at its first use, so
    ``KSP.set_from_options`` picks ``bcgs``."""
    from mpi_petsc4py_example_tpu.utils.options import Options as JaxOptions
    from mpi_petsc4py_example_tpu_torch.utils import options
    monkeypatch.setenv("TPU_SOLVE_KSP_TYPE", "bcgs")
    monkeypatch.setenv("TPU_SOLVE_KSP_RTOL", "1e-7")
    monkeypatch.setenv("TPU_SOLVE_BACKEND", "cpu")
    o, jo = options.Options(), JaxOptions()
    for key in ("ksp_type", "ksp_rtol", "backend"):
        assert o.get_string(key) == jo.get_string(key)
    assert (o.get_string("ksp_type"), o.get_real("ksp_rtol")) == ("bcgs", 1e-7)
    assert not o.has("backend")
    monkeypatch.setattr(options, "_global_options", None)
    ksp = pt.KSP().create(pt.DeviceComm(device="cpu")).set_from_options()
    assert (ksp.get_type(), ksp.rtol) == ("bcgs", 1e-7)
    pt.init(["prog", "-ksp_type", "cg"])
    assert pt.KSP().create(pt.DeviceComm(device="cpu")) \
        .set_from_options().get_type() == "cg"


# a port-side copy of the keys of the JAX package's KSP_KERNELS
# (solvers/krylov.py:1999-2025)
JAX_KSP_TYPES = ("cg", "pipecg", "sstep", "bcgs", "gmres", "fgmres", "cgs",
                 "tfqmr", "cr", "lsqr", "minres", "chebyshev", "preonly",
                 "richardson", "bicg", "gcr", "cgne", "symmlq", "fcg",
                 "lgmres", "bcgsl", "fbcgs", "fbcgsr")


@pytest.mark.parametrize("call", ["ksp_type", "pc_type", "norm_type"])
def test_unported_choices_raise(call):
    """A choice in neither package raises ``ValueError``, and every KSP type
    of the JAX package is accepted (the last ones landed with ROADMAP.md
    Queue A item 5); the natural norm is cg/fcg/cr's only, as in the JAX
    package."""
    ksp = pt.KSP().create(pt.DeviceComm(device="cpu"))
    if call == "ksp_type":
        from mpi_petsc4py_example_tpu.solvers.krylov import KSP_KERNELS
        assert set(JAX_KSP_TYPES) == set(KSP_KERNELS)
        for t in JAX_KSP_TYPES:
            assert ksp.set_type(t).get_type() == t
        with pytest.raises(ValueError):
            ksp.set_type("nosuchtype")
    elif call == "pc_type":
        with pytest.raises(ValueError):
            ksp.get_pc().set_type("hypre")   # in neither package
    else:
        with pytest.raises(ValueError):
            ksp.set_norm_type("nosuchnorm")
        ksp.set_type("gmres").set_norm_type("natural")
        with pytest.raises(ValueError, match="natural"):
            ksp._check_norm_type()


def test_solve_without_operators_raises():
    comm = pt.DeviceComm(device="cpu")
    v = pt.Vec(comm, 8)
    with pytest.raises(RuntimeError):
        pt.KSP().create(comm).solve(v, v.copy())


def test_repeat_solve_starts_from_zero():
    """A solve starts from a zero guess whatever ``x`` holds, and leaves
    ``b`` untouched, so repeating it repeats the result."""
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, 8)
    b_np = _rhs((8, 8, 8), 4)
    ksp = _configure(pt.KSP().create(comm), "jacobi", 1e-10, 10000, False)
    ksp.set_operators(op)
    x, b = op.get_vecs()
    b.set_global(b_np)
    first = ksp.solve(b, x)
    x1 = x.to_numpy()
    again = ksp.solve(b, x)
    assert first.iterations == again.iterations > 10
    np.testing.assert_array_equal(x.to_numpy(), x1)
    np.testing.assert_array_equal(b.to_numpy(), b_np)


# ---- rules the port keeps ------------------------------------------------------

def _port_sources():
    return sorted((REPO / "mpi_petsc4py_example_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_the_jax_package():
    forbidden = {"jax", "jaxlib", "ml_dtypes", "mpi_petsc4py_example_tpu"}
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}:{node.lineno} {n}" for n in names
                          if n.split(".")[0] in forbidden]
    sources = _port_sources()
    assert len(sources) > 15
    # the facade, its drivers, the runner, the eigensolver, the SVD and
    # the shell/null-space/binary-I/O modules are port files too
    names = {p.relative_to(REPO).as_posix() for p in sources}
    assert {"mpi_petsc4py_example_tpu_torch/run.py",
            "mpi_petsc4py_example_tpu_torch/facade/petsc4py/PETSc.py",
            "mpi_petsc4py_example_tpu_torch/facade/mpi4py/MPI.py",
            "mpi_petsc4py_example_tpu_torch/facade/drivers/solve_linear.py",
            "mpi_petsc4py_example_tpu_torch/facade/drivers/eigensolve.py",
            "mpi_petsc4py_example_tpu_torch/facade/slepc4py/__init__.py",
            "mpi_petsc4py_example_tpu_torch/facade/slepc4py/SLEPc.py",
            "mpi_petsc4py_example_tpu_torch/facade/petsc_funcs.py",
            "mpi_petsc4py_example_tpu_torch/solvers/eps.py",
            "mpi_petsc4py_example_tpu_torch/solvers/svd.py",
            "mpi_petsc4py_example_tpu_torch/solvers/st.py",
            "mpi_petsc4py_example_tpu_torch/solvers/refine.py",
            "mpi_petsc4py_example_tpu_torch/solvers/tridiag.py",
            # PC gamg and the asynchronous tier
            "mpi_petsc4py_example_tpu_torch/solvers/amg.py",
            "mpi_petsc4py_example_tpu_torch/solvers/multisplit.py",
            "mpi_petsc4py_example_tpu_torch/parallel/exchange.py",
            "mpi_petsc4py_example_tpu_torch/utils/dtypes.py",
            "mpi_petsc4py_example_tpu_torch/core/shell.py",
            "mpi_petsc4py_example_tpu_torch/core/nullspace.py",
            "mpi_petsc4py_example_tpu_torch/utils/petsc_io.py",
            "mpi_petsc4py_example_tpu_torch/facade/drivers/advanced.py",
            "mpi_petsc4py_example_tpu_torch/parallel/mesh.py",
            "mpi_petsc4py_example_tpu_torch/facade/drivers/parity.py",
            # the resilience layer and the checkpoints
            "mpi_petsc4py_example_tpu_torch/resilience/__init__.py",
            "mpi_petsc4py_example_tpu_torch/resilience/faults.py",
            "mpi_petsc4py_example_tpu_torch/resilience/abft.py",
            "mpi_petsc4py_example_tpu_torch/resilience/retry.py",
            "mpi_petsc4py_example_tpu_torch/resilience/fallback.py",
            "mpi_petsc4py_example_tpu_torch/resilience/elastic.py",
            "mpi_petsc4py_example_tpu_torch/utils/checkpoint.py",
            "mpi_petsc4py_example_tpu_torch/utils/errors.py",
            # the serving layer
            "mpi_petsc4py_example_tpu_torch/serving/server.py",
            "mpi_petsc4py_example_tpu_torch/serving/fleet.py",
            "mpi_petsc4py_example_tpu_torch/serving/transport.py",
            "mpi_petsc4py_example_tpu_torch/serving/remote.py",
            } <= names
    assert not offenders, offenders


def test_device_comm_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.DeviceComm()
    assert pt.DeviceComm(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        pt.DeviceComm(n_devices=0, device="cpu")


# ---- small modules -----------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_carry_round_trip(ndev):
    jcomm = tps.DeviceComm(n_devices=1)
    jop = JaxStencil(jcomm, 4, 3, 8)
    b = _rhs((4, 3, 8), 8)
    x0 = _rhs((4, 3, 8), 9)
    if 8 % ndev:
        with pytest.raises(ValueError):
            from_numpy_state(pt.DeviceComm(n_devices=ndev, device="cpu"),
                             jop.program_key(), b)
        return
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op, bv, xv = from_numpy_state(comm, jop.program_key(), b, x0,
                                  dtype=torch.float32)
    assert op.program_key()[:4] == jop.program_key()[:4]
    assert op.program_key()[4] == ndev and op.dtype == torch.float32
    np.testing.assert_array_equal(bv.to_numpy(), b.astype(np.float32))
    np.testing.assert_array_equal(xv.to_numpy(), x0.astype(np.float32))
    _, _, xz = from_numpy_state(comm, jop.program_key(), b)
    assert xz.dtype == torch.float64 and not xz.to_numpy().any()
    with pytest.raises(ValueError):
        from_numpy_state(comm, ("ell",) + jop.program_key()[1:], b)
    with pytest.raises(ValueError):
        from_numpy_state(comm, jop.program_key(), b[:-1])


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_vec_matches_jax_vec(ndev):
    n = 10
    rng = np.random.default_rng(ndev)
    a, c = rng.standard_normal(n), rng.standard_normal(n)
    jcomm = tps.DeviceComm(n_devices=ndev)
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    assert comm.local_size(n) == jcomm.local_size(n)
    assert comm.padded_size(n) == jcomm.padded_size(n)
    ja, jc = tps.Vec.from_global(jcomm, a), tps.Vec.from_global(jcomm, c)
    va, vc = pt.Vec.from_global(comm, a), pt.Vec.from_global(comm, c)
    assert va.data.shape == (comm.padded_size(n),)
    assert va.norm() == pytest.approx(ja.norm(), rel=1e-14)
    assert va.dot(vc) == pytest.approx(ja.dot(jc), rel=1e-14)
    w = va.copy()
    w.axpy(0.5, vc)
    np.testing.assert_allclose(w.to_numpy(), ja.copy().axpy(0.5, jc)
                               .to_numpy(), rtol=1e-15)
    w.aypx(-2.0, va)
    np.testing.assert_allclose(w.to_numpy(), -2.0 * (a + 0.5 * c) + a,
                               rtol=1e-14)
    w.waxpy(3.0, va, vc)
    np.testing.assert_allclose(w.to_numpy(), 3.0 * a + c, rtol=1e-15)
    np.testing.assert_array_equal(va.to_numpy(), a)     # copy is deep
    w.zero()
    assert not w.to_numpy().any() and len(w) == n
    w.set_global(c)
    np.testing.assert_array_equal(w.to_numpy(), c)
    host = a.copy()
    v = pt.Vec.from_global(comm, host)
    host[0] = 99.0                                  # placement copies
    assert v.to_numpy()[0] == a[0]
    with pytest.raises(ValueError):
        pt.Vec(comm, n, data=torch.zeros(n + 100, dtype=torch.float64))


@pytest.mark.parametrize("nrows,nparts", [(10, 3), (16, 8), (5, 8)])
def test_row_layout_matches_jax(nrows, nparts):
    ours, ref = RowLayout(nrows, nparts), JaxRowLayout(nrows, nparts)
    np.testing.assert_array_equal(ours.count, ref.count)
    np.testing.assert_array_equal(ours.displ, ref.displ)
    assert [ours.range(r) for r in range(nparts)] == \
        [ref.range(r) for r in range(nparts)]


def test_comm_collectives():
    comm = pt.DeviceComm(n_devices=4, device="cpu")
    x = torch.arange(8.0, dtype=torch.float64).reshape(4, 2)
    # ring shift: shard i receives shard i - step
    torch.testing.assert_close(comm.shift(x, 1)[1], x[0])
    torch.testing.assert_close(comm.shift(x, -1)[0], x[1])
    parts = comm.shard_map(lambda s: s.sum())(x)
    assert [float(p) for p in parts] == [1.0, 5.0, 9.0, 13.0]
    assert float(comm.psum(parts)) == 28.0
    np.testing.assert_array_equal(comm.host_fetch(x), x.numpy())
    assert comm.put_rows(np.ones(6), torch.float32).shape == (8,)
