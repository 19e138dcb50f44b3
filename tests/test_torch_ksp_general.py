"""The PyTorch port's assembled-matrix solves against the JAX package: CG,
GMRES(30) and BiCGStab with PC none/jacobi/bjacobi on ``Mat`` operators,
preonly with PC lu (dense and host sparse LU), the lu mode decision, the
true-residual gate and the batched ``solve_many`` with bjacobi and lu.

Both packages solve the same numpy problem (the JAX side on the forced
8-device CPU mesh of ``conftest.py``, the port on its CPU virtual mesh with
the same shard count; the matrix carried across as ``Mat.host_csr``), in
fp64 unless stated: iterations and reasons equal, iterates within 1e-10.
The operators are small cuts of the benchmark's assembled configurations:
cfg1 (3D Poisson, CG), cfg3 (2D Poisson, GMRES(30) + jacobi) and cfg4
(convection-diffusion, BiCGStab + bjacobi).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.solvers import pc as jax_pc  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    convdiff2d, random_system, tridiag_family)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson2d_csr, poisson3d_csr)
from mpi_petsc4py_example_tpu_torch.solvers import pc as port_pc  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    configure_pc, from_host_csr)

CR = pt.ConvergedReason
X_TOL = 1e-10

OPERATORS = {
    "cfg1": lambda: poisson3d_csr(6),
    "cfg3": lambda: poisson2d_csr(20),
    "cfg4": lambda: convdiff2d(16, beta=0.4),
}


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _configure(ksp, ksp_type, pc_type, rtol, max_it, gate, margin, blocks):
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.get_pc().bjacobi_blocks = blocks
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    ksp.set_true_residual_check(gate)
    ksp.true_residual_margin = margin
    return ksp


def _both(A, b, ndev, ksp_type, pc_type, rtol=1e-8, max_it=5000,
          gate=False, margin=1.0, blocks=0, dtype=np.float64, options=()):
    """Solve with the JAX package, then with the port on the carried CSR;
    returns ``(jax_result, jax_x, port_result, port_x, jax_ksp,
    port_ksp)``."""
    jcomm = tps.DeviceComm(n_devices=ndev)
    M = tps.Mat.from_scipy(jcomm, A, dtype=dtype)
    jksp = _configure(tps.KSP().create(jcomm), ksp_type, pc_type, rtol,
                      max_it, gate, margin, blocks)
    jksp.set_operators(M)
    comm = pt.DeviceComm(ndev, device="cpu")
    m, bv, xv = from_host_csr(comm, M.shape, M.host_csr, b.astype(dtype),
                              dtype=dtype)
    ksp = _configure(pt.KSP().create(comm), ksp_type, pc_type, rtol,
                     max_it, gate, margin, blocks)
    ksp.set_operators(m)
    if options:
        tps.init(["prog", *options])
        pt.init(["prog", *options])
        jksp.set_from_options()
        ksp.set_from_options()
    jx, jb = M.get_vecs()
    jb.set_global(b.astype(dtype))
    jres = jksp.solve(jb, jx)
    res = ksp.solve(bv, xv)
    return jres, jx.to_numpy(), res, xv.to_numpy(), jksp, ksp


def _assert_same(jres, jx, res, x, tol=X_TOL):
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason)), (res, jres)
    scale = max(np.abs(jx).max(), 1.0)
    np.testing.assert_allclose(x, jx, rtol=0, atol=tol * scale)


def _rhs(A, seed=3):
    return np.random.default_rng(seed).standard_normal(A.shape[0])


# ---- the Krylov methods on Mat operators -----------------------------------------

CASES = [("cfg1", "cg", "none"), ("cfg1", "cg", "jacobi"),
         ("cfg1", "cg", "bjacobi"), ("cfg3", "gmres", "jacobi"),
         ("cfg3", "gmres", "none"), ("cfg3", "gmres", "bjacobi"),
         ("cfg4", "bcgs", "bjacobi"), ("cfg4", "bcgs", "none"),
         ("cfg4", "gmres", "jacobi")]


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("op,ksp_type,pc_type", CASES)
def test_krylov_matches_jax(op, ksp_type, pc_type, ndev):
    A = OPERATORS[op]()
    jres, jx, res, x, _, ksp = _both(A, _rhs(A), ndev, ksp_type, pc_type)
    assert res.converged
    _assert_same(jres, jx, res, x)
    # host reads: one at set-up, then one per iteration (CG, BiCGStab) or
    # per restart cycle (GMRES)
    per = ksp.restart if ksp_type == "gmres" else 1
    assert res.host_syncs == 1 + res.iterations // per


@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_bjacobi_blocks_option(ndev):
    A = OPERATORS["cfg4"]()
    jres, jx, res, x, jksp, ksp = _both(
        A, _rhs(A), ndev, "bcgs", "bjacobi",
        options=("-pc_bjacobi_blocks", str(4 * ndev)))
    assert ksp.get_pc().bjacobi_blocks == 4 * ndev
    assert ksp.get_pc()._arrays[0].shape == (4 * ndev, 64 // ndev,
                                             64 // ndev)
    _assert_same(jres, jx, res, x)


def test_bjacobi_block_count_rules():
    for args in ((1000, 4, 8), (20000, 1, 0), (16384, 1, 0), (90000, 2, 0)):
        assert port_pc._bjacobi_block_count(*args) == \
            jax_pc._bjacobi_block_count(*args)
    assert port_pc._bjacobi_block_count(65536, 1, 0) == 32  # cfg4's split
    for args in ((1000, 4, 6), (1000, 4, 12)):
        with pytest.raises(ValueError):
            port_pc._bjacobi_block_count(*args)


@pytest.mark.parametrize("restart", [5, 12])
def test_gmres_restart_option(restart):
    A = OPERATORS["cfg3"]()
    jres, jx, res, x, jksp, ksp = _both(
        A, _rhs(A), 2, "gmres", "jacobi",
        options=("-ksp_gmres_restart", str(restart)))
    assert ksp.restart == jksp.restart == restart
    assert res.iterations % restart == 0
    _assert_same(jres, jx, res, x)


def test_gmres_max_it_and_dtol_like_jax():
    A = OPERATORS["cfg3"]()
    jres, jx, res, x, _, _ = _both(A, _rhs(A), 2, "gmres", "none",
                                   max_it=45)
    assert res.reason == CR.DIVERGED_MAX_IT and res.iterations == 60
    _assert_same(jres, jx, res, x)


# ---- the true-residual gate ---------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 4])
def test_gate_reenters_like_jax(ndev):
    """fp32 CG + jacobi on 2D Poisson: the recurrence says converged, the
    true residual misses rtol, and one re-entry from the current iterate
    closes the gap, in both packages."""
    A = poisson2d_csr(64)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    jres, jx, res, x, jksp, ksp = _both(A, b, ndev, "cg", "jacobi",
                                        rtol=1e-6, max_it=20000, gate=True,
                                        dtype=np.float32)
    assert ksp._last_reentries == jksp._last_reentries == 1
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason))
    rtrue = np.linalg.norm(b - A @ x.astype(np.float64)) / np.linalg.norm(b)
    assert res.converged and rtrue <= 1e-6 * 1.05
    assert res.residual_norm == pytest.approx(ksp._last_true_res[0])


@pytest.mark.parametrize("op,ksp_type,pc_type,margin", [
    ("cfg1", "cg", "none", 0.5), ("cfg3", "gmres", "jacobi", 1.0),
    ("cfg4", "bcgs", "bjacobi", 0.5)])
def test_gate_on_benchmark_operators(op, ksp_type, pc_type, margin):
    A = OPERATORS[op]()
    b = A @ np.random.default_rng(1).random(A.shape[0])
    jres, jx, res, x, jksp, ksp = _both(A, b, 2, ksp_type, pc_type,
                                        rtol=1e-6, gate=True, margin=margin)
    assert ksp._last_reentries == jksp._last_reentries
    _assert_same(jres, jx, res, x)
    trn, bn = ksp._last_true_res
    np.testing.assert_allclose(trn, np.linalg.norm(b - A @ x), rtol=1e-10)
    assert trn <= 1e-6 * bn
    # the epilogue's reads: one more than the ungated solve
    assert res.host_syncs == 2 + res.iterations // (
        ksp.restart if ksp_type == "gmres" else 1)


def test_gate_margin_stall_and_validation():
    """A margin-tightened loop that hits max_it still reports converged
    when the true residual meets the un-margined target (JAX
    ``ksp.py:951-958``); margins outside (0, 1] raise."""
    A = poisson2d_csr(48)
    b = A @ np.random.default_rng(8).random(A.shape[0])
    jres, jx, res, x, _, ksp = _both(A, b, 1, "cg", "jacobi", rtol=1e-6,
                                     max_it=120, gate=True, margin=1e-3,
                                     dtype=np.float32)
    assert res.iterations == jres.iterations == 120
    assert res.converged and jres.converged
    for bad in (0.0, 1.5):
        ksp.true_residual_margin = bad
        with pytest.raises(ValueError, match="margin"):
            ksp.solve(*reversed(ksp._mat.get_vecs()))


def test_gate_options():
    pt.init(["prog", "-ksp_true_residual_check", "-ksp_true_residual_margin",
             "0.25", "-ksp_gmres_restart", "7", "-pc_factor_mat_solver_type",
             "mumps", "-pc_bjacobi_blocks", "4", "-pc_setup_device", "0",
             "-ksp_converged_reason"])
    ksp = pt.KSP().create(pt.DeviceComm(device="cpu")).set_from_options()
    assert ksp._true_residual_check and ksp.true_residual_margin == 0.25
    assert ksp.restart == 7 and ksp._reason_flag
    pc = ksp.get_pc()
    assert (pc._factor_solver_type, pc.bjacobi_blocks, pc.setup_device) == (
        "mumps", 4, "0")


# ---- norm types ------------------------------------------------------------------

def test_norm_type_rules_like_jax():
    A = OPERATORS["cfg3"]()
    comm = pt.DeviceComm(device="cpu")
    m = pt.Mat.from_scipy(comm, A)
    jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=1), A)
    for ksp_type, norm, ok in (("gmres", "none", False),
                               ("gmres", "preconditioned", True),
                               ("gmres", "unpreconditioned", False),
                               ("cg", "preconditioned", False),
                               ("bcgs", "unpreconditioned", True),
                               ("preonly", "none", True)):
        results = []
        for pkg, mat in ((pt, m), (tps, jm)):
            ksp = pkg.KSP().create(mat.comm)
            ksp.set_operators(mat)
            ksp.set_type(ksp_type)
            ksp.set_norm_type(norm)
            x, b = mat.get_vecs()
            b.set_global(np.ones(A.shape[0]))
            try:
                ksp.solve(b, x)
                results.append(True)
            except ValueError:
                results.append(False)
        assert results == [ok, ok], (ksp_type, norm)
    ksp = pt.KSP()
    ksp.set_type("gmres")
    assert ksp.get_norm_type() == "preconditioned"


# ---- preonly + lu and the mode decision ------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_preonly_lu_reference_system(ndev):
    """The reference test.py system: preonly + lu ('mumps' accepted), x
    within 1e-12 of the JAX package's and allclose to the manufactured
    solution."""
    A, X, B = random_system(100, seed=42, density=0.1)
    jcomm = tps.DeviceComm(n_devices=ndev)
    M = tps.Mat.from_scipy(jcomm, A)
    xs = []
    for pkg, comm, mat in (
            (tps, jcomm, M),
            (pt, pt.DeviceComm(ndev, device="cpu"), None)):
        if mat is None:
            mat = from_host_csr(comm, M.shape, M.host_csr, B)[0]
        ksp = pkg.KSP().create(comm)
        ksp.set_type("preonly")
        ksp.get_pc().set_type("lu")
        ksp.get_pc().set_factor_solver_type("mumps")
        ksp.set_operators(mat)
        ksp.set_up()
        x, b = mat.get_vecs()
        b.set_global(B)
        res = ksp.solve(b, x)
        assert (res.iterations, int(res.reason)) == (1, CR.CONVERGED_ITS)
        xs.append(x.to_numpy())
    assert ksp.get_pc().kind == "lu" and ksp.get_pc().setup_mode == "host"
    np.testing.assert_allclose(xs[1], xs[0], rtol=0, atol=1e-12)
    assert np.allclose(xs[1], X)


def test_cholesky_symmetry_refusal():
    A = random_system(60, seed=1)[0]
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=1)),
                      (pt, pt.DeviceComm(device="cpu"))):
        pc = pkg.PC(comm)
        pc.set_type("cholesky")
        with pytest.raises(ValueError, match="symmetric"):
            pc.set_up(pkg.Mat.from_scipy(comm, A))
    # a symmetric operator factors, as lu
    pc = pt.PC(pt.DeviceComm(device="cpu")).set_type("cholesky")
    pc.set_up(pt.Mat.from_scipy(pc.comm, poisson2d_csr(6)))
    assert pc.kind == "lu" and pc.program_key() == ("lu",)


def _irreducible(n=1000):
    """Random sparsity plus a shifted diagonal: nonsingular, and its RCM
    bandwidth (≈ 680) exceeds the block cyclic-reduction cap."""
    import scipy.sparse as sp
    A = random_system(n, seed=42, density=0.005)[0]
    return (A + 10.0 * sp.eye(n)).tocsr()


MODES = {
    "dense": (lambda: random_system(50, seed=2)[0] + 5 * _eye(50), 64),
    "crtri": (lambda: tridiag_family(100), 64),
    "crband": (lambda: poisson2d_csr(12), 64),
    "crband-rcm": (lambda: _scrambled(12), 64),
    "hostlu": (_irreducible, 512),
}


def _eye(n):
    import scipy.sparse as sp
    return sp.eye(n)


def _scrambled(nx):
    A = poisson2d_csr(nx)
    p = np.random.default_rng(5).permutation(A.shape[0])
    return A[p][:, p].tocsr()


@pytest.mark.parametrize("case", sorted(MODES))
def test_lu_mode_decision_like_jax(case, monkeypatch):
    make, cap = MODES[case]
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", cap)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", cap)
    A = make().tocsr()
    jcomm = tps.DeviceComm(n_devices=2)
    jpc = tps.PC(jcomm).set_type("lu")
    jpc.set_up(tps.Mat.from_scipy(jcomm, A))
    expected = case.split("-")[0]
    # the dense mode's kind is 'lu'
    assert jpc.kind == {"dense": "lu"}.get(expected, expected)
    comm = pt.DeviceComm(2, device="cpu")
    m = pt.Mat.from_scipy(comm, A)
    assert port_pc.lu_mode(m) == expected
    pc = pt.PC(comm).set_type("lu")
    pc.set_up(m)
    assert pc.kind == jpc.kind
    assert pc.program_key() == jpc.program_key()


@pytest.mark.parametrize("ndev", [1, 3])
def test_hostlu_matches_jax(ndev, monkeypatch):
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", 512)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", 512)
    A = _irreducible()
    b = A @ np.random.default_rng(6).random(A.shape[0])
    jres, jx, res, x, jksp, ksp = _both(A, b, ndev, "preonly", "lu")
    assert ksp.get_pc().kind == jksp.get_pc().kind == "hostlu"
    assert (res.iterations, res.reason) == (1, CR.CONVERGED_ITS)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12 * np.abs(jx).max())
    assert res.residual_norm == pytest.approx(jres.residual_norm, rel=1e-6,
                                              abs=1e-12)
    # an iterative KSP cannot apply a host factor, in either package
    for k in (ksp, jksp):
        k.set_type("gmres")
        with pytest.raises(ValueError, match="host"):
            k.solve(*reversed(k._mat.get_vecs()))


def test_pc_setup_device_resolution():
    comm = pt.DeviceComm(device="cpu")
    m = pt.Mat.from_scipy(comm, convdiff2d(8))
    pc = pt.PC(comm).set_type("bjacobi")
    pc.set_up(m)
    assert pc.setup_mode == "host"        # 'auto' on the CPU
    pc.setup_device = "1"
    pc.set_up(m)
    assert pc.setup_mode == "device"
    pc.setup_device = "gpu"
    with pytest.raises(ValueError, match="pc_setup_device"):
        pc.set_up(m)
    pc.set_type("lu").setup_device = "1"
    pc.set_up(m)
    assert pc.kind == "lu" and pc.setup_mode == "device"


def test_factor_pcs_refuse_matrix_free():
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, 4)
    for t in ("bjacobi", "lu"):
        with pytest.raises(ValueError, match="assembled"):
            pt.PC(comm).set_type(t).set_up(op)


def test_pc_rebuilds_after_mutation():
    """A mutated Mat bumps its counter and the PC sets up again, as in the
    JAX package."""
    A = OPERATORS["cfg4"]()
    b = _rhs(A)
    jcomm = tps.DeviceComm(n_devices=2)
    M = tps.Mat.from_scipy(jcomm, A)
    comm = pt.DeviceComm(2, device="cpu")
    m = from_host_csr(comm, M.shape, M.host_csr, b)[0]
    out = []
    for pkg, mat in ((tps, M), (pt, m)):
        ksp = _configure(pkg.KSP().create(mat.comm), "bcgs", "bjacobi",
                         1e-8, 2000, False, 1.0, 0)
        ksp.set_operators(mat)
        x, bv = mat.get_vecs()
        bv.set_global(b)
        ksp.solve(bv, x)
        mat.shift(2.0)
        x.zero()
        res = ksp.solve(bv, x)
        out.append((res.iterations, int(res.reason), x.to_numpy()))
    assert out[0][:2] == out[1][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=X_TOL)


# ---- batched solves -------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("pc_type", ["bjacobi", "lu"])
def test_solve_many_batched_like_jax(pc_type, ndev):
    A = poisson2d_csr(12)
    B = np.random.default_rng(ndev).standard_normal((A.shape[0], 3))
    jcomm = tps.DeviceComm(n_devices=ndev)
    M = tps.Mat.from_scipy(jcomm, A)
    comm = pt.DeviceComm(ndev, device="cpu")
    m = from_host_csr(comm, M.shape, M.host_csr, B[:, 0])[0]
    out = []
    for pkg, mat in ((tps, M), (pt, m)):
        ksp = _configure(pkg.KSP().create(mat.comm), "cg", pc_type, 1e-8,
                         2000, False, 1.0, 0)
        ksp.set_operators(mat)
        out.append(ksp.solve_many(B))
    jres, res = out
    assert res.iterations == list(np.asarray(jres.iterations))
    assert res.reasons == [int(r) for r in jres.reasons]
    np.testing.assert_allclose(res.X, np.asarray(jres.X), rtol=0,
                               atol=X_TOL * np.abs(jres.X).max())
    # the batched route: one read at set-up, one per lockstep iteration
    assert res.host_syncs == 1 + max(res.iterations)
    # each column equals its own sequential solve
    ksp = _configure(pt.KSP().create(comm), "cg", pc_type, 1e-8, 2000,
                     False, 1.0, 0)
    ksp.set_operators(m)
    for j in range(3):
        x, b = m.get_vecs()
        b.set_global(B[:, j])
        single = ksp.solve(b, x)
        assert single.iterations == res.iterations[j]
        np.testing.assert_allclose(x.to_numpy(), res.X[:, j], rtol=0,
                                   atol=1e-13 * np.abs(res.X).max())


def test_solve_many_sequential_fallbacks():
    """GMRES, BiCGStab, a gated solve and host LU solve column by column,
    each column equal to its single solve."""
    A = OPERATORS["cfg4"]()
    B = np.random.default_rng(9).standard_normal((A.shape[0], 2))
    comm = pt.DeviceComm(2, device="cpu")
    m = pt.Mat.from_scipy(comm, A)
    for ksp_type, gate in (("gmres", False), ("bcgs", False), ("cg", True)):
        ksp = _configure(pt.KSP().create(comm), ksp_type, "jacobi", 1e-8,
                         2000, gate, 1.0, 0)
        ksp.set_operators(m)
        res = ksp.solve_many(B)
        for j in range(2):
            x, b = m.get_vecs()
            b.set_global(B[:, j])
            single = ksp.solve(b, x)
            assert single.iterations == res.iterations[j]
            np.testing.assert_array_equal(x.to_numpy(), res.X[:, j])


# ---- carrying an assembled problem ------------------------------------------------

@pytest.mark.parametrize("key", [("none",), ("jacobi",), ("bjacobi",),
                                 ("lu",), ("cholesky",)])
def test_configure_pc_from_jax_key(key):
    jcomm = tps.DeviceComm(n_devices=1)
    A = poisson2d_csr(5)
    jpc = tps.PC(jcomm).set_type(key[0])
    jpc.set_up(tps.Mat.from_scipy(jcomm, A))
    pc = configure_pc(pt.PC(pt.DeviceComm(device="cpu")), jpc.program_key())
    pc.set_up(pt.Mat.from_scipy(pc.comm, A))
    assert pc.program_key() == jpc.program_key()


def test_from_host_csr_validates_vectors():
    comm = pt.DeviceComm(device="cpu")
    A = poisson2d_csr(4)
    csr = (A.indptr, A.indices, A.data)
    m, b, x = from_host_csr(comm, A.shape, csr, np.ones(16), np.arange(16.))
    np.testing.assert_array_equal(x.to_numpy(), np.arange(16.))
    assert (m.to_scipy() != A).nnz == 0
    with pytest.raises(ValueError, match="b must"):
        from_host_csr(comm, A.shape, csr, np.ones(15))
    with pytest.raises(ValueError, match="x0 must"):
        from_host_csr(comm, A.shape, csr, np.ones(16), np.ones(3))


# ---- the options prefix and the flags of the modes the port lacks ----------

@pytest.fixture
def clean_jax_options():
    tps.global_options().clear()
    yield
    tps.global_options().clear()


def _port_cfg3(ksp_type="cg", pc_type="jacobi", prefix=""):
    A = OPERATORS["cfg3"]()
    comm = pt.DeviceComm(4, device="cpu")
    m, bv, xv = from_host_csr(comm, A.shape, (A.indptr, A.indices, A.data),
                              _rhs(A))
    ksp = pt.KSP().create(comm).set_options_prefix(prefix)
    ksp.set_operators(m)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=1e-8, atol=0.0)
    return ksp, bv, xv


@pytest.mark.parametrize("flag,item", [
    (["-ksp_abft"], 6), (["-ksp_residual_replacement", "10"], 6),
    # the automatic replacement of pipecg and sstep arms the guard
    (["-ksp_pipeline_auto_replacement", "10", "-ksp_type", "pipecg"], 6),
    (["-ksp_sstep_auto_replacement", "10", "-ksp_type", "sstep"], 6)])
def test_unported_mode_flag_raises_naming_its_item(clean_jax_options, flag,
                                                   item):
    """The guard flags of ROADMAP.md Queue A item 6 (ported since): each
    runs the guarded loop, single and batched, with the JAX package's
    iterations, reason, checksum checks, replacements and iterate."""
    assert item == 6
    tps.init(["prog", *flag])
    pt.init(["prog", *flag])
    A = OPERATORS["cfg3"]()
    b = _rhs(A)
    jcomm = tps.DeviceComm(n_devices=4)
    M = tps.Mat.from_scipy(jcomm, A)
    jksp = tps.KSP().create(jcomm)
    jksp.set_operators(M)
    jksp.set_type("cg")
    jksp.get_pc().set_type("jacobi")
    jksp.set_tolerances(rtol=1e-8, atol=0.0)
    jksp.set_from_options()
    jx, jb = M.get_vecs()
    jb.set_global(b)
    jres = jksp.solve(jb, jx)
    ksp, bv, xv = _port_cfg3()
    ksp.set_from_options()
    assert ksp._guard_requested()
    res = ksp.solve(bv, xv)
    _assert_same(jres, jx.to_numpy(), res, xv.to_numpy())
    assert (res.abft_checks, res.residual_replacements) == (
        jres.abft_checks, jres.residual_replacements)
    B = np.stack([b, 2.0 * b], axis=1)
    jmany = jksp.solve_many(B)
    many = ksp.solve_many(B)
    assert list(many.iterations) == list(jmany.iterations)
    assert (many.abft_checks, many.residual_replacements) == (
        jmany.abft_checks, jmany.residual_replacements)
    np.testing.assert_allclose(many.X, jmany.X, rtol=0, atol=1e-12 * np.abs(
        jmany.X).max())


STORED = [("ksp_abft_tol", "64", "abft_tol", None),
          ("ksp_lgmres_augment", "3", "lgmres_augment", None),
          ("ksp_bcgsl_ell", "4", "bcgsl_ell", None),
          ("ksp_sstep_s", "8", "sstep_s", None),
          ("ksp_sstep_max_replacements", "5", "sstep_max_replacements",
           None),
          ("ksp_sstep_auto_replacement", "20", "sstep_auto_replacement",
           None),
          ("ksp_pipeline_auto_replacement", "25",
           "pipeline_auto_replacement", None),
          ("ksp_reduction_probe_refresh", None, "reduction_probe_refresh",
           None),
          ("ksp_unroll", "4", "unroll", None),
          ("pc_gamg_threshold", "0.05", "gamg_threshold", "pc"),
          ("pc_gamg_coarse_eq_limit", "100", "gamg_coarse_size", "pc"),
          ("pc_mg_levels", "3", "gamg_max_levels", "pc")]


@pytest.mark.parametrize("flag,value,attr,owner", STORED,
                         ids=[s[0] for s in STORED])
def test_stored_flag_is_read_as_jax_reads_it(clean_jax_options, flag, value,
                                             attr, owner):
    argv = ["prog", "-" + flag] + ([value] if value is not None else [])
    tps.init(argv)
    pt.init(argv)
    jksp = tps.KSP().create(tps.DeviceComm(n_devices=1)).set_from_options()
    ksp = pt.KSP().create(pt.DeviceComm(device="cpu")).set_from_options()
    jobj = jksp.get_pc() if owner else jksp
    obj = ksp.get_pc() if owner else ksp
    assert getattr(obj, attr) == getattr(jobj, attr)
    assert getattr(obj, attr) != getattr(
        (pt.KSP().create(pt.DeviceComm(device="cpu")).get_pc() if owner
         else pt.KSP()), attr)
    # a CG solve with the flag runs (the guard flags of pipecg/sstep and
    # the guard's tolerance leave an unguarded cg as it was)
    solver, bv, xv = _port_cfg3()
    solver.set_from_options()
    assert solver.solve(bv, xv).reason == CR.CONVERGED_RTOL


def test_ksp_unroll_changes_nothing():
    ksp, bv, xv = _port_cfg3("gmres")
    ref = ksp.solve(bv, xv)
    x_ref = xv.to_numpy()
    pt.init(["prog", "-ksp_unroll", "8"])
    ksp2, bv2, xv2 = _port_cfg3("gmres")
    ksp2.set_from_options()
    assert ksp2.unroll == 8
    res = ksp2.solve(bv2, xv2)
    assert (res.iterations, res.reason) == (ref.iterations, ref.reason)
    np.testing.assert_array_equal(xv2.to_numpy(), x_ref)


def test_prefixed_options_match_jax(clean_jax_options):
    """``-sub_`` flags reach the prefixed KSP and its PC, as in the JAX
    package; the unprefixed ones do not."""
    opts = ["prog", "-sub_ksp_type", "gmres", "-sub_pc_type", "bjacobi",
            "-sub_ksp_rtol", "1e-6", "-sub_ksp_gmres_restart", "20",
            "-ksp_type", "bcgs", "-pc_type", "none"]
    tps.init(opts)
    pt.init(opts)
    A = OPERATORS["cfg3"]()
    b = _rhs(A)
    jcomm = tps.DeviceComm(n_devices=4)
    M = tps.Mat.from_scipy(jcomm, A)
    jksp = tps.KSP().create(jcomm)
    jksp.set_options_prefix("sub_")
    jksp.set_operators(M)
    jksp.set_from_options()
    jx, jb = M.get_vecs()
    jb.set_global(b)
    jres = jksp.solve(jb, jx)
    ksp, bv, xv = _port_cfg3("cg", "none", prefix="sub_")
    ksp.set_from_options()
    assert ksp.get_options_prefix() == "sub_"
    assert (ksp.get_type(), ksp.get_pc().get_type(), ksp.rtol,
            ksp.restart) == ("gmres", "bjacobi", 1e-6, 20)
    res = ksp.solve(bv, xv)
    _assert_same(jres, jx.to_numpy(), res, xv.to_numpy())


def test_prefixed_refined_ksp_reads_the_inner_prefix(clean_jax_options):
    """RefinedKSP reads its flags under the inner KSP's prefix (JAX
    ``refine.py:112``), and the inner KSP never takes the megasolve slot."""
    from mpi_petsc4py_example_tpu.solvers.refine import (
        RefinedKSP as JaxRefinedKSP)
    opts = ["prog", "-in_ksp_inner_precision", "f32", "-in_ksp_refine_max",
            "7", "-in_ksp_refine_inner_rtol", "1e-3", "-in_ksp_type", "cg",
            "-in_pc_type", "jacobi", "-in_ksp_megasolve",
            "-ksp_refine_max", "2"]
    tps.init(opts)
    pt.init(opts)
    jrk = JaxRefinedKSP().create(tps.DeviceComm(n_devices=1))
    jrk.inner.set_options_prefix("in_")
    jrk.set_from_options()
    rk = pt.RefinedKSP().create(pt.DeviceComm(device="cpu"))
    rk.inner.set_options_prefix("in_")
    rk.set_from_options()
    got = (rk.inner_precision, rk.max_refine, rk.inner_rtol, rk.megasolve,
           rk.inner.megasolve, rk.inner.get_type(),
           rk.inner.get_pc().get_type())
    want = (jrk.inner_precision, jrk.max_refine, jrk.inner_rtol,
            jrk.megasolve, jrk.inner.megasolve, jrk.inner.get_type(),
            jrk.inner.get_pc().get_type())
    assert got == want == ("f32", 7, 1e-3, True, False, "cg", "jacobi")


@pytest.mark.parametrize("prec,ksp_type,guarded", [
    ("bf16", "pipecg", True), ("f32", "sstep", True), ("bf16", "sstep", True),
    ("f64", "sstep", True), ("f64", "pipecg", False),
    ("f32", "pipecg", False)])
def test_refined_ksp_arms_the_inner_guards_like_jax(prec, ksp_type, guarded):
    """``RefinedKSP._arm_inner_guards`` (JAX ``refine.py:177-201``): a bf16
    pipecg inner gets ``-ksp_pipeline_auto_replacement 25`` and an sstep
    inner at any precision ``-ksp_sstep_auto_replacement 25``, which arm the
    guarded loops (``guarded``); a pipecg inner at f32/f64 runs unguarded.
    Both packages solve the same system on 2 shards. At f64 the outer
    steps and each inner solve's iterations, reason and residual
    replacements are equal, and the iterates agree within 1e-12 (pipecg)
    or 1e-10 (sstep: its monomial basis amplifies the summation order, the
    spread ``tests/test_torch_pipecg_sstep.py`` holds the unguarded sstep
    to; here the unguarded sstep parts by 2.1e-12 as well). At f32 and bf16 the
    inner solves part after a few iterations (XLA contracts and fuses the
    f32 arithmetic, the port rounds each torch op: the f32 replacement case
    of ``tests/test_torch_sdc.py`` holds iterations within 2 for the same
    reason), so there the spread is: the same reason, the guard replacing
    in both packages or in neither, outer steps within 3, and the iterate
    within 1e-8 of the JAX package's (the outer rtol 1e-10 times the
    operator's condition number, about 60)."""
    from mpi_petsc4py_example_tpu.solvers.refine import (
        RefinedKSP as JaxRefinedKSP)
    A = poisson2d_csr(12)
    b = A @ np.ones(A.shape[0])
    out = []
    for rk in (JaxRefinedKSP().create(tps.DeviceComm(n_devices=2)),
               pt.RefinedKSP().create(pt.DeviceComm(2, device="cpu"))):
        rk.set_inner_precision(prec)
        rk.set_operators(A)
        rk.set_type(ksp_type)
        rk.get_pc().set_type("jacobi")
        rk.set_tolerances(rtol=1e-10)
        steps = []

        def record(*a, _solve=rk.inner.solve, **k):
            r = _solve(*a, **k)
            steps.append((r.iterations, int(r.reason),
                          r.residual_replacements))
            return r
        rk.inner.solve = record
        x, res = rk.solve(b)
        out.append((rk, res, steps, x))
    (jrk, jres, jsteps, jx), (rk, res, steps, x) = out
    assert res.converged and int(res.reason) == int(jres.reason)
    assert rk.inner._guard_requested() == guarded
    for attr in ("pipeline_auto_replacement", "sstep_auto_replacement"):
        assert getattr(rk.inner, attr) == getattr(jrk.inner, attr)
    if prec == "f64":
        assert (rk.refine_steps, res.iterations, steps) == \
            (jrk.refine_steps, jres.iterations, jsteps)
        tol = 1e-10 if ksp_type == "sstep" else 1e-12
        np.testing.assert_allclose(x, jx, rtol=0, atol=tol * np.abs(jx).max())
    else:
        assert (sum(s[2] for s in steps) > 0) == \
            (sum(s[2] for s in jsteps) > 0)
        assert abs(rk.refine_steps - jrk.refine_steps) <= 3
        np.testing.assert_allclose(x, jx, rtol=0, atol=1e-8 * np.abs(jx).max())
