"""The PyTorch port's transpose product and the KSP types it brings
(lsqr, bicg, cgne), FGMRES, and ``Mat.astype``, against the JAX package.

``Mat.mult_transpose`` on every route of the product (banded DIA with the
spill exchange, gathered DIA, a purely diagonal matrix, ELL) is held
against the JAX package's and scipy's ``A.T @ x`` on 1/2/4/8 shards, fp64,
within 1e-13. The solves run the same numpy problem through both packages:
iterations and reasons equal, iterates within 1e-10. The operators are
well conditioned (a diagonally dominant convection-diffusion operator): on
an ill-conditioned one the Golub-Kahan recurrence of LSQR amplifies
rounding until the two packages' histories part, as two runs of the JAX
package on different device counts do. The refusals are pinned: an
operator without a transpose product, a PC without a transpose apply, and
every JAX KSP type the port does not have yet.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    convdiff2d)
from mpi_petsc4py_example_tpu_torch.solvers.krylov import (  # noqa: E402
    UNPORTED_TYPES)

SHARDS = [1, 2, 4, 8]
X_TOL = 1e-10


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _operators():
    rng = np.random.default_rng(5)
    n = 50
    return {
        # offsets ±1, ±10: banded DIA on 2+ shards, gathered on one
        "dia": convdiff2d(10, beta=0.4),
        # offsets ±1, ±2, ±45: gathered DIA past 2 shards (halo > lsize)
        "dia-wide": sp.diags([1.0, -2.0, 4.0, -0.5, 0.25, 3.0, -1.5],
                             [-45, -2, -1, 0, 1, 2, 45], shape=(n, n)),
        "diagonal": sp.diags(rng.standard_normal(n)),
        "ell": (sp.random(n, n, density=0.6, random_state=rng)
                + sp.eye(n)),
    }


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("kind", ["dia", "dia-wide", "diagonal", "ell"])
def test_mult_transpose_matches_jax_and_scipy(kind, ndev):
    A = _operators()[kind].tocsr()
    x = np.random.default_rng(ndev).standard_normal(A.shape[0])
    jc = tps.DeviceComm(n_devices=ndev)
    pc = pt.DeviceComm(ndev, device="cpu")
    jM = tps.Mat.from_scipy(jc, A)
    M = pt.Mat.from_scipy(pc, A)
    want = jM.mult_transpose(tps.Vec.from_global(jc, x)).to_numpy()
    y = M.mult_transpose(pt.Vec.from_global(pc, x))
    scale = np.abs(A.T @ x).max()
    np.testing.assert_allclose(y.to_numpy(), want, rtol=0,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(y.to_numpy(), A.T @ x, rtol=0,
                               atol=1e-13 * scale)
    assert torch.all(y.data[A.shape[0]:] == 0)
    # deterministic: the same bits twice
    again = M.mult_transpose(pt.Vec.from_global(pc, x))
    assert torch.equal(again.data, y.data)


def test_mult_transpose_refuses_rectangular_like_jax():
    A = sp.random(6, 9, density=0.5, random_state=1).tocsr()
    jM = tps.Mat.from_scipy(tps.DeviceComm(n_devices=2), A)
    M = pt.Mat.from_scipy(pt.DeviceComm(2, device="cpu"), A)
    for mat in (jM, M):
        with pytest.raises(ValueError, match="square operators only"):
            mat.local_spmv_t(mat.comm)


def test_astype_like_jax():
    A = convdiff2d(6, beta=0.3)
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, A)
    assert M.astype(torch.float64) is M
    ns = pt.NullSpace(constant=True)
    M.set_nullspace(ns)
    M32 = M.astype(torch.float32)
    assert M32.dtype == torch.float32 and M32.get_nullspace() is ns
    jM32 = tps.Mat.from_scipy(tps.DeviceComm(n_devices=2), A).astype(
        np.float32)
    np.testing.assert_array_equal(M32.to_scipy().toarray(),
                                  jM32.to_scipy().toarray())
    assert M32.dia_offsets == tuple(jM32.dia_offsets)
    Mb = M.astype(torch.bfloat16)
    assert Mb.dtype == torch.bfloat16 and Mb.get_nullspace() is ns


# ---- the transpose types and FGMRES ----------------------------------------------

def _system(seed=3):
    A = (convdiff2d(12, beta=0.3) + 4.0 * sp.eye(144)).tocsr()
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    return A, b


def _solve_both(A, b, ndev, ksp_type, pc_type, rtol=1e-8, max_it=2000,
                composite=None, restart=30):
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=ndev)),
                      (pt, pt.DeviceComm(ndev, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type(ksp_type)
        ksp.restart = restart
        pc = ksp.get_pc()
        pc.set_type(pc_type)
        if composite:
            pc.set_composite_type(composite)
            pc.set_composite_pcs("jacobi", "sor")
        ksp.set_tolerances(rtol=rtol, max_it=max_it)
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((res, x.to_numpy()))
    (jres, jx), (res, x) = out
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason)), (res, jres)
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=X_TOL * max(np.abs(jx).max(), 1.0))
    assert res.residual_norm == pytest.approx(jres.residual_norm, rel=1e-6)
    return res, x


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("ksp_type,pc_type", [
    ("lsqr", "none"), ("bicg", "jacobi"), ("bicg", "bjacobi"),
    ("cgne", "jacobi"), ("cgne", "none"), ("fgmres", "jacobi"),
    ("fgmres", "bjacobi")])
def test_transpose_types_and_fgmres_match_jax(ksp_type, pc_type, ndev):
    A, b = _system()
    res, x = _solve_both(A, b, ndev, ksp_type, pc_type)
    assert res.converged
    assert (np.linalg.norm(b - A @ x) / np.linalg.norm(b)
            <= (1e-7 if ksp_type == "lsqr" else 1e-8))


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("ksp_type", ["bicg", "fgmres"])
def test_dense_lu_and_composite_pcs_match_jax(ksp_type, ndev):
    A, b = _system(4)
    _solve_both(A, b, ndev, ksp_type, "lu", rtol=1e-10)
    if ksp_type == "fgmres":
        ctype = "additive" if ndev == 1 else "multiplicative"
        _solve_both(A, b, ndev, ksp_type, "composite", composite=ctype)


def test_lsqr_counts_its_true_residual_read():
    """LSQR's loop runs on its estimate; the reported norm is the true
    residual, one more host read."""
    A, b = _system()
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, A)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("lsqr")
    ksp.set_tolerances(rtol=1e-8)
    x, bv = M.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    assert res.host_syncs == res.iterations + 2
    assert res.residual_norm == pytest.approx(
        np.linalg.norm(b - A @ x.to_numpy()), rel=1e-8)


def test_fgmres_counts_cycles_and_refuses_norm_none():
    A, b = _system()
    res, _ = _solve_both(A, b, 2, "fgmres", "none", restart=10)
    assert res.iterations % 10 == 0
    assert res.host_syncs == 1 + res.iterations // 10
    ksp = pt.KSP().create(pt.DeviceComm(1, device="cpu"))
    ksp.set_type("fgmres")
    ksp.set_norm_type("none")
    with pytest.raises(ValueError, match="restart cycle"):
        ksp._check_norm_type()
    assert ksp.set_norm_type("default").get_norm_type() == "unpreconditioned"


# ---- refusals -------------------------------------------------------------------

@pytest.mark.parametrize("ksp_type", ["lsqr", "bicg", "cgne"])
def test_stencil_has_no_transpose_like_jax(ksp_type):
    msgs = []
    for pkg, comm, dt in ((tps, tps.DeviceComm(n_devices=2), np.float64),
                          (pt, pt.DeviceComm(2, device="cpu"),
                           torch.float64)):
        op = (JaxStencil if pkg is tps else pt.StencilPoisson3D)(
            comm, 4, dtype=dt)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_type(ksp_type)
        x, bv = op.get_vecs()
        bv.set_global(np.ones(64))
        with pytest.raises(ValueError, match="transpose product") as e:
            ksp.solve(bv, x)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_bicg_refuses_a_pc_without_transpose_like_jax():
    A, b = _system()
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=2)),
                      (pt, pt.DeviceComm(2, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("bicg")
        ksp.get_pc().set_type("asm")
        x, bv = M.get_vecs()
        bv.set_global(b)
        with pytest.raises(ValueError, match="PCApplyTranspose"):
            ksp.solve(bv, x)


@pytest.mark.parametrize("ksp_type", UNPORTED_TYPES)
def test_unported_ksp_types_name_item_5(ksp_type):
    """Each JAX type the port lacks is a JAX type, and the port refuses it
    naming the Queue A item that brings it."""
    assert tps.KSP().set_type(ksp_type).get_type() == ksp_type
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        pt.KSP().set_type(ksp_type)
    pt.init(["prog", "-ksp_type", ksp_type])
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        pt.KSP().create(pt.DeviceComm(1, device="cpu")).set_from_options()


def test_unknown_ksp_type_is_a_value_error():
    with pytest.raises(ValueError, match="unknown KSP type"):
        pt.KSP().set_type("nosuchtype")


def test_transpose_types_refuse_bf16_storage():
    comm = pt.DeviceComm(1, device="cpu")
    M = pt.Mat.from_scipy(comm, _system()[0], dtype=torch.bfloat16)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("lsqr")
    x, bv = M.get_vecs()
    with pytest.raises(ValueError, match="precision-plan body"):
        ksp.solve(bv, x)
