"""``-pc_setup_device`` in the PyTorch port against the JAX package: the
placement rule, the device inverses of PC bjacobi and dense PC lu
(``torch.linalg.inv_ex`` plus two Newton steps behind the ``max|I - B X|``
gate), the ELL block extraction and densification, the gate's host set-up,
and solves through device-built PCs.

``-pc_setup_device 1`` forces the device program on the port's CPU virtual
mesh and on the JAX package's forced 8-device CPU mesh; 'auto' is the host on
both. fp64 unless stated.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.solvers import pc as jax_pc  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    convdiff2d)
from mpi_petsc4py_example_tpu_torch.solvers import pc as port_pc  # noqa: E402

TOL = {np.float32: 2e-5, np.float64: 1e-12}
CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _built(pkg, comm, A, pc_type, dtype, setup_device, blocks=0):
    M = pkg.Mat.from_scipy(comm, sp.csr_matrix(A, dtype=dtype), dtype=dtype)
    p = pkg.PC(comm).set_type(pc_type)
    p.bjacobi_blocks = blocks
    p.setup_device = setup_device
    p.set_up(M)
    return p


def _arr(p):
    a = p._arrays[0]
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---- the placement rule -----------------------------------------------------------

@pytest.mark.parametrize("device,dtype,f64_ok,expected", [
    (CPU, torch.float32, True, False),
    (CPU, torch.float64, True, False),
    (CUDA, torch.float32, False, True),
    (CUDA, torch.float64, False, False),
    (CUDA, torch.float64, True, True),
    (CUDA, torch.bfloat16, True, False),
    (CUDA, np.float32, False, True),
])
def test_auto_placement(device, dtype, f64_ok, expected):
    """'auto' is the card for fp32 (fp64 with ``f64_ok``) on CUDA and the
    host on the CPU, as it is the TPU and the host in the JAX package."""
    assert port_pc._want_device_setup(device, dtype, "auto",
                                      f64_ok=f64_ok) is expected


def test_forced_placement_and_cpu_mesh_like_jax(comm8):
    for s, want in (("1", True), ("device", True), ("0", False),
                    ("host", False)):
        assert port_pc._want_device_setup(CPU, torch.float64, s) is want
        assert jax_pc._want_device_setup(comm8, np.float64, s) is want
    assert port_pc._want_device_setup(CUDA, torch.float32, "0") is False
    assert not jax_pc._want_device_setup(comm8, np.float32, "auto")
    for mod, where in ((port_pc, CPU), (jax_pc, comm8)):
        with pytest.raises(ValueError, match="pc_setup_device"):
            mod._want_device_setup(where, np.float32, "maybe")


# ---- PC bjacobi ---------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ndev,blocks", [(8, 0), (4, 16), (1, 0)])
def test_bjacobi_device_inverse_matches_jax(comm8, dtype, ndev, blocks):
    A = convdiff2d(16)               # n = 256
    jcomm = comm8 if ndev == 8 else tps.DeviceComm(n_devices=ndev)
    jh = _built(tps, jcomm, A, "bjacobi", dtype, "0", blocks)
    pd = _built(pt, pt.DeviceComm(ndev, device="cpu"), A, "bjacobi", dtype,
                "1", blocks)
    assert pd.setup_mode == "device" and jh.setup_mode == "host"
    assert set(pd.setup_breakdown) == {"extract_s", "invert_s"}
    ih, idv = np.asarray(jh._arrays[0]), _arr(pd)
    assert ih.shape == idv.shape and ih.dtype == idv.dtype
    np.testing.assert_allclose(idv, ih, rtol=TOL[dtype], atol=TOL[dtype])


def test_ell_diag_blocks_equal_host_extraction(comm8):
    A = convdiff2d(15)               # n = 225 over 8 shards: 31 pad rows
    n = A.shape[0]
    M = pt.Mat.from_scipy(pt.DeviceComm(8, device="cpu"), A)
    bs = M.ell_cols.shape[0] // 8
    dev = port_pc._ell_diag_blocks(M.ell_cols, M.ell_vals, bs, n).numpy()
    host = port_pc._dense_diag_blocks(A.tocsr(), n, bs, 8, np.float64)
    np.testing.assert_array_equal(dev, host)
    JM = tps.Mat.from_scipy(comm8, A)
    jdev = np.asarray(jax_pc._ell_diag_blocks(JM.ell_cols, JM.ell_vals, bs,
                                              n))
    np.testing.assert_array_equal(dev, jdev)


def test_singular_block_gate_and_host_error():
    blocks = np.stack([np.eye(4)] * 8)
    blocks[3, 2, :] = 0.0            # exactly singular
    assert port_pc._device_inverse(torch.from_numpy(blocks)) is None
    d = np.ones(64)
    d[10] = 0.0
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=8)),
                      (pt, pt.DeviceComm(8, device="cpu"))):
        with pytest.raises(ValueError, match="[Ss]ingular"):
            _built(pkg, comm, sp.diags(d).tocsr(), "bjacobi", np.float64,
                   "1")


def test_ill_conditioned_fp32_gate():
    """fp32 cannot invert an 8 x 8 Hilbert block (cond ~1.5e10) to the
    gate's 1e-2, in either package."""
    i = np.arange(8)
    hilbert = 1.0 / (i[:, None] + i[None, :] + 1.0)
    blocks = np.stack([hilbert] * 4).astype(np.float32)
    X, q = port_pc._inv_polish(torch.from_numpy(blocks))
    jX, jq = jax_pc._inv_polish(blocks)
    assert float(q) > port_pc._DEVICE_INV_GATE
    assert float(jq) > jax_pc._DEVICE_INV_GATE
    assert port_pc._device_inverse(torch.from_numpy(blocks)) is None


def test_gate_rejection_reuses_extracted_stack(monkeypatch):
    """A rejected device inverse is replaced by the host fp64 inverse of the
    blocks already extracted on the device: the host path's numbers,
    ``setup_mode`` 'host'."""
    monkeypatch.setattr(port_pc, "_device_inverse", lambda b: None)
    comm = pt.DeviceComm(8, device="cpu")
    A = convdiff2d(16)
    ph = _built(pt, comm, A, "bjacobi", np.float64, "0")
    pf = _built(pt, comm, A, "bjacobi", np.float64, "1")
    assert pf.setup_mode == "host" and pf.setup_breakdown is None
    np.testing.assert_array_equal(_arr(pf), _arr(ph))


def test_device_errors_propagate(monkeypatch):
    """An exception in the device program is not turned into a host run."""
    def boom(B):
        raise RuntimeError("device failure")
    monkeypatch.setattr(port_pc, "_inv_polish", boom)
    with pytest.raises(RuntimeError, match="device failure"):
        _built(pt, pt.DeviceComm(2, device="cpu"), convdiff2d(8), "bjacobi",
               np.float64, "1")


def test_forced_device_setup_refuses_bfloat16():
    with pytest.raises(TypeError, match="bfloat16"):
        _built(pt, pt.DeviceComm(2, device="cpu"), convdiff2d(8), "bjacobi",
               torch.bfloat16, "1")


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-10)])
def test_bcgs_through_device_bjacobi_matches_jax(comm8, dtype, rtol):
    """cfg4's shape: BiCGStab on convection-diffusion through block inverses
    made by the device program in both packages."""
    A = sp.csr_matrix(convdiff2d(16, beta=0.4), dtype=dtype)
    b = (A @ np.random.default_rng(0).random(A.shape[0])).astype(dtype)
    out = []
    for pkg, comm in ((tps, comm8), (pt, pt.DeviceComm(8, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A, dtype=dtype)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("bcgs")
        ksp.get_pc().set_type("bjacobi")
        ksp.get_pc().setup_device = "1"
        ksp.set_tolerances(rtol=rtol, atol=0.0)
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        assert ksp.get_pc().setup_mode == "device" and res.converged
        out.append((res.iterations, int(res.reason), x.to_numpy()))
    assert out[1][:2] == out[0][:2]
    if dtype == np.float64:
        np.testing.assert_allclose(out[1][2], out[0][2], rtol=0,
                                   atol=1e-10 * np.abs(out[0][2]).max())


# ---- dense PC lu --------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dense_lu_device_inverse_matches_jax(comm8, dtype):
    A = convdiff2d(7)                # n = 49, padded to 56 on 8 shards
    n = A.shape[0]
    jh = _built(tps, comm8, A, "lu", dtype, "0")
    pd = _built(pt, pt.DeviceComm(8, device="cpu"), A, "lu", dtype, "1")
    assert pd.kind == "lu" and pd.setup_mode == "device"
    inv = _arr(pd)
    assert inv.shape == (56, 56)
    assert not inv[n:, :].any() and not inv[:, n:].any()
    tol = 2e-5 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(inv, np.asarray(jh._arrays[0]), rtol=tol,
                               atol=tol)


def test_densify_ell_identity_pad_rows():
    A = convdiff2d(7)
    M = pt.Mat.from_scipy(pt.DeviceComm(8, device="cpu"), A)
    D = port_pc._densify_ell(M.ell_cols, M.ell_vals, 49).numpy()
    np.testing.assert_array_equal(D[:49, :49], A.toarray())
    np.testing.assert_array_equal(D[49:, 49:], np.eye(7))
    assert not D[:49, 49:].any() and not D[49:, :49].any()


@pytest.mark.parametrize("ndev", [1, 4])
def test_preonly_through_device_dense_lu_matches_jax(ndev):
    A = sp.csr_matrix(convdiff2d(7))
    b = A @ np.random.default_rng(3).random(A.shape[0])
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=ndev)),
                      (pt, pt.DeviceComm(ndev, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("preonly")
        ksp.get_pc().set_type("lu")
        ksp.get_pc().setup_device = "1"
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        assert ksp.get_pc().setup_mode == "device"
        out.append((res.iterations, int(res.reason), x.to_numpy()))
    assert out[1][:2] == out[0][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=1e-12)
    rr = np.linalg.norm(b - A @ out[1][2]) / np.linalg.norm(b)
    assert rr <= 1e-12, rr


# ---- options and rebuilds -----------------------------------------------------------

def test_option_plumbing_and_rebuild():
    pt.init(["prog", "-pc_setup_device", "1"])
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, convdiff2d(8))
    ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.get_pc().set_type("bjacobi")
    ksp.set_from_options()
    pc = ksp.get_pc()
    assert pc.setup_device == "1"
    ksp.set_up()
    assert pc.setup_mode == "device"
    pc.setup_device = "0"            # a tunable of the set-up key
    ksp.set_up()
    assert pc.setup_mode == "host"
