"""The PyTorch port's assembled matrix (``core/mat.py``, ``ops/spmv.py``)
against the JAX package.

The host layout functions must give the JAX package's arrays exactly; the
products (``Mat.mult``, ``local_spmv``, ``local_spmv_many``) must agree with
the JAX ``Mat.mult`` on 1/2/4/8 shards through all three routes (banded DIA
with a halo exchange, gathered DIA, ELL), in fp64, within 1e-14 relative.
The matrices: 2D Poisson, convection-diffusion, the tridiagonal family, a
scrambled Poisson matrix (whose diagonals exceed the DIA cap, so it takes
ELL) and the reference's random system.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.core import mat as jax_mat  # noqa: E402
from mpi_petsc4py_example_tpu.models import generators as jgen  # noqa: E402
from mpi_petsc4py_example_tpu.ops import spmv as jspmv  # noqa: E402
from mpi_petsc4py_example_tpu.parallel import partition as jpart  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.core.mat import Mat, coo_to_csr  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models import generators as gen  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson2d_csr)
from mpi_petsc4py_example_tpu_torch.ops import spmv  # noqa: E402
from mpi_petsc4py_example_tpu_torch.parallel import partition  # noqa: E402

REL = 1e-14


def scrambled_poisson(nx, seed=5):
    """2D Poisson under a seeded symmetric random permutation: its occupied
    diagonals exceed the DIA cap, so a Mat takes the ELL route."""
    A = poisson2d_csr(nx)
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


MATRICES = {
    "poisson2d": lambda: poisson2d_csr(12),
    "convdiff": lambda: gen.convdiff2d(10, beta=0.4),
    "tridiag": lambda: gen.tridiag_family(60),
    "scrambled": lambda: scrambled_poisson(9),
    "random": lambda: gen.random_system(100)[0],
}
ROUTE = {"poisson2d": "dia", "convdiff": "dia", "tridiag": "dia",
         "scrambled": "ell", "random": "ell"}


def _csr(A):
    return A.indptr, A.indices, A.data


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


# ---- host layouts equal to the JAX package's --------------------------------

@pytest.mark.parametrize("name", sorted(MATRICES))
def test_host_layouts_equal_jax(name):
    A = MATRICES[name]()
    n = A.shape[0]
    cols, vals = spmv.csr_to_ell(*_csr(A))
    jcols, jvals = jspmv.csr_to_ell(*_csr(A))
    assert cols.dtype == jcols.dtype and vals.dtype == jvals.dtype
    np.testing.assert_array_equal(cols, jcols)
    np.testing.assert_array_equal(vals, jvals)
    K = cols.shape[1]
    offs = spmv.csr_find_diagonals(A.indptr, A.indices, max(2 * K, 8))
    joffs = jspmv.csr_find_diagonals(A.indptr, A.indices, max(2 * K, 8))
    assert (offs is None) == (joffs is None) == (ROUTE[name] == "ell")
    all_offs = spmv.csr_find_diagonals(A.indptr, A.indices, 2 * n)
    np.testing.assert_array_equal(
        all_offs, jspmv.csr_find_diagonals(A.indptr, A.indices, 2 * n))
    np.testing.assert_array_equal(
        spmv.csr_to_dia(*_csr(A), n, all_offs),
        jspmv.csr_to_dia(*_csr(A), n, all_offs))
    np.testing.assert_array_equal(spmv.csr_diag(*_csr(A), n),
                                  jspmv.csr_diag(*_csr(A), n))
    # padding to a wider K, as the JAX function pads
    np.testing.assert_array_equal(spmv.csr_to_ell(*_csr(A), K + 3)[1],
                                  jspmv.csr_to_ell(*_csr(A), K + 3)[1])


def test_local_products_equal_jax():
    """The four local products on the same inputs (the port's DIA values
    are diagonal-major and its column blocks ``(k, n)``: the transposes of
    the JAX layouts)."""
    A = gen.convdiff2d(8, beta=0.3)
    n = A.shape[0]
    rng = np.random.default_rng(0)
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    cols, vals = spmv.csr_to_ell(*_csr(A))
    offs = tuple(int(o) for o in spmv.csr_find_diagonals(A.indptr,
                                                         A.indices))
    dia = spmv.csr_to_dia(*_csr(A), n, offs)
    halo = max(abs(o) for o in offs)
    lo, hi = 16, 40                                  # one shard's rows

    def close(port, ref):
        ref = np.asarray(ref)
        np.testing.assert_allclose(port, ref, rtol=0,
                                   atol=REL * np.abs(ref).max())

    t = torch.from_numpy
    close(spmv.ell_spmv_local(t(cols[lo:hi]), t(vals[lo:hi]), t(x)),
          jspmv.ell_spmv_local(cols[lo:hi], vals[lo:hi], jnp.asarray(x)))
    close(spmv.ell_spmv_local_many(t(cols[lo:hi]), t(vals[lo:hi]),
                                   t(X.T.copy())).T,
          jspmv.ell_spmv_local_many(cols[lo:hi], vals[lo:hi],
                                    jnp.asarray(X)))
    dia_t = t(dia[lo:hi].T.copy())
    close(spmv.dia_spmv_local(dia_t, offs, t(x), lo, halo),
          jspmv.dia_spmv_local(dia[lo:hi], offs, jnp.asarray(x), lo, halo))
    close(spmv.dia_spmv_local_many(dia_t, offs, t(X.T.copy()), lo, halo).T,
          jspmv.dia_spmv_local_many(dia[lo:hi], offs, jnp.asarray(X), lo,
                                    halo))


# ---- the products on 1/2/4/8 shards ------------------------------------------

def _jax_mult(A, x, ndev):
    jcomm = tps.DeviceComm(n_devices=ndev)
    M = tps.Mat.from_scipy(jcomm, A)
    return M, M.mult(tps.Vec.from_global(jcomm, x)).to_numpy()


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_products_match_jax(name, ndev):
    A = MATRICES[name]()
    n = A.shape[0]
    rng = np.random.default_rng(ndev)
    x, X = rng.standard_normal(n), rng.standard_normal((n, 3))
    M, y_ref = _jax_mult(A, x, ndev)
    comm = pt.DeviceComm(ndev, device="cpu")
    m = Mat.from_scipy(comm, A)
    assert m.program_key() == M.program_key()
    assert m.K == M.K and m.n_pad == M.n_pad
    route = m.spmv_route(comm)
    assert route.startswith(ROUTE[name])
    if ROUTE[name] == "dia" and ndev > 1:
        halo = max(abs(o) for o in m.dia_offsets)
        assert (route == "dia-banded") == (halo <= comm.local_size(n))
    tol = REL * np.abs(y_ref).max()
    xv = pt.Vec.from_global(comm, x)
    np.testing.assert_allclose(m.mult(xv).to_numpy(), y_ref, rtol=0, atol=tol)
    y = m.local_spmv(comm)(xv.data.view(ndev, -1)).reshape(-1)[:n]
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=tol)
    Y = comm.fetch_cols(m.local_spmv_many(comm)(comm.put_cols(X)), n)
    Y_ref = A @ X
    np.testing.assert_allclose(Y, Y_ref, rtol=0,
                               atol=REL * np.abs(Y_ref).max())


def test_every_route_is_reached():
    """The banded route needs a halo no wider than a shard; past it the
    gathered route serves; a matrix with too many diagonals takes ELL."""
    A = poisson2d_csr(12)                   # halo 12, 144 rows
    routes = {nd: Mat.from_scipy(c := pt.DeviceComm(nd, device="cpu"),
                                 A).spmv_route(c) for nd in (1, 4, 16)}
    assert routes == {1: "dia-gathered", 4: "dia-banded",
                      16: "dia-gathered"}
    comm = pt.DeviceComm(2, device="cpu")
    assert Mat.from_scipy(comm, scrambled_poisson(9)).spmv_route(comm) \
        == "ell"
    # rectangular and all-zero matrices stay on ELL, as in the JAX package
    import scipy.sparse as sp
    for S in (sp.random(6, 9, density=0.5, random_state=1, format="csr"),
              sp.csr_matrix((5, 5))):
        jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=1), S)
        assert Mat.from_scipy(comm, S).program_key() == jm.program_key() \
            == ("ell",)


# ---- construction ----------------------------------------------------------------

@pytest.mark.parametrize("nparts", [1, 3, 4])
def test_partition_helpers_equal_jax(nparts):
    A = gen.random_system(37, seed=3)[0]
    blocks = partition.partition_csr(*_csr(A), nparts)
    jblocks = jpart.partition_csr(*_csr(A), nparts)
    for blk, jblk in zip(blocks, jblocks):
        for a, b in zip(blk, jblk):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(partition.concat_csr_blocks(blocks),
                    jpart.concat_csr_blocks(jblocks)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(partition.slice_csr_block(*_csr(A), 5, 20),
                    jpart.slice_csr_block(*_csr(A), 5, 20)):
        np.testing.assert_array_equal(a, b)
    comm = pt.DeviceComm(nparts, device="cpu")
    m = Mat.from_local_blocks(comm, A.shape, blocks)
    np.testing.assert_array_equal(m.to_scipy().toarray(), A.toarray())


def test_generators_equal_jax():
    for mine, ref in ((gen.tridiag_family(30), jgen.tridiag_family(30)),
                      (gen.convdiff2d(7, 5, beta=0.2),
                       jgen.convdiff2d(7, 5, beta=0.2))):
        assert (mine != ref).nnz == 0
    for a, b in zip(gen.random_system(50, seed=9, density=0.2),
                    jgen.random_system(50, seed=9, density=0.2)):
        np.testing.assert_array_equal(
            a.toarray() if hasattr(a, "toarray") else a,
            b.toarray() if hasattr(b, "toarray") else b)


def test_create_aij_contract():
    comm = pt.DeviceComm(2, device="cpu")
    A = poisson2d_csr(5)
    m = Mat.create_aij(comm, A.shape, _csr(A))
    assert (m.to_scipy() != A).nnz == 0 and m.assembled
    with pytest.raises(ValueError, match="from_local_blocks"):
        Mat.create_aij(comm, A.shape,
                       partition.slice_csr_block(*_csr(A), 0, 10))


@pytest.mark.parametrize("bad", ["indptr0", "monotone", "nnz", "column",
                                 "rows"])
def test_malformed_csr_raises_like_jax(bad):
    A = poisson2d_csr(4)
    ip, ix, dv = A.indptr.copy(), A.indices.copy(), A.data.copy()
    shape = A.shape
    if bad == "indptr0":
        ip = ip + 1
    elif bad == "monotone":
        ip[3], ip[4] = ip[4], ip[3]
    elif bad == "nnz":
        ip[-1] -= 1
    elif bad == "column":
        ix[0] = 16
    else:
        shape = (17, 16)
    comm = pt.DeviceComm(1, device="cpu")
    with pytest.raises(ValueError, match="malformed CSR") as port:
        Mat.from_csr(comm, shape, (ip, ix, dv))
    if bad != "rows":
        with pytest.raises(ValueError, match="malformed CSR") as ref:
            tps.Mat.from_csr(tps.DeviceComm(n_devices=1), shape,
                             (ip, ix, dv))
        assert str(port.value) == str(ref.value)


def test_assembly_breakdown_keys_equal_jax():
    A = poisson2d_csr(6)
    jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=1), A)
    m = Mat.from_scipy(pt.DeviceComm(1, device="cpu"), A)
    assert list(m.assembly_breakdown) == list(jm.assembly_breakdown) == [
        "tocsr_s", "validate_s", "ell_convert_s", "dia_convert_s",
        "device_put_s"]
    assert all(v >= 0 for v in m.assembly_breakdown.values())
    m2 = Mat.from_csr(pt.DeviceComm(1, device="cpu"), A.shape, _csr(A))
    assert list(m2.assembly_breakdown) == list(
        tps.Mat.from_csr(tps.DeviceComm(n_devices=1), A.shape,
                         _csr(A)).assembly_breakdown)


# bfloat16 storage is taken (tests/test_torch_mixed_precision.py)
@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float16])
def test_sub_f32_storage_raises(dtype):
    with pytest.raises(NotImplementedError, match="mixed-precision"):
        Mat.from_scipy(pt.DeviceComm(1, device="cpu"), poisson2d_csr(4),
                       dtype=dtype)


def test_fp32_storage():
    A = gen.convdiff2d(9, beta=0.4)
    comm = pt.DeviceComm(3, device="cpu")
    m = Mat.from_scipy(comm, A, dtype=np.float32)
    assert m.dtype == torch.float32 and m.dia_vals.dtype == torch.float32
    x = np.random.default_rng(2).random(A.shape[0]).astype(np.float32)
    y = m.mult(pt.Vec.from_global(comm, x)).to_numpy()
    jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=3), A,
                            dtype=np.float32)
    y_ref = jm.mult(tps.Vec.from_global(jm.comm, x)).to_numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=1e-6 * np.abs(y_ref).max())


# ---- COO assembly -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["insert", "add"])
def test_coo_to_csr_equal_jax(mode):
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 7, 60)
    cols = rng.integers(0, 5, 60)
    vals = rng.standard_normal(60)
    for a, b in zip(coo_to_csr((7, 5), rows, cols, vals, mode),
                    jax_mat.coo_to_csr((7, 5), rows, cols, vals, mode)):
        np.testing.assert_array_equal(a, b)
    ip, ix, dv = coo_to_csr((2, 2), [0, 0, 1], [1, 1, 0], [1.0, 2.0, 5.0],
                            mode)
    assert dv[0] == (2.0 if mode == "insert" else 3.0)


def test_coo_to_csr_rejects():
    with pytest.raises(ValueError, match="out of range"):
        coo_to_csr((2, 2), [0, 2], [0, 0], [1.0, 1.0])
    with pytest.raises(ValueError, match="lengths differ"):
        coo_to_csr((2, 2), [0, 1], [0], [1.0, 1.0])
    with pytest.raises(ValueError, match="unknown mode"):
        coo_to_csr((2, 2), [0], [0], [1.0], mode="max")


# ---- the Mat algebra ------------------------------------------------------------

def _pair(A, ndev=2):
    return (Mat.from_scipy(pt.DeviceComm(ndev, device="cpu"), A),
            tps.Mat.from_scipy(tps.DeviceComm(n_devices=ndev), A))


def _same(m, jm):
    assert m.shape == jm.shape and m.program_key() == jm.program_key()
    assert m._state == jm._state
    assert abs(m.to_scipy() - jm.to_scipy()).max() == 0 \
        if m.to_scipy().nnz else True
    x = np.random.default_rng(1).standard_normal(m.shape[1])
    y = m.mult(pt.Vec.from_global(m.comm, x)).to_numpy()
    y_ref = jm.mult(tps.Vec.from_global(jm.comm, x)).to_numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0,
                               atol=REL * max(np.abs(y_ref).max(), 1.0))


@pytest.mark.parametrize("op", ["scale", "shift", "axpy", "zero_rows"])
def test_mutations_match_jax(op):
    A = gen.convdiff2d(6, beta=0.3)
    m, jm = _pair(A)
    if op == "scale":
        m.scale(-2.5), jm.scale(-2.5)
    elif op == "shift":
        m.shift(0.75), jm.shift(0.75)
    elif op == "axpy":
        B = gen.tridiag_family(36)
        m.axpy(0.5, _pair(B)[0]), jm.axpy(0.5, _pair(B)[1])
        with pytest.raises(ValueError, match="shape"):
            m.axpy(1.0, _pair(poisson2d_csr(5))[0])
    else:
        x = np.arange(36.0)
        xv, bv = m.get_vecs()
        jxv, jbv = jm.get_vecs()
        for v, jv, vals in ((xv, jxv, x), (bv, jbv, 2 * x)):
            v.set_global(vals)
            jv.set_global(vals)
        m.zero_rows([0, 7, 35], diag=3.0, b=bv, x=xv)
        jm.zero_rows([0, 7, 35], diag=3.0, b=jbv, x=jxv)
        np.testing.assert_array_equal(bv.to_numpy(), jbv.to_numpy())
    assert m._state == 1
    _same(m, jm)


def test_queries_match_jax():
    A = gen.convdiff2d(6, beta=0.3)
    m, jm = _pair(A, ndev=4)
    for t in ("frobenius", "1", "inf"):
        assert m.norm(t) == pytest.approx(jm.norm(t), rel=1e-15)
    with pytest.raises(ValueError):
        m.norm("2")
    np.testing.assert_array_equal(m.diagonal(), jm.diagonal())
    for a, b in zip(m.get_row(7), jm.get_row(7)):
        np.testing.assert_array_equal(a, b)
    info, jinfo = m.get_info(), jm.get_info()
    assert info == jinfo
    _same(m.transpose(), jm.transpose())
    _same(m.copy(), jm.copy())
    _same(m.duplicate(copy_values=False), jm.duplicate(copy_values=False))
    x, b = m.get_vecs()
    assert x.n == b.n == 36 and x.dtype == m.dtype and x.data is not b.data
