"""The PyTorch port's PETSc binary I/O (``utils/petsc_io.py``) against the
JAX package's.

The port's writers give the same bytes as the JAX package's on the same
matrix and vector (real, complex, unsorted column indices), each package
reads the other's files, and the readers refuse what the JAX package's
refuse, with its messages: a wrong class id, a truncated file, row lengths
that do not sum to nnz, and a complex-build file read as real, by path and
streamed. ``load_mat``/``load_vec`` put a file on the port's shards
(1/2/4/8), and the loaded system solves as the JAX package's does.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.utils import petsc_io as jio  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import petsc_io as pio  # noqa: E402


def poisson2d(nx):
    T = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    return (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def _mats():
    rng = np.random.default_rng(3)
    unsorted = sp.csr_matrix((np.array([3.0, 1.0, 2.0]),
                              np.array([2, 0, 1]), np.array([0, 3, 3, 3])),
                             shape=(3, 3))
    return {
        "random": sp.random(60, 45, density=0.08, random_state=rng).tocsr(),
        "poisson": poisson2d(7),
        "unsorted": unsorted,
        "complex": (sp.random(9, 9, density=0.3, random_state=rng)
                    + 1j * sp.eye(9)).tocsr(),
        "empty-rows": sp.csr_matrix((5, 4)),
    }


@pytest.mark.parametrize("name", sorted(_mats()))
def test_mat_bytes_equal_jax_and_each_reads_the_other(name, tmp_path):
    A = _mats()[name]
    pj, pp = tmp_path / "jax.petsc", tmp_path / "port.petsc"
    jio.write_mat(pj, A.copy())
    pio.write_mat(pp, A.copy())
    assert pp.read_bytes() == pj.read_bytes()
    scalar = "complex" if np.iscomplexobj(A.data) else "real"
    for reader, path in ((pio.read_mat, pj), (jio.read_mat, pp)):
        B = reader(path, scalar=scalar)
        assert B.shape == A.shape and (B != A).nnz == 0


@pytest.mark.parametrize("kind", ["real", "complex", "empty"])
def test_vec_bytes_equal_jax_and_each_reads_the_other(kind, tmp_path):
    rng = np.random.default_rng(4)
    v = {"real": rng.random(77),
         "complex": rng.random(11) + 1j * rng.random(11),
         "empty": np.zeros(0)}[kind]
    pj, pp = tmp_path / "jax.petsc", tmp_path / "port.petsc"
    jio.write_vec(pj, v)
    pio.write_vec(pp, v)
    assert pp.read_bytes() == pj.read_bytes()
    scalar = "complex" if kind == "complex" else "real"
    np.testing.assert_array_equal(pio.read_vec(pj, scalar=scalar), v)
    np.testing.assert_array_equal(jio.read_vec(pp, scalar=scalar), v)


def test_golden_bytes(tmp_path):
    """[[1, 2], [0, 3]] and [0.5, -1.25] in PETSc's big-endian layout."""
    p = tmp_path / "a.petsc"
    pio.write_mat(p, sp.csr_matrix(np.array([[1.0, 2.0], [0.0, 3.0]])))
    assert p.read_bytes() == (
        np.array([1211216, 2, 2, 3], dtype=">i4").tobytes()
        + np.array([2, 1], dtype=">i4").tobytes()
        + np.array([0, 1, 1], dtype=">i4").tobytes()
        + np.array([1.0, 2.0, 3.0], dtype=">f8").tobytes())
    pio.write_vec(p, np.array([0.5, -1.25]))
    assert p.read_bytes() == (
        np.array([1211214, 2], dtype=">i4").tobytes()
        + np.array([0.5, -1.25], dtype=">f8").tobytes())


def _complex_vec_file(p, n=5):
    hdr = np.array([1211214, n], dtype=">i4")
    interleaved = np.zeros(2 * n, dtype=">f8")
    interleaved[0::2] = np.arange(1.0, n + 1)
    interleaved[1::2] = 0.25
    p.write_bytes(hdr.tobytes() + interleaved.tobytes())


def _refusals(tmp_path):
    """(what, build the file, read it) for each file both readers refuse."""
    def wrong_classid(p):
        pio.write_vec(p, np.ones(3))

    def truncated(p):
        pio.write_mat(p, sp.eye(5, format="csr"))
        p.write_bytes(p.read_bytes()[:-12])

    def bad_rowlens(p):
        p.write_bytes(np.array([1211216, 2, 2, 3], dtype=">i4").tobytes()
                      + np.array([1, 1], dtype=">i4").tobytes()
                      + np.zeros(3, dtype=">i4").tobytes()
                      + np.zeros(3, dtype=">f8").tobytes())

    def complex_mat(p):
        p.write_bytes(np.array([1211216, 2, 2, 2], dtype=">i4").tobytes()
                      + np.array([1, 1], dtype=">i4").tobytes()
                      + np.array([0, 1], dtype=">i4").tobytes()
                      + np.array([1.0, 0.5, 2.0, -0.5],
                                 dtype=">f8").tobytes())

    return {
        "classid": (wrong_classid, "read_mat", False),
        "truncated": (truncated, "read_mat", False),
        "rowlens": (bad_rowlens, "read_mat", False),
        "complex-vec": (_complex_vec_file, "read_vec", False),
        "complex-mat": (complex_mat, "read_mat", False),
        "complex-vec-streamed": (_complex_vec_file, "read_vec", True),
    }


@pytest.mark.parametrize("what", ["classid", "truncated", "rowlens",
                                  "complex-vec", "complex-mat",
                                  "complex-vec-streamed"])
def test_refusals_like_jax(what, tmp_path):
    make, reader, streamed = _refusals(tmp_path)[what]
    p = tmp_path / "bad.petsc"
    make(p)
    msgs = []
    for mod in (jio, pio):
        with pytest.raises(ValueError) as e:
            if streamed:
                with open(p, "rb") as f:
                    getattr(mod, reader)(f)
            else:
                getattr(mod, reader)(p)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_streamed_mat_then_vec_keeps_the_cursor(tmp_path):
    p = tmp_path / "mv.petsc"
    A = sp.eye(4, format="csr") * 2.0
    v = np.arange(4.0)
    with open(p, "wb") as f:
        pio.write_mat(f, A)
        pio.write_vec(f, v)
    with open(p, "rb") as f:
        A2 = jio.read_mat(f)
        v2 = jio.read_vec(f)
    with open(p, "rb") as f:
        A3 = pio.read_mat(f)
        v3 = pio.read_vec(f)
    for M, w in ((A2, v2), (A3, v3)):
        np.testing.assert_array_equal(M.toarray(), A.toarray())
        np.testing.assert_array_equal(w, v)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_load_on_the_shards_and_solve_like_jax(ndev, tmp_path):
    A = poisson2d(9)
    b = np.random.default_rng(ndev).random(A.shape[0])
    pm, pv = tmp_path / "m.petsc", tmp_path / "v.petsc"
    jio.write_mat(pm, A)
    jio.write_vec(pv, b)
    comm = pt.DeviceComm(ndev, device="cpu")
    M = pio.load_mat(pm, comm)
    bv = pio.load_vec(pv, comm)
    assert M.dtype == torch.float64 and M.shape == A.shape
    np.testing.assert_array_equal(bv.to_numpy(), b)
    assert torch.all(bv.data[A.shape[0]:] == 0)
    # save_mat/save_vec write the bytes the JAX package's would
    pio.save_mat(tmp_path / "m2.petsc", M)
    pio.save_vec(tmp_path / "v2.petsc", bv)
    assert (tmp_path / "m2.petsc").read_bytes() == pm.read_bytes()
    assert (tmp_path / "v2.petsc").read_bytes() == pv.read_bytes()
    jc = tps.DeviceComm(n_devices=ndev)
    out = []
    for pkg, mat, vec in ((tps, jio.load_mat(pm, jc), jio.load_vec(pv, jc)),
                          (pt, M, bv)):
        ksp = pkg.KSP().create(mat.comm)
        ksp.set_operators(mat)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-10)
        x, _ = mat.get_vecs()
        res = ksp.solve(vec, x)
        out.append((res.iterations, int(res.reason), x.to_numpy()))
    assert out[0][:2] == out[1][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=1e-10)


def test_load_f32_and_refuse_complex_naming_item_5(tmp_path):
    p = tmp_path / "m.petsc"
    pio.write_mat(p, poisson2d(3))
    comm = pt.DeviceComm(2, device="cpu")
    assert pio.load_mat(p, comm, dtype=torch.float32).dtype == torch.float32
    for load in (pio.load_mat, pio.load_vec):
        with pytest.raises(NotImplementedError, match="Queue A item 5"):
            load(p, comm, scalar="complex")
    with pytest.raises(ValueError, match="scalar must be"):
        pio.load_mat(p, comm, scalar="quaternion")
