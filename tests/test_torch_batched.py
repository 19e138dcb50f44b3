"""The PyTorch port's batched multi-RHS slice (``KSP.solve_many``) against the
JAX package.

The port's ``stencil7_apply_many``/``stencil7_dot_many`` kernels run only on
the card (``chip_smoke.py`` holds them against their plain versions there).
Here the wrappers take the plain versions, which are held against the JAX
package's multi-RHS Pallas kernels run through the Pallas interpreter (as
``tests/test_pallas.py`` runs them) and against ``_stencil7_jnp`` in fp64.
Whole batched solves go through both packages on the same numpy inputs, per
column, and against the port's own sequential solves; the masked-convergence
cases mirror ``tests/test_batched.py`` on the stencil.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil3d_apply_many_pallas, stencil3d_dot_many_pallas)
from mpi_petsc4py_example_tpu.solvers import krylov as jax_krylov  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.stencil import (  # noqa: E402
    exchange_many)
from mpi_petsc4py_example_tpu_torch.ops import build  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import cg_plans  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers.krylov import (  # noqa: E402
    stencil_cg_eligible)

CR = pt.ConvergedReason
RTOL = 1e-8


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _block(shape, k, dtype, seed, halos=True):
    rng = np.random.default_rng(seed)
    lz, ny, nx = shape
    U = rng.random((k, lz, ny, nx)).astype(dtype)
    if not halos:
        return U, None, None
    return (U, rng.random((k, ny, nx)).astype(dtype),
            rng.random((k, ny, nx)).astype(dtype))


def _t(a):
    return None if a is None else torch.from_numpy(a)


# ---- plain versions vs the JAX Pallas kernels (interpreter), f32 ------------

@pytest.mark.parametrize("nrhs,lz,max_chunk", [(2, 4, None), (3, 8, 2)])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_plain_many_matches_pallas_interpret(kind, nrhs, lz, max_chunk):
    ny, nx = 8, 128
    U, lo, hi = _block((lz, ny, nx), nrhs, np.float32, 31 + nrhs + lz)
    args = (jnp.asarray(U), jnp.asarray(lo[:, None]), jnp.asarray(hi[:, None]),
            lz, ny, nx, nrhs, True, max_chunk)
    if kind == "apply":
        y_ref = np.asarray(stencil3d_apply_many_pallas(*args))
        y = st.stencil3d_apply_many(_t(U), _t(lo), _t(hi))
    else:
        y_ref, d_ref = stencil3d_dot_many_pallas(*args)
        y_ref = np.asarray(y_ref)
        y, d = st.stencil3d_dot_many(_t(U), _t(lo), _t(hi))
        assert d.dtype == torch.float32 and tuple(d.shape) == (nrhs,)
        np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-5)
    assert y.dtype == torch.float32 and tuple(y.shape) == U.shape
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)


# ---- plain versions vs vmapped _stencil7_jnp, f64, non-tileable planes ------

@pytest.mark.parametrize("shape,halos", [((3, 7, 33), True), ((1, 7, 33), True),
                                         ((5, 1, 1), True), ((4, 6, 10), False)])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_plain_many_matches_stencil7_jnp_f64(kind, shape, halos):
    U, lo, hi = _block(shape, 3, np.float64, sum(shape), halos)
    if not halos:
        lo_j = hi_j = np.zeros((3,) + shape[1:])
    else:
        lo_j, hi_j = lo, hi
    y_ref = np.asarray(jax.vmap(JaxStencil._stencil7_jnp)(
        jnp.asarray(U), jnp.asarray(lo_j), jnp.asarray(hi_j)))
    if kind == "apply":
        y = st.stencil3d_apply_many(_t(U), _t(lo), _t(hi))
    else:
        y, d = st.stencil3d_dot_many(_t(U), _t(lo), _t(hi))
        np.testing.assert_allclose(d.numpy(), (U * y_ref).sum(axis=(1, 2, 3)),
                                   rtol=1e-12)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("halos", [True, False], ids=["halos", "zero_halos"])
def test_plain_many_columns_equal_single_rhs_plain(halos):
    """Each column of the batched plain versions is the single-RHS plain
    version on that column: bit for bit in ``A u``, the dot to 1e-12."""
    U, lo, hi = (_t(a) for a in _block((4, 6, 10), 3, np.float64, 8, halos))
    Y = st.stencil3d_apply_many_plain(U, lo, hi)
    Yd, d = st.stencil3d_dot_many_plain(U, lo, hi)
    for j in range(3):
        lj, hj = (None, None) if lo is None else (lo[j], hi[j])
        y = st.stencil3d_apply_plain(U[j], lj, hj)
        zero = torch.zeros(U.shape[2:], dtype=U.dtype)
        yd, dj = st.stencil3d_dot_plain(U[j], lj if halos else zero,
                                        hj if halos else zero)
        torch.testing.assert_close(Y[j], y, rtol=0, atol=0)
        torch.testing.assert_close(Yd[j], yd, rtol=0, atol=0)
        torch.testing.assert_close(d[j], dj, rtol=1e-12, atol=0)


# ---- wrapper contract on the CPU --------------------------------------------

def test_cpu_many_wrappers_never_build_and_count_no_launch(monkeypatch):
    def refuse(*_):
        raise AssertionError("a CPU tensor reached the CUDA build")
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(st, "_libs", {})
    U, lo, hi = (_t(a) for a in _block((4, 6, 10), 3, np.float32, 1))
    before = {k: w.launches for k, w in st.KERNELS.items()}
    out = torch.empty_like(U)
    assert st.stencil3d_apply_many(U, lo, hi, out=out) is out
    torch.testing.assert_close(out, st.stencil3d_apply_many_plain(U, lo, hi),
                               rtol=0, atol=0)
    out2 = torch.empty_like(U)
    y2, d = st.stencil3d_dot_many(U, None, None, out=out2)
    assert y2 is out2
    torch.testing.assert_close(d, (U * out2).sum(dim=(1, 2, 3)), rtol=0,
                               atol=0)
    assert {k: w.launches for k, w in st.KERNELS.items()} == before
    assert {"stencil7_apply_many", "stencil7_dot_many"} <= set(st.KERNELS)


@pytest.mark.parametrize("bad,exc", [
    ("bf16", TypeError), ("plane_halo", ValueError), ("one_halo", ValueError),
    ("noncontig", ValueError), ("rank", ValueError), ("out_overlap",
                                                      ValueError),
    ("too_many_columns", ValueError)])
def test_many_wrappers_reject_what_the_kernels_do_not_take(bad, exc):
    U, lo, hi = (_t(a) for a in _block((4, 6, 10), 3, np.float32, 2))
    out = None
    if bad == "bf16":
        U, lo, hi = (a.to(torch.bfloat16) for a in (U, lo, hi))
    elif bad == "plane_halo":
        lo = lo[0]
    elif bad == "one_halo":
        hi = None
    elif bad == "noncontig":
        U = U.transpose(2, 3).contiguous().transpose(2, 3)
    elif bad == "rank":
        U = U[0]
    elif bad == "out_overlap":
        out = U
    elif bad == "too_many_columns":          # the kernels' grid limit
        U = torch.zeros(65536, 1, 1, 1)
        lo = hi = torch.zeros(65536, 1, 1)
    for fn in (st.stencil3d_apply_many, st.stencil3d_dot_many):
        with pytest.raises(exc):
            fn(U, lo, hi, out=out)


# ---- exchange, operator closures and column blocks --------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_exchange_many_ring_with_dirichlet_ends(ndev):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    U = torch.from_numpy(np.random.default_rng(ndev).random((ndev, 3, 2, 4, 5)))
    lo, hi = exchange_many(comm, U)
    if ndev == 1:
        assert lo is None and hi is None     # zero halos, no stale block
        return
    assert tuple(lo.shape) == (ndev, 3, 4, 5) and lo[0].is_contiguous()
    zero = torch.zeros(3, 4, 5, dtype=U.dtype)
    for i in range(ndev):
        exp_lo = U[i - 1, :, -1] if i > 0 else zero
        exp_hi = U[i + 1, :, 0] if i < ndev - 1 else zero
        torch.testing.assert_close(lo[i], exp_lo, rtol=0, atol=0)
        torch.testing.assert_close(hi[i], exp_hi, rtol=0, atol=0)


@pytest.mark.parametrize("ndev", [1, 4])
def test_many_closures_equal_column_by_column_applies(ndev):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op = pt.StencilPoisson3D(comm, 5, 4, 8, dtype=torch.float64)
    k = 3
    X = torch.from_numpy(np.random.default_rng(ndev).random(
        (ndev, k, op.shape[0] // ndev)))
    Y = op.local_spmv_many(comm)(X)
    U = X.reshape((ndev, k) + op.grid3d)
    Yd, d = op.local_matvec_dot_many(comm)(U)
    assert tuple(d.shape) == (k,)
    for j in range(k):
        y = op.mult(pt.Vec(comm, op.shape[0], data=X[:, j].reshape(-1))).data
        torch.testing.assert_close(Y[:, j].reshape(-1), y, rtol=0, atol=0)
        torch.testing.assert_close(Yd[:, j].reshape(-1), y, rtol=0, atol=0)
        torch.testing.assert_close(d[j], (X[:, j].reshape(-1) * y).sum(),
                                   rtol=1e-13, atol=0)
    op.force_plain = True
    torch.testing.assert_close(op.local_spmv_many(comm)(X), Y, rtol=0, atol=0)


@pytest.mark.parametrize("ndev,n", [(1, 10), (3, 10), (4, 16)])
def test_put_and_fetch_cols_round_trip(ndev, n):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    B = np.random.default_rng(n).standard_normal((n, 3))
    Bd = comm.put_cols(B, torch.float32)
    lsize = comm.local_size(n)
    assert tuple(Bd.shape) == (ndev, 3, lsize) and Bd.dtype == torch.float32
    flat = Bd.transpose(1, 2).reshape(-1, 3)
    np.testing.assert_array_equal(flat[:n].numpy(), B.astype(np.float32))
    assert not flat[n:].any()                     # zero padding rows
    np.testing.assert_array_equal(comm.fetch_cols(Bd, n), B.astype(np.float32))
    B[0, 0] = 99.0                                # the placement is a copy
    assert Bd[0, 0, 0] != 99.0


def test_many_batch_plan_broadcasts_per_column_scalars():
    s = torch.arange(3.0)
    assert tuple(cg_plans.ManyBatch("slabs").ex(s).shape) == (3, 1, 1, 1)
    assert tuple(cg_plans.ManyBatch("cols").ex(s).shape) == (3, 1)
    with pytest.raises(ValueError):
        cg_plans.ManyBatch("rows")


# ---- whole batched solves vs the JAX package --------------------------------

def _rhs_block(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


def _jax_solve_many(ndev, grid, B, pc, general=False, **tol):
    comm = tps.DeviceComm(n_devices=ndev)
    op = JaxStencil(comm, *grid, dtype=jnp.float64)
    ksp = tps.KSP().create(comm)
    ksp.set_type("cg")
    ksp.set_operators(op, JaxStencil(comm, *grid, dtype=jnp.float64)
                      if general else None)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=tol.get("rtol", RTOL), max_it=tol.get("max_it",
                                                                  10000))
    return op, ksp.solve_many(B)


def _port_ksp(ndev, grid, pc, general=False, rtol=RTOL, max_it=10000,
              dtype=torch.float64):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op = pt.StencilPoisson3D(comm, *grid, dtype=dtype)
    ksp = pt.KSP().create(comm)
    ksp.set_type("cg")
    ksp.set_operators(op, pt.StencilPoisson3D(comm, *grid, dtype=dtype)
                      if general else None)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol, max_it=max_it)
    return op, ksp


def _sequential(ksp, op, B):
    out = []
    for j in range(B.shape[1]):
        x, b = op.get_vecs()
        b.set_global(B[:, j])
        res = ksp.solve(b, x)
        out.append((res, x.to_numpy()))
    return out


@pytest.mark.parametrize("route", ["none", "jacobi", "general"])
@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("grid", [(16, 16, 16), (8, 12, 16)],
                         ids=["16cube", "8x12x16"])
def test_solve_many_matches_jax_and_sequential_fp64(grid, ndev, route,
                                                    monkeypatch):
    """Per column: iterations and reasons equal to the JAX package's
    ``solve_many`` and to the port's own sequential solves, ``X`` within
    1e-10. ``general`` is Amat != Pmat: PC jacobi built on a second operator,
    which both packages run on the general batched route (the JAX program
    cache does not key on that, so it is emptied for this case)."""
    general = route == "general"
    pc = "jacobi" if general else route
    if general:
        monkeypatch.setenv("TPU_SOLVE_AOT", "0")
        monkeypatch.setattr(jax_krylov, "_PROGRAM_CACHE_MANY", {})
    k = 3
    B = _rhs_block(int(np.prod(grid)), k, 10 * ndev + len(route))
    _, jres = _jax_solve_many(ndev, grid, B, pc, general)
    op, ksp = _port_ksp(ndev, grid, pc, general)
    assert stencil_cg_eligible("cg", ksp.get_pc(), op, many=True) \
        != general
    res = ksp.solve_many(B)
    assert isinstance(res, pt.BatchedSolveResult) and res.nrhs == k
    assert res.iterations == jres.iterations
    assert res.reasons == jres.reasons == [CR.CONVERGED_RTOL] * k
    assert res.host_syncs == 1 + max(res.iterations)
    assert res.histories == [[], [], []]
    for j, (sres, xj) in enumerate(_sequential(ksp, op, B)):
        ref = jres.X[:, j]
        assert np.linalg.norm(res.X[:, j] - ref) <= 1e-10 * np.linalg.norm(ref)
        assert sres.iterations == res.iterations[j]
        assert sres.reason == res.reasons[j]
        assert np.linalg.norm(res.X[:, j] - xj) <= 1e-10 * np.linalg.norm(xj)
        assert res.residual_norms[j] == pytest.approx(sres.residual_norm,
                                                      rel=1e-8)


@pytest.mark.parametrize("ndev", [1, 2])
def test_mg_takes_the_sequential_fallback_like_jax(ndev):
    grid = (16, 16, 16)
    B = _rhs_block(4096, 2, 5 + ndev)
    _, jres = _jax_solve_many(ndev, grid, B, "mg")
    op, ksp = _port_ksp(ndev, grid, "mg")
    st.stencil3d_dot_many.launches = 0
    res = ksp.solve_many(B)
    assert res.iterations == jres.iterations
    assert res.reasons == jres.reasons
    np.testing.assert_allclose(res.X, jres.X, rtol=1e-10, atol=1e-12)
    seq = _sequential(ksp, op, B)
    assert res.host_syncs == sum(s.host_syncs for s, _ in seq)
    assert [s.iterations for s, _ in seq] == res.iterations


# ---- masked convergence on the stencil (tests/test_batched.py:141-331) ------

def _eigen_and_hard(nx, seed=42):
    """Column 0: the exact eigenvector sin x sin x sin of the Dirichlet
    stencil (a one-dimensional Krylov space); column 1: ``A`` times a random
    vector, which needs the full spectral sweep."""
    i = np.arange(1, nx + 1)
    v = np.sin(np.pi * i / (nx + 1))
    easy = np.kron(np.kron(v, v), v)
    hard = pt.poisson3d_csr(nx) @ np.random.default_rng(seed).random(nx ** 3)
    return np.stack([easy, hard], axis=1)


@pytest.mark.parametrize("ndev", [1, 2])
def test_easy_column_freezes_hard_keeps_iterating(ndev):
    B = _eigen_and_hard(12)
    op, ksp = _port_ksp(ndev, (12, 12, 12), "none")
    ksp.set_tolerances(atol=0.0)
    res = ksp.solve_many(B)
    assert res.converged
    assert res.iterations[0] <= 3, res.iterations
    assert res.iterations[1] > res.iterations[0] + 5, res.iterations
    assert res.reasons == [CR.CONVERGED_RTOL] * 2
    (solo, x0), (solo1, x1) = _sequential(ksp, op, B)
    # the frozen column is untouched by the steps the hard column ran on
    assert solo.iterations == res.iterations[0]
    np.testing.assert_allclose(res.X[:, 0], x0, rtol=1e-12, atol=1e-14)
    assert solo1.iterations == res.iterations[1]
    np.testing.assert_allclose(res.X[:, 1], x1, rtol=1e-12, atol=1e-14)
    A = pt.poisson3d_csr(12)
    for j in range(2):
        assert (np.linalg.norm(B[:, j] - A @ res.X[:, j])
                <= RTOL * 1.05 * np.linalg.norm(B[:, j]))


def test_zero_and_nan_columns_freeze_without_touching_the_others():
    B = _rhs_block(512, 3, 1)
    B[:, 0] = 0.0
    B[0, 2] = np.nan
    op, ksp = _port_ksp(1, (8, 8, 8), "jacobi")
    res = ksp.solve_many(B)
    assert res.iterations[0] == 0 and res.reasons[0] == CR.CONVERGED_ATOL
    assert not res.X[:, 0].any()
    assert res.iterations[2] == 0 and res.reasons[2] == CR.DIVERGED_NANORINF
    assert res.reasons[1] == CR.CONVERGED_RTOL
    (solo, x1), = _sequential(ksp, op, B[:, 1:2])
    assert solo.iterations == res.iterations[1]
    np.testing.assert_allclose(res.X[:, 1], x1, rtol=1e-12, atol=1e-14)


def test_zero_column_matches_jax():
    B = _rhs_block(512, 2, 1)
    B[:, 0] = 0.0
    _, jres = _jax_solve_many(2, (8, 8, 8), B, "jacobi")
    _, ksp = _port_ksp(2, (8, 8, 8), "jacobi")
    res = ksp.solve_many(B)
    assert res.iterations == jres.iterations and res.iterations[0] == 0
    assert res.reasons == jres.reasons
    assert res.reasons[0] == CR.CONVERGED_ATOL and not res.X[:, 0].any()


@pytest.mark.parametrize("route", ["fast", "general"])
def test_norm_none_runs_max_it_on_every_column(route):
    B = _rhs_block(1536, 3, 10)
    _, ksp = _port_ksp(2, (8, 12, 16), "jacobi", general=route == "general",
                       max_it=7)
    ksp.set_norm_type("none")
    res = ksp.solve_many(B)
    assert res.iterations == [7, 7, 7]
    assert res.reasons == [CR.CONVERGED_ITS] * 3
    assert res.host_syncs == 8


# ---- routing, chunking, inputs ----------------------------------------------

def test_batch_limit_chunks_identically():
    B = _rhs_block(512, 5, 2)
    _, ksp = _port_ksp(2, (8, 8, 8), "jacobi")
    full = ksp.solve_many(B)
    ksp.batch_limit = 2
    chunked = ksp.solve_many(B)
    assert ksp.result_many is chunked
    assert chunked.iterations == full.iterations
    assert chunked.reasons == full.reasons
    np.testing.assert_array_equal(chunked.X, full.X)
    assert chunked.host_syncs == sum(
        1 + max(full.iterations[s:s + 2]) for s in range(0, 5, 2))


def test_batch_limit_from_options():
    pt.init(["prog", "-ksp_batch_limit", "4"])
    ksp = pt.KSP().create(pt.DeviceComm(device="cpu"))
    assert ksp.batch_limit == 0
    ksp.set_from_options()
    assert ksp.batch_limit == 4


def test_lists_of_vecs_as_b_and_x():
    B = _rhs_block(512, 2, 8)
    op, ksp = _port_ksp(2, (8, 8, 8), "jacobi")
    comm = op.comm
    ref = ksp.solve_many(B)
    vecs = [pt.Vec.from_global(comm, B[:, j], layout=op.layout)
            for j in range(2)]
    res = ksp.solve_many(vecs)
    assert res.iterations == ref.iterations
    np.testing.assert_array_equal(res.X, ref.X)
    xs = [op.get_vecs()[0] for _ in range(2)]
    res2 = ksp.solve_many(vecs, xs)
    assert res2.X is xs and res2.iterations == ref.iterations
    for j in range(2):
        np.testing.assert_array_equal(xs[j].to_numpy(), ref.X[:, j])
        np.testing.assert_array_equal(vecs[j].to_numpy(), B[:, j])
    X = np.full((512, 2), 7.0)
    assert ksp.solve_many(B, X).X is X      # written in place, zero guess
    np.testing.assert_array_equal(X, ref.X)


def test_input_validation():
    op, ksp = _port_ksp(1, (4, 5, 5), "jacobi")
    with pytest.raises(ValueError, match="nrhs"):
        ksp.solve_many(np.zeros(100))
    with pytest.raises(ValueError, match="nrhs=0"):
        ksp.solve_many(np.zeros((100, 0)))
    with pytest.raises(ValueError, match="X shape"):
        ksp.solve_many(np.zeros((100, 2)), np.zeros((100, 3)))
    with pytest.raises(ValueError, match="one length"):
        ksp.solve_many([op.get_vecs()[0], pt.Vec(op.comm, 7)])
    with pytest.raises(RuntimeError):
        pt.KSP().create(op.comm).solve_many(np.zeros((100, 1)))


def test_batched_result_views():
    B = _rhs_block(512, 2, 3)
    _, ksp = _port_ksp(1, (8, 8, 8), "jacobi", max_it=4)
    res = ksp.solve_many(B)
    assert res.reason_names == ["DIVERGED_MAX_IT"] * 2 and not res.converged
    per = res.per_rhs()
    assert [p.iterations for p in per] == res.iterations == [4, 4]
    assert per[1].residual_norm == res.residual_norms[1]
    assert "NOT converged" in repr(res)
    assert repr(pt.BatchedSolveResult()) == "BatchedSolveResult(empty)"


def test_fp32_batched_solve_agrees_with_sequential():
    """fp32 (the card's type): the batched column reductions are the
    single-RHS ``pdot`` of each column, so every column follows its
    sequential solve."""
    grid = (16, 16, 16)
    B = _rhs_block(4096, 3, 32).astype(np.float32)
    op, ksp = _port_ksp(1, grid, "jacobi", rtol=1e-5, dtype=torch.float32)
    res = ksp.solve_many(B)
    assert res.X.dtype == np.float32 and res.converged
    for j, (sres, xj) in enumerate(_sequential(ksp, op, B)):
        assert sres.iterations == res.iterations[j]
        np.testing.assert_allclose(res.X[:, j], xj, rtol=1e-5, atol=1e-6)
