"""The PyTorch port's Vec BLAS-1 surface and null spaces against the JAX
package.

The same seeded numpy vectors go through both packages' ``Vec`` on 1/2/4/8
shards (37 entries, so every shard count pads), fp64: reductions within
1e-13, elementwise results exact or within 1e-15. The null-space cases are
the JAX package's own (``tests/test_vec_mat.py:210-330``): the pure-Neumann
1D Laplacian with a compatible and an incompatible right-hand side, an
explicit null vector, an empty null space; iterations and reasons equal,
iterates within 1e-10.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402

SHARDS = [1, 2, 4, 8]
N = 37
RED_TOL = 1e-13
X_TOL = 1e-10


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _vecs(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(N)
    b = rng.standard_normal(N)
    b[[3, 11]] = 0.0                  # exact zeros for divide / reciprocal
    return a, b


def _pair(ndev, arr):
    jc = tps.DeviceComm(n_devices=ndev)
    pc = pt.DeviceComm(ndev, device="cpu")
    return (tps.Vec.from_global(jc, arr, dtype=np.float64),
            pt.Vec.from_global(pc, arr, dtype=torch.float64))


# each: (name, fn(vec_a, vec_b) -> value or the changed vec_a)
REDUCTIONS = {
    "norm2": lambda u, v: u.norm(),
    "norm1": lambda u, v: u.norm("1"),
    "norminf": lambda u, v: u.norm("inf"),
    "dot": lambda u, v: u.dot(v),
    "sum": lambda u, v: u.sum(),
    "mean": lambda u, v: u.mean(),
    "min": lambda u, v: u.min(),
    "max": lambda u, v: u.max(),
}

UPDATES = {
    "scale": lambda u, v: u.scale(-2.5),
    "shift": lambda u, v: u.shift(1.25),
    "axpy": lambda u, v: u.axpy(0.5, v),
    "aypx": lambda u, v: u.aypx(0.5, v),
    "axpby": lambda u, v: u.axpby(0.75, -1.5, v),
    "waxpy": lambda u, v: u.waxpy(2.0, v, u.copy()),
    "pointwise_mult": lambda u, v: u.pointwise_mult(u.copy(), v),
    "pointwise_divide": lambda u, v: u.pointwise_divide(u.copy(), v),
    "reciprocal": lambda u, v: v.reciprocal(),
    "set": lambda u, v: u.set(3.5),
    "set_value": lambda u, v: u.set_value(30, -7.0),
}


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("op", sorted(REDUCTIONS))
def test_reductions_match_jax(op, ndev):
    a, b = _vecs()
    (ja, pa), (jb, pb) = _pair(ndev, a), _pair(ndev, b)
    want, got = REDUCTIONS[op](ja, jb), REDUCTIONS[op](pa, pb)
    if op in ("min", "max"):       # (index, value), padding ignored
        assert got[0] == want[0]
        assert got[1] == want[1]
        return
    assert abs(got - want) <= RED_TOL * max(abs(want), 1.0)


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("op", sorted(UPDATES))
def test_updates_match_jax_and_keep_padding_zero(op, ndev):
    a, b = _vecs(1)
    (ja, pa), (jb, pb) = _pair(ndev, a), _pair(ndev, b)
    jv, pv = UPDATES[op](ja, jb), UPDATES[op](pa, pb)
    np.testing.assert_allclose(pv.to_numpy(), jv.to_numpy(), rtol=1e-15,
                               atol=1e-15)
    # the padding stays zero, so the reductions stay exact
    assert torch.all(pv.data[N:] == 0)


@pytest.mark.parametrize("ndev", [1, 4])
def test_normalize_and_local_blocks(ndev):
    a, _ = _vecs(2)
    ja, pa = _pair(ndev, a)
    assert abs(pa.normalize() - ja.normalize()) <= RED_TOL * np.linalg.norm(a)
    np.testing.assert_allclose(pa.to_numpy(), ja.to_numpy(), rtol=1e-15)
    for rank in range(ndev):
        np.testing.assert_array_equal(pa.local_array(rank),
                                      ja.local_array(rank))
        block = np.full(len(ja.local_array(rank)), float(rank + 1))
        ja.set_array(block, rank=rank)
        pa.set_array(block, rank=rank)
    np.testing.assert_array_equal(pa.to_numpy(), ja.to_numpy())
    np.testing.assert_array_equal(pa.array, ja.array)
    with pytest.raises(ValueError, match="local block"):
        pa.set_array(np.ones(N + 1), rank=0)


def test_bf16_reductions_accumulate_in_fp32():
    a, b = _vecs(3)
    comm = pt.DeviceComm(4, device="cpu")
    u = pt.Vec.from_global(comm, a, dtype=torch.bfloat16)
    v = pt.Vec.from_global(comm, b, dtype=torch.bfloat16)
    ua, va = u.to_numpy().astype(np.float64), v.to_numpy().astype(np.float64)
    assert abs(u.dot(v) - ua @ va) <= 1e-5 * np.abs(ua * va).sum()
    assert abs(u.sum() - ua.sum()) <= 1e-5 * np.abs(ua).sum()
    assert u.min() == (int(np.argmin(ua)), float(ua.min()))


# ---- NullSpace ------------------------------------------------------------------

def neumann1d(n):
    main = 2 * np.ones(n)
    main[0] = main[-1] = 1.0
    return sp.diags([-np.ones(n - 1), main, -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


def test_basis_remove_and_test_like_jax():
    rng = np.random.default_rng(4)
    vecs = [rng.standard_normal(20), rng.standard_normal(20)]
    jns = tps.NullSpace(constant=True, vectors=vecs)
    pns = pt.NullSpace(constant=True, vectors=vecs)
    assert pns.dim == jns.dim == 3 and pns.has_constant()
    np.testing.assert_allclose(pns.basis_host(20), jns.basis_host(20),
                               rtol=0, atol=1e-15)
    v = rng.standard_normal(20)
    np.testing.assert_allclose(pns.remove(v), jns.remove(v), atol=1e-15)
    A = neumann1d(20)
    comm = pt.DeviceComm(2, device="cpu")
    ns = pt.NullSpace(constant=True)
    assert ns.test(pt.Mat.from_scipy(comm, A))
    assert not ns.test(pt.Mat.from_scipy(comm, A + sp.eye(20)))
    with pytest.raises(ValueError, match="linearly dependent"):
        pt.NullSpace(vectors=[np.ones(20), 2 * np.ones(20)]).basis_host(20)
    with pytest.raises(ValueError, match="empty null space"):
        pt.NullSpace().basis_host(20)
    with pytest.raises(ValueError, match="length"):
        pt.NullSpace(vectors=[np.ones(19)]).basis_host(20)


def test_device_basis_is_padded_and_cached():
    comm = pt.DeviceComm(4, device="cpu")
    ns = pt.NullSpace(constant=True)
    Q = ns.device_array(comm, 10, torch.float64)
    assert tuple(Q.shape) == (1, 12) and torch.all(Q[:, 10:] == 0)
    np.testing.assert_allclose(Q[0, :10].numpy(),
                               ns.basis_host(10)[0], rtol=1e-15)
    np.testing.assert_allclose(np.abs(Q[0, :10].numpy()),
                               np.full(10, 10 ** -0.5), rtol=1e-15)
    assert ns.device_array(comm, 10, torch.float64) is Q
    assert ns.device_array(comm, 10, torch.float32) is not Q


def _solve_both(A, b, ndev, ns_kw, rtol=1e-10, max_it=5000, pc="jacobi",
                ksp_type="cg"):
    out = []
    for pkg, comm, dt in ((tps, tps.DeviceComm(n_devices=ndev), np.float64),
                          (pt, pt.DeviceComm(ndev, device="cpu"),
                           torch.float64)):
        M = pkg.Mat.from_scipy(comm, A, dtype=dt)
        if ns_kw is not None:
            M.set_nullspace(pkg.NullSpace(**ns_kw))
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type(ksp_type)
        ksp.get_pc().set_type(pc)
        ksp.set_tolerances(rtol=rtol, max_it=max_it)
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((res, x.to_numpy()))
    (jres, jx), (res, x) = out
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason))
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=X_TOL * max(np.abs(jx).max(), 1.0))
    return res, x


@pytest.mark.parametrize("ndev", SHARDS)
def test_cg_singular_neumann_like_jax(ndev):
    n = 64
    A = neumann1d(n)
    b = pt.NullSpace(constant=True).remove(
        np.random.default_rng(1).random(n))
    res, x = _solve_both(A, b, ndev, {"constant": True}, rtol=1e-6)
    assert res.converged
    assert np.linalg.norm(A @ x - b) <= 1e-5 * np.linalg.norm(b)
    assert abs(x.mean()) < 1e-10


@pytest.mark.parametrize("ndev", SHARDS)
def test_incompatible_rhs_like_jax(ndev):
    n = 48
    A = neumann1d(n)
    b_raw = np.random.default_rng(2).random(n)
    res, x = _solve_both(A, b_raw, ndev, {"constant": True}, rtol=1e-6,
                         pc="none")
    b_proj = pt.NullSpace(constant=True).remove(b_raw)
    assert res.converged
    assert np.linalg.norm(A @ x - b_proj) <= 1e-5 * np.linalg.norm(b_proj)


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_vector_nullspace_like_jax(ndev):
    n = 40
    d = np.arange(1.0, n + 1)
    d[7] = 0.0
    A = sp.diags(d).tocsr()
    null = np.zeros(n)
    null[7] = 1.0
    b = np.random.default_rng(3).random(n)
    b[7] = 0.0
    res, x = _solve_both(A, b, ndev, {"vectors": [null]}, rtol=1e-12,
                         pc="none")
    assert res.converged and abs(x[7]) < 1e-10


@pytest.mark.parametrize("ndev", [1, 4])
def test_empty_nullspace_is_ignored_like_jax(ndev):
    A = sp.eye(12, format="csr")
    res, x = _solve_both(A, np.ones(12), ndev, {}, pc="none")
    assert res.converged
    np.testing.assert_allclose(x, np.ones(12), rtol=1e-10)


@pytest.mark.parametrize("ksp_type,pc", [("gmres", "jacobi"),
                                         ("bcgs", "jacobi"),
                                         ("fgmres", "none")])
def test_projection_in_other_krylov_types_like_jax(ksp_type, pc):
    """The 2D pure-Neumann Laplacian at 10^2. The 1D one converges in
    finitely many steps, where the counts are a matter of rounding; at 12^2
    BiCGStab amplifies rounding so far that the JAX package's own iterates
    differ by 1.6e-8 between 1 and 4 devices."""
    N1 = neumann1d(10)
    A = (sp.kron(sp.eye(10), N1) + sp.kron(N1, sp.eye(10))).tocsr()
    b = pt.NullSpace(constant=True).remove(
        np.random.default_rng(5).random(A.shape[0]))
    res, x = _solve_both(A, b, 4, {"constant": True}, rtol=1e-6, pc=pc,
                         ksp_type=ksp_type)
    assert res.converged and abs(x.mean()) < 1e-10


def test_nullspace_leaves_the_stencil_fast_path():
    from mpi_petsc4py_example_tpu_torch.solvers.krylov import (
        stencil_cg_eligible)
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 4, dtype=torch.float64)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    assert stencil_cg_eligible("cg", ksp.get_pc(), op)
    basis = pt.NullSpace(constant=True).device_array(comm, 64,
                                                     torch.float64)
    assert not stencil_cg_eligible("cg", ksp.get_pc(), op, nullspace=basis)
