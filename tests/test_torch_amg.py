"""PC gamg (alias amg) of the PyTorch port against the JAX package: the
smoothed-aggregation hierarchy (``sa_setup``), one V-cycle, and every gamg
solve of the JAX tests (``tests/test_ksp.py``'s TestGAMG and its flexible
gcr/fcg cases, ``tests/test_batched.py``'s sequential fallback,
``tests/test_complex.py``'s Hermitian cases), on 1/2/4/8 shards.

Both packages build the hierarchy from the same numpy operator, so the level
sizes and CSR patterns are equal and the values agree to 1e-14 relative. The
port restricts by a stored ``R = P^H`` where JAX scatter-adds, so one cycle
agrees to 1e-13 (the sums run in another order), and a solve takes JAX's
iterations and reason, with its iterate within the case's tolerance. The
JAX references are made once a module (``scope="module"``).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.solvers import amg as jamg  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import amg  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    configure_pc, from_host_csr)

C128 = torch.complex128


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def poisson1d(n):
    return sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (n, n), format="csr")


def poisson2d(nx):
    eye = sp.eye(nx)
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], (nx, nx))
    return (sp.kron(eye, T) + sp.kron(T, eye)).tocsr()


def convdiff2d(nx, beta=0.3):
    eye = sp.eye(nx)
    T = sp.diags([-1.0 - beta, 2.0, -1.0 + beta], [-1, 0, 1], (nx, nx))
    return (sp.kron(eye, T) + sp.kron(poisson1d(nx), eye)).tocsr()


def hermitian_poisson2d(n, theta=0.3):
    """The gauge-phased 2D Laplacian of ``tests/test_complex.py``: Hermitian
    positive definite with complex off-diagonals."""
    Pm = poisson2d(n)
    ph = np.exp(1j * theta)
    U = sp.triu(Pm, 1)
    return (sp.diags(Pm.diagonal()) + ph * U + np.conj(ph) * U.conj().T
            ).tocsr()


def manufactured(A, seed=0):
    x = np.random.default_rng(seed).random(A.shape[0])
    return x, np.asarray(A @ x)


def cvec(n, seed=11):
    rng = np.random.default_rng(seed)
    return rng.random(n) + 1j * rng.random(n)


def _solve(pkg, comm, A, b, ksp_type, pc_type, rtol, dtype, max_it=5000,
           **attrs):
    M = pkg.Mat.from_scipy(comm, A, dtype=dtype)
    ksp = pkg.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=rtol, max_it=max_it)
    for k, v in attrs.items():
        setattr(ksp.get_pc(), k, v)
    x, bv = M.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return x.to_numpy(), res, ksp


def solve_jax(ndev, A, b, ksp_type, pc_type="gamg", rtol=1e-9,
              dtype=np.float64, **kw):
    x, res, ksp = _solve(tps, tps.DeviceComm(n_devices=ndev), A, b,
                         ksp_type, pc_type, rtol, dtype, **kw)
    return x, res.iterations, int(res.reason), ksp.get_pc().program_key()


def solve_port(ndev, A, b, ksp_type, pc_type="gamg", rtol=1e-9,
               dtype=torch.float64, **kw):
    return _solve(pt, pt.DeviceComm(ndev, device="cpu"), A, b, ksp_type,
                  pc_type, rtol, dtype, **kw)


# ---- the hierarchy ----------------------------------------------------------

OPERATORS = {
    "poisson2d_24": lambda: poisson2d(24),
    "convdiff2d_16": lambda: convdiff2d(16),
    "poisson1d_300": lambda: poisson1d(300),
    "hermitian_12": lambda: hermitian_poisson2d(12),
}


@pytest.mark.parametrize("threshold,coarse", [(0.0, 64), (0.02, 32),
                                              (0.3, 16)])
@pytest.mark.parametrize("name", sorted(OPERATORS))
def test_sa_setup_matches_jax(name, threshold, coarse):
    A = OPERATORS[name]()
    jlv, jAc = jamg.sa_setup(A, threshold, 10, coarse)
    lv, Ac = amg.sa_setup(A, threshold, 10, coarse)
    assert [L.shape for L, _ in lv] == [L.shape for L, _ in jlv]
    pairs = [m for (L, Pl), (jL, jP) in zip(lv, jlv)
             for m in ((L, jL), (Pl, jP))] + [(Ac, jAc)]
    for M, J in pairs:
        M, J = M.tocsr(), J.tocsr()
        M.sort_indices()
        J.sort_indices()
        np.testing.assert_array_equal(M.indptr, J.indptr)
        np.testing.assert_array_equal(M.indices, J.indices)
        scale = max(np.abs(J.data).max(), 1e-300)
        assert np.abs(M.data - J.data).max() <= 1e-14 * scale


def test_aggregate_matches_jax_python_passes():
    rng = np.random.default_rng(0)
    for n, density in ((60, 0.1), (200, 0.03), (500, 0.01)):
        A = sp.random(n, n, density=density, random_state=rng, format="csr")
        S = ((A + A.T) != 0).astype(np.float64).tocsr()
        agg, nagg = amg._aggregate(S)
        jagg, jnagg = jamg._aggregate_py(S.indptr, S.indices, n)
        assert nagg == jnagg
        np.testing.assert_array_equal(agg, jagg)


def test_galerkin_levels_stay_hermitian():
    """Every Galerkin level of a Hermitian fine operator is Hermitian (the
    adjoint product ``P^H A P``; JAX ``test_gamg_coarse_hermitian``)."""
    levels, Ac = amg.sa_setup(hermitian_poisson2d(10))
    for L, _ in levels:
        assert np.allclose((L - L.conj().T).toarray(), 0, atol=1e-12)
    assert np.allclose((Ac - Ac.conj().T).toarray(), 0, atol=1e-12)


def test_setup_breakdown_names_each_part():
    comm = pt.DeviceComm(2, device="cpu")
    pc = pt.PC(comm).set_type("gamg")
    pc.set_up(pt.Mat.from_scipy(comm, poisson2d(20)))
    assert set(pc.setup_breakdown) == {
        "strength_s", "aggregate_s", "prolongator_s", "galerkin_s",
        "upload_s", "coarse_inverse_s"}
    assert pc.setup_mode == "host"
    assert all(v >= 0 for v in pc.setup_breakdown.values())


# ---- one V-cycle ------------------------------------------------------------

def _jax_cycle(comm, pc, r):
    h = pc._amg
    app = h.local_apply(comm)
    nar = len(h.device_arrays())
    prog = jax.jit(comm.shard_map(lambda *a: app(a[:nar], a[nar]),
                                  h.in_specs() + (P(comm.axis),),
                                  P(comm.axis)))
    return np.asarray(prog(*h.device_arrays(), comm.put_rows(r)))


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("op,dtype", [("poisson2d_24", np.float64),
                                      ("convdiff2d_16", np.float64),
                                      ("hermitian_12", np.complex128)])
def test_vcycle_matches_jax(op, dtype, ndev):
    A = OPERATORS[op]()
    n = A.shape[0]
    rng = np.random.default_rng(ndev)
    r = rng.standard_normal(n)
    if dtype == np.complex128:
        r = r + 1j * rng.standard_normal(n)
    jcomm = tps.DeviceComm(n_devices=ndev)
    jpc = tps.PC(jcomm).set_type("gamg")
    jpc.set_up(tps.Mat.from_scipy(jcomm, A, dtype=dtype))
    want = _jax_cycle(jcomm, jpc, r)[:n]
    comm = pt.DeviceComm(ndev, device="cpu")
    pc = pt.PC(comm).set_type("gamg")
    pc.set_up(pt.Mat.from_scipy(comm, A, dtype=pt.parallel.mesh.torch_dtype(
        dtype)))
    assert pc.program_key() == jpc.program_key()
    rd = comm.put_rows(r).view(ndev, -1)
    got = pc.local_apply(comm, n)(rd).reshape(-1)
    got = got.numpy()[:n]
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    # the padding rows stay zero and a second cycle gives the same bits
    again = pc.local_apply(comm, n)(rd).reshape(-1).numpy()
    np.testing.assert_array_equal(again[:n], got)
    assert not again[n:].any()


def test_vcycle_bits_do_not_depend_on_the_shard_count():
    """The restriction by the stored ``R`` and the unpadded coarse solve do
    not depend on the shard count: one cycle gives the same bits on 1, 3
    and 4 shards."""
    A = poisson2d(23)
    n = A.shape[0]
    r = np.random.default_rng(5).standard_normal(n)
    outs = []
    for ndev in (1, 3, 4):
        comm = pt.DeviceComm(ndev, device="cpu")
        pc = pt.PC(comm).set_type("gamg")
        pc.set_up(pt.Mat.from_scipy(comm, A))
        z = pc.local_apply(comm, n)(comm.put_rows(r).view(ndev, -1))
        outs.append(z.reshape(-1).numpy()[:n])
    for z in outs[1:]:
        np.testing.assert_array_equal(z, outs[0])


def test_vcycle_has_no_scatter_and_no_psum():
    comm = pt.DeviceComm(4, device="cpu")
    pc = pt.PC(comm).set_type("gamg")
    n = 400
    pc.set_up(pt.Mat.from_scipy(comm, poisson2d(20)))
    before = dict(comm.collectives)
    pc.local_apply(comm, n)(torch.ones(4, comm.local_size(n),
                                       dtype=torch.float64))
    assert comm.collectives["psum"] == before["psum"]
    assert comm.collectives["all_gather"] > before["all_gather"]


# ---- solves against the JAX package -----------------------------------------

# (case, operator, ksp type, rtol, shard counts): tests/test_ksp.py's gamg
# cases and the flexible types with gamg
SOLVES = {
    "cg_gamg_poisson2d": (lambda: poisson2d(40), "cg", 1e-9, (1, 2, 4, 8)),
    "tiny_direct_coarse": (lambda: poisson1d(20), "cg", 1e-10, (1, 8)),
    "gcr_flexible": (lambda: poisson2d(32), "gcr", 1e-9, (2, 8)),
    "fcg_flexible": (lambda: poisson2d(32), "fcg", 1e-9, (4, 8)),
    "mesh_16": (lambda: poisson2d(16), "cg", 1e-8, (8,)),
    "mesh_32": (lambda: poisson2d(32), "cg", 1e-8, (8,)),
    "mesh_48": (lambda: poisson2d(48), "cg", 1e-8, (8,)),
}
SOLVE_CASES = [(c, nd) for c, spec in SOLVES.items() for nd in spec[3]]


@pytest.fixture(scope="module")
def jax_solves():
    out = {}
    for case, ndev in SOLVE_CASES:
        mk, kt, rtol, _ = SOLVES[case]
        A = mk()
        x_true, b = manufactured(A)
        out[case, ndev] = solve_jax(ndev, A, b, kt, rtol=rtol)
    return out


@pytest.mark.parametrize("case,ndev", SOLVE_CASES)
def test_solve_matches_jax(case, ndev, jax_solves):
    mk, kt, rtol, _ = SOLVES[case]
    A = mk()
    x_true, b = manufactured(A)
    jx, jits, jreason, jkey = jax_solves[case, ndev]
    x, res, ksp = solve_port(ndev, A, b, kt, rtol=rtol)
    assert jreason > 0
    assert (res.iterations, res.reason) == (jits, jreason)
    assert ksp.get_pc().program_key() == jkey
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)
    np.testing.assert_allclose(x, x_true, atol=1e-6)
    if case == "tiny_direct_coarse":
        assert res.iterations <= 3       # the hierarchy is one direct solve
    if case in ("gcr_flexible", "fcg_flexible"):
        assert res.iterations <= 25


def test_much_faster_than_jacobi(jax_solves):
    A = poisson2d(48)
    _, b = manufactured(A)
    _, res_j, _ = solve_port(8, A, b, "cg", "jacobi", rtol=1e-8)
    _, res_g, _ = solve_port(8, A, b, "cg", "gamg", rtol=1e-8)
    assert res_g.converged
    assert res_g.iterations < res_j.iterations // 3
    assert res_g.iterations == jax_solves["mesh_48", 8][1]


def test_mesh_independent_iterations(jax_solves):
    iters = [jax_solves[f"mesh_{nx}", 8][1] for nx in (16, 32, 48)]
    assert max(iters) <= min(iters) + 6


def test_amg_alias_and_options():
    A = poisson2d(24)
    x_true, b = manufactured(A)
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=8)),
                      (pt, pt.DeviceComm(8, device="cpu"))):
        opt = pkg.global_options()
        opt.set("pc_type", "amg")
        opt.set("pc_gamg_threshold", 0.02)
        opt.set("pc_gamg_coarse_eq_limit", 32)
        try:
            M = pkg.Mat.from_scipy(comm, A)
            ksp = pkg.KSP().create(comm)
            ksp.set_operators(M)
            ksp.set_type("cg")
            ksp.set_from_options()
            pc = ksp.get_pc()
            assert pc.get_type() == "amg"
            assert (pc.gamg_threshold, pc.gamg_coarse_size) == (0.02, 32)
            ksp.set_tolerances(rtol=1e-10)
            x, bv = M.get_vecs()
            bv.set_global(b)
            res = ksp.solve(bv, x)
            out.append((res.iterations, int(res.reason), x.to_numpy(),
                        pc.program_key()))
        finally:
            opt.clear()
    (jits, jreason, jx, jkey), (its, reason, x, key) = out
    assert (its, reason, key) == (jits, jreason, jkey) and reason > 0
    np.testing.assert_allclose(x, x_true, atol=1e-7)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)


def test_mg_levels_option_caps_the_hierarchy():
    A = poisson2d(32)
    comm = pt.DeviceComm(2, device="cpu")
    pt.global_options().set("pc_mg_levels", 2)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(pt.Mat.from_scipy(comm, A))
    ksp.get_pc().set_type("gamg")
    ksp.set_from_options()
    ksp.get_pc().set_up()
    assert ksp.get_pc()._amg.n_levels == 1
    jcomm = tps.DeviceComm(n_devices=2)
    jpc = tps.PC(jcomm).set_type("gamg")
    jpc.gamg_max_levels = 2
    jpc.set_up(tps.Mat.from_scipy(jcomm, A))
    assert ksp.get_pc().program_key() == jpc.program_key()


def test_matrix_free_rejected():
    op = pt.StencilPoisson3D(pt.DeviceComm(2, device="cpu"), 8)
    pc = pt.PC().set_type("gamg")
    with pytest.raises(ValueError, match="assembled"):
        pc.set_up(op)


def test_coarsening_stall_names_the_flags():
    """A coarsest level past the dense cap raises JAX's message."""
    A = poisson1d(20000)
    comm = pt.DeviceComm(1, device="cpu")
    pc = pt.PC(comm).set_type("gamg")
    pc.gamg_max_levels = 1            # no coarsening: n = 20000 is coarsest
    with pytest.raises(ValueError, match="coarsening stalled"):
        pc.set_up(pt.Mat.from_scipy(comm, A))


def test_setup_reuse_cached():
    comm = pt.DeviceComm(8, device="cpu")
    M = pt.Mat.from_scipy(comm, poisson2d(24))
    pc = pt.PC().set_type("gamg")
    pc.set_up(M)
    h1 = pc._amg
    pc.set_up(M)            # unchanged operator and tunables: no rebuild
    assert pc._amg is h1
    pc.gamg_threshold = 0.1
    pc.set_up(M)            # a tunable changed: rebuilt
    assert pc._amg is not h1


def test_no_transpose_and_no_batched_apply():
    comm = pt.DeviceComm(2, device="cpu")
    pc = pt.PC(comm).set_type("gamg")
    pc.set_up(pt.Mat.from_scipy(comm, poisson2d(12)))
    assert pc.local_apply_transpose(comm, 144) is None
    assert pc.local_apply_many(comm, 144) is None
    with pytest.raises(ValueError, match="PCApplyTranspose"):
        solve_port(2, poisson2d(12), np.ones(144), "bicg")


def test_unbatched_pc_falls_back_sequential():
    """PC gamg has no batched apply: ``solve_many`` solves the columns one
    by one (JAX ``tests/test_batched.py:277``), each column as its single
    solve and as JAX's."""
    A = poisson2d(12)
    B = np.random.default_rng(6).random((A.shape[0], 2))
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=8)),
                      (pt, pt.DeviceComm(8, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.get_pc().set_type("gamg")
        ksp.set_tolerances(rtol=1e-8, atol=0.0)
        out.append(ksp.solve_many(B))
    jres, res = out
    assert res.converged
    assert list(res.iterations) == list(jres.iterations)
    assert list(res.reasons) == [int(r) for r in jres.reasons]
    for j in range(2):
        rres = (np.linalg.norm(B[:, j] - A @ res.X[:, j])
                / np.linalg.norm(B[:, j]))
        assert rres <= 1e-8 * 1.05
    np.testing.assert_allclose(res.X, np.asarray(jres.X), rtol=0, atol=1e-10)


# ---- complex ----------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 4, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_gamg_hermitian(seed, ndev):
    """CG + gamg on the gauge-phased complex Laplacian (JAX
    ``test_gamg_hermitian``): JAX's iterations and reason, the iterate
    within 1e-7 of the truth and 1e-10 of JAX's."""
    A = hermitian_poisson2d(12, theta=0.3 + 0.1 * seed)
    x_true = cvec(A.shape[0])
    b = A @ x_true
    jx, jits, jreason, jkey = solve_jax(ndev, A, b, "cg", rtol=1e-10,
                                        dtype=np.complex128)
    x, res, ksp = solve_port(ndev, A, b, "cg", rtol=1e-10, dtype=C128)
    assert (res.iterations, res.reason) == (jits, jreason) and jreason > 0
    assert ksp.get_pc().program_key() == jkey
    np.testing.assert_allclose(x, x_true, atol=1e-7)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10)


# ---- carry ------------------------------------------------------------------

@pytest.mark.parametrize("tunables", [{}, {"gamg_threshold": 0.05,
                                           "gamg_coarse_size": 32},
                                      {"gamg_max_levels": 2}])
def test_configure_pc_carries_a_jax_gamg(tunables):
    A = poisson2d(20)
    jcomm = tps.DeviceComm(n_devices=2)
    jpc = tps.PC(jcomm).set_type("gamg")
    for k, v in tunables.items():
        setattr(jpc, k, v)
    jpc.set_up(tps.Mat.from_scipy(jcomm, A))
    pc = configure_pc(pt.PC(pt.DeviceComm(2, device="cpu")),
                      jpc.program_key(), **tunables)
    m, _, _ = from_host_csr(pc.comm, A.shape, (A.indptr, A.indices, A.data),
                            np.ones(A.shape[0]))
    pc.set_up(m)
    assert pc.program_key() == jpc.program_key()
    for k, v in tunables.items():
        assert getattr(pc, k) == v
    with pytest.raises(ValueError, match="gamg"):
        configure_pc(pt.PC(), ("gamg",))
