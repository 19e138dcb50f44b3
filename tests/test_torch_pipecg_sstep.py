"""Pipelined CG (``pipecg``) and s-step CG (``sstep``) of ROADMAP.md Queue A
item 5.2 against the JAX package, unguarded.

The operator families and shard counts of ``tests/test_pipecg.py`` and
``tests/test_sstep.py`` (a random SPD ELL matrix, the DIA tridiagonal
family, the 7-point stencil; 1/2/4/8 shards): iterations and reasons equal
to the JAX package's, iterates within 1e-10 relative, fp64. Also: sstep at
s = 1, 2, 4 and 8; the batched forms through ``KSP.solve_many`` (the
pipelined and s-step programs batch on the general route in both packages,
with the PC on the operator and on a distinct matrix); bf16 storage on the
16^3 stencil (reasons equal and iterations within 10%, as
``tests/test_torch_mixed_precision.py`` holds bf16 CG); and the reductions
each plan issues, counted from ``comm.collectives``: one ``psum`` an
iteration for pipecg, one a block for sstep, after the start-up's two
(``||b||``, ``||r0||``) and before the final residual's one.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers import krylov as jax_krylov  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    tridiag_family)
from mpi_petsc4py_example_tpu_torch.solvers import cg_plans  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import krylov  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    from_host_csr, from_numpy_state)

CR = pt.ConvergedReason
X_TOL = 1e-10
RTOL = 1e-10
PLANS = ["pipecg", "sstep"]


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _ell_matrix(n=512, seed=11):
    """The random SPD matrix of ``tests/test_pipecg.py``: the ELL route."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    A = A + A.T
    return (A + sp.eye(n, format="csr") * n).tocsr()


def _stencil_grid(ndev):
    return (16, 16, ((16 + ndev - 1) // ndev) * ndev)


def _operators(kind, ndev):
    """``(jax_op, port_op, A)`` for one operator family."""
    jcomm = tps.DeviceComm(n_devices=ndev)
    comm = pt.DeviceComm(ndev, device="cpu")
    if kind == "stencil":
        grid = _stencil_grid(ndev)
        return (JaxStencil(jcomm, *grid, dtype=jnp.float64),
                pt.StencilPoisson3D(comm, *grid, dtype=torch.float64),
                pt.poisson3d_csr(*grid))
    A = _ell_matrix() if kind == "ell" else tridiag_family(256)
    M = tps.Mat.from_scipy(jcomm, A)
    m = from_host_csr(comm, M.shape, M.host_csr,
                      np.zeros(A.shape[0]))[0]
    assert m.spmv_route(comm).startswith(kind)
    return M, m, A


def _ksp(pkg, op, ksp_type, pc="jacobi", rtol=RTOL, max_it=5000, pmat=None,
         **attrs):
    ksp = pkg.KSP().create(op.comm)
    ksp.set_operators(op, pmat)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=max_it)
    for k, v in attrs.items():
        setattr(ksp, k, v)
    return ksp


def _solve(pkg, op, b, ksp_type, **kw):
    ksp = _ksp(pkg, op, ksp_type, **kw)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return res, x.to_numpy()


def _counted(op, fn):
    """``fn()`` and the collective calls it made on ``op``'s comm."""
    before = dict(op.comm.collectives)
    out = fn()
    return out, {k: v - before[k] for k, v in op.comm.collectives.items()}


def _assert_same(jres, jx, res, x, tol=X_TOL):
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason)), (res, jres)
    assert np.linalg.norm(x - jx) <= tol * np.linalg.norm(jx)


def _rhs(A, seed=3):
    return np.asarray(A @ np.random.default_rng(seed).random(A.shape[0]))


# ---- single right-hand side: operator families x shard counts ----------------

# sstep on the DIA tridiagonal family (kappa ~ n^2) is held by
# test_sstep_on_the_tridiagonal_within_jax_spread
CASES = [(t, kind) for t in PLANS for kind in ("ell", "dia", "stencil")
         if (t, kind) != ("sstep", "dia")]


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("ksp_type,kind", CASES)
def test_matches_jax(ksp_type, kind, ndev):
    jop, op, A = _operators(kind, ndev)
    b = _rhs(A)
    jres, jx = _solve(tps, jop, b, ksp_type)
    (res, x), calls = _counted(op, lambda: _solve(pt, op, b, ksp_type))
    assert res.converged
    _assert_same(jres, jx, res, x)
    # start-up: ||b|| and ||r0||; the loop: one an iteration (pipecg) or a
    # block (sstep); the final residual: one
    if ksp_type == "pipecg":
        assert calls["psum"] == 3 + res.iterations
        assert res.host_syncs == 2 + res.iterations
    else:
        blocks = calls["psum"] - 3
        assert -(-res.iterations // 4) <= blocks <= res.iterations
        assert res.host_syncs == 2 + blocks


def test_sstep_on_the_tridiagonal_within_jax_spread():
    """The DIA tridiagonal family (``tridiag_family(256)``, kappa ~ n^2)
    with s = 4 at rtol 1e-10: the monomial basis' conditioning (~kappa^2)
    leaves the JAX package's counts far apart across device counts (378,
    331, 370 and 304 iterations on 1/2/4/8 devices). The port's, on 1 and
    4 shards, lie within them, converged, its true residual at rtol."""
    A = tridiag_family(256)
    b = _rhs(A)
    jits = []
    for nd in (1, 2, 4, 8):
        jop, op, _ = _operators("dia", nd)
        jres, _ = _solve(tps, jop, b, "sstep")
        assert jres.reason == CR.CONVERGED_RTOL
        jits.append(jres.iterations)
        if nd in (1, 4):
            res, x = _solve(pt, op, b, "sstep")
            assert res.reason == CR.CONVERGED_RTOL
            assert np.linalg.norm(b - A @ x) <= 1.01 * RTOL * \
                np.linalg.norm(b)
            its = res.iterations
    assert max(jits) - min(jits) > 50
    assert min(jits) <= its <= max(jits), (jits, its)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_sstep_block_sizes_match_jax(s):
    """``-ksp_sstep_s``: one Gram reduction per block of ``s``. At s = 8
    the monomial basis' conditioning (~kappa^(s/2)) leaves the JAX
    package's own iterates 1e-9 apart across device counts: the port is
    held within ten times the spread of its 1- and 2-device iterates."""
    jop, op, A = _operators("ell", 2)
    b = _rhs(A, s)
    pt.init(["prog", "-ksp_sstep_s", str(s)])
    ksp = _ksp(pt, op, "sstep")
    ksp.set_from_options()
    assert ksp.sstep_s == s
    x, bv = op.get_vecs()
    bv.set_global(b)
    res, calls = _counted(op, lambda: ksp.solve(bv, x))
    jres, jx = _solve(tps, jop, b, "sstep", sstep_s=s)
    tol = X_TOL
    if s == 8:
        j1, _, _ = _operators("ell", 1)
        _, jx1 = _solve(tps, j1, b, "sstep", sstep_s=s)
        tol = max(X_TOL, 10 * np.linalg.norm(jx1 - jx) / np.linalg.norm(jx))
    _assert_same(jres, jx, res, x.to_numpy(), tol=tol)
    blocks = calls["psum"] - 3
    assert -(-res.iterations // s) <= blocks and res.host_syncs == 2 + blocks
    if s == 1:
        assert blocks == res.iterations


def test_pipecg_lags_classic_cg_by_about_one():
    """Iterates of classic CG within 1e-10; the pipelined norm lags one
    iteration (JAX ``cg_plans.py:631-634``)."""
    _, op, A = _operators("stencil", 2)
    b = _rhs(A)
    cres, cx = _solve(pt, op, b, "cg")
    res, x = _solve(pt, op, b, "pipecg")
    assert abs(res.iterations - cres.iterations) <= 2
    assert np.linalg.norm(x - cx) <= 1e-10 * np.linalg.norm(cx)


def test_stencil_fast_path_engaged(monkeypatch):
    """A stencil pipecg solve with PC none/jacobi on its operator runs the
    grid-shaped fast path (JAX ``krylov.py:2289-2298``); a distinct PC
    matrix or PC bjacobi on a Mat does not."""
    calls = []
    orig = krylov.pipecg_stencil_kernel

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(krylov, "pipecg_stencil_kernel", spy)
    jop, op, A = _operators("stencil", 4)
    b = _rhs(A)
    for pc in ("none", "jacobi"):
        calls.clear()
        jres, jx = _solve(tps, jop, b, "pipecg", pc=pc)
        res, x = _solve(pt, op, b, "pipecg", pc=pc)
        assert calls == [1]
        _assert_same(jres, jx, res, x)
    calls.clear()
    pmat = pt.StencilPoisson3D(op.comm, *_stencil_grid(4))
    res, _ = _solve(pt, op, b, "pipecg", pmat=pmat)
    assert calls == [] and res.converged
    assert not krylov.stencil_pipe_eligible("pipecg", _ksp(
        pt, op, "pipecg", pmat=pmat).get_pc(), op)


@pytest.mark.parametrize("ksp_type", PLANS)
def test_pc_none_and_bjacobi_like_jax(ksp_type):
    jop, op, A = _operators("ell", 4)
    b = _rhs(A, 5)
    for pc in ("none", "bjacobi"):
        jres, jx = _solve(tps, jop, b, ksp_type, pc=pc)
        res, x = _solve(pt, op, b, ksp_type, pc=pc)
        assert res.converged
        _assert_same(jres, jx, res, x)


@pytest.mark.parametrize("ksp_type", PLANS)
def test_monitor_history_like_jax(ksp_type):
    """One entry per iteration, the initial norm first: pipecg's at its
    per-iteration reads, sstep's from the coefficient recurrences of each
    block, as the JAX package records them."""
    jop, op, A = _operators("ell", 2)
    b = _rhs(A, 6)
    hist = []
    for pkg, o in ((tps, jop), (pt, op)):
        ksp = _ksp(pkg, o, ksp_type, rtol=1e-8)
        ksp.set_convergence_history()
        x, bv = o.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        hist.append(np.asarray(ksp.get_convergence_history()))
    assert len(hist[1]) == len(hist[0]) == res.iterations + 1
    # entries far below the initial norm (the s-step coordinate norm is a
    # difference of quadratics) compare to the initial norm
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-8,
                               atol=1e-11 * hist[0][0])


@pytest.mark.parametrize("ksp_type", PLANS)
def test_max_it_and_dtol_like_jax(ksp_type):
    jop, op, A = _operators("dia", 2)
    b = _rhs(A, 8)
    jres, jx = _solve(tps, jop, b, ksp_type, max_it=9)
    res, x = _solve(pt, op, b, ksp_type, max_it=9)
    assert res.reason == CR.DIVERGED_MAX_IT and res.iterations == 9
    _assert_same(jres, jx, res, x)


# ---- batched: KSP.solve_many --------------------------------------------------

@pytest.mark.parametrize("route", ["pc_on_operator", "distinct_pmat"])
@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("ksp_type", PLANS)
def test_solve_many_matches_jax(ksp_type, ndev, route, monkeypatch):
    """k = 3 columns in lockstep: per column iterations and reasons equal
    to the JAX ``solve_many`` and iterates within 1e-10; one reduction per
    lockstep iteration (pipecg) or block (sstep) for all the columns; each
    column's iterations equal to its own single solve."""
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    monkeypatch.setattr(jax_krylov, "_PROGRAM_CACHE_MANY", {})
    grid = (8, 12, 16)
    n = int(np.prod(grid))
    B = np.random.default_rng(ndev).standard_normal((n, 3))
    general = route == "distinct_pmat"
    out = []
    for pkg, comm, Op, dt in (
            (tps, tps.DeviceComm(n_devices=ndev), JaxStencil, jnp.float64),
            (pt, pt.DeviceComm(ndev, device="cpu"), pt.StencilPoisson3D,
             torch.float64)):
        op = Op(comm, *grid, dtype=dt)
        ksp = _ksp(pkg, op, ksp_type, rtol=1e-8,
                   pmat=Op(comm, *grid, dtype=dt) if general else None)
        res, calls = _counted(op, lambda: ksp.solve_many(B)) \
            if pkg is pt else (ksp.solve_many(B), None)
        out.append(res)
    jres, res = out
    assert res.iterations == [int(i) for i in jres.iterations]
    assert res.reasons == [int(r) for r in jres.reasons] == \
        [CR.CONVERGED_RTOL] * 3
    for j in range(3):
        ref = np.asarray(jres.X)[:, j]
        assert np.linalg.norm(res.X[:, j] - ref) <= 1e-10 * \
            np.linalg.norm(ref)
    if ksp_type == "pipecg":
        assert calls["psum"] == 3 + max(res.iterations)
        assert res.host_syncs == 2 + max(res.iterations)
    else:
        assert res.host_syncs == 2 + calls["psum"] - 3
    ksp2 = _ksp(pt, op, ksp_type, rtol=1e-8)
    for j in range(3):
        x, bv = op.get_vecs()
        bv.set_global(B[:, j])
        single = ksp2.solve(bv, x)
        assert single.iterations == res.iterations[j]
        assert np.linalg.norm(x.to_numpy() - res.X[:, j]) <= 1e-10 * \
            np.linalg.norm(res.X[:, j])


@pytest.mark.parametrize("ksp_type", PLANS)
def test_solve_many_launches_the_batched_stencil_product(ksp_type):
    """The batched plans apply the stencil with one ``stencil7_apply_many``
    pass per shard for all the columns (row 9 on the card)."""
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 8, dtype=torch.float64)
    ksp = _ksp(pt, op, ksp_type, rtol=1e-8)
    seen = []
    orig = op.local_spmv_many

    def spy(c):
        f = orig(c)

        def g(X):
            seen.append(X.shape[1])
            return f(X)
        return g

    op.local_spmv_many = spy
    res = ksp.solve_many(np.random.default_rng(0).random((512, 3)))
    assert all(r > 0 for r in res.reasons)
    assert seen and set(seen) == {3}


# ---- bf16 storage -------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("ksp_type", PLANS)
def test_bf16_matches_jax(ksp_type, ndev):
    """bf16 storage, fp32 reductions (the mixed plan) on the 16^3 stencil to
    the bf16 floor: reasons equal, iterations within 10% (the iterates
    round differently: ROADMAP.md Queue C, "why bf16 iterates cannot be
    bit-equal"), the iterate stays bf16. Unguarded bf16 pipecg drifts: in
    both packages this right-hand side stagnates to max_it on one device
    and converges on four (the drift bound is the guard, Queue A item 6;
    ROADMAP.md Queue C)."""
    nx, rtol = 16, 4 * 2.0 ** -7
    b = np.random.default_rng(ndev).standard_normal(nx ** 3)
    jcomm = tps.DeviceComm(n_devices=ndev)
    jop = JaxStencil(jcomm, nx, nx, nx, dtype=jnp.bfloat16)
    jksp = _ksp(tps, jop, ksp_type, rtol=rtol, max_it=300)
    jx, jb = jop.get_vecs()
    jb.set_global(b.astype(jnp.bfloat16))
    jres = jksp.solve(jb, jx)
    comm = pt.DeviceComm(ndev, device="cpu")
    op, bv, xv = from_numpy_state(comm, jop.program_key(), b,
                                  dtype=torch.bfloat16)
    res = _ksp(pt, op, ksp_type, rtol=rtol, max_it=300).solve(bv, xv)
    want = (CR.DIVERGED_MAX_IT if (ksp_type, ndev) == ("pipecg", 1)
            else CR.CONVERGED_RTOL)
    assert res.reason == jres.reason == want
    assert abs(res.iterations - jres.iterations) <= 0.1 * jres.iterations
    assert xv.dtype == torch.bfloat16


def test_mixed_plan_keeps_the_scalars_in_fp32():
    comm = pt.DeviceComm(1, device="cpu")
    op = pt.StencilPoisson3D(comm, 8, dtype=torch.bfloat16)
    seen = []
    orig = krylov.fused_dots

    def spy(comm_, up, cols=False):
        f = orig(comm_, up, cols)

        def g(pairs):
            out = f(pairs)
            seen.append(out.dtype)
            return out
        return g

    krylov.fused_dots = spy
    try:
        res, _ = _solve(pt, op, np.ones(512), "pipecg", rtol=0.05)
    finally:
        krylov.fused_dots = orig
    assert res.converged and set(seen) == {torch.float32}


# ---- the pieces ---------------------------------------------------------------

def test_sstep_shift_matches_jax():
    from mpi_petsc4py_example_tpu.solvers import cg_plans as jax_plans
    for s in (1, 2, 4, 8):
        np.testing.assert_array_equal(cg_plans.sstep_shift(s, 2 * s + 1),
                                      jax_plans._sstep_shift(s, 2 * s + 1))


@pytest.mark.parametrize("cols", [False, True])
def test_gram_is_one_psum_of_per_shard_products(cols):
    comm = pt.DeviceComm(4, device="cpu")
    shape = (4, 5, 3, 10) if cols else (4, 5, 10)
    C = torch.from_numpy(np.random.default_rng(1).standard_normal(shape))
    before = comm.collectives["psum"]
    E = krylov.gram_psum(comm, cols)(C)
    assert comm.collectives["psum"] - before == 1
    if cols:
        full = C.permute(2, 1, 0, 3).reshape(3, 5, -1)
        want = torch.einsum("kal,kbl->abk", full, full)
    else:
        full = C.permute(1, 0, 2).reshape(5, -1)
        want = full @ full.T
    torch.testing.assert_close(E, want, rtol=1e-13, atol=1e-12)


def test_sstep_zero_block_runs_as_one_like_jax():
    """``-ksp_sstep_s 0`` runs blocks of one, as the JAX builder's
    ``max(1, s)`` does."""
    jop, op, A = _operators("ell", 1)
    b = _rhs(A)
    jres, jx = _solve(tps, jop, b, "sstep", sstep_s=0)
    res, x = _solve(pt, op, b, "sstep", sstep_s=0)
    one, _ = _solve(pt, op, b, "sstep", sstep_s=1)
    _assert_same(jres, jx, res, x)
    assert res.host_syncs == one.host_syncs == 2 + res.iterations
