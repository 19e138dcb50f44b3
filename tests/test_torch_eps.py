"""The PyTorch port's eigensolver (EPS) and spectral transformations (ST)
against the JAX package, on the CPU.

Both packages solve the same numpy problem: the JAX side on the forced
8-device CPU mesh of ``conftest.py``, the port on its CPU virtual mesh with
the same shard count, in fp64. The JAX Krylov-Schur runs its host loop
(``TPU_SOLVE_EPS_FUSED=0``, read at solve time), the loop the port has; one
case holds the port against the JAX package's default fused loop too.

Limits: restarts, nconv and reason equal; eigenvalues within 1e-10
relative; the eigenvectors of converged pairs within 1e-8 up to sign (a
phase for complex pairs); ``compute_error`` within 1e-8; and the port's
host reads, ``host_syncs``, equal to restarts + 1 (one read of the projected
matrix per restart, one for the eigenvectors).

The problems are those of the JAX package's own EPS tests
(``tests/test_eps.py``, ``tests/test_st_cayley.py``,
``tests/test_eps_monitor.py``), the reference ``test2.py`` matrix
(``tridiag_family``) and the 7-point Poisson stencil, whose extreme
eigenvalues are ``6 -+ 6 cos(pi/(n+1))`` summed over the axes.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers.st import ST as JaxST  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    convdiff2d, tridiag_family)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson1d_csr, poisson3d_csr)
from mpi_petsc4py_example_tpu_torch.solvers import eps as port_eps  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers.krylov import (  # noqa: E402
    _cgs2_step)

LAM_RTOL = 1e-10
VEC_TOL = 1e-8
ERR_TOL = 1e-8
NDEVS = [1, 2, 4, 8]


@pytest.fixture(autouse=True)
def host_loop_and_clean_options(monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_EPS_FUSED", "0")
    tps.global_options().clear()
    pt.global_options().clear()
    yield
    tps.global_options().clear()
    pt.global_options().clear()


# ---- building and comparing -------------------------------------------------------

def csr(A, B=None):
    """Operators from scipy matrices, built by each package."""
    def make(pkg, comm):
        return (pkg.Mat.from_scipy(comm, A),
                pkg.Mat.from_scipy(comm, B) if B is not None else None)
    return make


def stencil(nx, ny=None, nz=None):
    """The matrix-free 7-point Poisson stencil of each package."""
    def make(pkg, comm):
        if pkg is tps:
            return JaxStencil(comm, nx, ny, nz, dtype=jnp.float64), None
        return pt.StencilPoisson3D(comm, nx, ny, nz,
                                   dtype=torch.float64), None
    return make


def comms(ndev):
    return ((tps, tps.DeviceComm(n_devices=ndev)),
            (pt, pt.DeviceComm(ndev, device="cpu")))


def solve_both(ndev, make_ops, ptype="hep", eps_type=None, which=None,
               nev=None, ncv=None, tol=None, max_it=None, target=None,
               st=None, shift=None, antishift=None):
    """The same EPS configuration solved by both packages: ``(jax_eps,
    port_eps)``."""
    out = []
    for pkg, comm in comms(ndev):
        A, B = make_ops(pkg, comm)
        E = pkg.EPS().create(comm)
        E.set_operators(A, B)
        E.set_problem_type(ptype)
        if eps_type:
            E.set_type(eps_type)
        if which:
            E.set_which_eigenpairs(which)
        E.set_dimensions(nev=nev, ncv=ncv)
        E.set_tolerances(tol=tol, max_it=max_it)
        if target is not None:
            E.set_target(target)
        if st:
            E.get_st().set_type(st)
        if shift is not None:
            E.get_st().set_shift(shift)
        if antishift is not None:
            E.get_st().set_antishift(antishift)
        E.solve()
        out.append(E)
    return tuple(out)


def assert_same(jE, pE, errors=True):
    """Restarts, nconv and reason equal; the stored pairs within the
    module's limits; the port's host reads one per restart plus one."""
    its = pE.get_iteration_number()
    assert (its, pE.get_converged(), pE.result.reason) == (
        jE.get_iteration_number(), jE.get_converged(),
        int(jE.result.reason))
    if pE.get_type() != "lapack":
        assert pE.result.host_syncs == its + 1
    assert len(pE._eigenvalues) == len(jE._eigenvalues)
    for i in range(len(jE._eigenvalues)):
        lj, lp = jE.get_eigenvalue(i), pE.get_eigenvalue(i)
        assert abs(lp - lj) <= LAM_RTOL * abs(lj), (i, lp, lj)
        if i >= jE.get_converged():
            continue
        vj = np.asarray(jE._eigenvectors[i])
        vp = np.asarray(pE._eigenvectors[i])
        s = np.vdot(vp, vj)
        np.testing.assert_allclose(vp * (s / abs(s)), vj, rtol=0,
                                   atol=VEC_TOL)
        if errors:
            assert abs(pE.compute_error(i) - jE.compute_error(i)) <= ERR_TOL


def stencil_extremes(nx, ny, nz):
    """The largest and smallest eigenvalues of the 7-point Dirichlet
    Laplacian on an nx x ny x nz grid, in closed form."""
    c = [np.cos(np.pi / (m + 1)) for m in (nx, ny, nz)]
    return 6 + 2 * sum(c), 6 - 2 * sum(c)


# ---- the reference test2.py matrix ------------------------------------------------

@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("n,restarts", [(100, 4), (4096, 14)])
def test_tridiag_family_matches_jax(n, restarts, ndev):
    """cfg2's problem (``test2.py``): nev 1, the largest magnitude, the
    defaults (ncv 16, tol 1e-8). On 4 shards the JAX package takes 4 and 14
    restarts."""
    A = tridiag_family(n)
    jE, pE = solve_both(ndev, csr(A))
    assert_same(jE, pE)
    if ndev == 4:
        assert pE.get_iteration_number() == restarts
    lam = np.linalg.eigvalsh(A.toarray()) if n <= 100 else None
    if lam is not None:
        want = lam[np.argmax(np.abs(lam))]
        assert abs(pE.get_eigenvalue(0).real - want) <= 1e-10 * abs(want)


def test_tridiag_family_matches_the_jax_fused_loop(monkeypatch):
    """The JAX package's default at n = 4096 on the CPU is its fused
    whole-solve program: the port's host loop takes the same restarts."""
    monkeypatch.delenv("TPU_SOLVE_EPS_FUSED")
    jE, pE = solve_both(4, csr(tridiag_family(4096)))
    assert_same(jE, pE)
    assert pE.get_iteration_number() == 14


@pytest.mark.parametrize("ndev", [1, 2])
def test_nev4_with_ncv(ndev):
    jE, pE = solve_both(ndev, csr(tridiag_family(100)), nev=4, ncv=12,
                        tol=1e-9)
    assert_same(jE, pE)
    assert pE.get_converged() >= 4
    assert pE.get_dimensions() == jE.get_dimensions() == (4, 12)
    assert pE.get_tolerances() == jE.get_tolerances() == (1e-9, 100)
    lam = np.linalg.eigvalsh(tridiag_family(100).toarray())
    want = lam[np.argsort(-np.abs(lam))][:4]
    got = [pE.get_eigenvalue(i).real for i in range(4)]
    np.testing.assert_allclose(got, want, rtol=1e-10)


# ---- the stencil and its assembled matrix -------------------------------------------

@pytest.mark.parametrize("ndev", NDEVS)
@pytest.mark.parametrize("which,restarts",
                         [("largest_magnitude", 9), ("smallest_real", 11)])
def test_stencil_16_matches_jax(which, restarts, ndev):
    """The 16^3 stencil: 9 restarts for the largest magnitude and 11 for
    the smallest real on 4 shards in the JAX package; each eigenvalue its
    closed form."""
    jE, pE = solve_both(ndev, stencil(16), which=which)
    assert_same(jE, pE)
    if ndev == 4:
        assert pE.get_iteration_number() == restarts
    hi, lo = stencil_extremes(16, 16, 16)
    want = hi if which == "largest_magnitude" else lo
    assert abs(pE.get_eigenvalue(0).real - want) <= 1e-9 * want


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("which", ["largest_magnitude", "smallest_real"])
def test_stencil_8x12x16_matches_jax(which, ndev):
    jE, pE = solve_both(ndev, stencil(8, 12, 16), which=which)
    assert_same(jE, pE)
    hi, lo = stencil_extremes(8, 12, 16)
    want = hi if which == "largest_magnitude" else lo
    assert abs(pE.get_eigenvalue(0).real - want) <= 1e-9 * want


@pytest.mark.parametrize("which", ["largest_magnitude", "smallest_real"])
def test_assembled_poisson_equals_the_stencil(which):
    """``poisson3d_csr(16)`` as a Mat runs the same solve as the stencil:
    the same restarts, the eigenvalue within 1e-10, and both equal the JAX
    package's Mat."""
    jE, pE = solve_both(4, csr(poisson3d_csr(16)), which=which)
    assert_same(jE, pE)
    _, sE = solve_both(4, stencil(16), which=which)
    assert sE.get_iteration_number() == pE.get_iteration_number()
    assert abs(sE.get_eigenvalue(0) - pE.get_eigenvalue(0)) <= \
        LAM_RTOL * abs(sE.get_eigenvalue(0))


def test_stencil_eigenpair_and_error():
    """``get_eigenpair`` fills the Vecs with the unit eigenvector and
    ``compute_error`` is its true residual."""
    jE, pE = solve_both(2, stencil(8), which="smallest_real")
    op = pE._mat
    vr, vi = op.get_vecs()
    lam = pE.get_eigenpair(0, vr, vi)
    v = vr.to_numpy()
    assert np.all(vi.to_numpy() == 0.0)
    assert abs(np.linalg.norm(v) - 1.0) < 1e-12
    A = poisson3d_csr(8)
    r = np.linalg.norm(A @ v - lam.real * v) / abs(lam)
    assert abs(r - pE.compute_error(0)) <= 1e-12
    assert pE.compute_error(0) <= 1e-8
    assert abs(pE.compute_error(0, "absolute")
               - pE.compute_error(0) * abs(lam)) <= 1e-14
    with pytest.raises(ValueError, match="unknown error type"):
        pE.compute_error(0, "bogus")


# ---- the six selections -----------------------------------------------------------

def _shifted_poisson(n=60):
    """A symmetric matrix with both signs in its spectrum (about -1 to 3),
    so that magnitude and real part order it differently."""
    return (poisson1d_csr(n) - 1.0 * sp.eye(n)).tocsr()


@pytest.mark.parametrize("which,target", [
    ("largest_magnitude", None), ("smallest_magnitude", None),
    ("largest_real", None), ("smallest_real", None),
    ("target_magnitude", 3.5), ("target_real", -2.0)])
def test_which_selections_match_jax(which, target):
    A = _shifted_poisson()
    jE, pE = solve_both(4, csr(A), which=which, target=target, nev=2,
                        max_it=300)
    assert_same(jE, pE)
    lam = np.linalg.eigvalsh(A.toarray())
    if pE.get_converged() >= 1:
        metric = {"largest_magnitude": -np.abs(lam),
                  "smallest_magnitude": np.abs(lam),
                  "largest_real": -lam, "smallest_real": lam,
                  "target_magnitude": np.abs(lam - (target or 0.0)),
                  "target_real": np.abs(lam - (target or 0.0))}[which]
        want = lam[np.argmin(metric)]
        assert abs(pE.get_eigenvalue(0).real - want) <= 1e-9 * abs(want)


# ---- non-Hermitian problems (JAX tests/test_eps.py:82, :144, :509) ---------------

def _nonsymmetric(n, seed, upper):
    rng = np.random.default_rng(seed)
    D = np.diag(np.linspace(1.0, n, n))
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    return Q @ D @ Q.T + upper * np.triu(rng.standard_normal((n, n)), 1)


@pytest.mark.parametrize("ndev", [1, 8])
@pytest.mark.parametrize("n,seed,upper,ncv,max_it",
                         [(60, 7, 0.01, 30, None), (80, 11, 0.05, 12, 300)])
def test_nhep_matches_jax(n, seed, upper, ncv, max_it, ndev):
    Ad = _nonsymmetric(n, seed, upper)
    jE, pE = solve_both(ndev, csr(sp.csr_matrix(Ad)), ptype="nhep", ncv=ncv,
                        tol=1e-8, max_it=max_it)
    assert_same(jE, pE)
    lam = np.linalg.eigvals(Ad)
    want = lam[np.argmax(np.abs(lam))]
    assert abs(pE.get_eigenvalue(0) - want) <= 1e-6 * abs(want)


def test_nhep_complex_pairs_match_jax():
    """A random real matrix: complex-conjugate pairs lead its spectrum, so
    the ordered real Schur form keeps 2x2 blocks whole at the restart."""
    rng = np.random.default_rng(3)
    Ad = rng.standard_normal((40, 40))
    jE, pE = solve_both(2, csr(sp.csr_matrix(Ad)), ptype="nhep", nev=2,
                        ncv=16, max_it=300)
    assert_same(jE, pE)


def test_nhep_convdiff_largest_real():
    """The benchmark's unsymmetric convection-diffusion operator (cfg4's
    family), largest real part, against ``numpy.linalg.eig``."""
    A = convdiff2d(12, beta=0.3)
    jE, pE = solve_both(4, csr(A), ptype="nhep", which="largest_real",
                        max_it=300)
    assert_same(jE, pE)
    lam = np.linalg.eigvals(A.toarray())
    want = lam[np.argmax(lam.real)]
    assert abs(pE.get_eigenvalue(0) - want) <= 1e-8 * abs(want)


def test_lanczos_is_the_hermitian_alias():
    jE, pE = solve_both(2, csr(tridiag_family(100)), eps_type="lanczos")
    assert_same(jE, pE)
    with pytest.raises(ValueError, match="Hermitian"):
        solve_both(2, csr(tridiag_family(20)), ptype="nhep",
                   eps_type="lanczos")


# ---- generalized problems (JAX tests/test_eps.py:241, :257, :277) ----------------

def _pencil(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(1.0, 3.0, n)
    B = sp.diags([0.1 * np.ones(n - 1), d, 0.1 * np.ones(n - 1)],
                 [-1, 0, 1]).tocsr()
    return tridiag_family(n), B


@pytest.mark.parametrize("ndev", [1, 4])
def test_ghep_shift_matches_jax(ndev):
    import scipy.linalg
    A, B = _pencil(50, 3)
    jE, pE = solve_both(ndev, csr(A, B), ptype="ghep", tol=1e-9)
    assert_same(jE, pE)
    lam = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    want = lam[np.argmax(np.abs(lam))]
    assert abs(pE.get_eigenvalue(0).real - want) <= 1e-9 * abs(want)


def test_ghep_sinvert_matches_jax():
    import scipy.linalg
    A, B = _pencil(40, 9)
    jE, pE = solve_both(2, csr(A, B), ptype="ghep", st="sinvert",
                        which="target_magnitude", target=0.0, tol=1e-9)
    assert_same(jE, pE)
    lam = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    want = lam[np.argmin(np.abs(lam))]
    assert abs(pE.get_eigenvalue(0).real - want) <= 1e-9 * abs(want)


def test_ghep_eigenvector_residual():
    A, B = _pencil(40, 5)
    jE, pE = solve_both(4, csr(A, B), ptype="ghep", tol=1e-10)
    assert_same(jE, pE)
    vr, _ = pE._mat.get_vecs()
    lam = pE.get_eigenpair(0, vr).real
    v = vr.to_numpy()
    assert np.linalg.norm(A @ v - lam * (B @ v)) <= 1e-7 * abs(lam)


def test_two_operators_need_ghep():
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, sp.eye(10, format="csr"))
    E = pt.EPS().create(comm)
    E.set_operators(M, M)
    assert E._problem_type == "ghep"
    E.set_problem_type("hep")
    with pytest.raises(ValueError, match="ghep"):
        E.solve()
    E = pt.EPS().create(comm).set_operators(M).set_problem_type("ghep")
    with pytest.raises(ValueError, match="needs operators"):
        E.solve()


# ---- spectral transformations (JAX tests/test_eps.py:168-217, cayley) ------------

def test_sinvert_smallest_matches_jax():
    n = 120
    A = poisson1d_csr(n)
    jE, pE = solve_both(4, csr(A), st="sinvert", which="target_magnitude",
                        target=0.0, tol=1e-10)
    assert_same(jE, pE)
    assert pE.get_iteration_number() <= 3
    lam_min = np.linalg.eigvalsh(A.toarray())[0]
    assert abs(pE.get_eigenvalue(0).real - lam_min) <= 1e-9 * lam_min


@pytest.mark.parametrize("st", ["sinvert", "cayley"])
def test_interior_target_matches_jax(st):
    A = sp.diags(np.arange(1.0, 61.0)).tocsr()
    jE, pE = solve_both(8, csr(A), st=st, which="target_magnitude",
                        target=33.4)
    assert_same(jE, pE)
    assert abs(pE.get_eigenvalue(0).real - 33.0) <= 1e-9 * 33.0
    # the target became the shift (SLEPc's convention)
    assert pE.get_st().get_shift() == 33.4


def test_shift_back_transform_matches_jax():
    A = tridiag_family(60)
    jE, pE = solve_both(4, csr(A), st="shift", shift=-500.0, tol=1e-9)
    assert_same(jE, pE)
    lam = np.linalg.eigvalsh(A.toarray())
    want = lam[np.argmax(np.abs(lam))]
    assert abs(pE.get_eigenvalue(0).real - want) <= 1e-9 * abs(want)


def test_shift_on_the_stencil_matches_jax():
    """ST shift needs no entries, so it runs on the matrix-free stencil."""
    jE, pE = solve_both(2, stencil(8), st="shift", shift=-3.0)
    assert_same(jE, pE)


def test_cayley_smallest_poisson_matches_jax():
    A = poisson1d_csr(120)
    jE, pE = solve_both(4, csr(A), st="cayley", shift=0.0, antishift=1.0,
                        which="target_magnitude", target=0.0, tol=1e-10)
    assert_same(jE, pE)
    lam_min = np.linalg.eigvalsh(A.toarray())[0]
    assert abs(pE.get_eigenvalue(0).real - lam_min) <= 1e-8 * lam_min


def test_cayley_ghep_matches_jax():
    rng = np.random.default_rng(0)
    n = 50
    Q = rng.random((n, n))
    A = sp.csr_matrix((Q + Q.T) / 2 + n * np.eye(n))
    B = sp.diags(1.0 + rng.random(n)).tocsr()
    import scipy.linalg
    lam = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    target = float(lam[n // 2] + 0.01)
    jE, pE = solve_both(2, csr(A, B), ptype="ghep", st="cayley",
                        which="target_magnitude", target=target)
    assert_same(jE, pE)
    nearest = lam[np.argmin(np.abs(lam - target))]
    assert abs(pE.get_eigenvalue(0).real - nearest) <= 1e-8 * abs(nearest)


def test_cayley_antishift_change_rebuilds_the_operator():
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, sp.diags(np.arange(1.0, 41.0)).tocsr())
    E = pt.EPS().create(comm).set_operators(M).set_problem_type("hep")
    E.get_st().set_type("cayley")
    E.set_which_eigenpairs("target_magnitude").set_target(17.2)
    E.solve()
    op = E._op_cache[1]
    assert abs(E.get_eigenvalue(0).real - 17.0) <= 1e-8 * 17.0
    E.solve()
    assert E._op_cache[1] is op          # unchanged: the cached inverse
    E.get_st().set_antishift(500.0)
    E.solve()
    assert E._op_cache[1] is not op
    assert abs(E.get_eigenvalue(0).real - 17.0) <= 1e-7 * 17.0


@pytest.mark.parametrize("st,sigma,nu", [
    ("shift", 2.5, None), ("sinvert", 2.5, None), ("cayley", 3.0, 1.5),
    ("cayley", 1.0, None)])
def test_back_transform_equals_jax(st, sigma, nu):
    theta = np.array([-7.0, 0.0, 0.4, 1.0, 2.2, 9.9])
    out = []
    for cls in (JaxST, pt.ST):
        s = cls().set_type(st).set_shift(sigma)
        if nu is not None:
            s.set_antishift(nu)
        out.append(s.back_transform(theta))
    np.testing.assert_array_equal(out[1], out[0])


def test_cayley_roundtrip_and_identity_rejection():
    st = pt.ST().set_type("cayley").set_shift(3.0).set_antishift(1.5)
    lam = np.array([-7.0, 0.4, 2.2, 9.9])
    np.testing.assert_allclose(st.back_transform((lam + 1.5) / (lam - 3.0)),
                               lam, rtol=1e-13)
    assert pt.ST().set_type("cayley").set_shift(2.0).get_antishift() == 2.0
    comm = pt.DeviceComm(device="cpu")
    M = pt.Mat.from_scipy(comm, tridiag_family(20))
    E = pt.EPS().create(comm).set_operators(M).set_problem_type("hep")
    E.get_st().set_type("cayley")      # sigma 0, nu 0: the identity
    with pytest.raises(ValueError, match="identity"):
        E.solve()


@pytest.mark.parametrize("st", ["sinvert", "cayley"])
def test_factoring_transforms_reject_matrix_free(st):
    """sinvert and cayley factor the operator: the stencil has no entries,
    so both packages refuse it."""
    for pkg, comm in comms(2):
        op, _ = stencil(8)(pkg, comm)
        E = pkg.EPS().create(comm).set_operators(op)
        E.set_problem_type("hep")
        E.get_st().set_type(st)
        E.set_target(1.0)
        with pytest.raises(ValueError, match="matrix-free"):
            E.solve()


def test_st_options_and_unknown_type():
    pt.init(["prog", "-st_type", "cayley", "-st_shift", "2.5",
             "-st_cayley_antishift", "0.5"])
    st = pt.ST().set_from_options()
    assert (st.get_type(), st.get_shift(), st.get_antishift()) == (
        "cayley", 2.5, 0.5)
    with pytest.raises(ValueError, match="unknown ST type"):
        pt.ST().set_type("fold")


# ---- lapack (JAX tests/test_eps.py:492-597, tests/test_st_cayley.py) -------------

@pytest.mark.parametrize("case", ["hep", "nhep", "ghep", "smallest_real",
                                  "sinvert", "cayley", "nev_over_n"])
def test_lapack_matches_jax(case):
    A = tridiag_family(60)
    kw = {"eps_type": "lapack", "nev": 2}
    if case == "nhep":
        A = sp.csr_matrix(np.random.default_rng(3).standard_normal((40, 40)))
        kw["ptype"] = "nhep"
    elif case == "ghep":
        kw.update(ptype="ghep")
        ops = csr(A, sp.diags([np.linspace(1.0, 2.0, 60)], [0]).tocsr())
    elif case == "smallest_real":
        kw.update(which="smallest_real", nev=1)
    elif case == "sinvert":
        kw.update(st="sinvert", shift=float(np.median(
            np.linalg.eigvalsh(A.toarray()))))
    elif case == "cayley":
        A = sp.diags([-1.0, 3.5, 5.0, 9.0, 20.0, -14.0, 30.0, -25.0]).tocsr()
        kw.update(st="cayley", shift=1.0, nev=1)
    elif case == "nev_over_n":
        A = tridiag_family(20)
        kw["nev"] = 50
    jE, pE = solve_both(2, ops if case == "ghep" else csr(A), **kw)
    assert_same(jE, pE)
    assert pE.result.residual_norm < 1e-11
    if case == "cayley":     # by |theta|, not by distance to sigma
        assert pE.get_eigenvalue(0).real == 3.5
    if case == "nev_over_n":
        assert pE.get_converged() == 20 and pE.result.reason == 2


def test_lapack_cap_and_matrix_free():
    comm = pt.DeviceComm(2, device="cpu")
    E = pt.EPS().create(comm).set_type("lapack")
    E.set_operators(pt.Mat.from_scipy(comm, tridiag_family(50)))
    E._LAPACK_CAP = 10
    with pytest.raises(ValueError, match="lapack"):
        E.solve()
    E = pt.EPS().create(comm).set_type("lapack")
    E.set_operators(pt.StencilPoisson3D(comm, 4))
    with pytest.raises(ValueError, match="assembled"):
        E.solve()


# ---- options, monitors, types -----------------------------------------------------

def test_options_database_matches_jax():
    argv = ["prog", "-eps_type", "lapack", "-eps_nev", "3", "-eps_ncv",
            "20", "-eps_tol", "1e-9", "-eps_max_it", "50", "-eps_hermitian",
            "-eps_which", "smallest_real", "-eps_target", "2.0",
            "-eps_monitor", "-st_type", "sinvert", "-st_shift", "1.5",
            "-st_cayley_antishift", "0.5"]
    got = []
    for pkg, comm in comms(2):
        pkg.init(argv)
        E = pkg.EPS().create(comm).set_from_options()
        st = E.get_st()
        got.append((E.get_type(), E.nev, E.ncv, E.tol, E.max_it,
                    E._problem_type, E._which, E._target, E._monitor_flag,
                    st.get_type(), st.get_shift(), st.get_antishift()))
    assert got[1] == got[0]
    assert got[1][:3] == ("lapack", 3, 20)


def test_options_drive_a_solve():
    """``-eps_nev 4 -eps_which smallest_real`` from the options database
    reconfigure a solve as they do in the JAX package."""
    out = []
    for pkg, comm in comms(2):
        pkg.init(["prog", "-eps_nev", "4", "-eps_which", "smallest_real",
                  "-eps_ncv", "20"])
        E = pkg.EPS().create(comm)
        E.set_operators(pkg.Mat.from_scipy(comm, tridiag_family(100)))
        E.set_problem_type("hep").set_from_options().solve()
        out.append(E)
    assert_same(*out)
    assert out[1].get_converged() >= 4


@pytest.mark.parametrize("eps_type", port_eps.UNPORTED_TYPES)
def test_unported_types_raise(eps_type):
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        pt.EPS().set_type(eps_type)
    pt.init(["prog", "-eps_type", eps_type])
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        pt.EPS().set_from_options()
    with pytest.raises(ValueError, match="unknown EPS type"):
        pt.EPS().set_type("jd")


def test_defaults_match_jax():
    jE, pE = tps.EPS(), pt.EPS()
    assert (pE.get_type(), pE.nev, pE.ncv, pE.tol, pE.max_it, pE._which,
            pE._problem_type) == (jE.get_type(), jE.nev, jE.ncv, jE.tol,
                                  jE.max_it, jE._which, jE._problem_type)
    assert pE.get_dimensions() == jE.get_dimensions() == (1, 16)
    with pytest.raises(RuntimeError, match="no operators"):
        pE.solve()


def test_monitor_events_match_jax():
    events = {}
    for pkg, comm in comms(4):
        ev = events[pkg.__name__] = []
        E = pkg.EPS().create(comm)
        E.set_operators(pkg.Mat.from_scipy(comm, tridiag_family(80)))
        E.set_problem_type("hep").set_dimensions(nev=2)
        E.set_monitor(lambda eps, its, nconv, eig, err, ev=ev: ev.append(
            (its, nconv, np.asarray(eig).copy(), np.asarray(err).copy())))
        E.set_monitor(None)              # a no-op, as in slepc4py
        E.solve()
    jev, pev = events.values()
    assert [e[:2] for e in pev] == [e[:2] for e in jev] and pev
    for (_, _, eig_p, err_p), (_, _, eig_j, err_j) in zip(pev, jev):
        np.testing.assert_allclose(eig_p, eig_j, rtol=LAM_RTOL)
        np.testing.assert_allclose(err_p, err_j, rtol=0, atol=1e-10)


def _monitor_lines(text):
    """``-eps_monitor`` lines as (its, nconv, value, error), the numbers
    parsed."""
    rows = []
    for line in text.splitlines():
        m = re.match(r"\s*(\d+) EPS nconv=(\d+) first unconverged value "
                     r"\(error\) (\S+) \((\S+)\)", line)
        if m:
            rows.append((int(m[1]), int(m[2]), float(m[3]), float(m[4])))
        elif "EPS nconv=" in line:
            rows.append(line.strip())
    return rows


def test_monitor_flag_prints_the_jax_lines(capsys):
    rows = []
    for pkg, comm in comms(2):
        E = pkg.EPS().create(comm)
        E.set_operators(pkg.Mat.from_scipy(comm, tridiag_family(80)))
        E.set_problem_type("hep")
        E._monitor_flag = True
        E.solve()
        rows.append(_monitor_lines(capsys.readouterr().out))
    jrows, prows = rows
    assert len(prows) == len(jrows) > 0
    for p, j in zip(prows, jrows):
        assert p[:2] == j[:2]
        assert abs(p[2] - j[2]) <= LAM_RTOL * abs(j[2])
        assert abs(p[3] - j[3]) <= 1e-10
    # the cancelled monitor prints nothing and calls nothing
    comm = pt.DeviceComm(device="cpu")
    E = pt.EPS().create(comm).set_problem_type("hep")
    E.set_operators(pt.Mat.from_scipy(comm, tridiag_family(40)))
    E.set_monitor(lambda *a: pytest.fail("cancelled monitor called"))
    E._monitor_flag = True
    E.cancel_monitor().solve()
    assert capsys.readouterr().out == "" and not E._monitored()


def test_host_syncs_are_restarts_plus_one():
    """One host read of the projected matrix per restart, one for the
    eigenvectors; at ncv = n the first factorization is exact."""
    comm = pt.DeviceComm(4, device="cpu")
    M = pt.Mat.from_scipy(comm, tridiag_family(4096))
    E = pt.EPS().create(comm).set_operators(M).set_problem_type("hep")
    E.solve()
    assert E.result.host_syncs == E.get_iteration_number() + 1 == 15
    E.set_tolerances(max_it=3).solve()
    assert (E.get_iteration_number(), E.result.host_syncs,
            E.result.reason, E.get_converged()) == (3, 4, -3, 0)
    D = pt.Mat.from_scipy(comm, sp.diags(np.arange(1.0, 41.0)).tocsr())
    E = pt.EPS().create(comm).set_operators(D).set_problem_type("hep")
    E.set_which_eigenpairs("smallest_magnitude").set_dimensions(ncv=40)
    E.solve()
    assert (E.get_iteration_number(), E.result.host_syncs) == (1, 2)
    assert abs(E.get_eigenvalue(0).real - 1.0) <= 1e-10


def test_facto_steps_skip_the_zero_rows():
    """A CGS2 step projected against the built rows only equals the step
    against the whole basis, whose rows past the current one are zero."""
    comm = pt.DeviceComm(2, device="cpu")
    rng = np.random.default_rng(0)
    V = torch.zeros((2, 9, 16), dtype=torch.float64)
    V[:, :4] = torch.from_numpy(np.linalg.qr(rng.standard_normal(
        (32, 4)))[0].T.reshape(4, 2, 16).transpose(1, 0, 2).copy())
    w = torch.from_numpy(rng.standard_normal((2, 16)))
    pmatdot, pnorm = port_eps._inner_products(comm, None)
    h_all, b_all, v_all = _cgs2_step(V, w, pmatdot, pnorm)
    h, b, v = _cgs2_step(V[:, :4], w, pmatdot, pnorm)
    assert torch.all(h_all[4:] == 0)
    torch.testing.assert_close(h, h_all[:4], rtol=0, atol=1e-15)
    torch.testing.assert_close(b, b_all, rtol=0, atol=1e-15)
    torch.testing.assert_close(v, v_all, rtol=0, atol=1e-15)
