"""The port's other eigensolver types, ``gd``, ``power``, ``subspace`` and
``arnoldi``, against the JAX package on the CPU, with the limits, helpers
and host-read formulas ``tests/test_torch_eps_lobpcg.py`` shares.

Both packages solve the same numpy problem in fp64 (complex128 for the
complex cases): the JAX side on the forced 8-device CPU mesh of
``conftest.py``, the port on its CPU virtual mesh with the same shard
count, 1, 2, 4 or 8. ``lobpcg`` and Hermitian ``subspace`` have two routes
in each package: the device route (the port's eager loop) is held against
the JAX package's default on the CPU, its fused loop program
(``TPU_SOLVE_EPS_FUSED`` unset), and the host route against the JAX host
loops (``TPU_SOLVE_EPS_FUSED=0``) and against monitored solves.

Limits: iterations, nconv and reason equal; eigenvalues within 1e-10
relative; the eigenvectors of converged, simple pairs within 1e-8 up to
sign or phase; ``compute_error`` within 1e-8; ``host_syncs`` equal to each
type's count taken from the code (the formulas below). Two counts turn
on rounding, and are held in a band instead. LOBPCG's, near its tolerance:
the JAX package's own moves by one over 1/2/4/8 shards on the real
problems (143-144 on the tridiagonal, 183-184 on the generalized pencil),
so the port's is held within two of the JAX package's on the same shard
count, and on the complex generalized pencil, where the JAX package's
ranges over 111-137 on 1/2/4/8 shards, within the JAX package's range over
1, 2 and 4 shards (which spans it).
And where a wanted eigenvalue is degenerate (GD on the square Laplacian),
the port's count is held within two; there the eigenvectors of the
degenerate pairs are not unique and are held by their residuals.

The problems are those of the JAX package's own tests:
``TestPowerSubspace`` (``tests/test_eps.py:293``), the explicit-Arnoldi
restart comparison (``:123``), every case of ``tests/test_eps_gd.py``, the
monitor of each type (``tests/test_eps_monitor.py:50``; a monitor forces
the host route) and the complex power/subspace and GD cases
(``tests/test_complex.py:620``, ``tests/test_eps_gd.py:70``); then the
subspace refill on a rank-deficient block and GD's basis on the device,
two port-side choices (ROADMAP.md Queue C).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import eps as port_eps  # noqa: E402,E501

from test_complex import random_complex_csr  # noqa: E402
from test_eps import reference_tridiag  # noqa: E402
from test_eps_gd import poisson2d  # noqa: E402

LAM_RTOL = 1e-10
VEC_TOL = 1e-8
ERR_TOL = 1e-8
C128 = torch.complex128


@pytest.fixture(autouse=True)
def clean_options():
    tps.global_options().clear()
    pt.global_options().clear()
    yield
    tps.global_options().clear()
    pt.global_options().clear()


# ---- building, solving and comparing ------------------------------------------

def tridiag(n=60):
    return sp.diags([-np.ones(n - 1), 2 * np.ones(n), -np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


def comms(ndev):
    return ((tps, tps.DeviceComm(n_devices=ndev)),
            (pt, pt.DeviceComm(ndev, device="cpu")))


def mat(pkg, comm, A):
    if np.iscomplexobj(A.data):
        return pkg.Mat.from_scipy(comm, A, dtype=np.complex128 if pkg is tps
                                  else C128)
    return pkg.Mat.from_scipy(comm, A)


def solve_both(monkeypatch, ndev, A, eps_type, route="device", B=None,
               ptype="hep", which=None, nev=None, ncv=None, tol=None,
               max_it=None, monitor=None, blocksize=None, st=None,
               target=None, jax_only=False):
    """The same EPS solved by both packages on ``ndev`` shards: ``(jax,
    port)`` (the JAX one alone with ``jax_only``). ``route`` 'host' sets
    ``TPU_SOLVE_EPS_FUSED=0`` for both."""
    if route == "host":
        monkeypatch.setenv("TPU_SOLVE_EPS_FUSED", "0")
    else:
        monkeypatch.delenv("TPU_SOLVE_EPS_FUSED", raising=False)
    out = []
    for pkg, comm in comms(ndev):
        E = pkg.EPS().create(comm)
        E.set_operators(mat(pkg, comm, A),
                        mat(pkg, comm, B) if B is not None else None)
        E.set_problem_type(ptype)
        E.set_type(eps_type)
        if which:
            E.set_which_eigenpairs(which)
        E.set_dimensions(nev=nev, ncv=ncv)
        E.set_tolerances(tol=tol, max_it=max_it)
        if blocksize is not None:
            E.gd_blocksize = blocksize
        if st:
            E.get_st().set_type(st)
        if target is not None:
            E.set_target(target)
        if monitor is not None:
            E.set_monitor(monitor(pkg))
        E.solve()
        if jax_only:
            return E
        out.append(E)
    return tuple(out)


def lobpcg_device_syncs(its):
    """The device route's reads: the start block's evaluation with the first
    Gram matrix, then per iteration that read for the next block and, for
    every iteration that builds one, the second Gram matrix and the pencil;
    one for the eigenvectors."""
    return 2 if its == 0 else 3 * its - 1


SYNCS = {
    # the host loop: one read a block product, A (and B) of the start block
    # and of every trial basis built
    ("lobpcg", "host"): lambda E: E.get_iteration_number() * (
        1 + (E._bmat is not None)),
    ("lobpcg", "device"): lambda E: lobpcg_device_syncs(
        E.get_iteration_number()),
    # H, the residual norms and the corrections' norms an iteration (the
    # last one the first two), one read for the eigenvectors
    ("gd", "device"): lambda E: 3 * E.get_iteration_number(),
    # one read a chunk of 8 steps, one for the eigenvector
    ("power", "device"): lambda E: E.get_iteration_number() // 8 + 1,
    # the host loop: one read a block product
    ("subspace", "host"): lambda E: E.get_iteration_number(),
    # two Gram matrices, the projected matrix and the residual norms an
    # iteration, one more per refill, one for the eigenvectors
    ("subspace", "device"): lambda E: 4 * E.get_iteration_number() + 1,
    # one read of H a restart, one for the eigenvectors
    ("arnoldi", "device"): lambda E: E.get_iteration_number() + 1,
}


def jax_its_range(monkeypatch, jE, A, eps_type, route="device", **cfg):
    """The JAX package's iteration counts over 1, 2 and 4 shards, ``jE`` its
    solve on one of them."""
    its = [jE.get_iteration_number()]
    for ndev in sorted({1, 2, 4} - {jE._mat.comm.size}):
        its.append(solve_both(monkeypatch, ndev, A, eps_type, route,
                              jax_only=True, **cfg).get_iteration_number())
    return min(its), max(its)


def assert_same(jE, pE, route="device", its_band=0, vectors=True,
                errors=True, its_range=None):
    """The port against the JAX package: iterations (within ``its_band``,
    or inside ``its_range``), nconv and reason equal, host reads by the type's formula, eigenvalues
    within 1e-10, converged eigenvectors within 1e-8 up to phase (when
    ``vectors``) and ``compute_error`` within 1e-8."""
    its, jits = pE.get_iteration_number(), jE.get_iteration_number()
    if its_range is None:
        assert abs(its - jits) <= its_band, (its, jits)
    else:
        assert its_range[0] <= its <= its_range[1], (its, its_range)
    assert (pE.get_converged(), int(pE.result.reason)) == (
        jE.get_converged(), int(jE.result.reason))
    assert pE.result.host_syncs == SYNCS[(pE.get_type(), route)](pE)
    assert len(pE._eigenvalues) == len(jE._eigenvalues)
    for i in range(len(jE._eigenvalues)):
        lj, lp = jE.get_eigenvalue(i), pE.get_eigenvalue(i)
        assert abs(lp - lj) <= LAM_RTOL * abs(lj), (i, lp, lj)
        if i >= jE.get_converged():
            continue
        if vectors:
            vj = np.asarray(jE._eigenvectors[i])
            vp = np.asarray(pE._eigenvectors[i])
            s = np.vdot(vp, vj)
            np.testing.assert_allclose(vp * (s / abs(s)), vj, rtol=0,
                                       atol=VEC_TOL)
        if errors:
            assert abs(pE.compute_error(i) - jE.compute_error(i)) <= ERR_TOL


# ---- power, subspace (tests/test_eps.py TestPowerSubspace) ----------------------

@pytest.mark.parametrize("ndev", [1, 2])
def test_power_dominant_matches_jax(monkeypatch, ndev):
    jE, pE = solve_both(monkeypatch, ndev, sp.diags(np.arange(1.0, 81.0))
                        .tocsr(), "power", tol=1e-8, max_it=400)
    assert_same(jE, pE)
    np.testing.assert_allclose(pE.get_eigenvalue(0).real, 80.0, rtol=1e-6)


@pytest.mark.parametrize("route,ndev", [("device", 1), ("device", 8),
                                        ("host", 2)])
def test_subspace_multiple_matches_jax(monkeypatch, route, ndev):
    A = reference_tridiag(90)
    jE, pE = solve_both(monkeypatch, ndev, A, "subspace", route, nev=2,
                        ncv=12, tol=1e-7, max_it=500)
    assert_same(jE, pE, route)
    lam = np.linalg.eigvalsh(A.toarray())
    want = lam[np.argsort(-np.abs(lam))][:2]
    np.testing.assert_allclose(pE._eigenvalues.real, want, rtol=1e-5)


@pytest.mark.parametrize("eps_type,route", [("power", "device"),
                                            ("subspace", "device"),
                                            ("subspace", "host")])
def test_power_subspace_complex_dominant_matches_jax(monkeypatch, eps_type,
                                                     route):
    """``test_power_subspace_complex_dominant`` (``tests/test_complex.py:
    620``), on 2 shards: power's Rayleigh quotient stays complex (power has
    one route)."""
    n = 80
    B = random_complex_csr(n, density=0.15, seed=28)
    H = (B + B.conj().T).tocsr() + sp.diags(np.linspace(1, 50, n))
    jE, pE = solve_both(monkeypatch, 2, H, eps_type, route, nev=1)
    assert_same(jE, pE, route)
    if eps_type == "power":
        assert np.iscomplexobj(pE._eigenvalues)
    lam = np.linalg.eigvalsh(H.toarray())
    np.testing.assert_allclose(pE.get_eigenvalue(0).real,
                               lam[np.argmax(np.abs(lam))], rtol=1e-7)


def test_subspace_nhep_takes_the_host_loop(monkeypatch):
    """A non-Hermitian problem runs the host loop in both packages (eig of
    the projected matrix), whatever the route setting."""
    rng = np.random.default_rng(11)
    n = 40
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    d = np.linspace(1.0, 10.0, n)
    d[-1] = 30.0
    A = sp.csr_matrix(Q @ np.diag(d) @ Q.T
                      + 0.05 * np.triu(rng.standard_normal((n, n)), 1))
    jE, pE = solve_both(monkeypatch, 1, A, "subspace", ptype="nhep", nev=1,
                        ncv=8, tol=1e-8, max_it=400)
    assert_same(jE, pE, "host")


def _rank3(n=48):
    """A diagonal operator of rank 3: the power step of an 8-row block
    has rank 3, so the second iteration's orthonormalization masks 5
    rows."""
    d = np.zeros(n)
    d[[5, 17, 30]] = [9.0, 5.0, 2.0]
    return sp.diags(d).tocsr()


@pytest.mark.parametrize("ndev", [1, 4])
def test_subspace_refill_converges_as_jax(monkeypatch, ndev):
    """Masked rows are refilled from a ``torch.Generator`` seeded by
    (7, iteration, global shard index), not the JAX package's
    ``jax.random`` bits (ROADMAP.md Queue C): on a rank-3 operator, where
    the refill fires in the second iteration, the port converges as the
    JAX package does, with the same dominant eigenvalues (iterations
    within one)."""
    monkeypatch.delenv("TPU_SOLVE_EPS_FUSED", raising=False)
    refills = []
    orig = port_eps._reseed_block
    monkeypatch.setattr(port_eps, "_reseed_block",
                        lambda *a: refills.append(a[2]) or orig(*a))
    jE, pE = solve_both(monkeypatch, ndev, _rank3(), "subspace", nev=2,
                        ncv=8, tol=1e-10, max_it=50)
    assert refills == [1]
    assert pE.get_converged() == jE.get_converged() == 2
    assert abs(pE.get_iteration_number() - jE.get_iteration_number()) <= 1
    np.testing.assert_allclose(pE._eigenvalues.real, [9.0, 5.0],
                               rtol=LAM_RTOL)
    np.testing.assert_allclose(pE._eigenvalues.real,
                               np.asarray(jE._eigenvalues).real,
                               rtol=LAM_RTOL)
    # the refills read once each, past the formula's four an iteration
    assert pE.result.host_syncs == 4 * pE.get_iteration_number() + 1 + len(
        refills)


def test_refill_block_is_the_same_on_any_split():
    """The refill block of ``DeviceComm(4)`` is the two processes' blocks
    of a 2 x 2 split, stacked: each shard's draws depend on its global
    index only (the ``ProcessComm`` agreement)."""
    comm = pt.DeviceComm(4, device="cpu")
    mask = torch.ones((4, 1, 5), dtype=torch.float64)
    whole = port_eps._reseed_block(comm, (3, 5), 6, torch.float64, mask)

    class Half:
        local_shards = 2

        def __init__(self, offset):
            self.shard_offset = offset

    halves = [port_eps._reseed_block(Half(o), (3, 5), 6, torch.float64,
                                     mask[:2]) for o in (0, 2)]
    assert torch.equal(whole, torch.cat(halves))
    other = port_eps._reseed_block(comm, (3, 5), 7, torch.float64, mask)
    assert not torch.equal(whole, other)


def test_dominant_only_restrictions_match_jax():
    """power and subspace refuse a non-dominant selection, and subspace an
    ncv past its cap of 32, with the JAX package's messages."""
    A = reference_tridiag(40)
    for pkg, comm in comms(2):
        for eps_type in ("power", "subspace"):
            E = pkg.EPS().create(comm).set_operators(mat(pkg, comm, A))
            E.set_problem_type("hep").set_type(eps_type)
            E.set_which_eigenpairs("smallest_real")
            with pytest.raises(ValueError, match="dominant eigenpairs"):
                E.solve()
        E = pkg.EPS().create(comm).set_operators(mat(pkg, comm, A))
        E.set_problem_type("hep").set_type("subspace")
        with pytest.raises(ValueError, match="caps ncv at 32 .the block"):
            E.set_dimensions(nev=2, ncv=33).solve()


# ---- arnoldi -------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [2])
def test_fewer_restarts_than_explicit_arnoldi(monkeypatch, ndev):
    """``test_fewer_restarts_than_explicit_arnoldi`` (``tests/test_eps.py:
    123``): explicit Arnoldi against the JAX package, and thick restarts
    need no more restarts than it."""
    A = reference_tridiag(150)
    jE, pE = solve_both(monkeypatch, ndev, A, "arnoldi", nev=3, ncv=10,
                        tol=1e-8, max_it=500)
    assert_same(jE, pE)
    comm = pt.DeviceComm(ndev, device="cpu")
    ks = pt.EPS().create(comm).set_operators(pt.Mat.from_scipy(comm, A))
    ks.set_problem_type("hep").set_dimensions(nev=3, ncv=10)
    ks.set_tolerances(tol=1e-8, max_it=500).solve()
    assert ks.get_converged() >= 3
    assert ks.get_iteration_number() <= pE.get_iteration_number()


def test_arnoldi_sinvert_nhep_matches_jax(monkeypatch):
    """Explicit Arnoldi on a non-Hermitian operator under shift-and-invert:
    the restart vector takes the real part of complex-pair columns."""
    rng = np.random.default_rng(3)
    n = 50
    A = sp.csr_matrix(np.diag(np.linspace(1.0, 10.0, n))
                      + 0.3 * rng.standard_normal((n, n)))
    jE, pE = solve_both(monkeypatch, 4, A, "arnoldi", ptype="nhep", nev=2,
                        ncv=12, tol=1e-10, max_it=200, st="sinvert",
                        which="target_magnitude", target=5.0)
    assert_same(jE, pE)


# ---- gd (every case of tests/test_eps_gd.py) ------------------------------------

def test_gd_largest_reference_family(monkeypatch):
    A = reference_tridiag(100)
    jE, pE = solve_both(monkeypatch, 2, A, "gd", which="largest_real",
                        nev=2, tol=1e-7, max_it=500)
    assert_same(jE, pE)
    lam = np.linalg.eigvalsh(A.toarray())
    np.testing.assert_allclose(pE._eigenvalues, lam[::-1][:2], rtol=1e-6)


def test_gd_smallest_poisson(monkeypatch):
    """The 12 x 12 Laplacian's second and third pairs are degenerate."""
    A = poisson2d(12)
    jE, pE = solve_both(monkeypatch, 2, A, "gd", which="smallest_real",
                        nev=3, tol=1e-7, max_it=500)
    assert_same(jE, pE, its_band=2, vectors=False, errors=False)
    np.testing.assert_allclose(np.sort(pE._eigenvalues),
                               np.linalg.eigvalsh(A.toarray())[:3],
                               rtol=1e-5)
    for i in range(3):
        assert pE.compute_error(i) <= 1e-6


@pytest.mark.parametrize("ndev", [1, 3, 8])
def test_gd_eigenvector_residual(monkeypatch, ndev):
    A = reference_tridiag(64)
    jE, pE = solve_both(monkeypatch, ndev, A, "gd", which="largest_real",
                        nev=1, tol=1e-7, max_it=500)
    assert_same(jE, pE)
    comm = pE._mat.comm
    vr, _ = pE._mat.get_vecs()
    lam = pE.get_eigenpair(0, vr).real
    v = vr.to_numpy()
    assert np.linalg.norm(A @ v - lam * v) / abs(lam) <= 1e-6
    assert comm.size == ndev


def test_gd_complex_hermitian(monkeypatch):
    """``test_complex_hermitian`` (``tests/test_eps_gd.py:70``)."""
    rng = np.random.default_rng(5)
    B = rng.random((60, 60)) + 1j * rng.random((60, 60))
    A = sp.csr_matrix((B + B.conj().T) / 2)
    jE, pE = solve_both(monkeypatch, 2, A, "gd", which="largest_real",
                        nev=2, tol=1e-7, max_it=500)
    assert_same(jE, pE)


def test_gd_restart_path(monkeypatch):
    A = poisson2d(10)
    jE, pE = solve_both(monkeypatch, 2, A, "gd", which="smallest_real",
                        nev=2, ncv=6, tol=1e-7, max_it=800)
    assert_same(jE, pE)
    np.testing.assert_allclose(np.sort(pE._eigenvalues),
                               np.linalg.eigvalsh(A.toarray())[:2],
                               rtol=1e-5)


def test_gd_block_larger_than_half_space(monkeypatch):
    """n < 2m: the basis stops at n rows (Rayleigh-Ritz over the whole
    space)."""
    A = reference_tridiag(24)
    jE, pE = solve_both(monkeypatch, 2, A, "gd", which="largest_real",
                        nev=12, tol=1e-7, max_it=200)
    assert_same(jE, pE)
    assert pE.get_converged() >= 12


def test_gd_small_eigenvalue_relative_residual(monkeypatch):
    A = (poisson2d(10) * 1e-3).tocsr()
    jE, pE = solve_both(monkeypatch, 2, A, "gd", which="smallest_real",
                        nev=1, tol=1e-8, max_it=500)
    assert_same(jE, pE)
    assert pE._residuals[0] <= 1e-8


def test_gd_blocksize_option(monkeypatch):
    """-eps_gd_blocksize widens the expansion block past nev (the second
    pair is degenerate)."""
    A = poisson2d(10)
    tps.global_options().set("eps_gd_blocksize", 6)
    pt.global_options().set("eps_gd_blocksize", 6)
    out = []
    for pkg, comm in comms(2):
        E = pkg.EPS().create(comm).set_operators(mat(pkg, comm, A))
        E.set_problem_type("hep").set_type("gd")
        E.set_which_eigenpairs("smallest_real").set_dimensions(nev=2)
        E.set_from_options()
        assert E.gd_blocksize == 6
        E.set_tolerances(tol=1e-7, max_it=300).solve()
        out.append(E)
    assert_same(*out, its_band=2, vectors=False)


def test_gd_restrictions_match_jax():
    """The JAX package's refusals: a non-extreme selection, an explicit ncv
    at or below the block (an ncv above it is honored), NHEP, a spectral
    transform and the block caps."""
    A = reference_tridiag(30)

    def gd(pkg, comm, which="largest_real", nev=1, ncv=None,
           ptype="hep", st=None, blocksize=0):
        E = pkg.EPS().create(comm).set_operators(mat(pkg, comm, A))
        E.set_problem_type(ptype).set_type("gd")
        E.set_which_eigenpairs(which).set_dimensions(nev=nev, ncv=ncv)
        E.gd_blocksize = blocksize
        E.set_tolerances(tol=1e-7, max_it=500)
        if st:
            E.get_st().set_type(st)
        return E.solve()

    for pkg, comm in comms(2):
        with pytest.raises(ValueError, match="extreme"):
            gd(pkg, comm, which="largest_magnitude")
        for ncv in (4, 3):
            with pytest.raises(ValueError, match="ncv"):
                gd(pkg, comm, nev=4, ncv=ncv)
        assert gd(pkg, comm, nev=4, ncv=9).get_converged() >= 4
        with pytest.raises(ValueError, match="hep"):
            gd(pkg, comm, ptype="nhep")
        with pytest.raises(ValueError, match="spectral transform"):
            gd(pkg, comm, which="smallest_real", st="sinvert")
        with pytest.raises(ValueError, match="caps the block size"):
            gd(pkg, comm, nev=17)
        with pytest.raises(ValueError, match="exceeds the 16 cap"):
            gd(pkg, comm, blocksize=17)


@pytest.mark.parametrize("eps_type", port_eps.EPS_TYPES)
def test_every_type_from_options(eps_type):
    """``-eps_type`` selects each of the eight types in both packages (the
    facade's ``SLEPc.EPS.Type`` constants, ``GD`` among them, are checked
    in ``tests/test_torch_svd.py``'s run of the facade)."""
    for pkg in (tps, pt):
        pkg.global_options().set("eps_type", eps_type)
    jE = tps.EPS().create(tps.DeviceComm(n_devices=2)).set_from_options()
    pE = pt.EPS().create(pt.DeviceComm(2, device="cpu")).set_from_options()
    assert pE.get_type() == jE.get_type() == eps_type
    assert getattr(pt.EPS.Type, eps_type.upper()) == eps_type


def test_gd_basis_stays_on_the_device(monkeypatch):
    """GD's basis stays on the device (ROADMAP.md Queue C): every read of a
    solve but the last is a small matrix or a vector of at most ncv rows
    (``V^H A V``, residual norms, correction norms), and the eigenvectors
    come back once, through one block fetch."""
    sizes, fetches = [], []
    orig_read, orig_fetch = port_eps._read, port_eps._fetch_block
    monkeypatch.setattr(port_eps, "_read", lambda *t: sizes.append(
        sum(x.numel() for x in t)) or orig_read(*t))
    monkeypatch.setattr(port_eps, "_fetch_block", lambda *a: fetches.append(
        a[1].shape) or orig_fetch(*a))
    comm = pt.DeviceComm(4, device="cpu")
    A = poisson2d(24)
    E = pt.EPS().create(comm).set_operators(pt.Mat.from_scipy(comm, A))
    E.set_problem_type("hep").set_type("gd").set_which_eigenpairs(
        "smallest_real").set_dimensions(nev=3).set_tolerances(tol=1e-7,
                                                              max_it=500)
    E.solve()
    ncv = E.get_dimensions()[1]
    assert E.get_converged() >= 3
    assert len(sizes) == E.result.host_syncs - 1
    assert max(sizes) <= ncv * ncv < A.shape[0]
    assert len(fetches) == 1 and fetches[0][1] == 3


# ---- the monitors (tests/test_eps_monitor.py) -----------------------------------

@pytest.mark.parametrize("eps_type,which", [
    ("arnoldi", None), ("power", None), ("subspace", None),
    ("lobpcg", "largest_real"), ("gd", "largest_real")])
def test_monitor_fires_each_type_as_jax(monkeypatch, eps_type, which):
    """``test_monitor_fires_each_type`` (``tests/test_eps_monitor.py:50``):
    a monitored solve takes the host route and reports the JAX package's
    events, iteration by iteration, on 2 shards: nconv equal, the wanted
    approximation within 1e-10 and the rest (Krylov types: unconverged
    interior Ritz values, sensitive to rounding) within 1e-6 relative."""
    events = {}

    def monitor(pkg):
        events[pkg] = []
        return lambda eps, its, nconv, eig, errest: events[pkg].append(
            (its, nconv, np.asarray(eig).copy(), np.asarray(errest).copy()))

    A = (sp.diags(np.arange(1.0, 61.0)).tocsr() if eps_type == "lobpcg"
         else reference_tridiag(80))
    jE, pE = solve_both(monkeypatch, 2, A, eps_type, which=which,
                        max_it=500, monitor=monitor)
    route = "host" if eps_type in ("lobpcg", "subspace") else "device"
    assert_same(jE, pE, route)
    assert len(events[pt]) == len(events[tps]) > 0
    for (pi, pn, pl, pr), (ji, jn, jl, jr) in zip(events[pt], events[tps]):
        assert (pi, pn) == (ji, jn)
        np.testing.assert_allclose(pl[:1], jl[:1], rtol=LAM_RTOL)
        np.testing.assert_allclose(pl, jl, rtol=1e-6)
        np.testing.assert_allclose(pr, jr, rtol=1e-6, atol=1e-12)
