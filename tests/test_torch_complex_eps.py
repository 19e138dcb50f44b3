"""Complex scalars in the port's eigensolver, spectral transformations,
fused solve program and refinement (ROADMAP.md Queue A item 5.6), against
the JAX package's ``tests/test_complex.py`` flows.

EPS: Krylov-Schur on complex Hermitian (HEP), general complex (NHEP, the
complex Schur form in the thick restart) and generalized Hermitian (GHEP)
problems, lanczos and lapack, ST shift/sinvert/cayley, the complex
``get_eigenpair`` (``vr`` the whole complex vector, ``vi`` zero) and
``compute_error``; each against the JAX package's host loop
(``TPU_SOLVE_EPS_FUSED=0``; complex never takes its fused program anyway)
on the same shard count: restarts and nconv equal, eigenvalues within
1e-10. The complex types the port lacks (lobpcg, power, subspace, arnoldi,
gd) raise naming ROADMAP.md item 7.

The fused program (``-ksp_megasolve``) on complex operators: its general
plan against the unfused loop of the port (cg and pipecg bit for bit) and
the JAX package's megasolve (``TPU_SOLVE_AOT=0``), single and batched; its
guarded modes raise naming item 6. ``RefinedKSP`` does with a complex
operator what the JAX package's does.
"""

import warnings

import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import megasolve  # noqa: E402

C128 = torch.complex128
LAM_TOL = 1e-10
X_TOL = 1e-10


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_EPS_FUSED", "0")
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    pt.global_options().clear()
    yield
    pt.global_options().clear()
    megasolve.clear_cache()


def random_complex_csr(n, density=0.2, seed=0):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, format="csr", dtype=np.float64,
                  random_state=rng)
    B = sp.random(n, n, density=density, format="csr", dtype=np.float64,
                  random_state=rng)
    return (A + 1j * B).tocsr()


def hermitian_spd(n, seed=0, shift=20.0):
    B = random_complex_csr(n, seed=seed)
    return (B + B.conj().T + sp.eye(n) * shift).tocsr()


def cvec(n, seed=1):
    rng = np.random.default_rng(seed)
    return rng.random(n) + 1j * rng.random(n)


def hermitian(n, seed, hi, density=0.15):
    B = random_complex_csr(n, density=density, seed=seed)
    return (B + B.conj().T).tocsr() + sp.diags(np.linspace(1, hi, n))


def ghep_pair(seed=26, n=80):
    C = random_complex_csr(n, density=0.15, seed=seed)
    A = (C + C.conj().T).tocsr() + sp.diags(np.linspace(1, 30, n))
    B = (0.1 * (C + C.conj().T)).tocsr() + sp.eye(n) * 5.0
    return A, B


def _eps(mod, comm, A, B=None, ptype="hep", nev=3, eps_type="krylovschur",
         st=None, target=None, which=None):
    dt = np.complex128 if mod is tps else C128
    eps = mod.EPS().create(comm)
    if B is None:
        eps.set_operators(mod.Mat.from_scipy(comm, A, dtype=dt))
    else:
        eps.set_operators(mod.Mat.from_scipy(comm, A, dtype=dt),
                          mod.Mat.from_scipy(comm, B, dtype=dt))
    eps.set_problem_type(ptype)
    eps.set_type(eps_type)
    eps.set_dimensions(nev=nev)
    if which is not None:
        eps.set_which_eigenpairs(which)
    if target is not None:
        eps.set_target(target)
    if st is not None:
        eps.st.set_type(st)
    eps.solve()
    return eps


def _both(ndev, *args, **kw):
    j = _eps(tps, tps.DeviceComm(n_devices=ndev), *args, **kw)
    p = _eps(pt, pt.DeviceComm(ndev, device="cpu"), *args, **kw)
    return j, p


def _assert_pairs(j, p, count, lam_tol=LAM_TOL):
    """Restarts and nconv equal, eigenvalues within ``lam_tol``, each
    eigenvector the JAX one up to a unit complex factor, and the residual
    the JAX package computes."""
    assert p.get_converged() == j.get_converged() >= count
    assert p.get_iteration_number() == j.get_iteration_number()
    for i in range(count):
        lj, lp = j.get_eigenvalue(i), p.get_eigenvalue(i)
        assert isinstance(lp, complex)
        assert abs(lp - lj) <= lam_tol * max(1.0, abs(lj)), (i, lp, lj)
        vj, vp = j._eigenvectors[i], p._eigenvectors[i]
        phase = np.vdot(vp, vj)
        phase /= abs(phase)
        assert np.linalg.norm(vp * phase - vj) <= 1e-7
        ep = p.compute_error(i)
        assert isinstance(ep, float)
        assert abs(ep - j.compute_error(i)) <= 1e-9


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_hermitian_krylovschur(ndev):
    """HEP: conjugating CGS2 projections and a complex Hermitian projected
    problem; the four largest-magnitude pairs against dense ``eigh``."""
    H = hermitian(120, 21, 50)
    j, p = _both(ndev, H, nev=4)
    _assert_pairs(j, p, 4)
    lam = np.linalg.eigvalsh(H.toarray())
    lam = lam[np.argsort(-np.abs(lam))]
    for i in range(4):
        np.testing.assert_allclose(p.get_eigenvalue(i).real, lam[i],
                                   rtol=1e-9)
        assert abs(p.get_eigenvalue(i).imag) < 1e-9
        assert p.compute_error(i) < 1e-7


def test_nhep_complex_schur():
    """NHEP: the thick restart on the complex (triangular) Schur form."""
    n = 80
    A = (random_complex_csr(n, density=0.15, seed=25)
         + sp.diags(np.linspace(1, 40, n))).tocsr()
    j, p = _both(8, A, ptype="nhep")
    _assert_pairs(j, p, 3, lam_tol=1e-9)
    lam = np.linalg.eigvals(A.toarray())
    lam = lam[np.argsort(-np.abs(lam))]
    for i in range(3):
        assert abs(p.get_eigenvalue(i) - lam[i]) < 1e-6
        assert p.compute_error(i) < 1e-6


@pytest.mark.parametrize("eps_type", ["krylovschur", "lanczos", "lapack"])
def test_ghep(eps_type):
    """Generalized complex Hermitian ``A x = lambda B x`` (B-inner-product
    Lanczos), the three ported types."""
    A, B = ghep_pair()
    j, p = _both(8, A, B, ptype="ghep", eps_type=eps_type)
    _assert_pairs(j, p, 3)
    lam = scipy.linalg.eigh(A.toarray(), B.toarray(), eigvals_only=True)
    lam = lam[np.argsort(-np.abs(lam))]
    for i in range(3):
        np.testing.assert_allclose(p.get_eigenvalue(i).real, lam[i],
                                   rtol=1e-8)


@pytest.mark.parametrize("st", ["sinvert", "cayley"])
def test_interior_sinvert_cayley(st):
    """Shift-and-invert and Cayley on a complex Hermitian operator: the
    pairs nearest the target through a complex128 host factorization."""
    H = hermitian(80, 27, 30)
    j, p = _both(8, H, nev=2, st=st, target=15.0,
                 which="target_magnitude")
    _assert_pairs(j, p, 2)
    lam = np.linalg.eigvalsh(H.toarray())
    near = np.sort(lam[np.argsort(np.abs(lam - 15.0))][:2])
    got = np.sort([p.get_eigenvalue(i).real for i in range(2)])
    np.testing.assert_allclose(got, near, rtol=1e-8)


def test_shift_st_and_lapack_hep():
    """ST shift and the dense lapack type on a complex HEP."""
    H = hermitian_spd(60, seed=22, shift=30.0)
    comm = pt.DeviceComm(4, device="cpu")
    eps = pt.EPS().create(comm)
    eps.set_operators(pt.Mat.from_scipy(comm, H, dtype=C128))
    eps.set_problem_type("hep")
    eps.st.set_shift(2.0)
    eps.set_dimensions(nev=2)
    eps.solve()
    lap = _eps(pt, comm, H, nev=2, eps_type="lapack")
    for i in range(2):
        assert abs(eps.get_eigenvalue(i) - lap.get_eigenvalue(i)) <= 1e-9
    jl = _eps(tps, tps.DeviceComm(n_devices=4), H, nev=2, eps_type="lapack")
    _assert_pairs(jl, lap, 2)


def test_complex_eigenpair_extraction():
    """``get_eigenpair`` on complex Vecs: ``vr`` carries the whole complex
    eigenvector and ``vi`` is zero; the pair satisfies ``A v = lambda v``."""
    H = hermitian_spd(60, seed=22, shift=30.0)
    comm = pt.DeviceComm(8, device="cpu")
    M = pt.Mat.from_scipy(comm, H, dtype=C128)
    eps = pt.EPS().create(comm)
    eps.set_operators(M)
    eps.set_problem_type("hep")
    eps.solve()
    assert eps.get_converged() >= 1
    vr, vi = M.get_vecs()
    lam = eps.get_eigenpair(0, vr, vi)
    v = vr.to_numpy()
    assert np.linalg.norm(np.imag(v)) > 0
    assert np.allclose(vi.to_numpy(), 0)
    assert np.linalg.norm(H @ v - lam.real * v) < 1e-8


@pytest.mark.parametrize("eps_type", ["lobpcg", "power", "subspace",
                                      "arnoldi", "gd"])
def test_unported_types_raise_naming_item_7(eps_type):
    """The JAX package runs these on complex operators
    (``test_eps_lobpcg_complex_hermitian``, ``_ghep``,
    ``test_power_subspace_complex_dominant``); the port does not yet."""
    with pytest.raises(NotImplementedError, match="item 7"):
        pt.EPS().set_type(eps_type)


# ---- the fused program ------------------------------------------------------

def _mega(mod, ndev, A, ksp_type, mega, many=False):
    comm = (tps.DeviceComm(n_devices=ndev) if mod is tps
            else pt.DeviceComm(ndev, device="cpu"))
    M = mod.Mat.from_scipy(comm, A, dtype=(np.complex128 if mod is tps
                                           else C128))
    ksp = mod.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=1e-10, max_it=500)
    ksp.megasolve = mega
    ksp.sstep_s = 4
    n = A.shape[0]
    if many:
        B = np.stack([A @ cvec(n, s) for s in (1, 2, 3)], axis=1)
        X = np.zeros(B.shape, np.complex128)
        res = ksp.solve_many(B, X)
        return (list(res.iterations), [int(r) for r in res.reasons],
                np.asarray(res.X if hasattr(res, "X") and res.X is not None
                           else X))
    x, bv = M.get_vecs()
    bv.set_global(A @ cvec(n, 11))
    res = ksp.solve(bv, x)
    return res.iterations, int(res.reason), x.to_numpy()


@pytest.mark.parametrize("ksp_type", ["cg", "pipecg", "sstep"])
@pytest.mark.parametrize("ndev", [1, 8])
def test_megasolve_complex(ksp_type, ndev):
    """``-ksp_megasolve`` on a complex Hermitian operator runs the general
    plan with conjugating dots: against the port's unfused loop (cg and
    pipecg bit for bit; sstep's coefficient recurrences run on the device
    there, on the host unfused) and the JAX package's fused program."""
    A = hermitian_spd(90, seed=21)
    fused = _mega(pt, ndev, A, ksp_type, True)
    plain = _mega(pt, ndev, A, ksp_type, False)
    jax_ = _mega(tps, ndev, A, ksp_type, True)
    assert fused[:2] == plain[:2] == jax_[:2]
    if ksp_type == "sstep":
        assert np.linalg.norm(fused[2] - plain[2]) <= X_TOL * np.linalg.norm(
            plain[2])
    else:
        assert np.array_equal(fused[2], plain[2])
    assert np.linalg.norm(fused[2] - jax_[2]) <= X_TOL * np.linalg.norm(
        jax_[2])


def test_megasolve_complex_batched():
    """The batched fused program (``solve_many``) on a complex operator:
    per-column iterations and reasons equal to the JAX package's."""
    A = hermitian_spd(90, seed=21)
    fused = _mega(pt, 4, A, "cg", True, many=True)
    jax_ = _mega(tps, 4, A, "cg", True, many=True)
    assert fused[:2] == jax_[:2]
    assert np.linalg.norm(fused[2] - jax_[2]) <= X_TOL * np.linalg.norm(
        jax_[2])


def test_megasolve_complex_no_stencil_fastpath():
    """The stencil fast path stays off for complex operators (JAX
    ``megasolve.py:127``); a guarded mode, which raised before the fused
    guarded modes were ported, runs: ABFT without the checksums raises, and
    with them the complex fused guarded solve equals the unfused guarded
    one (iterations, checks) and adds no error."""
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, hermitian_spd(40), dtype=C128)
    pc = pt.PC()
    pc.set_type("jacobi")
    pc.set_up(M)
    assert not megasolve.megasolve_stencil_supported("cg", pc, M)
    with pytest.raises(ValueError, match="checksum"):
        megasolve.build_megasolve_program(comm, "cg", pc, M, abft=True)
    b = np.random.default_rng(8).standard_normal(40) * (1 + 1j)
    out = []
    for fused in (False, True):
        ksp = pt.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-10)
        ksp.abft = True
        ksp.megasolve = fused
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((res.iterations, res.abft_checks, x.to_numpy()))
    assert out[0][:2] == out[1][:2]
    assert np.linalg.norm(out[0][2] - out[1][2]) <= 1e-9 * np.linalg.norm(
        out[0][2])


def test_refined_ksp_complex_matches_jax():
    """``RefinedKSP`` given a complex operator does what the JAX package's
    does: both build their inner and outer operators from the real parts
    (numpy's ComplexWarning), so the answers agree."""
    A = hermitian_spd(60, seed=5)
    b = A @ cvec(60, 6)
    out = []
    for mod, comm in ((tps, tps.DeviceComm(n_devices=4)),
                      (pt, pt.DeviceComm(4, device="cpu"))):
        rk = mod.RefinedKSP().create(comm)
        rk.set_inner_precision("f32")
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            rk.set_operators(A)
            rk.set_type("cg")
            rk.inner.get_pc().set_type("jacobi")
            rk.set_tolerances(rtol=1e-10)
            x, res = rk.solve(b)
        assert any(issubclass(m.category, np.exceptions.ComplexWarning)
                   for m in w)
        out.append((np.asarray(x), res.iterations, int(res.reason)))
    assert out[0][1:] == out[1][1:]
    assert np.iscomplexobj(out[1][0]) == np.iscomplexobj(out[0][0])
    assert np.linalg.norm(out[1][0] - out[0][0]) <= 1e-10 * np.linalg.norm(
        out[0][0])
