"""The port's LOBPCG against the JAX package on the CPU, both routes.

The cases of the JAX package's ``TestLOBPCG`` (``tests/test_eps.py:407``:
smallest, largest, generalized and the restrictions), the complex
Hermitian and generalized cases (``tests/test_complex.py:394``, ``:417``),
the 8^3 Poisson stencil, whose block products are the batched stencil
apply (the plain version of ``stencil7_apply_many`` here), the start block
``_lobpcg_seed`` and the route choice. The limits, the helpers and the
host-read formulas are ``tests/test_torch_eps_types.py``'s: the device
route against the JAX package's fused loop (``TPU_SOLVE_EPS_FUSED``
unset), the host route against its host loop (``TPU_SOLVE_EPS_FUSED=0``),
fp64 (complex128), on 1, 2, 4 and 8 shards.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers import eps as jax_eps  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops import stencil as port_stencil  # noqa: E402,E501
from mpi_petsc4py_example_tpu_torch.solvers import eps as port_eps  # noqa: E402,E501

from test_complex import hermitian_poisson2d  # noqa: E402
from test_torch_eps_types import (  # noqa: E402
    C128, SYNCS, assert_same, clean_options, comms, jax_its_range, mat,
    solve_both, tridiag)

__all__ = ["clean_options"]     # the autouse fixture, used by import


# ---- lobpcg (tests/test_eps.py TestLOBPCG) --------------------------------------

@pytest.mark.parametrize("route,ndev", [("device", 1), ("device", 2),
                                        ("device", 4), ("device", 8),
                                        ("host", 2)])
def test_lobpcg_smallest_matches_jax(monkeypatch, route, ndev):
    A = tridiag()
    jE, pE = solve_both(monkeypatch, ndev, A, "lobpcg", route,
                        which="smallest_real", nev=3, tol=1e-9, max_it=300)
    assert_same(jE, pE, route, its_band=2)
    assert pE.get_converged() >= 3
    exact = np.linalg.eigvalsh(A.toarray())[:3]
    np.testing.assert_allclose(np.sort(pE._eigenvalues), exact, rtol=1e-6)


@pytest.mark.parametrize("route,ndev", [("device", 2), ("host", 1)])
def test_lobpcg_largest_matches_jax(monkeypatch, route, ndev):
    jE, pE = solve_both(monkeypatch, ndev, tridiag(), "lobpcg", route,
                        which="largest_real", nev=2, tol=1e-9, max_it=300)
    assert_same(jE, pE, route, its_band=2)
    assert pE.get_converged() >= 2


@pytest.mark.parametrize("route,ndev", [("device", 4), ("host", 1)])
def test_lobpcg_generalized_matches_jax(monkeypatch, route, ndev):
    import scipy.linalg
    n = 50
    A = tridiag(n)
    Bd = 1.0 + np.random.default_rng(1).random(n)
    jE, pE = solve_both(monkeypatch, ndev, A, "lobpcg", route,
                        B=sp.diags(Bd).tocsr(), ptype="ghep",
                        which="smallest_real", nev=2, tol=1e-9, max_it=400)
    assert_same(jE, pE, route, its_band=2)
    exact = scipy.linalg.eigh(A.toarray(), np.diag(Bd),
                              eigvals_only=True)[:2]
    np.testing.assert_allclose(np.sort(pE._eigenvalues), exact, rtol=1e-6)


@pytest.mark.parametrize("which,route", [("smallest_real", "device"),
                                         ("largest_real", "device"),
                                         ("smallest_real", "host")])
def test_lobpcg_complex_hermitian_matches_jax(monkeypatch, which, route):
    """``test_eps_lobpcg_complex_hermitian`` (``tests/test_complex.py:394``)
    on 2 shards: the projections conjugate the projector rows. The phased
    Laplacian's second and third pairs are degenerate, so its eigenvectors
    are held by their residuals, not entry by entry."""
    A = hermitian_poisson2d(9, theta=0.4)
    jE, pE = solve_both(monkeypatch, 2, A, "lobpcg", route, which=which,
                        nev=3, tol=1e-9, max_it=300)
    assert_same(jE, pE, route, its_band=2, vectors=False)
    for i in range(3):
        assert pE.compute_error(i) <= 1e-6


@pytest.mark.parametrize("route", ["device", "host"])
def test_lobpcg_complex_ghep_matches_jax(monkeypatch, route):
    """``test_eps_lobpcg_complex_ghep`` (``tests/test_complex.py:417``):
    the device route's count within the JAX package's own range over
    1, 2 and 4 shards (111-137, as over 1/2/4/8); the host route's is 139
    on each, and the port's equal."""
    A = hermitian_poisson2d(8, theta=0.25)
    n = A.shape[0]
    rng = np.random.default_rng(41)
    B = sp.diags(1.0 + rng.random(n)).tocsr().astype(complex)
    cfg = dict(B=B, ptype="ghep", which="smallest_real", nev=2, tol=1e-9,
               max_it=400)
    jE, pE = solve_both(monkeypatch, 4, A, "lobpcg", route, **cfg)
    if route == "host":
        assert_same(jE, pE, route)
    else:
        assert_same(jE, pE, route, its_range=jax_its_range(
            monkeypatch, jE, A, "lobpcg", route, **cfg))


@pytest.mark.parametrize("ndev", [1, 2])
def test_lobpcg_stencil_8_matches_jax_and_the_closed_form(monkeypatch, ndev):
    """The 8^3 Poisson stencil, the 3 smallest pairs: the block products go
    through the stencil's batched apply (on the CPU the plain version of
    ``stencil7_apply_many``, once a shard for the start block and once for
    every trial basis built, i.e. ``max(its, 1)`` times), the eigenvalues
    against the closed form sum 4 sin^2(k pi / 18) over the axes: lambda(1,
    1,1), then lambda(2,1,1) twice (a triple eigenvalue, so the vectors are
    held by their residuals)."""
    monkeypatch.delenv("TPU_SOLVE_EPS_FUSED", raising=False)
    calls = []
    plain = port_stencil.stencil3d_apply_many_plain

    def counted(*a, **k):
        calls.append(a[0].shape[0])
        return plain(*a, **k)

    monkeypatch.setattr(port_stencil, "stencil3d_apply_many_plain", counted)
    out = []
    for pkg, comm in comms(ndev):
        op = (JaxStencil(comm, 8, dtype=jnp.float64) if pkg is tps
              else pt.StencilPoisson3D(comm, 8, dtype=torch.float64))
        E = pkg.EPS().create(comm).set_operators(op)
        E.set_problem_type("hep").set_type("lobpcg")
        E.set_which_eigenpairs("smallest_real")
        E.set_dimensions(nev=3).set_tolerances(tol=1e-8, max_it=500)
        E.solve()
        out.append(E)
    jE, pE = out
    assert_same(jE, pE, its_band=2, vectors=False, errors=False)
    its = pE.get_iteration_number()
    # the start block (m rows), then 3m rows a built basis
    assert calls == [3] * ndev + [9] * ndev * (its - 1)
    s = lambda k: 4 * np.sin(k * np.pi / 18) ** 2
    want = [3 * s(1), s(2) + 2 * s(1), s(2) + 2 * s(1)]
    np.testing.assert_allclose(np.sort(pE._eigenvalues), want, rtol=1e-9)
    for i in range(3):
        assert pE.compute_error(i) <= 1e-6


@pytest.mark.parametrize("op,dtype", [
    ("mat", np.float64), ("mat", np.complex128), ("stencil", np.float64),
    ("shell", np.float64), ("shell", np.complex128)])
def test_lobpcg_seed_equals_jax(op, dtype):
    """``_lobpcg_seed``: the start block and the Jacobi inverse are the JAX
    package's arrays, bit for bit (a shell without a diagonal gets ones;
    the stencil is real)."""
    n, m = 64, 3
    A = tridiag(n) * 3.0 + sp.eye(n)
    jc, pc = tps.DeviceComm(n_devices=2), pt.DeviceComm(2, device="cpu")
    if op == "mat":
        jop = tps.Mat.from_scipy(jc, A.astype(dtype), dtype=dtype)
        pop = pt.Mat.from_scipy(pc, A.astype(dtype),
                                dtype=C128 if dtype is np.complex128
                                else torch.float64)
    elif op == "stencil":
        jop = JaxStencil(jc, 4, dtype=jnp.float64)
        pop = pt.StencilPoisson3D(pc, 4, dtype=torch.float64)
    else:
        Ad = A.toarray()
        jop = tps.ShellMat(jc, n, lambda v: jnp.asarray(Ad) @ v)
        pop = pt.ShellMat(pc, n, lambda v: torch.tensor(Ad) @ v)
    pdt = C128 if dtype is np.complex128 else torch.float64
    X0j, dj = jax_eps._lobpcg_seed(jop, n, m, np.dtype(dtype))
    X0p, dp = port_eps._lobpcg_seed(pop, n, m, pdt)
    np.testing.assert_array_equal(X0p, X0j)
    np.testing.assert_array_equal(dp, dj)
    assert X0p.dtype == X0j.dtype and dp.dtype == dj.dtype


def test_lobpcg_restrictions_match_jax():
    """The JAX package's refusals and their messages: a non-extreme
    selection, a non-Hermitian problem, a spectral transform and a block
    past the cap of 16."""
    A = tridiag(20)
    cases = [dict(which=None, ptype="hep", match="extreme eigenvalues"),
             dict(which="smallest_real", ptype="nhep",
                  match="Hermitian problem"),
             dict(which="smallest_real", ptype="hep", st="sinvert",
                  match="spectral transform"),
             dict(which="smallest_real", ptype="hep", nev=17,
                  match="caps the block size at 16")]
    for case in cases:
        for pkg, comm in comms(2):
            E = pkg.EPS().create(comm).set_operators(mat(pkg, comm, A))
            E.set_problem_type(case["ptype"]).set_type("lobpcg")
            if case["which"]:
                E.set_which_eigenpairs(case["which"])
            if case.get("st"):
                E.get_st().set_type(case["st"])
            E.set_dimensions(nev=case.get("nev"))
            with pytest.raises(ValueError, match=case["match"]):
                E.solve()


# ---- the routes: port-side choices (ROADMAP.md Queue C) -------------------------

@pytest.mark.parametrize("env,route", [(None, "device"), ("1", "device"),
                                       ("true", "device"), ("0", "host"),
                                       ("false", "host")])
def test_device_route_at_every_size(monkeypatch, env, route):
    """The port takes the device route at every n, also below the JAX
    package's n >= 4096 off the CPU (which guards a TPU compile-cache
    load), unless ``TPU_SOLVE_EPS_FUSED`` is 0/false or a monitor is set:
    a 20-row problem's reads follow the route's formula."""
    if env is None:
        monkeypatch.delenv("TPU_SOLVE_EPS_FUSED", raising=False)
    else:
        monkeypatch.setenv("TPU_SOLVE_EPS_FUSED", env)
    assert port_eps._device_route(False) == (route == "device")
    assert not port_eps._device_route(True)
    comm = pt.DeviceComm(2, device="cpu")
    E = pt.EPS().create(comm).set_operators(pt.Mat.from_scipy(
        comm, tridiag(20)))
    E.set_problem_type("hep").set_type("lobpcg")
    E.set_which_eigenpairs("smallest_real").set_dimensions(nev=2)
    E.solve()
    assert E.get_converged() >= 2
    assert E.result.host_syncs == SYNCS[("lobpcg", route)](E)
