"""The Krylov types of ROADMAP.md Queue A item 5.1 against the JAX package:
cgs, tfqmr, cr, minres, symmlq, chebyshev, richardson, gcr, fcg, lgmres,
bcgsl, fbcgs and fbcgsr.

Both packages solve the same numpy problem, fp64, on the same shard count
(the JAX side on the forced 8-device CPU mesh of ``conftest.py``; assembled
matrices carried across as ``Mat.host_csr``): iterations (restarted
iterations for lgmres, ``ell`` steps for bcgsl) and reasons equal, iterates
within 1e-10 relative. The operators:

* the symmetric positive definite ones, for every type: the 8x12x16
  stencil with PC jacobi, and ``poisson2d(12)`` on the DIA route and, with
  its rows and columns permuted, on the ELL route, each with PC
  none/jacobi/bjacobi;
* the unsymmetric ``convdiff2d`` of ``tests/test_ksp.py:566-660`` with PC
  jacobi/bjacobi/ilu, for the types that take one (lgmres with
  ``-ksp_lgmres_augment`` 2 and 3, bcgsl with ``-ksp_bcgsl_ell`` 2 and 3);
* ``poisson2d(12) - 3 I``, symmetric indefinite, for minres and symmlq.

Each type's host reads are pinned: one at set-up, one per iteration (per
restart cycle for lgmres, per outer step of ``ell`` iterations for bcgsl),
and one more for the types that report the exact final residual.
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
    convdiff2d)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson2d_csr)
from mpi_petsc4py_example_tpu_torch.solvers import krylov  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    from_host_csr)

CR = pt.ConvergedReason
X_TOL = 1e-10
RTOL = 1e-8
# fbcgs and fbcgsr stagnate near rtol on these symmetric operators, where
# their counts turn on rounding (ROADMAP.md Queue C, reference-side notes):
# they are held exactly on the unsymmetric ones, and within the JAX
# package's own spread here
SPD_TYPES = ["cr", "fcg", "minres", "symmlq", "chebyshev", "richardson",
             "gcr", "cgs", "tfqmr", "bcgsl"]
GRID = (8, 12, 16)


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _permuted(A, seed=5):
    """``P A P^T`` for a seeded permutation: the same spectrum, and
    diagonals past the DIA cap, so a Mat takes the ELL route."""
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


OPERATORS = {
    "dia": lambda: poisson2d_csr(12),
    "ell": lambda: _permuted(poisson2d_csr(12)),
    "cd12": lambda: convdiff2d(12, beta=0.4),
    "cd16": lambda: convdiff2d(16, beta=0.4),
    "cd20": lambda: convdiff2d(20, beta=0.3),
    "indefinite": lambda: (poisson2d_csr(12) - 3.0 * sp.eye(144)).tocsr(),
    "indefinite_mild": lambda: (poisson2d_csr(12)
                                - 0.5 * sp.eye(144)).tocsr(),
    "p2d10": lambda: poisson2d_csr(10),
    "cd10": lambda: convdiff2d(10, beta=0.3),
}


def _configure(ksp, ksp_type, pc_type, opts, max_it):
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=opts.get("rtol", RTOL), atol=0.0, max_it=max_it)
    for attr, value in opts.items():
        if attr == "rtol":
            continue
        if attr == "norm":
            ksp.set_norm_type(value)
        else:
            setattr(ksp, attr, value)
    return ksp


def _mat_pair(name, ndev, b):
    A = OPERATORS[name]()
    jcomm = tps.DeviceComm(n_devices=ndev)
    M = tps.Mat.from_scipy(jcomm, A)
    m = from_host_csr(pt.DeviceComm(ndev, device="cpu"), M.shape,
                      M.host_csr, b)[0]
    return A, M, m


def _stencil_pair(ndev):
    return (JaxStencil(tps.DeviceComm(n_devices=ndev), *GRID,
                       dtype=jnp.float64),
            pt.StencilPoisson3D(pt.DeviceComm(ndev, device="cpu"), *GRID,
                                dtype=torch.float64))


def _solve(op, b, ksp_type, pc_type, opts, max_it):
    ksp = _configure(type_of(op).KSP().create(op.comm), ksp_type, pc_type,
                     opts, max_it)
    ksp.set_operators(op)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return res, x.to_numpy(), ksp


def type_of(op):
    return pt if type(op).__module__.startswith(pt.__name__) else tps


def _both(jop, op, b, ksp_type, pc_type, opts=None, max_it=5000):
    """The JAX solve, then the port's; returns ``(jres, jx, res, x, ksp,
    collectives)``, the last the port comm's collective calls of the
    solve."""
    opts = dict(opts or {})
    jres, jx, _ = _solve(jop, b, ksp_type, pc_type, opts, max_it)
    before = dict(op.comm.collectives)
    res, x, ksp = _solve(op, b, ksp_type, pc_type, opts, max_it)
    calls = {k: v - before[k] for k, v in op.comm.collectives.items()}
    return jres, jx, res, x, ksp, calls


def _assert_same(jres, jx, res, x, tol=X_TOL):
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason)), (res, jres)
    scale = max(np.abs(jx).max(), 1.0)
    np.testing.assert_allclose(x, jx, rtol=0, atol=tol * scale)


# the types whose result reports the exact ||b - A x||, read after the loop
_FINAL_READ = ("cgs", "tfqmr", "minres", "symmlq", "bcgsl", "fbcgsr")


def expected_syncs(ksp, res) -> int:
    """One read at set-up, one per iteration, restart cycle (lgmres) or
    outer step (bcgsl), one more for a final true residual."""
    t = ksp.get_type()
    per = {"lgmres": ksp.restart + ksp.lgmres_augment,
           "bcgsl": ksp.bcgsl_ell}.get(t, 1)
    return 1 + res.iterations // per + (t in _FINAL_READ)


def _rhs(n, seed=3):
    return np.random.default_rng(seed).standard_normal(n)


# ---- the symmetric positive definite operators, every type -------------------

@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("ksp_type", SPD_TYPES)
def test_spd_type_on_stencil_matches_jax(ksp_type, ndev):
    jop, op = _stencil_pair(ndev)
    jres, jx, res, x, ksp, _ = _both(jop, op, _rhs(op.shape[0], ndev),
                                     ksp_type, "jacobi")
    assert res.converged
    _assert_same(jres, jx, res, x)
    assert res.host_syncs == expected_syncs(ksp, res)


@pytest.mark.parametrize("ksp_type", ["fbcgs", "fbcgsr"])
def test_bicgstab_family_on_spd_within_jax_spread(ksp_type):
    """On the symmetric stencil the JAX package's own counts move with the
    device count (fbcgs 41-44, fbcgsr 41-46 for these right-hand sides on
    1/2/4/8 devices): the port's, on 1 and 4 shards, lie within the JAX
    counts of 1/2/4/8 devices, with the same reason and a true residual
    that meets rtol."""
    b = _rhs(int(np.prod(GRID)), 1)
    jits = []
    for nd in (1, 2, 4, 8):
        jop = JaxStencil(tps.DeviceComm(n_devices=nd), *GRID,
                         dtype=jnp.float64)
        jres, _, _ = _solve(jop, b, ksp_type, "jacobi", {}, 5000)
        assert jres.reason == CR.CONVERGED_RTOL
        jits.append(jres.iterations)
    A = pt.poisson3d_csr(*GRID)
    for nd in (1, 4):
        op = pt.StencilPoisson3D(pt.DeviceComm(nd, device="cpu"), *GRID,
                                 dtype=torch.float64)
        res, x, ksp = _solve(op, b, ksp_type, "jacobi", {}, 5000)
        assert res.reason == CR.CONVERGED_RTOL
        assert min(jits) - 1 <= res.iterations <= max(jits) + 1, (jits, res)
        assert np.linalg.norm(b - A @ x) <= 1.01 * RTOL * np.linalg.norm(b)
        assert res.host_syncs == expected_syncs(ksp, res)


# the DIA route on two shards, the ELL route on four (on one device PC
# bjacobi is the exact inverse of this small matrix, and bcgsl then breaks
# down in the JAX package where 2/4/8 devices converge)
MAT_CASES = [("dia", 2), ("ell", 4)]


@pytest.mark.parametrize("pc_type", ["none", "jacobi", "bjacobi"])
@pytest.mark.parametrize("route,ndev", MAT_CASES)
@pytest.mark.parametrize("ksp_type", SPD_TYPES)
def test_spd_type_on_mat_matches_jax(ksp_type, route, ndev, pc_type):
    b = _rhs(144)
    A, M, m = _mat_pair(route, ndev, b)
    assert m.spmv_route(m.comm).startswith(route)
    jres, jx, res, x, ksp, _ = _both(M, m, b, ksp_type, pc_type)
    _assert_same(jres, jx, res, x)
    if res.converged:
        assert res.host_syncs == expected_syncs(ksp, res)
    else:
        # Richardson without a preconditioner: |1 - lambda_max| > 1
        assert (ksp_type, pc_type, res.reason) == ("richardson", "none",
                                                   CR.DIVERGED_DTOL)


# ---- the unsymmetric operators -------------------------------------------------

UNSYM_CASES = [("cgs", {}), ("tfqmr", {}), ("gcr", {}), ("fbcgs", {}),
               ("fbcgsr", {}),
               ("lgmres", {"restart": 10, "lgmres_augment": 2}),
               ("lgmres", {"restart": 10, "lgmres_augment": 3}),
               ("bcgsl", {"bcgsl_ell": 2}), ("bcgsl", {"bcgsl_ell": 3})]


@pytest.mark.parametrize("pc_type", ["jacobi", "bjacobi", "ilu"])
@pytest.mark.parametrize("ksp_type,opts", UNSYM_CASES,
                         ids=[f"{t}-{'-'.join(map(str, o.values()))}"
                              for t, o in UNSYM_CASES])
def test_unsymmetric_type_matches_jax(ksp_type, opts, pc_type):
    b = _rhs(256, 11)
    _, M, m = _mat_pair("cd16", 2, b)
    jres, jx, res, x, ksp, _ = _both(M, m, b, ksp_type, pc_type, opts)
    assert res.converged
    _assert_same(jres, jx, res, x)
    assert res.host_syncs == expected_syncs(ksp, res)
    if ksp_type == "lgmres":
        assert res.iterations % (10 + opts["lgmres_augment"]) == 0


@pytest.mark.parametrize("name,ndev", [("cd12", 1), ("cd20", 4)])
@pytest.mark.parametrize("ksp_type", ["gcr", "lgmres", "tfqmr"])
def test_unsymmetric_sizes_and_shards(ksp_type, name, ndev):
    b = _rhs(OPERATORS[name]().shape[0], 5)
    _, M, m = _mat_pair(name, ndev, b)
    jres, jx, res, x, _, _ = _both(M, m, b, ksp_type, "bjacobi")
    assert res.converged
    _assert_same(jres, jx, res, x)


def test_lgmres_without_augmentation_is_gmres():
    """``-ksp_lgmres_augment 0`` runs GMRES(restart), in both packages."""
    b = _rhs(256, 2)
    _, M, m = _mat_pair("cd16", 2, b)
    jres, jx, res, x, _, _ = _both(M, m, b, "lgmres", "jacobi",
                                   {"restart": 12, "lgmres_augment": 0})
    _assert_same(jres, jx, res, x)
    _, _, gres, gx, _, _ = _both(M, m, b, "gmres", "jacobi",
                                 {"restart": 12})
    assert gres.iterations == res.iterations
    np.testing.assert_array_equal(gx, x)


# ---- symmetric indefinite: minres and symmlq -----------------------------------

@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("ksp_type", ["minres", "symmlq"])
def test_symmetric_indefinite_matches_jax(ksp_type, ndev):
    """``poisson2d(12) - 0.5 I`` (eigenvalues -0.38 to 7.38), where the
    JAX package's counts agree across device counts: exact parity."""
    b = _rhs(144, 7)
    A, M, m = _mat_pair("indefinite_mild", ndev, b)
    ev = np.linalg.eigvalsh(A.toarray())
    assert ev.min() < 0 < ev.max()
    jres, jx, res, x, ksp, _ = _both(M, m, b, ksp_type, "none")
    assert res.converged
    _assert_same(jres, jx, res, x)
    assert np.linalg.norm(b - A @ x) <= 1.01 * RTOL * np.linalg.norm(b)
    assert res.host_syncs == expected_syncs(ksp, res)


@pytest.mark.parametrize("ksp_type", ["minres", "symmlq"])
def test_shifted_laplacian_within_jax_spread(ksp_type):
    """``poisson2d(12) - 3 I`` with PC none (JAX ``tests/test_ksp.py:575``):
    its eigenvalue nearest zero is 0.05 and the JAX package's own counts
    move with the device count (minres 93/93/91/91, symmlq 92/92/90/90 on
    1/2/4/8 devices). The port's, on 1 and 4 shards, lie within them, with
    the same reason and a true residual that meets rtol."""
    b = _rhs(144, 7)
    A = OPERATORS["indefinite"]()
    jits = []
    for nd in (1, 2, 4, 8):
        jres, _, _ = _solve(tps.Mat.from_scipy(tps.DeviceComm(n_devices=nd),
                                               A), b, ksp_type, "none", {},
                            5000)
        assert jres.reason == CR.CONVERGED_RTOL
        jits.append(jres.iterations)
    assert max(jits) > min(jits)
    for nd in (1, 4):
        _, _, m = _mat_pair("indefinite", nd, b)
        res, x, ksp = _solve(m, b, ksp_type, "none", {}, 5000)
        assert res.reason == CR.CONVERGED_RTOL
        assert min(jits) <= res.iterations <= max(jits), (jits, res)
        assert np.linalg.norm(b - A @ x) <= 1.01 * RTOL * np.linalg.norm(b)


# ---- the natural norm ------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("ksp_type", ["fcg", "cr"])
def test_natural_norm_matches_jax(ksp_type, ndev):
    b = _rhs(144, 9)
    _, M, m = _mat_pair("dia", ndev, b)
    jres, jx, res, x, ksp, _ = _both(M, m, b, ksp_type, "jacobi",
                                     {"norm": "natural"})
    assert ksp.get_norm_type() == "natural"
    assert res.converged
    _assert_same(jres, jx, res, x)
    # the natural norm is what the loop monitored: it differs from ||r||
    dres, _, _, _, _, _ = _both(M, m, b, ksp_type, "jacobi")
    assert dres.iterations != res.iterations or \
        dres.residual_norm != res.residual_norm


def test_natural_types_and_norm_rules_like_jax():
    assert krylov.NATURAL_TYPES == jax_krylov.NATURAL_TYPES == (
        "cg", "fcg", "cr")
    comm = pt.DeviceComm(device="cpu")
    for t in ("gmres", "tfqmr", "pipecg"):
        ksp = pt.KSP().create(comm).set_type(t).set_norm_type("natural")
        with pytest.raises(ValueError, match="natural"):
            ksp._check_norm_type()
    for t, norm in (("lgmres", "preconditioned"), ("cr", "preconditioned"),
                    ("symmlq", "unpreconditioned"),
                    ("minres", "unpreconditioned")):
        assert pt.KSP().set_type(t).get_norm_type() == \
            tps.KSP().set_type(t).get_norm_type() == norm
    # the cycle-granular types refuse the norm type 'none', as in JAX
    for t in ("lgmres", "bcgsl"):
        ksp = pt.KSP().create(comm).set_type(t).set_norm_type("none")
        with pytest.raises(ValueError, match="'none' is unavailable"):
            ksp._check_norm_type()
    ksp = pt.KSP().create(comm).set_type("tfqmr").set_norm_type("none")
    ksp._check_norm_type()


def test_norm_none_runs_max_it_like_jax():
    """Norm type none: max_it iterations, reason CONVERGED_ITS."""
    b = _rhs(144, 4)
    _, M, m = _mat_pair("dia", 2, b)
    for t in ("tfqmr", "chebyshev", "fcg"):
        jres, jx, res, x, _, _ = _both(M, m, b, t, "jacobi",
                                       {"norm": "none"}, max_it=7)
        assert (res.iterations, res.reason) == (7, CR.CONVERGED_ITS)
        _assert_same(jres, jx, res, x)


# ---- fbcgsr's fused reduction ----------------------------------------------------

def test_fbcgsr_reduces_twice_an_iteration():
    """fbcgsr: ``<r^, v>`` and one fused reduction of four dots an
    iteration; BiCGStab (fbcgs) five; general-route CG three (the JAX reduce
    sites, ``ksp.py:572-575``). Set-up and the final true residual add
    their own."""
    b = _rhs(256, 13)
    _, M, m = _mat_pair("cd16", 4, b)
    jres, jx, res, x, _, calls = _both(M, m, b, "fbcgsr", "jacobi")
    _assert_same(jres, jx, res, x)
    assert calls["psum"] == 2 + 2 * res.iterations + 1
    res2, _, _ = _solve(m, b, "fbcgs", "jacobi", {}, 5000)
    before = m.comm.collectives["psum"]
    res2, _, _ = _solve(m, b, "fbcgs", "jacobi", {}, 5000)
    assert m.comm.collectives["psum"] - before == 2 + 5 * res2.iterations
    A = poisson2d_csr(12)
    cg = pt.Mat.from_scipy(m.comm, A)
    before = m.comm.collectives["psum"]
    res3, _, _ = _solve(cg, _rhs(144), "cg", "jacobi", {}, 5000)
    assert m.comm.collectives["psum"] - before == 3 + 3 * res3.iterations


# ---- monitors, max_it and the options ---------------------------------------------

@pytest.mark.parametrize("ksp_type", ["tfqmr", "lgmres", "bcgsl", "minres"])
def test_monitor_history_like_jax(ksp_type):
    """The monitored norms at the reads the loop makes anyway, as the JAX
    package records them: one entry per iteration (cycle for lgmres, outer
    step for bcgsl) and the initial norm."""
    b = _rhs(256, 6)
    _, M, m = _mat_pair("cd16", 1, b)
    hist = []
    for op in (M, m):
        ksp = _configure(type_of(op).KSP().create(op.comm), ksp_type,
                         "jacobi", {}, 5000)
        ksp.set_operators(op)
        ksp.set_convergence_history()
        x, bv = op.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        hist.append(np.asarray(ksp.get_convergence_history()))
    assert len(hist[0]) == len(hist[1])
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-8,
                               atol=1e-12 * hist[0][0])
    assert res.host_syncs == expected_syncs(ksp, res)


def test_options_reach_the_kernels():
    """``-ksp_lgmres_augment``, ``-ksp_bcgsl_ell`` and ``-ksp_gmres_restart``
    parameterise the solves they name."""
    b = _rhs(256, 1)
    _, M, m = _mat_pair("cd16", 1, b)
    for argv, t, per in ((["-ksp_lgmres_augment", "3",
                           "-ksp_gmres_restart", "8"], "lgmres", 11),
                         (["-ksp_bcgsl_ell", "3"], "bcgsl", 3)):
        pt.init(["prog", "-ksp_type", t, *argv])
        ksp = pt.KSP().create(m.comm)
        ksp.set_operators(m)
        ksp.set_from_options()
        ksp.get_pc().set_type("jacobi")
        x, bv = m.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        assert res.converged and res.iterations % per == 0


def test_max_it_and_dtol_like_jax():
    b = _rhs(256, 8)
    _, M, m = _mat_pair("cd16", 2, b)
    for t in ("cgs", "bcgsl", "lgmres", "gcr"):
        jres, jx, res, x, _, _ = _both(M, m, b, t, "none", max_it=6)
        assert res.reason == CR.DIVERGED_MAX_IT
        _assert_same(jres, jx, res, x)


def test_bcgsl_ell_must_be_positive():
    _, _, m = _mat_pair("dia", 1, _rhs(144))
    ksp = _configure(pt.KSP().create(m.comm), "bcgsl", "none",
                     {"bcgsl_ell": 0}, 100)
    ksp.set_operators(m)
    x, b = m.get_vecs()
    with pytest.raises(ValueError, match="bcgsl_ell"):
        ksp.solve(b, x)


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("pc_type", ["lu", "asm"])
@pytest.mark.parametrize("name", ["p2d10", "cd10"])
def test_bcgsl_reason_judged_on_the_true_residual(name, pc_type, ndev):
    """Under a (near-)exact PC bcgsl's first BiCG step can leave its
    recurrence residual at rounding noise on a wrong iterate, and the loop
    stops there (ROADMAP.md Queue C, port-side choices): a positive reason
    implies that the true residual meets ``max(rtol ||b||, atol)``. On
    ``convdiff2d`` with PC lu the JAX package breaks down, and so does the
    port."""
    A = OPERATORS[name]()
    b = A @ np.linspace(1.0, 2.0, A.shape[0])
    _, M, m = _mat_pair(name, ndev, b)
    res, x, ksp = _solve(m, b, "bcgsl", pc_type, {}, 5000)
    assert res.host_syncs == expected_syncs(ksp, res)
    true_res = np.linalg.norm(b - A @ x)
    assert res.residual_norm == pytest.approx(true_res, rel=1e-6)
    if res.reason > 0:
        assert true_res <= 1.01 * RTOL * np.linalg.norm(b), (res, true_res)
    if (name, pc_type) == ("cd10", "lu"):
        jres, _, _ = _solve(M, b, "bcgsl", pc_type, {}, 5000)
        assert res.reason == int(jres.reason) == CR.DIVERGED_BREAKDOWN


# ---- precision -------------------------------------------------------------------

def test_richardson_runs_at_bf16_and_the_others_raise_like_jax():
    """Richardson has a body for bfloat16 storage (JAX ``krylov.py:2179``):
    the update rounds to bf16 and the norms lift to fp32, so it stagnates
    near bf16's resolution, at the reason and (within 10%) the iteration
    of the JAX package's bf16 solve; a type without a body raises in both
    packages."""
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 8, dtype=torch.bfloat16)
    b = np.random.default_rng(0).random(512)
    x, bv = op.get_vecs()
    bv.set_global(b)
    ksp = _configure(pt.KSP().create(comm), "richardson", "jacobi",
                     {"rtol": 5e-2}, 400)
    ksp.set_operators(op)
    res = ksp.solve(bv, x)
    assert res.converged and x.dtype == torch.bfloat16
    jcomm = tps.DeviceComm(n_devices=2)
    jop = JaxStencil(jcomm, 8, dtype=jnp.bfloat16)
    jres, _, _ = _solve(jop, b, "richardson", "jacobi", {"rtol": 5e-2}, 400)
    assert res.reason == jres.reason
    assert abs(res.iterations - jres.iterations) <= 0.1 * jres.iterations
    for t in ("tfqmr", "gcr"):
        ksp.set_type(t)
        with pytest.raises(ValueError, match="cg/pipecg/sstep"):
            ksp.solve(bv, x)
        jcomm = tps.DeviceComm(n_devices=2)
        jop = JaxStencil(jcomm, 8, dtype=jnp.bfloat16)
        jksp = tps.KSP().create(jcomm).set_type(t)
        jksp.set_operators(jop)
        jx, jb = jop.get_vecs()
        with pytest.raises(ValueError, match="mixed-precision CG plans"):
            jksp.solve(jb, jx)


# ---- every JAX type is a port type -------------------------------------------------

def test_every_jax_kernel_is_ported():
    assert set(krylov.KSP_TYPES) == set(jax_krylov.KSP_KERNELS)
    assert set(krylov.KSP_KERNELS) == set(jax_krylov.KSP_KERNELS)
    assert krylov.KSP_KERNELS["fbcgs"] is krylov.bcgs_kernel
    assert not hasattr(krylov, "UNPORTED_TYPES")
