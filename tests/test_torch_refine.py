"""The PyTorch port's ``RefinedKSP`` against the JAX package's.

The same fp64 problem (the scipy matrix and ``b`` from a numpy seed) goes to
both packages' mixed-precision refinement, CG + Jacobi at rtol 1e-10, on 1
and 4 shards: the matrix-free stencil as the inner operator (``inner_op``),
and assembled inner Mats on the DIA and the ELL route (the generators of
``tests/test_mixed_precision.py``, copied).

Tolerances, by inner precision:

* f64: refine steps and inner iterations equal, ``x`` within 1e-12;
* f32: steps equal, inner iterations within one per refine step, ``x``
  within 1e-9 (fp32 sums in another order);
* bf16: the reason equal, steps within one, inner iterations within 10%;
  ``x`` is not compared. The iterates cannot be bit-equal: XLA fuses
  ``x + a p`` into an fp32 FMA on the CPU, and the dots sum in other orders,
  so each bf16 rounding of an iterate may land on the other neighbour.

In every case both fp64 relative residuals are at most ``1.05 rtol``.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson3d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers.refine import (  # noqa: E402
    RefinedKSP as JaxRefinedKSP)
from mpi_petsc4py_example_tpu.utils.dtypes import (  # noqa: E402
    inner_precision_dtype as jax_dtype)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.dtypes import (  # noqa: E402
    inner_precision_dtype)

RTOL = 1e-10
CR = pt.ConvergedReason


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _ell_matrix(n=128, seed=5):
    """Random sparsity (too many occupied diagonals for DIA) with a
    dominant diagonal."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.05, random_state=rng, format="csr")
    A = A + A.T + sp.eye(n, format="csr") * 8.0
    return A.tocsr()


def _banded_matrix(n=128):
    """Constant-coefficient SPD tridiagonal: the DIA layout."""
    return sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr()


def _rel(A, x, b):
    return float(np.linalg.norm(b - A @ np.asarray(x, np.float64))
                 / np.linalg.norm(b))


def _configure(rk, A, prec, inner_op, pc_type="jacobi"):
    rk.set_inner_precision(prec)
    rk.set_operators(A, inner_op=inner_op)
    rk.set_type("cg")
    rk.get_pc().set_type(pc_type)
    rk.set_tolerances(rtol=RTOL)
    return rk


def _pair(A, prec, ndev, stencil_nx=None, pc_type="jacobi"):
    """``(jax RefinedKSP, port RefinedKSP)`` for one configuration."""
    jcomm = tps.DeviceComm(n_devices=ndev)
    pcomm = pt.DeviceComm(ndev, device="cpu")
    jop = pop = None
    if stencil_nx:
        jop = JaxStencil(jcomm, stencil_nx, stencil_nx, stencil_nx,
                         dtype=jax_dtype(prec))
        pop = pt.StencilPoisson3D(pcomm, stencil_nx,
                                  dtype=inner_precision_dtype(prec))
    return (_configure(JaxRefinedKSP().create(jcomm), A, prec, jop, pc_type),
            _configure(pt.RefinedKSP().create(pcomm), A, prec, pop, pc_type))


def _assert_bands(prec, jk, pk, jres, pres, xj, xp):
    """The tolerances of the module docstring."""
    js, ps = jk.refine_steps, pk.refine_steps
    if prec == "f64":
        assert (ps, pres.iterations) == (js, jres.iterations)
        assert np.linalg.norm(xp - xj) <= 1e-12 * np.linalg.norm(xj)
    elif prec == "f32":
        assert ps == js
        assert abs(pres.iterations - jres.iterations) <= js
        assert np.linalg.norm(xp - xj) <= 1e-9 * np.linalg.norm(xj)
    else:
        assert abs(ps - js) <= 1
        assert abs(pres.iterations - jres.iterations) <= \
            0.1 * jres.iterations
    assert pres.reason == jres.reason


CASES = {"stencil8": (lambda: poisson3d_csr(8), 8),
         "stencil16": (lambda: poisson3d_csr(16), 16),
         "dia": (_banded_matrix, None),
         "ell": (_ell_matrix, None)}


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("prec", ["bf16", "f32", "f64"])
@pytest.mark.parametrize("case", list(CASES))
def test_refined_solve_matches_jax(case, prec, ndev):
    make, nx = CASES[case]
    A = make()
    b = A @ np.random.default_rng(4).random(A.shape[0])
    jk, pk = _pair(A, prec, ndev, nx)
    xj, jres = jk.solve(b)
    xp, pres = pk.solve(b)
    assert pres.reason == CR.CONVERGED_RTOL
    # the inner operator is the storage precision asked for, on the route
    # the case names
    assert pk._inner_op.dtype == inner_precision_dtype(prec)
    if case == "dia":
        assert pk._mat32.dia_vals is not None
    elif case == "ell":
        assert pk._mat32.dia_vals is None
    assert xp.dtype == np.float64
    _assert_bands(prec, jk, pk, jres, pres, xj, xp)
    assert _rel(A, xj, b) <= 1.05 * RTOL and _rel(A, xp, b) <= 1.05 * RTOL


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("prec", ["bf16", "f32", "f64"])
def test_refined_solve_many_matches_jax(prec, ndev):
    """k = 4 columns, one batched inner ``solve_many`` per outer step."""
    A = _ell_matrix()
    B = np.asarray(A @ np.random.default_rng(3).random((A.shape[0], 4)))
    jk, pk = _pair(A, prec, ndev)
    Xj, jres = jk.solve_many(B)
    Xp, pres = pk.solve_many(B)
    assert pres.reason == CR.CONVERGED_RTOL
    _assert_bands(prec, jk, pk, jres, pres, Xj, Xp)
    for j in range(B.shape[1]):
        assert _rel(A, Xj[:, j], B[:, j]) <= 1.05 * RTOL
        assert _rel(A, Xp[:, j], B[:, j]) <= 1.05 * RTOL


@pytest.mark.parametrize("pc_type", ["bjacobi", "lu"])
def test_refined_factor_pcs_at_bf16(pc_type):
    """The factor PCs with bf16 storage, contracting in fp32 (JAX
    ``pc.py:474-483``, ``:618-632``). The JAX package cannot set them up on
    its CPU mesh: the host set-up densifies the bf16 (``ml_dtypes``) CSR
    values with scipy, which raises; ROADMAP Queue C records it. So the
    port's refined solve is held to the fp64 contract and to its own f32
    run: the same solution to 1.05 rtol, at least as many outer steps."""
    A = _ell_matrix(64)
    b = A @ np.random.default_rng(6).random(A.shape[0])
    jk, pk = _pair(A, "bf16", 4, pc_type=pc_type)
    with pytest.raises(ValueError, match="dtype"):
        jk.solve(b)
    xp, pres = pk.solve(b)
    assert pk.get_pc()._arrays[0].dtype == torch.bfloat16
    assert pres.reason == CR.CONVERGED_RTOL
    assert _rel(A, xp, b) <= 1.05 * RTOL
    pk32 = _configure(pt.RefinedKSP().create(pk.comm), A, "f32", None,
                      pc_type)
    x32, _ = pk32.solve(b)
    assert pk.refine_steps >= pk32.refine_steps
    assert np.linalg.norm(xp - x32) <= 1e-8 * np.linalg.norm(x32)


def _record(rk):
    """Record ``(inner iterations, ||r||)`` of each outer step, ``r`` the
    residual the step's correction solve is given (in the inner
    precision)."""
    steps = []
    solve = rk.inner.solve

    def recording(b, x, *args, **kwargs):
        rn = float(np.linalg.norm(np.asarray(b.to_numpy(), np.float64)))
        res = solve(b, x, *args, **kwargs)
        steps.append((res.iterations, rn))
        return res

    rk.inner.solve = recording
    return steps


def test_bf16_stencil_64_tracks_jax_to_the_edge():
    """64^3 bf16 inner stencil, cfg11's right-hand side (``b = A u``, ``u``
    uniform from ``default_rng(0)``), 1 shard. Here ``cond(A) eps_bf16``
    is about 13: every other outer step reduces the residual only about 2x,
    and whether one of them falls short of the stagnation guard's 0.9 turns
    on the rounding of the iterates. Measured on the CPU: the JAX package
    converges in 11 steps (418 inner iterations) on 1 shard but stops with
    DIVERGED_BREAKDOWN after 8 steps (402) on 4 shards for the same
    problem; the port stops after 10 steps here (406). So the outcome is
    not compared. What is: the port follows the JAX package step by step
    through the first six outer steps (each step's inner iterations and
    the residual it starts from within 10%, the bf16 band; measured 3% and
    6%), and each run ends either converged at ``1.05 rtol`` or by the
    stagnation guard."""
    nx = 64
    A = poisson3d_csr(nx)
    b = A @ np.random.default_rng(0).random(nx ** 3)
    jk, pk = _pair(A, "bf16", 1, nx)
    jsteps, psteps = _record(jk), _record(pk)
    xj, jres = jk.solve(b)
    xp, pres = pk.solve(b)
    assert len(jsteps) >= 6 and len(psteps) >= 6
    for (ji, jr), (pi, pr) in zip(jsteps[:6], psteps[:6]):
        assert abs(pi - ji) <= max(1, 0.1 * ji)
        assert abs(pr - jr) <= 0.1 * jr
    for k, res, x, steps in ((jk, jres, xj, jsteps), (pk, pres, xp, psteps)):
        assert k.refine_steps == len(steps)
        if res.reason == CR.CONVERGED_RTOL:
            assert _rel(A, x, b) <= 1.05 * RTOL
        else:
            assert res.reason == CR.DIVERGED_BREAKDOWN
            # the guard stops on a step that kept >= 0.9 of the residual
            assert res.residual_norm >= 0.9 * steps[-1][1] * 0.99
            assert _rel(A, x, b) <= 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("operator", ["stencil", "assembled"])
def test_bf16_128_stagnates_like_jax(operator):
    """cfg11 at 128^3 with bf16 inner storage, on the stencil inner operator
    and on the assembled Mat (cfg11 as written): ``cond(A) eps_bf16`` is
    about 51 and both packages stop with DIVERGED_BREAKDOWN. Measured on
    the CPU: the JAX package after 4 steps (270 inner iterations) at
    relres 1.0e-3 on the stencil and 6 steps (400) at 1.0e-4 on the Mat;
    the port after 4 steps (270) at 1.0e-3 on both. Slow: the JAX side
    takes minutes of CPU time."""
    nx = 128
    A = poisson3d_csr(nx)
    b = A @ np.random.default_rng(0).random(nx ** 3)
    jk, pk = _pair(A, "bf16", 1, nx if operator == "stencil" else None)
    xj, jres = jk.solve(b)
    xp, pres = pk.solve(b)
    assert jres.reason == pres.reason == CR.DIVERGED_BREAKDOWN
    assert abs(pk.refine_steps - jk.refine_steps) <= 2
    assert _rel(A, xp, b) > RTOL and _rel(A, xj, b) > RTOL


# ---- the surface -------------------------------------------------------------

def test_flags_apply():
    opt = pt.global_options()
    opt.set("ksp_inner_precision", "bf16")
    opt.set("ksp_refine_max", 30)
    opt.set("ksp_refine_inner_rtol", 1e-2)
    comm = pt.DeviceComm(2, device="cpu")
    rk = pt.RefinedKSP().create(comm)
    rk.set_from_options()
    assert rk.inner_precision == "bf16"
    assert rk.max_refine == 30
    assert rk.inner_rtol == 1e-2
    rk.set_operators(_banded_matrix(64))
    assert rk._inner_op.dtype == torch.bfloat16
    assert rk.inner_dtype == torch.bfloat16


@pytest.mark.parametrize("prec", ["bf16", "f32", "f64"])
def test_inner_rtol_floored_at_storage_eps_like_jax(prec):
    comm = pt.DeviceComm(1, device="cpu")
    rk = pt.RefinedKSP().create(comm).set_inner_precision(prec)
    rk.set_tolerances(inner_rtol=1e-12)
    jk = JaxRefinedKSP().create(tps.DeviceComm(n_devices=1))
    jk.set_inner_precision(prec).set_tolerances(inner_rtol=1e-12)
    assert rk._effective_inner_rtol() == jk._effective_inner_rtol()
    if prec == "bf16":
        assert rk._effective_inner_rtol() == 4 * 2.0 ** -7 >= 0.01


def test_f64_inner_finishes_in_three_steps():
    A = _banded_matrix()
    comm = pt.DeviceComm(4, device="cpu")
    rk = _configure(pt.RefinedKSP().create(comm), A, "f64", None)
    rk.set_tolerances(inner_rtol=1e-11)
    b = A @ np.ones(A.shape[0])
    x, res = rk.solve(b)
    assert res.converged and rk.refine_steps <= 3
    assert _rel(A, x, b) <= 1.05 * RTOL


@pytest.mark.parametrize("ksp_type", ["gmres", "bcgs"])
def test_non_cg_types_raise_at_bf16_like_jax(ksp_type):
    A = _ell_matrix(64)
    jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=2), A,
                            dtype=jnp.bfloat16)
    jksp = tps.KSP().create(jm.comm)
    jksp.set_operators(jm)
    jksp.set_type(ksp_type)
    jx, jb = jm.get_vecs()
    with pytest.raises(ValueError, match="mixed-precision CG plans"):
        jksp.solve(jb, jx)
    comm = pt.DeviceComm(2, device="cpu")
    rk = _configure(pt.RefinedKSP().create(comm), A, "bf16", None)
    rk.set_type(ksp_type)
    with pytest.raises(ValueError, match="mixed-precision CG plans") as err:
        rk.solve(A @ np.ones(A.shape[0]))
    assert "Queue A item 5" in str(err.value)


def test_megasolve_raises_naming_its_queue_item():
    comm = pt.DeviceComm(1, device="cpu")
    pt.global_options().set("ksp_megasolve", "true")
    rk = pt.RefinedKSP().create(comm).set_from_options()
    assert rk.megasolve
    A = _banded_matrix(32)
    _configure(rk, A, "bf16", None)
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        rk.solve(np.ones(32))
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        rk.solve_many(np.ones((32, 2)))


def test_solve_without_operators_raises():
    rk = pt.RefinedKSP().create(pt.DeviceComm(1, device="cpu"))
    with pytest.raises(RuntimeError, match="no operators"):
        rk.solve(np.ones(4))


def test_zero_rhs_converges_at_once():
    A = _banded_matrix(32)
    rk = _configure(pt.RefinedKSP().create(pt.DeviceComm(1, device="cpu")),
                    A, "bf16", None)
    x, res = rk.solve(np.zeros(32))
    assert res.reason == CR.CONVERGED_ATOL and rk.refine_steps == 0
    assert not x.any()
