"""The port's CG + geometric-multigrid slice (PC ``mg``) against the JAX package.

The same problem and the same PC configuration, made from
``np.random.default_rng`` and carried across as plain values
(``utils/carry.py``), are solved by both packages: the JAX side on the forced
8-device CPU mesh of ``conftest.py``, the port on its CPU virtual mesh with the
same shard count. The port's V-cycle passes take their plain versions here.

Tolerances: the JAX package's CPU path stages the two-sweep smoothers and
restricts with dense einsums, where the port's plain versions follow its
kernels (one fused formula per pair pass, four restriction taps per axis).
The two differ in rounding only: in fp64 the cycles agree to 1e-12 and the
solves to 1e-10 with equal iteration counts; in fp32 the counts agree to
within one iteration.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
import mpi_petsc4py_example_tpu.solvers.mg as jmg  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops.stencil import restrict1d  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import mg  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    configure_pc, from_numpy_state)

CR = pt.ConvergedReason


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _jax_solve(ndev, grid, b, smoother="chebyshev", dtype=jnp.float64,
               rtol=1e-8, options=None):
    comm = tps.DeviceComm(n_devices=ndev)
    op = JaxStencil(comm, *grid, dtype=dtype)
    ksp = tps.KSP().create(comm)
    ksp.set_type("cg")
    ksp.get_pc().set_type("mg")
    if options is not None:
        tps.init(options)
        ksp.set_from_options()
    else:
        ksp.get_pc().mg_smoother = smoother
    ksp.set_tolerances(rtol=rtol, max_it=200)
    ksp.set_operators(op)
    x, bv = op.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return op, ksp.get_pc(), res, x.to_numpy()


def _port_solve(ndev, geometry, pc_key, b, dtype=torch.float64, rtol=1e-8,
                options=None):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op, bv, xv = from_numpy_state(comm, geometry, b, dtype=dtype)
    ksp = pt.KSP().create(comm)
    ksp.set_type("cg")
    configure_pc(ksp.get_pc(), pc_key)
    if options is not None:
        pt.init(options)
        ksp.set_from_options()
    ksp.set_tolerances(rtol=rtol, max_it=200)
    ksp.set_operators(op)
    res = ksp.solve(bv, xv)
    return ksp.get_pc(), res, xv.to_numpy()


def _rhs(grid, seed, dtype=np.float64):
    return np.random.default_rng(seed).standard_normal(
        int(np.prod(grid))).astype(dtype)


def _assert_same_solve(res, jres, xp, xj):
    assert res.iterations == jres.iterations
    assert res.reason == jres.reason == CR.CONVERGED_RTOL
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= 1e-10
    # one host read at set-up, one per iteration: the V-cycle adds none
    assert res.host_syncs == res.iterations + 1


# ---- slice vs the JAX package ------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("grid", [(16, 16, 16), (8, 16, 32)],
                         ids=["16cube", "8x16x32"])
def test_cg_mg_matches_jax_fp64(grid, ndev):
    b = _rhs(grid, 40 + ndev)
    jop, jpc, jres, xj = _jax_solve(ndev, grid, b)
    pc, res, xp = _port_solve(ndev, jop.program_key(), jpc.program_key(), b)
    assert pc.program_key() == jpc.program_key() == ("mg", "chebyshev")
    _assert_same_solve(res, jres, xp, xj)


def test_odd_local_slab_gathers_at_level_0():
    """nz = 24 over 8 shards: 3 planes each, so the cycle gathers at once."""
    grid = (8, 8, 24)
    b = _rhs(grid, 24)
    jop, jpc, jres, xj = _jax_solve(8, grid, b)
    _, res, xp = _port_solve(8, jop.program_key(), jpc.program_key(), b)
    _assert_same_solve(res, jres, xp, xj)


@pytest.mark.parametrize("ndev", [1, 4])
def test_jacobi_smoother_through_options(ndev):
    grid = (16, 16, 16)
    b = _rhs(grid, 5)
    argv = ["prog", "-pc_mg_smooth_type", "jacobi"]
    jop, jpc, jres, xj = _jax_solve(ndev, grid, b, options=argv)
    assert jpc.program_key() == ("mg", "jacobi")
    # the options database, not the carried key, picks the smoother
    pc, res, xp = _port_solve(ndev, jop.program_key(), ("mg", "chebyshev"),
                              b, options=argv)
    assert pc.mg_smoother == "jacobi"
    _assert_same_solve(res, jres, xp, xj)


@pytest.mark.parametrize("nx", [16, 32])
def test_cg_mg_fp32_within_one_iteration(nx):
    grid = (nx, nx, nx)
    b = _rhs(grid, nx, np.float32)
    jop, jpc, jres, xj = _jax_solve(1, grid, b, dtype=jnp.float32, rtol=1e-5)
    _, res, xp = _port_solve(1, jop.program_key(), jpc.program_key(), b,
                             dtype=torch.float32, rtol=1e-5)
    assert xp.dtype == np.float32
    assert res.reason == jres.reason == CR.CONVERGED_RTOL
    assert abs(res.iterations - jres.iterations) <= 1
    assert np.linalg.norm(xp - xj) / np.linalg.norm(xj) <= 1e-4


def test_mg_beats_jacobi_and_matches_the_csr_oracle():
    """bench.py's problem (b = A x_true, default_rng(7)) at 24^3: CG + mg
    reaches rtol 1e-8 in a handful of iterations where CG + Jacobi needs
    tens, and recovers x_true."""
    nx = 24
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, nx)
    x_true = np.random.default_rng(7).random(nx ** 3)
    b = pt.poisson3d_csr(nx) @ x_true
    its = {}
    for pc_type in ("mg", "jacobi"):
        ksp = pt.KSP().create(comm)
        ksp.set_type("cg")
        ksp.set_operators(op)
        ksp.get_pc().set_type(pc_type)
        ksp.set_tolerances(rtol=1e-8)
        x, bv = op.get_vecs()
        bv.set_global(b)
        its[pc_type] = ksp.solve(bv, x).iterations
        np.testing.assert_allclose(x.to_numpy(), x_true, rtol=1e-5,
                                   atol=1e-6)
    assert its["mg"] <= 12 and its["jacobi"] > 3 * its["mg"], its


# ---- the V-cycle and its pieces vs the JAX package --------------------------

def _jax_cycle(grid3, ndev, smoother):
    nz, ny, nx = grid3
    if ndev == 1:
        return jmg.make_vcycle3d(nz, ny, nx, smoother=smoother)
    comm = tps.DeviceComm(n_devices=ndev)
    cycle = jmg.make_vcycle3d(nz, ny, nx, axis=comm.axis, ndev=ndev,
                              platform=comm.platform, smoother=smoother)
    return jax.jit(comm.shard_map(cycle, (P(comm.axis),), P(comm.axis)))


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
@pytest.mark.parametrize("ndev", [1, 4])
def test_vcycle_matches_jax_fp64(ndev, smoother):
    grid3 = (16, 16, 8)           # (nz, ny, nx)
    r = np.random.default_rng(11).standard_normal(grid3)
    ref = np.asarray(_jax_cycle(grid3, ndev, smoother)(jnp.asarray(r)))
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    cycle = mg.make_vcycle3d(*grid3, comm=comm, smoother=smoother)
    out = cycle(torch.from_numpy(r).reshape((ndev, -1) + grid3[1:]))
    assert tuple(out.shape) == (ndev, grid3[0] // ndev) + grid3[1:]
    out = out.reshape(grid3).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("ndev", [1, 4])
def test_vcycle_is_symmetric(ndev):
    """<M u, v> == <u, M v> (as tests/test_mg_slab.py:49-59 asserts for JAX)."""
    nx = 16
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    vc = mg.make_vcycle(nx, nx, nx, comm=comm)
    rng = np.random.default_rng(1)
    u = torch.from_numpy(rng.standard_normal(nx ** 3)).reshape(ndev, -1)
    v = torch.from_numpy(rng.standard_normal(nx ** 3)).reshape(ndev, -1)
    lhs = float((vc(u) * v).sum())
    rhs = float((u * vc(v)).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0), (lhs, rhs)


@pytest.mark.parametrize("n", [4, 8, 10, 32, 512])
def test_tmat_and_cheby_omegas_equal_jax_bit_for_bit(n):
    """The cycle's carried "weights": the transfer matrices and the
    Chebyshev omega schedule."""
    np.testing.assert_array_equal(mg._tmat(n).numpy(),
                                  np.asarray(jmg._tmat(n, jnp.float64)))
    assert mg._tmat(n, torch.float32).dtype == torch.float32
    assert mg._tmat(n) is mg._tmat(n, torch.float64, "cpu")     # cached
    assert mg.cheby_omegas(2) == jmg.cheby_omegas(2)
    assert mg.cheby_omegas(3) == jmg.cheby_omegas(3)
    assert (mg._OMEGA, mg._RSCALE) == (jmg._OMEGA, jmg._RSCALE)


def _p1d(c, ax: int, lo=None, hi=None):
    """One axis of the linear prolongation ``P``, staged::

        fine[2i]   = 0.75 c[i] + 0.25 c[i-1]
        fine[2i+1] = 0.75 c[i] + 0.25 c[i+1]

    with zero ghosts; ``lo``/``hi`` are the neighbouring slabs' boundary
    coarse planes in the sharded z pass. The reference for the einsum form."""
    m = c.shape[ax]
    if lo is None:
        lo = torch.zeros_like(c.select(ax, 0))
    if hi is None:
        hi = torch.zeros_like(lo)
    cm = torch.cat([lo.unsqueeze(ax), c.narrow(ax, 0, m - 1)], dim=ax)
    cp = torch.cat([c.narrow(ax, 1, m - 1), hi.unsqueeze(ax)], dim=ax)
    out = torch.stack([0.75 * c + 0.25 * cm, 0.75 * c + 0.25 * cp],
                      dim=ax + 1)
    sh = list(c.shape)
    sh[ax] *= 2
    return out.reshape(sh)


@pytest.mark.parametrize("grid3", [(8, 8, 8), (16, 8, 8), (4, 16, 8),
                                   (24, 8, 8)])
def test_levels_and_transfers_match_jax_fp64(grid3):
    assert mg.mg_levels(*grid3) == jmg.mg_levels(*grid3)
    rng = np.random.default_rng(sum(grid3))
    r = rng.standard_normal(grid3)
    lo, hi = rng.standard_normal(grid3[1:]), rng.standard_normal(grid3[1:])
    cg = tuple(s // 2 for s in grid3)
    e = rng.standard_normal(cg)
    elo, ehi = rng.standard_normal(cg[1:]), rng.standard_normal(cg[1:])
    t = torch.from_numpy
    j = jnp.asarray
    for args, jargs in [((t(r),), (j(r), None, None)),
                        ((t(r), t(lo), t(hi)), (j(r), j(lo), j(hi)))]:
        np.testing.assert_allclose(mg._restrict_mm(*args).numpy(),
                                   np.asarray(jmg._restrict_mm(*jargs)),
                                   rtol=1e-13, atol=1e-13)
        staged = restrict1d(restrict1d(restrict1d(args[0], 0, *args[1:]), 1), 2)
        np.testing.assert_allclose(mg._restrict_mm(*args).numpy(),
                                   staged.numpy(), rtol=1e-13, atol=1e-13)
    for args, jargs in [((t(e),), (j(e), None, None)),
                        ((t(e), t(elo), t(ehi)), (j(e), j(elo), j(ehi)))]:
        p = mg._prolong_mm(*args).numpy()
        np.testing.assert_allclose(p, np.asarray(jmg._prolong_mm(*jargs)),
                                   rtol=1e-13, atol=1e-13)
        staged = _p1d(_p1d(_p1d(args[0], 0, *args[1:]), 1), 2)
        np.testing.assert_allclose(p, staged.numpy(), rtol=1e-13, atol=1e-13)
    # R = (1/2) P^T exactly
    lhs = float((mg._restrict_mm(t(r)) * t(e)).sum())
    rhs = 0.5 * float((t(r) * mg._prolong_mm(t(e))).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)


# ---- errors raised as the JAX package raises them ---------------------------

def test_cycle_refuses_tf32_prolongation_on_cuda():
    """The einsum transfers must run in full fp32 on the card: with TF32 on,
    the cycle raises for a CUDA fp32 input. CPU and fp64 inputs are not
    matmul'd in TF32 and run on."""
    cuda_f32 = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    cuda_f64 = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    cycle = mg.make_vcycle3d(8, 8, 8)
    r = torch.from_numpy(_rhs((8, 8, 8), 4, np.float32)).reshape(1, 8, 8, 8)
    mg._check_fp32_matmul(cuda_f32)
    ref = cycle(r)
    torch.set_float32_matmul_precision("high")
    try:
        assert mg._tf32_allowed()
        with pytest.raises(RuntimeError, match="TF32"):
            mg._check_fp32_matmul(cuda_f32)
        mg._check_fp32_matmul(cuda_f64)
        torch.testing.assert_close(cycle(r), ref, rtol=0, atol=0)
    finally:
        torch.set_float32_matmul_precision("highest")
    assert not mg._tf32_allowed()


def test_unknown_smoother_raises_like_jax():
    with pytest.raises(ValueError, match="smoother"):
        jmg.make_vcycle3d(8, 8, 8, smoother="nosuch")
    with pytest.raises(ValueError, match="smoother"):
        mg.make_vcycle3d(8, 8, 8, smoother="nosuch")
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, 8)
    pt.init(["prog", "-pc_type", "mg", "-pc_mg_smooth_type", "nosuch"])
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_from_options()
    x, b = op.get_vecs()
    b.set_global(_rhs((8, 8, 8), 2))
    with pytest.raises(ValueError, match="smoother"):
        ksp.solve(b, x)


def test_non_stencil_operator_raises_like_jax():
    """PC mg on an operator without grid dims: the JAX ValueError of
    ``pc.py:341-345``, raised when the solve builds its program."""
    comm = pt.DeviceComm(device="cpu")
    op = pt.StencilPoisson3D(comm, 4)
    plain_op = types.SimpleNamespace(
        comm=comm, shape=op.shape, dtype=op.dtype,
        local_spmv=op.local_spmv, diagonal=op.diagonal)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(plain_op)
    ksp.get_pc().set_type("mg")
    x, b = op.get_vecs()
    b.set_global(_rhs((4, 4, 4), 3))
    with pytest.raises(ValueError, match="structured stencil"):
        ksp.solve(b, x)
    jcomm = tps.DeviceComm(n_devices=1)
    jpc = tps.PC(jcomm)
    jpc.set_type("mg")
    with pytest.raises(ValueError, match="structured stencil"):
        A = pt.poisson3d_csr(2, 2, 2)
        jpc.set_up(tps.Mat.from_csr(jcomm, A.shape,
                                    (A.indptr, A.indices, A.data)))


def test_general_route_mg_matches_the_fast_path():
    """An operator with grid dims but no fused matvec-dot takes the general
    A/M route with the flat V-cycle (``make_vcycle``): same solve."""
    grid = (8, 8, 8)
    comm = pt.DeviceComm(n_devices=2, device="cpu")
    op = pt.StencilPoisson3D(comm, *grid)
    flat_op = types.SimpleNamespace(
        comm=comm, shape=op.shape, dtype=op.dtype, nx=op.nx, ny=op.ny,
        nz=op.nz, local_spmv=op.local_spmv, diagonal=op.diagonal)
    b = _rhs(grid, 9)
    out = {}
    for name, A in (("fast", op), ("general", flat_op)):
        ksp = pt.KSP().create(comm)
        ksp.set_type("cg")
        ksp.set_operators(A)
        ksp.get_pc().set_type("mg")
        ksp.set_tolerances(rtol=1e-10)
        x, bv = op.get_vecs()
        bv.set_global(b)
        out[name] = (ksp.solve(bv, x).iterations, x.to_numpy())
    assert out["fast"][0] == out["general"][0]
    np.testing.assert_allclose(out["general"][1], out["fast"][1],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("key", [("jacobi",), ("mg", "jacobi"),
                                 ("mg", "chebyshev"), ("none",)])
def test_configure_pc_round_trips_the_jax_key(key):
    jpc = tps.PC(tps.DeviceComm(n_devices=1))
    jpc.set_type(key[0])
    if key[0] == "mg":
        jpc.mg_smoother = key[1]
    pc = configure_pc(pt.PC(), jpc.program_key())
    assert pc.program_key() == jpc.program_key() == key
    with pytest.raises(ValueError):
        configure_pc(pt.PC(), ("mg",) if key[0] == "mg" else key + ("x",))


def test_all_gather_is_the_tiled_gather():
    comm = pt.DeviceComm(n_devices=4, device="cpu")
    x = torch.arange(48.0).reshape(4, 3, 2, 2)
    full = comm.all_gather(x)
    assert tuple(full.shape) == (12, 2, 2)
    torch.testing.assert_close(full[3:6], x[1], rtol=0, atol=0)
    with pytest.raises(ValueError):
        comm.all_gather(x[:2])
