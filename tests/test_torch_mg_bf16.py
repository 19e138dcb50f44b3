"""The port's bfloat16 V-cycle (PC ``mg`` under bfloat16 storage) against the
JAX package.

The four bfloat16 passes the TPU V-cycle runs (``mg._sweep``, ``_residual``,
``_smooth``'s and ``_smooth0``'s two-sweep routes) go through their plain
versions here, the CPU path of the port's kernels, and through the JAX bodies
at bfloat16 with ``platform="cpu"``; then one V-cycle, and ``RefinedKSP``
with a bfloat16 (and a float32) inner CG + PC mg, on 1, 2 and 4 shards.
Inputs come from ``np.random.default_rng`` and are rounded to bfloat16 once.

Tolerances, with their reasons:

* a pass: the port lifts to fp32 and rounds once, XLA's CPU path rounds
  each bfloat16 operation (``ROADMAP.md`` Queue C), so the two differ
  by a few bfloat16 steps of the operands' scale: at most ``4 eps_bf16`` of
  the largest output. The port is also held within ``1 eps_bf16`` of the
  fp64 evaluation of the same bfloat16 inputs (one rounding; the two-sweep
  passes round twice, ``2 eps_bf16``).
* the pair pass equals two sweeps bit for bit (the kernels' contract).
* one V-cycle: within 3e-2 (relative 2-norm) of the JAX bfloat16 cycle,
  which is itself 0.7-1.4% from the fp64 cycle at these shapes; the port's
  cycle, with its transfers in fp32, within 5e-3 of the fp64 cycle.
* ``RefinedKSP`` bf16 + mg: the reason equal, outer steps within one, inner
  iterations within 10% (the bands of ``tests/test_torch_refine.py``) or
  two, whichever is more: at 16^3 the JAX package itself takes 11 inner
  iterations on 1 shard and 13 on 2 and 4; f32 inner + mg: steps and inner
  iterations equal.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
import mpi_petsc4py_example_tpu.solvers.mg as jmg  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson3d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers.refine import (  # noqa: E402
    RefinedKSP as JaxRefinedKSP)
from mpi_petsc4py_example_tpu.utils.dtypes import (  # noqa: E402
    inner_precision_dtype as jax_dtype)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import mg  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.dtypes import (  # noqa: E402
    inner_precision_dtype)

EPS = 2.0 ** -7
SHAPES = [(8, 12, 16), (16, 16, 16)]     # (lz, ny, nx)
# the edges of the bf16 pair kernel's 64 x 32 tile and its runs of 4 points
# (csrc/mg3d.cu), as chip_smoke.py's VCYCLE_EDGE_SHAPES gives them to the
# kernel on the card: ny one short of and one past the tile, nx a multiple of
# 8 short of a tile, nx not a whole number of runs (the card also takes
# (129, 257, 1024), one plane past a 128-plane z-chunk)
EDGE_SHAPES = [(19, 31, 64), (18, 33, 72), (9, 33, 66)]
OMEGAS = jmg.cheby_omegas(2)
CR = pt.ConvergedReason


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _bf16(shape, seed):
    """``(fp64 array of bfloat16 values, the bfloat16 tensor)``."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.double().numpy(), t


def _j(a):
    return jnp.asarray(a, jnp.bfloat16)


def _apply64(u, lo, hi):
    """``A u`` in fp64 with zero fill in x and y (``None`` halos: zero)."""
    ext = np.concatenate([np.zeros_like(u[:1]) if lo is None else lo[None],
                          u,
                          np.zeros_like(u[:1]) if hi is None else hi[None]])
    out = 6.0 * u - ext[:-2] - ext[2:]
    out[:, 1:] -= u[:, :-1]
    out[:, :-1] -= u[:, 1:]
    out[:, :, 1:] -= u[:, :, :-1]
    out[:, :, :-1] -= u[:, :, 1:]
    return out


@functools.lru_cache(maxsize=None)
def _cases(shape):
    """``{name: (port plain output, JAX output, fp64 value, roundings)}``."""
    u64, u = _bf16(shape, 1)
    f64, f = _bf16(shape, 2)
    lo64, lo = _bf16(shape[1:], 3)
    hi64, hi = _bf16(shape[1:], 4)
    w, (w1, w2) = (2.0 / 3.0) / 6.0, (OMEGAS[0] / 6.0, OMEGAS[1] / 6.0)
    s1 = u64 + w1 * (f64 - _apply64(u64, None, None))
    s1 = torch.from_numpy(s1).to(torch.bfloat16).double().numpy()
    return {
        "smooth": (st.stencil3d_smooth_plain(u, f, lo, hi, w),
                   jmg._sweep(_j(u64), _j(f64), _j(lo64), _j(hi64), 2.0 / 3.0,
                              platform="cpu"),
                   u64 + w * (f64 - _apply64(u64, lo64, hi64)), 1),
        "residual": (st.stencil3d_residual_plain(u, f, lo, hi),
                     jmg._residual(_j(u64), _j(f64), _j(lo64), _j(hi64),
                                   platform="cpu"),
                     f64 - _apply64(u64, lo64, hi64), 1),
        "smooth_pair": (st.stencil3d_smooth_pair_plain(u, f, w1, w2),
                        jmg._smooth(_j(u64), _j(f64), 0, jmg._no_exchange,
                                    omega=OMEGAS, platform="cpu"),
                        s1 + w2 * (f64 - _apply64(s1, None, None)), 2),
        "smooth0_pair": (st.stencil3d_smooth0_pair_plain(f, w1, w2),
                         jmg._smooth0(_j(f64), 0, jmg._no_exchange,
                                      omega=OMEGAS, platform="cpu"),
                         (w1 + w2) * f64 - w1 * w2 * _apply64(f64, None,
                                                               None), 1),
    }


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize("kind", ["smooth", "residual", "smooth_pair",
                                  "smooth0_pair"])
def test_bf16_plain_passes_match_jax(kind, shape):
    got, ref, exact, roundings = _cases(shape)[kind]
    assert got.dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    got = got.double().numpy()
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 4 * EPS * scale
    assert np.abs(got - exact).max() <= roundings * EPS * np.abs(exact).max()


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
def test_bf16_pair_is_two_sweeps_bit_for_bit(shape):
    _, u = _bf16(shape, 5)
    _, f = _bf16(shape, 6)
    w1, w2 = OMEGAS[0] / 6.0, OMEGAS[1] / 6.0
    two = st.stencil3d_smooth_plain(
        st.stencil3d_smooth_plain(u, f, None, None, w1), f, None, None, w2)
    assert torch.equal(st.stencil3d_smooth_pair_plain(u, f, w1, w2), two)
    # the wrappers take the plain versions on CPU tensors, and count nothing
    st.reset_launches()
    assert torch.equal(st.stencil3d_smooth_pair(u, f, w1, w2), two)
    out = torch.empty_like(u)
    st.stencil3d_smooth(u, f, None, None, w1, out=out)
    assert torch.equal(out, st.stencil3d_smooth_plain(u, f, None, None, w1))
    assert torch.equal(st.stencil3d_residual(u, f, None, None),
                       st.stencil3d_residual_plain(u, f, None, None))
    assert torch.equal(st.stencil3d_smooth0_pair(f, w1, w2),
                       st.stencil3d_smooth0_pair_plain(f, w1, w2))
    assert all(w.launches == w.launches_bf16 == 0
               for w in st.KERNELS.values())


def test_residual_restrict_has_no_bf16_instantiation():
    """The TPU V-cycle never reaches the fused residual-restriction at
    bfloat16 (``mg._mm_ok``); neither does the port's, and the wrapper
    refuses it."""
    u = torch.ones(4, 6, 10, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32/float64"):
        st.stencil3d_residual_restrict(u, u)


def _jax_cycle(grid3, ndev):
    nz, ny, nx = grid3
    if ndev == 1:
        return jmg.make_vcycle3d(nz, ny, nx)
    comm = tps.DeviceComm(n_devices=ndev)
    cycle = jmg.make_vcycle3d(nz, ny, nx, axis=comm.axis, ndev=ndev,
                              platform=comm.platform)
    return jax.jit(comm.shard_map(cycle, (P(comm.axis),), P(comm.axis)))


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("grid3", [(16, 12, 8), (16, 16, 16)])
def test_bf16_vcycle_matches_jax(grid3, ndev):
    r64, r = _bf16(grid3, 11)
    ref = np.asarray(_jax_cycle(grid3, ndev)(_j(r64)), np.float64)
    ref64 = np.asarray(_jax_cycle(grid3, 1)(jnp.asarray(r64)))
    comm = pt.DeviceComm(ndev, device="cpu")
    out = mg.make_vcycle3d(*grid3, comm=comm)(
        r.reshape((ndev, -1) + grid3[1:]))
    assert out.dtype == torch.bfloat16
    assert tuple(out.shape) == (ndev, grid3[0] // ndev) + grid3[1:]
    out = out.reshape(grid3).double().numpy()
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(out, ref) <= 3e-2
    assert rel(out, ref64) <= 5e-3


def _refined_pair(prec, ndev):
    A = poisson3d_csr(16)
    jcomm = tps.DeviceComm(n_devices=ndev)
    pcomm = pt.DeviceComm(ndev, device="cpu")
    out = []
    for rk, op in (
            (JaxRefinedKSP().create(jcomm),
             JaxStencil(jcomm, 16, 16, 16, dtype=jax_dtype(prec))),
            (pt.RefinedKSP().create(pcomm),
             pt.StencilPoisson3D(pcomm, 16,
                                 dtype=inner_precision_dtype(prec)))):
        rk.set_inner_precision(prec)
        rk.set_operators(A, inner_op=op)
        rk.set_type("cg")
        rk.get_pc().set_type("mg")
        rk.set_tolerances(rtol=1e-10)
        out.append(rk)
    return A, out


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("prec", ["bf16", "f32"])
def test_refined_cg_mg_matches_jax(prec, ndev):
    A, (jk, pk) = _refined_pair(prec, ndev)
    b = A @ np.random.default_rng(4).random(A.shape[0])
    xj, jres = jk.solve(b)
    xp, pres = pk.solve(b)
    assert pres.reason == jres.reason == CR.CONVERGED_RTOL
    if prec == "f32":
        assert (pk.refine_steps, pres.iterations) == \
            (jk.refine_steps, jres.iterations)
    else:
        assert abs(pk.refine_steps - jk.refine_steps) <= 1
        assert abs(pres.iterations - jres.iterations) <= \
            max(0.1 * jres.iterations, 2)
    rel = np.linalg.norm(b - A @ xp) / np.linalg.norm(b)
    assert rel <= 1.05e-10
