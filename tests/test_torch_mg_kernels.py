"""The plain versions of the port's five V-cycle kernels against the JAX package.

The CUDA kernels (``csrc/stencil7.cu`` epilogues, ``csrc/mg3d.cu``) run only
on the card, where ``chip_smoke.py`` holds them against these plain versions.
Here, on the CPU, the wrappers take the plain versions, and these are held
against the JAX package's Pallas kernels run through the Pallas interpreter
(the shapes and f32 tolerances of ``tests/test_pallas.py``) and against the
jnp bodies of ``solvers/mg.py`` in fp64. Inputs come from
``np.random.default_rng`` and go to both packages.

Tolerances: the plain versions follow the port's kernels, which compute the
two-sweep smoothers and the restriction as the TPU kernels do (one fused
formula, four restriction taps per axis), while the JAX package's CPU path
stages the sweeps and restricts with dense einsums. The two agree to rounding:
1e-5 in f32 (as ``tests/test_pallas.py`` holds the Pallas kernels), 1e-12 in
f64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu.solvers.mg as jmg  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil3d_residual_pallas, stencil3d_residual_restrict_pallas,
    stencil3d_smooth0_pair_pallas, stencil3d_smooth_pair_pallas,
    stencil3d_smooth_pallas)

from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import mg  # noqa: E402

W = 2.0 / 3.0 / 6.0


def _arrays(shape, dtype, seed, n=2, planes=True):
    """``n`` slabs of ``shape`` and, with ``planes``, two halo planes."""
    rng = np.random.default_rng(seed)
    out = [rng.random(shape).astype(dtype) for _ in range(n)]
    if planes:
        out += [rng.random(shape[1:]).astype(dtype) for _ in range(2)]
    return out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---- plain versions vs the JAX Pallas kernels (interpreter), f32 ------------

@pytest.mark.parametrize("lz,max_chunk", [(4, None), (6, 2), (8, 1)])
@pytest.mark.parametrize("kind", ["smooth", "residual"])
def test_smooth_residual_match_pallas_interpret(kind, lz, max_chunk):
    ny, nx = 8, 128
    u, f, lo, hi = _arrays((lz, ny, nx), np.float32, 200 + lz)
    ja = (jnp.asarray(u), jnp.asarray(f), jnp.asarray(lo[None]),
          jnp.asarray(hi[None]), lz, ny, nx)
    tu, tf, tlo, thi = _t(u, f, lo, hi)
    if kind == "smooth":
        ref = stencil3d_smooth_pallas(*ja, W, True, max_chunk)
        out = st.stencil3d_smooth(tu, tf, tlo, thi, W)
    else:
        ref = stencil3d_residual_pallas(*ja, True, max_chunk)
        out = st.stencil3d_residual(tu, tf, tlo, thi)
    assert out.dtype == torch.float32 and tuple(out.shape) == (lz, ny, nx)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lz,mc", [(4, None), (8, 2), (6, 3)])
def test_smooth_pairs_match_pallas_interpret(lz, mc):
    ny, nx = 8, 128
    u, f = _arrays((lz, ny, nx), np.float32, 600 + lz, planes=False)
    w1, w2 = (w / 6.0 for w in mg.cheby_omegas(2))
    ref = stencil3d_smooth_pair_pallas(jnp.asarray(u), jnp.asarray(f), lz,
                                       ny, nx, w1, w2, True, mc)
    out = st.stencil3d_smooth_pair(*_t(u, f), w1, w2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    ref0 = stencil3d_smooth0_pair_pallas(jnp.asarray(f), lz, ny, nx, w1, w2,
                                         True, mc)
    out0 = st.stencil3d_smooth0_pair(*_t(f), w1, w2)
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lz,ny,nx,max_chunk", [
    (4, 8, 128, None), (8, 8, 128, 2), (12, 16, 128, 4), (6, 16, 256, 2)])
def test_residual_restrict_matches_pallas_interpret(lz, ny, nx, max_chunk):
    u, f = _arrays((lz, ny, nx), np.float32, 700 + lz + nx, planes=False)
    dt = jnp.float32
    ref = stencil3d_residual_restrict_pallas(
        jnp.asarray(u), jnp.asarray(f), jmg._tmat(ny, dt).T,
        jmg._tmat(nx, dt), lz, ny, nx, jmg._RSCALE, True, max_chunk)
    out = st.stencil3d_residual_restrict(*_t(u, f))
    assert tuple(out.shape) == (lz // 2, ny // 2, nx // 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---- plain versions vs the jnp bodies of mg.py, f64 -------------------------

SHAPES_F64 = [(3, 7, 33), (1, 8, 128), (5, 1, 1), (4, 6, 10)]


@pytest.mark.parametrize("shape", SHAPES_F64)
def test_sweep_and_residual_match_jnp_f64(shape):
    u, f, lo, hi = _arrays(shape, np.float64, sum(shape))
    ja = [jnp.asarray(a) for a in (u, f, lo, hi)]
    tu, tf, tlo, thi = _t(u, f, lo, hi)
    np.testing.assert_allclose(
        st.stencil3d_smooth(tu, tf, tlo, thi, W).numpy(),
        np.asarray(jmg._sweep(*ja)), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        st.stencil3d_residual(tu, tf, tlo, thi).numpy(),
        np.asarray(jmg._residual(*ja)), rtol=1e-12, atol=1e-12)
    # None halos are the zero Dirichlet planes
    z = jnp.zeros(shape[1:], jnp.float64)
    np.testing.assert_allclose(
        st.stencil3d_residual(tu, tf, None, None).numpy(),
        np.asarray(jmg._residual(ja[0], ja[1], z, z)), rtol=1e-12,
        atol=1e-12)
    np.testing.assert_allclose(
        st.stencil3d_smooth(tu, tf, None, None, W).numpy(),
        np.asarray(jmg._sweep(ja[0], ja[1], z, z)), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", SHAPES_F64)
@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_pairs_match_staged_jnp_sweeps_f64(shape, smoother):
    """The pair passes equal the JAX package's staged CPU sweeps
    (``mg._smooth``/``_smooth0`` with zero ghosts)."""
    u, f = _arrays(shape, np.float64, 3 * sum(shape), planes=False)
    ws = (mg.cheby_omegas(2) if smoother == "chebyshev"
          else (mg._OMEGA, mg._OMEGA))
    ref = jmg._smooth(jnp.asarray(u), jnp.asarray(f), 0, jmg._no_exchange,
                      ws)
    out = st.stencil3d_smooth_pair(*_t(u, f), ws[0] / 6.0, ws[1] / 6.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)
    ref0 = jmg._smooth0(jnp.asarray(f), 0, jmg._no_exchange, ws)
    out0 = st.stencil3d_smooth0_pair(*_t(f), ws[0] / 6.0, ws[1] / 6.0)
    np.testing.assert_allclose(out0.numpy(), np.asarray(ref0), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(4, 6, 10), (8, 8, 8), (2, 2, 2),
                                   (6, 16, 256)])
def test_residual_restrict_matches_jnp_f64(shape):
    u, f = _arrays(shape, np.float64, 9 * sum(shape), planes=False)
    z = jnp.zeros(shape[1:], jnp.float64)
    r = jnp.asarray(f) - JaxStencil._stencil7_jnp(jnp.asarray(u), z, z)
    ref = np.asarray(jmg._restrict(r))
    out = st.stencil3d_residual_restrict(*_t(u, f))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    # the staged taps are JAX's _r1d chain
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jmg._r1d(jmg._r1d(jmg._r1d(r, 0), 1), 2)),
        rtol=1e-13, atol=1e-13)


# ---- shapes at the edges of the kernels' tiles and z-chunks, f64 -----------
# (csrc/mg3d.cu: the f32/f64 smooth_pair tile 64 x 16, the bf16 pair's 64 x
# 32 (its edges: tests/test_torch_mg_bf16.py), residual_restrict's fine tile
# 64 x 16; x, y one past or short of a tile, lz one or three planes past a
# chunk.) chip_smoke.py holds the kernels against these plain versions at the
# same shapes (TILE_EDGE_SHAPES, VCYCLE_EDGE_SHAPES for the bf16 pair).

@pytest.mark.parametrize("shape", [(17, 15, 63), (35, 17, 65), (19, 17, 65)])
def test_smooth_pair_matches_jnp_at_tile_edges_f64(shape):
    u, f = _arrays(shape, np.float64, 5 * sum(shape), planes=False)
    ws = mg.cheby_omegas(2)
    ref = jmg._smooth(jnp.asarray(u), jnp.asarray(f), 0, jmg._no_exchange,
                      ws)
    out = st.stencil3d_smooth_pair(*_t(u, f), ws[0] / 6.0, ws[1] / 6.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("shape", [(34, 18, 66), (66, 14, 62), (70, 18, 66)])
def test_residual_restrict_matches_jnp_at_tile_edges_f64(shape):
    u, f = _arrays(shape, np.float64, 7 * sum(shape), planes=False)
    z = jnp.zeros(shape[1:], jnp.float64)
    r = jnp.asarray(f) - JaxStencil._stencil7_jnp(jnp.asarray(u), z, z)
    out = st.stencil3d_residual_restrict(*_t(u, f))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmg._restrict(r)),
                               rtol=1e-12, atol=1e-12)


def test_residual_restrict_matches_pallas_interpret_at_tile_edge():
    lz, ny, nx = 34, 16, 128
    u, f = _arrays((lz, ny, nx), np.float32, 34, planes=False)
    dt = jnp.float32
    ref = stencil3d_residual_restrict_pallas(
        jnp.asarray(u), jnp.asarray(f), jmg._tmat(ny, dt).T,
        jmg._tmat(nx, dt), lz, ny, nx, jmg._RSCALE, True, None)
    out = st.stencil3d_residual_restrict(*_t(u, f))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# ---- wrapper contract on the CPU --------------------------------------------

def _calls():
    u, f, lo, hi = _t(*_arrays((4, 6, 10), np.float32, 1))
    return {
        "smooth": (st.stencil3d_smooth, (u, f, lo, hi, W),
                   lambda: st.stencil3d_smooth_plain(u, f, lo, hi, W)),
        "residual": (st.stencil3d_residual, (u, f, lo, hi),
                     lambda: st.stencil3d_residual_plain(u, f, lo, hi)),
        "smooth0_pair": (st.stencil3d_smooth0_pair, (f, 0.1, 0.2),
                         lambda: st.stencil3d_smooth0_pair_plain(f, 0.1, 0.2)),
        "smooth_pair": (st.stencil3d_smooth_pair, (u, f, 0.1, 0.2),
                        lambda: st.stencil3d_smooth_pair_plain(u, f, 0.1,
                                                               0.2)),
        "residual_restrict": (
            st.stencil3d_residual_restrict, (u, f),
            lambda: st.stencil3d_residual_restrict_plain(u, f)),
    }


@pytest.mark.parametrize("name", list(_calls()))
def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch(name):
    fn, args, plain = _calls()[name]
    before = {k: w.launches for k, w in st.KERNELS.items()}
    want = plain()
    out = torch.empty_like(want)
    got = fn(*args, out=out)
    assert got is out
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(fn(*args), want, rtol=0, atol=0)
    assert {k: w.launches for k, w in st.KERNELS.items()} == before


@pytest.mark.parametrize("shape", [(3, 4, 4), (4, 5, 4), (4, 4, 7)])
def test_residual_restrict_raises_on_odd_dims(shape):
    u = torch.zeros(shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="even dims"):
        st.stencil3d_residual_restrict(u, u.clone())


@pytest.mark.parametrize("bad,exc", [
    ("bf16", TypeError), ("f_shape", ValueError), ("f_dtype", TypeError),
    ("noncontig", ValueError), ("out_alias", ValueError),
    ("out_shape", ValueError), ("one_halo", ValueError)])
def test_new_wrappers_reject_what_the_kernels_do_not_take(bad, exc):
    u, f = _t(*_arrays((4, 6, 10), np.float32, 2, planes=False))
    out = None
    extra = []
    if bad == "bf16":
        # bfloat16 reaches the sweeps, the residual and the pairs (the TPU
        # V-cycle runs them at bfloat16 storage); the fused restriction
        # refuses it, and every V-cycle pass refuses float16
        ub, fb = u.to(torch.bfloat16), f.to(torch.bfloat16)
        extra = [lambda: st.stencil3d_residual_restrict(ub, fb)]
        u, f = u.to(torch.float16), f.to(torch.float16)
    elif bad == "f_shape":
        f = f[:2].contiguous()
    elif bad == "f_dtype":
        f = f.double()
    elif bad == "noncontig":
        f = f.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "out_alias":
        out = u
    elif bad == "out_shape":
        out = torch.empty(3, 6, 10)
    lo = hi = None
    if bad == "one_halo":
        lo = torch.zeros(6, 10)
        calls = [lambda: st.stencil3d_apply(u, lo, hi),
                 lambda: st.stencil3d_dot(u, lo, hi),
                 lambda: st.stencil3d_dot(u, hi, hi)]
    else:
        calls = [lambda: st.stencil3d_smooth_pair(u, f, 0.1, 0.2, out=out),
                 lambda: st.stencil3d_residual_restrict(
                     u, f, out=None if out is None else out[:2, :3, :5])]
    calls += [lambda: st.stencil3d_smooth(u, f, lo, hi, W, out=out),
              lambda: st.stencil3d_residual(u, f, lo, hi, out=out)]
    if bad in ("bf16", "out_alias", "out_shape"):
        calls.append(lambda: st.stencil3d_smooth0_pair(u, 0.1, 0.2, out=out))
    for call in calls + extra:
        with pytest.raises(exc):
            call()
