"""The PyTorch port's stencil layer against the JAX package.

The port's kernels (``csrc/stencil7.cu``) run only on the card, where
``chip_smoke.py`` holds them against their plain PyTorch versions. Here, on the
CPU, the wrappers take the plain versions, and these are held against the JAX
package's Pallas kernels run through the Pallas interpreter (as
``tests/test_pallas.py`` runs them) and against ``_stencil7_jnp`` in fp64.
Inputs come from ``np.random.default_rng`` and go to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil3d_apply_pallas, stencil3d_dot_pallas)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.stencil import (  # noqa: E402
    make_plane_exchange)
from mpi_petsc4py_example_tpu_torch.ops import build  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402


def _slab(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    lz, ny, nx = shape
    return (rng.random((lz, ny, nx)).astype(dtype),
            rng.random((ny, nx)).astype(dtype),
            rng.random((ny, nx)).astype(dtype))


def _t(a):
    return torch.from_numpy(a)


def _cpu():
    return pt.DeviceComm(device="cpu")


# ---- plain versions vs the JAX Pallas kernels (interpreter), f32 ------------

@pytest.mark.parametrize("lz,max_chunk", [(4, None), (6, 2), (8, 1)])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_plain_matches_pallas_interpret(kind, lz, max_chunk):
    ny, nx = 8, 128
    u, lo, hi = _slab((lz, ny, nx), np.float32, 10 * lz + (kind == "dot"))
    args = (jnp.asarray(u), jnp.asarray(lo[None]), jnp.asarray(hi[None]),
            lz, ny, nx, True, max_chunk)
    if kind == "apply":
        y_ref = np.asarray(stencil3d_apply_pallas(*args))
        y = st.stencil3d_apply(_t(u), _t(lo), _t(hi))
    else:
        y_ref, d_ref = stencil3d_dot_pallas(*args)
        y_ref = np.asarray(y_ref)
        y, d = st.stencil3d_dot(_t(u), _t(lo), _t(hi))
        assert d.dtype == torch.float32 and d.shape == ()
        np.testing.assert_allclose(float(d), float(d_ref), rtol=1e-5)
    assert y.dtype == torch.float32 and tuple(y.shape) == (lz, ny, nx)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)


# ---- plain versions vs _stencil7_jnp, f64, non-tileable planes and lz=1 -----

@pytest.mark.parametrize("shape", [(3, 7, 33), (1, 7, 33), (1, 8, 128),
                                   (5, 1, 1)])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_plain_matches_stencil7_jnp_f64(kind, shape):
    u, lo, hi = _slab(shape, np.float64, sum(shape))
    y_ref = np.asarray(JaxStencil._stencil7_jnp(
        jnp.asarray(u), jnp.asarray(lo), jnp.asarray(hi)))
    if kind == "apply":
        y = st.stencil3d_apply(_t(u), _t(lo), _t(hi))
    else:
        y, d = st.stencil3d_dot(_t(u), _t(lo), _t(hi))
        np.testing.assert_allclose(float(d), float((u * y_ref).sum()),
                                   rtol=1e-12)
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-12, atol=1e-12)


def test_operator_stencil7_is_the_plain_body():
    u, lo, hi = _slab((2, 5, 6), np.float64, 3)
    np.testing.assert_array_equal(
        pt.StencilPoisson3D._stencil7(_t(u), _t(lo), _t(hi)).numpy(),
        st.stencil3d_apply(_t(u), _t(lo), _t(hi)).numpy())


# ---- wrapper contract on the CPU --------------------------------------------

def test_cpu_wrappers_use_plain_and_count_no_launch():
    u, lo, hi = (_t(a) for a in _slab((4, 6, 10), np.float32, 1))
    before = (st.stencil3d_apply.launches, st.stencil3d_dot.launches)
    out = torch.empty_like(u)
    y = st.stencil3d_apply(u, lo, hi, out=out)
    assert y is out
    torch.testing.assert_close(out, st.stencil3d_apply_plain(u, lo, hi),
                               rtol=0, atol=0)
    out2 = torch.empty_like(u)
    y2, d = st.stencil3d_dot(u, lo, hi, out=out2)
    assert y2 is out2
    torch.testing.assert_close(d, (u * out2).sum(), rtol=0, atol=0)
    assert (st.stencil3d_apply.launches, st.stencil3d_dot.launches) == before


@pytest.mark.parametrize("bad,exc", [
    ("bf16", TypeError), ("halo_shape", ValueError),
    ("noncontig", ValueError), ("halo_dtype", TypeError),
    ("empty", ValueError), ("rank", ValueError)])
def test_wrappers_reject_what_the_kernel_does_not_take(bad, exc):
    u, lo, hi = (_t(a) for a in _slab((4, 6, 10), np.float32, 2))
    if bad == "bf16":
        u, lo, hi = (a.to(torch.bfloat16) for a in (u, lo, hi))
    elif bad == "halo_shape":
        lo = lo[None]
    elif bad == "noncontig":
        u = u.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "halo_dtype":
        hi = hi.double()
    elif bad == "empty":
        u = u[:0]
    elif bad == "rank":
        u = u.reshape(-1)
    for fn in (st.stencil3d_apply, st.stencil3d_dot):
        with pytest.raises(exc):
            fn(u, lo, hi)


def test_library_path_tracks_the_source_hash():
    p = build.library_path("stencil7")
    assert p == build.library_path("stencil7")
    assert p.parent == build.BUILD_DIR and p.name.startswith("stencil7-")
    assert (build.CSRC / "stencil7.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


# ---- halo exchange and the operator vs the JAX package ----------------------

@pytest.mark.parametrize("ndev", [1, 2, 4])
def test_plane_exchange_ring_with_dirichlet_ends(ndev):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    rng = np.random.default_rng(ndev)
    u = torch.from_numpy(rng.random((ndev, 3, 4, 5)))
    lo, hi = make_plane_exchange(comm)(u)
    for i in range(ndev):
        exp_lo = u[i - 1, -1] if i > 0 else torch.zeros(4, 5, dtype=u.dtype)
        exp_hi = (u[i + 1, 0] if i < ndev - 1
                  else torch.zeros(4, 5, dtype=u.dtype))
        torch.testing.assert_close(lo[i], exp_lo, rtol=0, atol=0)
        torch.testing.assert_close(hi[i], exp_hi, rtol=0, atol=0)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_mult_matches_jax_and_csr(ndev):
    nx, ny, nz = 9, 6, 16
    x = np.random.default_rng(ndev).standard_normal(nx * ny * nz)
    jcomm = tps.DeviceComm(n_devices=ndev)
    jop = JaxStencil(jcomm, nx, ny, nz, dtype=jnp.float64)
    y_jax = jop.mult(tps.Vec.from_global(jcomm, x)).to_numpy()
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op = pt.StencilPoisson3D(comm, nx, ny, nz, dtype=torch.float64)
    assert op.program_key() == jop.program_key()
    y = op.mult(pt.Vec.from_global(comm, x)).to_numpy()
    np.testing.assert_allclose(y, y_jax, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, pt.poisson3d_csr(nx, ny, nz) @ x,
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ndev", [1, 4])
def test_local_matvec_dot_psums_the_shard_partials(ndev):
    comm = pt.DeviceComm(n_devices=ndev, device="cpu")
    op = pt.StencilPoisson3D(comm, 5, 4, 8, dtype=torch.float64)
    u = torch.from_numpy(np.random.default_rng(5).random(
        (ndev,) + op.grid3d))
    y, d = op.local_matvec_dot(comm)(u)
    y_flat = op.mult(pt.Vec(comm, op.shape[0], data=u.reshape(-1))).data
    torch.testing.assert_close(y.reshape(-1), y_flat, rtol=1e-14, atol=1e-14)
    torch.testing.assert_close(d, (u.reshape(-1) * y_flat).sum(),
                               rtol=1e-13, atol=0)
    torch.testing.assert_close(op.local_apply_grid3(comm)(u), y,
                               rtol=0, atol=0)


def test_operator_needs_nz_divisible_by_shards():
    with pytest.raises(ValueError):
        pt.StencilPoisson3D(pt.DeviceComm(n_devices=3, device="cpu"), 4)
    op = pt.StencilPoisson3D(_cpu(), 4, 3, 2, dtype=np.float32)
    assert op.dtype == torch.float32 and op.shape == (24, 24)
    assert op.grid3d == (2, 3, 4)
    np.testing.assert_array_equal(op.diagonal(), np.full(24, 6.0))
    x, b = op.get_vecs()
    assert x.dtype == torch.float32 and len(b) == 24
