"""The PyTorch port's bfloat16 storage against the JAX package.

The dtype vocabulary and the precision plan against ``utils/dtypes.py`` and
``cg_plans.precision_plan``; the plain versions of the four bfloat16 stencil
kernels against the JAX kernels in Pallas interpret mode (as
``tests/test_mixed_precision.py`` runs them) and against ``_stencil7_jnp``;
the bfloat16 DIA/ELL products; the host casts; the bfloat16 Mat, Vec, PCs
and CG loops; and the dispatch rule of the wrappers. Inputs come from
``np.random.default_rng``, are rounded to bfloat16 once (``ml_dtypes`` on the
JAX side) and reach the port as the float32 values they are.

Tolerances: a bfloat16 stencil output is bit-equal to the JAX kernel's (both
sum the 7 terms in fp32 in one order and round once); the dots sum in fp32
in another order (1e-6 relative). The assembled products sum each row's
taps in fp32 in an order XLA chooses, so a row may round to the neighbouring
bfloat16 value: at most 1 ulp, with the count of such rows bounded.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.ops import spmv as jspmv  # noqa: E402
from mpi_petsc4py_example_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil3d_apply_many_pallas, stencil3d_apply_pallas,
    stencil3d_dot_many_pallas, stencil3d_dot_pallas)
from mpi_petsc4py_example_tpu.solvers.cg_plans import (  # noqa: E402
    precision_plan as jax_plan)
from mpi_petsc4py_example_tpu.utils import dtypes as jdt  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson3d_csr)
from mpi_petsc4py_example_tpu_torch.ops import spmv  # noqa: E402
from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import dtypes as pdt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    from_host_csr, from_numpy_state)

BF16 = np.dtype(jnp.bfloat16)
DTYPES = {"bf16": (torch.bfloat16, BF16),
          "f32": (torch.float32, np.dtype(np.float32)),
          "f64": (torch.float64, np.dtype(np.float64))}


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _name(dtype) -> str:
    """A dtype's name on either side (``torch.bfloat16`` -> ``bfloat16``)."""
    return (str(dtype).removeprefix("torch.")
            if isinstance(dtype, torch.dtype) else str(np.dtype(dtype)))


def _bf16_values(shape, seed):
    """``(float32 array of bfloat16 values, the same as ml_dtypes bf16)``."""
    a = np.random.default_rng(seed).random(shape).astype(BF16)
    return a.astype(np.float32), a


def _tb(a32):
    return torch.from_numpy(a32).to(torch.bfloat16)


def _f32(t):
    return t.to(torch.float32).numpy()


def _exact_dots(U32, lo32, hi32):
    """``<u, A u>`` in fp64 from the bf16 values (per column of a block)."""
    t = lambda a: None if a is None else torch.from_numpy(a).double()
    U = t(U32)
    if U.dim() == 3:
        return float((U * st.stencil3d_apply_plain(U, t(lo32), t(hi32)))
                     .sum())
    Y = st.stencil3d_apply_many_plain(U, t(lo32), t(hi32))
    return (U * Y).sum(dim=(1, 2, 3)).numpy()


def _assert_dots(port, ref, exact):
    """The port's fp32 dot within 1e-6 of the fp64 value of the same sum,
    and of the Pallas kernel's within 2e-6: the interpreter's fp32 chunk
    sums were measured up to 1.2e-6 off the fp64 value at these shapes
    (the port's 8e-8)."""
    port, ref, exact = (np.atleast_1d(np.asarray(a, np.float64))
                        for a in (port, ref, exact))
    np.testing.assert_allclose(port, exact, rtol=1e-6)
    np.testing.assert_allclose(port, ref, rtol=2e-6)


# ---- the dtype vocabulary and the precision plan ---------------------------

@pytest.mark.parametrize("prec", ["bf16", "f32", "f64"])
def test_dtype_helpers_match_jax(prec):
    tdt, jd = DTYPES[prec]
    assert _name(pdt.reduce_dtype(tdt)) == _name(jdt.reduce_dtype(jd))
    assert _name(pdt.tolerance_dtype(tdt)) == _name(jdt.tolerance_dtype(jd))
    assert pdt.real_eps(tdt) == jdt.real_eps(jd)
    assert pdt.is_low_precision(tdt) == jdt.is_low_precision(jd)
    assert pdt.real_eps(torch.bfloat16) == 2.0 ** -7


@pytest.mark.parametrize("spelling", [
    "bf16", "bfloat16", "BF16", "f32", "fp32", "float32", "single", "f64",
    "fp64", "float64", "double"])
def test_inner_precision_spellings_match_jax(spelling):
    assert _name(pdt.inner_precision_dtype(spelling)) == _name(
        jdt.inner_precision_dtype(spelling))


def test_unknown_spelling_raises_the_jax_error():
    with pytest.raises(ValueError) as jerr:
        jdt.inner_precision_dtype("fp8")
    with pytest.raises(ValueError) as perr:
        pdt.inner_precision_dtype("fp8")
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("prec", ["bf16", "f32", "f64"])
def test_precision_plan_matches_jax(prec):
    tdt, jd = DTYPES[prec]
    p, j = pt.precision_plan(tdt), jax_plan(jd)
    assert p.mixed == j.mixed
    assert p.key() == j.key()
    assert _name(p.storage) == _name(j.storage)
    assert _name(p.reduce) == _name(j.reduce)
    v = torch.ones(4, dtype=torch.float32)
    assert _name(p.store(v).dtype) == _name(j.store(jnp.ones(4,
                                                             jnp.float32)).dtype)
    if p.mixed:
        assert p.up(p.store(v)).dtype == torch.float32
        assert p.store(v).dtype == torch.bfloat16
    else:                              # uniform plans are identities
        w = torch.ones(3, dtype=tdt)
        assert p.store(w) is w and p.up(w) is w


# ---- the four bf16 plain versions against the Pallas kernels ---------------

@pytest.mark.parametrize("lz,max_chunk", [(8, None), (8, 2)],
                         ids=["one-chunk", "multi-chunk"])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_bf16_plain_matches_pallas_interpret(kind, lz, max_chunk):
    ny, nx = 16, 128
    u32, u = _bf16_values((lz, ny, nx), 70 + lz + (max_chunk or 0))
    lo32, lo = _bf16_values((1, ny, nx), 71)
    hi32, hi = _bf16_values((1, ny, nx), 72)
    args = (jnp.asarray(u), jnp.asarray(lo), jnp.asarray(hi), lz, ny, nx,
            True, max_chunk)
    if kind == "apply":
        y_ref = stencil3d_apply_pallas(*args)
        y = st.stencil3d_apply(_tb(u32), _tb(lo32[0]), _tb(hi32[0]))
    else:
        y_ref, d_ref = stencil3d_dot_pallas(*args)
        y, d = st.stencil3d_dot(_tb(u32), _tb(lo32[0]), _tb(hi32[0]))
        assert d.dtype == torch.float32 and d_ref.dtype == jnp.float32
        _assert_dots(float(d), float(d_ref),
                     _exact_dots(u32, lo32[0], hi32[0]))
    assert y.dtype == torch.bfloat16 and y_ref.dtype == jnp.bfloat16
    # both sum in fp32 in one order and round once: bit-equal
    np.testing.assert_array_equal(_f32(y), np.asarray(y_ref, np.float32))


@pytest.mark.parametrize("lz,max_chunk", [(8, None), (8, 2)],
                         ids=["one-chunk", "multi-chunk"])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_bf16_plain_many_matches_pallas_interpret(kind, lz, max_chunk):
    k, ny, nx = 3, 16, 128
    U32, U = _bf16_values((k, lz, ny, nx), 80 + lz + (max_chunk or 0))
    lo32, lo = _bf16_values((k, 1, ny, nx), 81)
    hi32, hi = _bf16_values((k, 1, ny, nx), 82)
    args = (jnp.asarray(U), jnp.asarray(lo), jnp.asarray(hi), lz, ny, nx, k,
            True, max_chunk)
    if kind == "apply":
        Y_ref = stencil3d_apply_many_pallas(*args)
        Y = st.stencil3d_apply_many(_tb(U32), _tb(lo32[:, 0]),
                                    _tb(hi32[:, 0]))
    else:
        Y_ref, d_ref = stencil3d_dot_many_pallas(*args)
        Y, d = st.stencil3d_dot_many(_tb(U32), _tb(lo32[:, 0]),
                                     _tb(hi32[:, 0]))
        assert d.dtype == torch.float32 and tuple(d.shape) == (k,)
        _assert_dots(d.numpy(), d_ref, _exact_dots(U32, lo32[:, 0],
                                                   hi32[:, 0]))
    assert Y.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(Y), np.asarray(Y_ref, np.float32))


@pytest.mark.parametrize("shape", [(6, 12, 40), (1, 7, 33), (3, 5, 1)])
def test_bf16_plain_matches_stencil7_jnp(shape):
    """Non-tileable planes against the jnp body. ``A u`` is bit-equal. The
    jnp path's dot sums ``u * round(A u)`` where the Pallas kernel (and the
    port) sum the unrounded fp32 ``A u``: that gap is the rounding of ``y``,
    measured here at 2.2e-5, 1.2e-4 and 5.0e-4 relative (the three shapes
    in order), and held to 1e-3."""
    u32, u = _bf16_values(shape, sum(shape))
    lo32, lo = _bf16_values(shape[1:], 1)
    hi32, hi = _bf16_values(shape[1:], 2)
    y_ref = JaxStencil._stencil7_jnp(jnp.asarray(u), jnp.asarray(lo),
                                     jnp.asarray(hi))
    y, d = st.stencil3d_dot(_tb(u32), _tb(lo32), _tb(hi32))
    np.testing.assert_array_equal(_f32(y), np.asarray(y_ref, np.float32))
    d_jnp = float(np.sum(u32.astype(np.float64)
                         * np.asarray(y_ref, np.float64)))
    assert abs(float(d) - d_jnp) <= 1e-3 * abs(d_jnp)
    # the port's dot is the fp32 dot of the unrounded product
    d64 = _exact_dots(u32, lo32, hi32)
    assert abs(float(d) - d64) <= 1e-6 * abs(d64)


# ---- the dispatch rule --------------------------------------------------------

def test_bf16_cpu_tensors_take_the_plain_versions():
    u32, _ = _bf16_values((4, 6, 10), 5)
    lo32, _ = _bf16_values((6, 10), 6)
    U32, _ = _bf16_values((2, 4, 6, 10), 7)
    before = {k: (w.launches, w.launches_bf16) for k, w in st.KERNELS.items()}
    u, lo, hi, U = _tb(u32), _tb(lo32), _tb(lo32), _tb(U32)
    y = st.stencil3d_apply(u, lo, hi)
    yd, d = st.stencil3d_dot(u, lo, hi)
    Y = st.stencil3d_apply_many(U, None, None)
    Yd, dm = st.stencil3d_dot_many(U, None, None)
    for got, plain in [(y, st.stencil3d_apply_plain(u, lo, hi)),
                       (yd, st.stencil3d_dot_plain(u, lo, hi)[0]),
                       (Y, st.stencil3d_apply_many_plain(U, None, None)),
                       (Yd, st.stencil3d_dot_many_plain(U, None, None)[0])]:
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
    assert d.dtype == dm.dtype == torch.float32 and d.shape == ()
    assert {k: (w.launches, w.launches_bf16)
            for k, w in st.KERNELS.items()} == before


@pytest.mark.parametrize("bad", [torch.float16, torch.int32])
def test_other_dtypes_raise(bad):
    u = torch.ones(4, 6, 10, dtype=bad)
    for fn in (st.stencil3d_apply, st.stencil3d_dot):
        with pytest.raises(TypeError):
            fn(u, u[0].clone(), u[0].clone())
    U = torch.ones(2, 4, 6, 10, dtype=bad)
    for fn in (st.stencil3d_apply_many, st.stencil3d_dot_many):
        with pytest.raises(TypeError):
            fn(U, None, None)


def test_vcycle_kernels_stay_f32_f64():
    u = torch.ones(4, 6, 10, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="float32/float64"):
        st.stencil3d_smooth(u, u, None, None, 0.1)
    with pytest.raises(TypeError):
        st.stencil3d_residual_restrict(u, u)


def test_reset_launches_zeroes_both_counters():
    st.stencil3d_apply.launches_bf16 = 3
    st.stencil3d_dot.launches = 2
    st.reset_launches()
    assert all(w.launches == w.launches_bf16 == 0
               for w in st.KERNELS.values())


# ---- the bf16 assembled products ------------------------------------------------

def _ulps(port, ref):
    """Per element, how many bfloat16 steps apart two bf16-valued arrays
    are (through their bit patterns)."""
    a = torch.from_numpy(np.ascontiguousarray(port, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    b = torch.from_numpy(np.ascontiguousarray(ref, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().astype(np.int64)
    return np.abs(a - b)


def _assert_within_one_ulp(port, ref, max_frac):
    d = _ulps(port, ref)
    assert d.max() <= 1, d.max()
    assert np.count_nonzero(d) <= max_frac * d.size, np.count_nonzero(d)


def test_bf16_local_products_match_jax():
    """DIA and ELL, single and batched, at bf16: the DIA products are
    bit-equal (each diagonal added in fp32 in the same order, one
    rounding); an ELL row sum runs in XLA's order: held to at most 1 ulp
    in a tenth of the rows, measured bit-equal (0 of 24 rows, 0 of 72
    batched elements)."""
    S = (sp.random(64, 64, density=0.1, random_state=3, format="csr")
         + sp.diags([-1.0, 4.0, -1.0], [-1, 0, 1], shape=(64, 64))).tocsr()
    n = S.shape[0]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n).astype(BF16)
    x32 = x.astype(np.float32)
    X32 = rng.standard_normal((n, 3)).astype(BF16).astype(np.float32)
    csr = (S.indptr, S.indices, S.data.astype(BF16).astype(np.float32))
    cols, vals = spmv.csr_to_ell(*csr)
    B = sp.diags([-1.0, 4.0, -1.0, 0.5], [-1, 0, 1, 3], shape=(n, n)).tocsr()
    bcsr = (B.indptr, B.indices, B.data.astype(np.float32))
    offs = tuple(int(o) for o in spmv.csr_find_diagonals(*bcsr[:2]))
    dia = spmv.csr_to_dia(*bcsr, n, offs)
    halo = max(abs(o) for o in offs)
    lo, hi = 16, 40
    t = torch.from_numpy
    ell = spmv.ell_spmv_local(t(cols[lo:hi]), _tb(vals[lo:hi]), _tb(x32))
    ell_ref = jspmv.ell_spmv_local(cols[lo:hi], vals[lo:hi].astype(BF16),
                                   jnp.asarray(x))
    assert ell.dtype == torch.bfloat16 and ell_ref.dtype == jnp.bfloat16
    _assert_within_one_ulp(_f32(ell), np.asarray(ell_ref, np.float32), 0.1)
    ellm = spmv.ell_spmv_local_many(t(cols[lo:hi]), _tb(vals[lo:hi]),
                                    _tb(X32.T.copy()))
    ellm_ref = jspmv.ell_spmv_local_many(cols[lo:hi],
                                         vals[lo:hi].astype(BF16),
                                         jnp.asarray(X32.astype(BF16)))
    _assert_within_one_ulp(_f32(ellm).T, np.asarray(ellm_ref, np.float32),
                           0.1)
    dia_t = _tb(dia[lo:hi].T.copy())
    d1 = spmv.dia_spmv_local(dia_t, offs, _tb(x32), lo, halo)
    d1_ref = jspmv.dia_spmv_local(dia[lo:hi].astype(BF16), offs,
                                  jnp.asarray(x), lo, halo)
    assert d1.dtype == torch.bfloat16
    np.testing.assert_array_equal(_f32(d1), np.asarray(d1_ref, np.float32))
    dm = spmv.dia_spmv_local_many(dia_t, offs, _tb(X32.T.copy()), lo, halo)
    dm_ref = jspmv.dia_spmv_local_many(dia[lo:hi].astype(BF16), offs,
                                       jnp.asarray(X32.astype(BF16)), lo,
                                       halo)
    np.testing.assert_array_equal(_f32(dm).T, np.asarray(dm_ref, np.float32))


def test_widened_einsum_rounds_once():
    a32, _ = _bf16_values((5, 7), 11)
    b32, _ = _bf16_values((7,), 12)
    got = spmv.widened_einsum("ij,j->i", _tb(a32), _tb(b32))
    assert got.dtype == torch.bfloat16
    want = torch.from_numpy(a32 @ b32).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert spmv.accum_dtype(torch.bfloat16) == torch.float32
    assert spmv.accum_dtype(torch.float32) is None
    with pytest.raises(NotImplementedError):
        spmv.accum_dtype(torch.float16)


# ---- host casts, Vec, Mat -----------------------------------------------------

def test_host_casts_agree_with_ml_dtypes():
    """fp64 -> bf16 through torch equals ``ml_dtypes`` (both round through
    fp32), on random values and on a constructed tie."""
    rng = np.random.default_rng(9)
    v = np.concatenate([rng.standard_normal(20000) * 10.0 ** rng.integers(
        -6, 6, 20000), [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -9,
                        1.0 + 2.0 ** -8 + 2.0 ** -40]])
    comm = pt.DeviceComm(2, device="cpu")
    got = comm.host_fetch(comm.put_rows(v, torch.bfloat16))[: v.size]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, v.astype(BF16).astype(np.float32))
    B = v[:19998].reshape(-1, 3)
    blk = comm.fetch_cols(comm.put_cols(B, torch.bfloat16), B.shape[0])
    np.testing.assert_array_equal(blk, B.astype(BF16).astype(np.float32))


@pytest.mark.parametrize("ndev", [1, 4])
def test_bf16_vec_matches_jax_vec(ndev):
    comm = pt.DeviceComm(ndev, device="cpu")
    v = np.random.default_rng(ndev).standard_normal(50)
    w = np.random.default_rng(ndev + 1).standard_normal(50)
    pv = pt.Vec.from_global(comm, v, dtype=torch.bfloat16)
    pw = pt.Vec.from_global(comm, w, dtype=torch.bfloat16)
    jv = tps.Vec.from_global(tps.DeviceComm(n_devices=ndev), v, dtype=BF16)
    assert pv.dtype == torch.bfloat16
    got = pv.to_numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jv.to_numpy(), np.float32))
    # norm and dot accumulate in fp32 from the bf16 values
    v32, w32 = got, pw.to_numpy()
    assert abs(pv.norm() - np.linalg.norm(v32.astype(np.float64))) <= \
        1e-6 * np.linalg.norm(v32)
    assert abs(pv.dot(pw) - float(v32.astype(np.float64) @ w32)) <= \
        1e-6 * np.linalg.norm(v32) * np.linalg.norm(w32)
    pv.set_global(w)
    np.testing.assert_array_equal(pv.to_numpy(), w32)


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("layout", ["dia", "ell"])
def test_bf16_mat_matches_jax_mat(layout, ndev):
    """The bf16 Mat's values, diagonal and product against the JAX Mat's:
    the product held to 1 ulp in 5% of the rows on the ELL route and
    bit-equal on DIA; measured bit-equal on all four cases (0 of 96)."""
    n = 96
    if layout == "dia":
        S = sp.diags([-1.3, 4.1, -0.7], [-1, 0, 1], shape=(n, n)).tocsr()
    else:
        S = (sp.random(n, n, density=0.08, random_state=4, format="csr")
             + sp.eye(n, format="csr") * 8.0).tocsr()
    jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=ndev), S, dtype=BF16)
    comm = pt.DeviceComm(ndev, device="cpu")
    pm = pt.Mat.from_scipy(comm, S, dtype=torch.bfloat16)
    assert pm.dtype == torch.bfloat16
    assert (pm.dia_vals is None) == (jm.dia_vals is None) == (layout == "ell")
    # one rounding of the fp64 values, the same bits as the JAX Mat's
    np.testing.assert_array_equal(pm.host_csr[2],
                                  np.asarray(jm.host_csr[2], np.float32))
    np.testing.assert_array_equal(pm.diagonal(),
                                  np.asarray(jm.diagonal(), np.float32))
    x = np.random.default_rng(ndev).standard_normal(n)
    y = pm.mult(pt.Vec.from_global(comm, x, dtype=torch.bfloat16)).to_numpy()
    y_ref = np.asarray(jm.mult(tps.Vec.from_global(jm.comm, x, dtype=BF16))
                       .to_numpy(), np.float32)
    _assert_within_one_ulp(y, y_ref, 0.05 if layout == "ell" else 0.0)
    mat, bv, xv = from_host_csr(comm, jm.shape, jm.host_csr, x,
                                dtype=torch.bfloat16)
    np.testing.assert_array_equal(mat.host_csr[2], pm.host_csr[2])
    assert bv.dtype == xv.dtype == torch.bfloat16


@pytest.mark.parametrize("ndev", [1, 4])
def test_bf16_jacobi_inverse_matches_jax(ndev):
    S = sp.diags([-1.0, 6.0, -1.0], [-1, 0, 1], shape=(40, 40)).tocsr()
    S = (S + sp.diags(np.linspace(0.0, 3.0, 40))).tocsr()
    comm = pt.DeviceComm(ndev, device="cpu")
    pm = pt.Mat.from_scipy(comm, S, dtype=torch.bfloat16)
    pc = pt.PC(comm).set_type("jacobi")
    pc.set_up(pm)
    inv = pc._jacobi_inverse()
    assert inv.dtype == torch.bfloat16
    jm = tps.Mat.from_scipy(tps.DeviceComm(n_devices=ndev), S, dtype=BF16)
    jpc = tps.PC(jm.comm).set_type("jacobi")
    jpc.set_up(jm)
    ref = np.asarray(jpc.device_arrays()[0], np.float32)[:40]
    np.testing.assert_array_equal(_f32(inv.reshape(-1))[:40], ref)


def test_bf16_stencil_state_from_jax_values():
    comm = pt.DeviceComm(2, device="cpu")
    jop = JaxStencil(tps.DeviceComm(n_devices=2), 4, 4, 4, dtype=BF16)
    b = np.random.default_rng(3).standard_normal(64).astype(BF16)
    op, bv, xv = from_numpy_state(comm, jop.program_key(), b,
                                  dtype=torch.bfloat16)
    assert op.dtype == bv.dtype == xv.dtype == torch.bfloat16
    np.testing.assert_array_equal(bv.to_numpy(), b.astype(np.float32))
    np.testing.assert_array_equal(op.diagonal(), np.full(64, 6.0))
    # the bf16 operator's apply equals the JAX operator's
    y = op.mult(bv).to_numpy()
    jb = tps.Vec.from_global(jop.comm, b, dtype=BF16)
    np.testing.assert_array_equal(y, np.asarray(jop.mult(jb).to_numpy(),
                                                np.float32))


# ---- the bf16 CG loops against the JAX package ------------------------------------

def _jax_cg(ndev, nx, b, rtol):
    comm = tps.DeviceComm(n_devices=ndev)
    op = JaxStencil(comm, nx, nx, nx, dtype=BF16)
    ksp = tps.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=rtol)
    x, bv = op.get_vecs()
    bv.set_global(b.astype(BF16))
    res = ksp.solve(bv, x)
    return op, res


@pytest.mark.parametrize("ndev", [1, 4])
def test_bf16_stencil_cg_matches_jax(ndev):
    """Unrefined CG + Jacobi on bf16 storage to the bf16 floor (4 eps):
    reasons equal, iterations within 10% (the iterates round differently,
    see ``tests/test_torch_refine.py``), the fp32 residual norm at the
    target, and one ``stencil7_dot`` pass per iteration plus one."""
    nx, rtol = 12, 4 * 2.0 ** -7
    b = np.random.default_rng(ndev).standard_normal(nx ** 3)
    jop, jres = _jax_cg(ndev, nx, b, rtol)
    comm = pt.DeviceComm(ndev, device="cpu")
    op, bv, xv = from_numpy_state(comm, jop.program_key(), b,
                                  dtype=torch.bfloat16)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=rtol)
    res = ksp.solve(bv, xv)
    assert res.reason == jres.reason == pt.ConvergedReason.CONVERGED_RTOL
    assert abs(res.iterations - jres.iterations) <= 0.1 * jres.iterations
    assert xv.dtype == torch.bfloat16
    assert res.host_syncs == res.iterations + 1


def test_lifted_update_rounds_once():
    """``x + al * p`` with bf16 ``x, p`` and an fp32 ``al``: the plan's
    update equals fp32 arithmetic rounded once; eager bf16 arithmetic does
    not (it rounds ``al * p`` first)."""
    from mpi_petsc4py_example_tpu_torch.solvers.cg_plans import _lifted_axpy
    rng = np.random.default_rng(1)
    x32 = rng.standard_normal(1 << 14).astype(BF16).astype(np.float32)
    p32 = rng.standard_normal(1 << 14).astype(BF16).astype(np.float32)
    al = torch.tensor(0.3791, dtype=torch.float32)
    x = _tb(x32)
    _lifted_axpy(x, al, _tb(p32))
    want = torch.from_numpy(x32 + np.float32(al.item()) * p32).to(
        torch.bfloat16)
    torch.testing.assert_close(x, want, rtol=0, atol=0)
    eager = _tb(x32) + al * _tb(p32)
    assert eager.dtype == torch.bfloat16
    assert int((eager != want).sum()) > 0


def test_mixed_plan_scalars_stay_f32():
    nx = 8
    comm = pt.DeviceComm(1, device="cpu")
    op = pt.StencilPoisson3D(comm, nx, dtype=torch.bfloat16)
    seen = []
    from mpi_petsc4py_example_tpu_torch.solvers import cg_plans
    orig = cg_plans._safe_div

    def spy(num, den):
        seen.append((num.dtype, den.dtype))
        return orig(num, den)

    cg_plans._safe_div = spy
    try:
        ksp = pt.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=0.05)
        x, b = op.get_vecs()
        b.set_global(np.ones(nx ** 3))
        res = ksp.solve(b, x)
    finally:
        cg_plans._safe_div = orig
    assert res.converged and seen
    assert set(seen) == {(torch.float32, torch.float32)}
    assert x.dtype == torch.bfloat16


def test_pc_mg_raises_on_bf16_storage():
    comm = pt.DeviceComm(1, device="cpu")
    op = pt.StencilPoisson3D(comm, 8, dtype=torch.bfloat16)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("mg")
    x, b = op.get_vecs()
    b.set_global(np.ones(512))
    with pytest.raises(NotImplementedError, match="Queue A item 5"):
        ksp.solve(b, x)


@pytest.mark.parametrize("pc_type", ["bjacobi", "lu"])
def test_bf16_factor_pcs_store_bf16_and_contract_in_f32(pc_type):
    S = poisson3d_csr(4)
    comm = pt.DeviceComm(2, device="cpu")
    m = pt.Mat.from_scipy(comm, S, dtype=torch.bfloat16)
    pc = pt.PC(comm).set_type(pc_type)
    pc.set_up(m)
    assert pc._arrays[0].dtype == torch.bfloat16
    r = pt.Vec.from_global(comm, np.linspace(-1, 1, 64),
                           dtype=torch.bfloat16)
    z = pc.local_apply(comm, 64)(r.data.view(2, -1))
    assert z.dtype == torch.bfloat16
    # the same contraction in fp32 from the stored bf16 factor, rounded once
    if pc_type == "lu":
        want = (pc._arrays[0].float() @ r.data.float()).to(torch.bfloat16)
    else:
        want = torch.einsum("bij,bj->bi", pc._arrays[0].float(),
                            r.data.float().view(2, -1)).to(torch.bfloat16)
    torch.testing.assert_close(z.reshape(-1), want.reshape(-1), rtol=0,
                               atol=0)
