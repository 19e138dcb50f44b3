"""The bfloat16 stencil kernels' shapes and scratch, against the JAX package.

On the card the four bfloat16 entry points are one kernel (the single-RHS
pair is its k = 1 launch) that tiles each plane by its flat index in blocks
of 2048 points, runs of 8 points a thread, on a 16-byte or an element route.
Its shapes' edges are where a warp's runs span nx = 256 (255, 256, 257), one
row past a block (ny = 9 at nx = 256, 17 at nx = 128, 33 at nx = 64), odd
slabs, and the refinement's 32^3 and 64^3 grids. Here, on the CPU, the
wrappers take their plain versions at those shapes, which must equal the JAX
package's: ``A u`` bit for bit against ``_stencil7_jnp`` on each column and
against the Pallas kernels in interpret mode where the shape tiles (nx =
128); the fp32 dots within 1e-6 of the fp64 value of the same sum (as
``tests/test_torch_mixed_precision.py`` holds them). The dot's scratch is
sized from each dtype's own block count, its route asked of the library,
and the f32/f64 dots pass the fold's ticket counters, checked with a
stand-in library. Inputs come from ``np.random.default_rng``, rounded to
bfloat16 once.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.ops.pallas_stencil import (  # noqa: E402
    stencil3d_apply_many_pallas, stencil3d_dot_many_pallas)

from mpi_petsc4py_example_tpu_torch.ops import stencil as st  # noqa: E402

BF16 = np.dtype(jnp.bfloat16)
EDGE_SHAPES = [(4, 9, 255), (4, 9, 256), (4, 9, 257), (3, 33, 64),
               (5, 17, 128), (3, 5, 7), (37, 45, 131), (32, 32, 32),
               (64, 64, 64)]
K = 3


def _bf16_values(shape, seed):
    """``(float32 array of bfloat16 values, the same as ml_dtypes bf16)``."""
    a = np.random.default_rng(seed).random(shape).astype(BF16)
    return a.astype(np.float32), a


def _tb(a32):
    return None if a32 is None else torch.from_numpy(a32).to(torch.bfloat16)


def _block(shape, halos, seed):
    """k bfloat16 slabs and their halo blocks (None for zero halos), as
    float32 arrays of bfloat16 values."""
    U32, _ = _bf16_values((K,) + shape, seed)
    if halos == "zero":
        return U32, None, None
    lo32, _ = _bf16_values((K,) + shape[1:], seed + 1)
    hi32, _ = _bf16_values((K,) + shape[1:], seed + 2)
    return U32, lo32, hi32


def _exact_dots(U32, lo32, hi32):
    """``<u_j, A u_j>`` in fp64 from the bfloat16 values."""
    t = lambda a: None if a is None else torch.from_numpy(a).double()
    U = t(U32)
    return (U * st.stencil3d_apply_many_plain(U, t(lo32), t(hi32))).sum(
        dim=(1, 2, 3)).numpy()


@pytest.mark.parametrize("halos", ["random", "zero"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_bf16_many_match_stencil7_jnp_at_tile_edges(shape, halos):
    U32, lo32, hi32 = _block(shape, halos, sum(shape))
    U, lo, hi = _tb(U32), _tb(lo32), _tb(hi32)
    Y = st.stencil3d_apply_many(U, lo, hi)
    Yd, d = st.stencil3d_dot_many(U, lo, hi)
    assert Y.dtype == Yd.dtype == torch.bfloat16 and d.dtype == torch.float32
    zero = np.zeros(shape[1:], BF16)
    for j in range(K):
        jlo = zero if lo32 is None else lo32[j].astype(BF16)
        jhi = zero if hi32 is None else hi32[j].astype(BF16)
        y_ref = np.asarray(JaxStencil._stencil7_jnp(
            jnp.asarray(U32[j].astype(BF16)), jnp.asarray(jlo),
            jnp.asarray(jhi)), np.float32)
        # both sum the 7 terms in fp32 in one order and round once
        np.testing.assert_array_equal(Y[j].float().numpy(), y_ref)
        np.testing.assert_array_equal(Yd[j].float().numpy(), y_ref)
    np.testing.assert_allclose(d.double().numpy(),
                               _exact_dots(U32, lo32, hi32), rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 16, 128), (5, 17, 128)],
                         ids=["one-tile", "row-past-a-tile"])
@pytest.mark.parametrize("kind", ["apply", "dot"])
def test_bf16_many_match_pallas_interpret_at_tile_edges(kind, shape):
    lz, ny, nx = shape
    U32, lo32, hi32 = _block(shape, "random", 300 + ny)
    args = (jnp.asarray(U32.astype(BF16)),
            jnp.asarray(lo32[:, None].astype(BF16)),
            jnp.asarray(hi32[:, None].astype(BF16)), lz, ny, nx, K, True)
    U, lo, hi = _tb(U32), _tb(lo32), _tb(hi32)
    if kind == "apply":
        Y_ref = stencil3d_apply_many_pallas(*args)
        Y = st.stencil3d_apply_many(U, lo, hi)
    else:
        Y_ref, d_ref = stencil3d_dot_many_pallas(*args)
        Y, d = st.stencil3d_dot_many(U, lo, hi)
        exact = _exact_dots(U32, lo32, hi32)
        np.testing.assert_allclose(d.double().numpy(), exact, rtol=1e-6)
        # the interpreter's fp32 chunk sums: within 2e-6 of the fp64 value
        np.testing.assert_allclose(np.asarray(d_ref, np.float64), exact,
                                   rtol=2e-6)
    np.testing.assert_array_equal(Y.float().numpy(),
                                  np.asarray(Y_ref, np.float32))


class _StandInLibrary:
    """The block counts of ``csrc/stencil7.cu``, one a dtype, recording
    each call, and its route query."""

    def __init__(self, route=1):
        self.calls = []
        self.route = route

    def stencil7_dot_blocks_f32(self, lz, ny, nx):
        self.calls.append(("stencil7_dot_blocks_f32", (lz, ny, nx)))
        return 7

    def stencil7_dot_blocks_f64(self, lz, ny, nx):
        self.calls.append(("stencil7_dot_blocks_f64", (lz, ny, nx)))
        return 5

    def stencil7_dot_blocks_bf16(self, lz, ny, nx):
        self.calls.append(("stencil7_dot_blocks_bf16", (lz, ny, nx)))
        return 3

    def stencil7_bf16_route(self, nx, *ptrs):
        self.calls.append(("stencil7_bf16_route", (nx,) + ptrs))
        return self.route

    def stencil7_run_route_f32(self, nx, *ptrs):
        self.calls.append(("stencil7_run_route_f32", (nx,) + ptrs))
        return self.route

    def stencil7_run_route_f64(self, nx, *ptrs):
        self.calls.append(("stencil7_run_route_f64", (nx,) + ptrs))
        return self.route


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("dtype,entry,blocks", [
    (torch.bfloat16, "stencil7_dot_blocks_bf16", 3),
    (torch.float32, "stencil7_dot_blocks_f32", 7),
    (torch.float64, "stencil7_dot_blocks_f64", 5)], ids=["bf16", "f32", "f64"])
def test_dot_scratch_takes_its_dtypes_block_count(monkeypatch, dtype, entry,
                                                  blocks, k):
    lib = _StandInLibrary()
    monkeypatch.setattr(st, "_libs", {"stencil7": lib})
    assert st._dot_partials(st._kernels(), dtype, k, 4, 9, 256) == k * blocks
    assert lib.calls == [(entry, (4, 9, 256))]


@pytest.mark.parametrize("route,name", [(1, "vec16"), (0, "elem")])
def test_bf16_route_asks_the_library(monkeypatch, route, name):
    lib = _StandInLibrary(route)
    monkeypatch.setattr(st, "_libs", {"stencil7": lib})
    U = torch.zeros(2, 3, 4, 16, dtype=torch.bfloat16)
    Y = torch.empty_like(U)
    assert st.bf16_route(U, None, None, Y) == name
    # the last pointer is the V-cycle passes' right-hand side f (none here)
    assert lib.calls == [("stencil7_bf16_route",
                          (16, U.data_ptr(), None, None, Y.data_ptr(),
                           None))]
    F = torch.empty_like(U)
    lib.calls.clear()
    assert st.bf16_route(U, None, None, Y, F) == name
    assert lib.calls == [("stencil7_bf16_route",
                          (16, U.data_ptr(), None, None, Y.data_ptr(),
                           F.data_ptr()))]


@pytest.mark.parametrize("dtype,entry", [
    (torch.float32, "stencil7_run_route_f32"),
    (torch.float64, "stencil7_run_route_f64"),
    (torch.bfloat16, "stencil7_bf16_route")], ids=["f32", "f64", "bf16"])
def test_dot_route_asks_the_library(monkeypatch, dtype, entry):
    lib = _StandInLibrary(0)
    monkeypatch.setattr(st, "_libs", {"stencil7": lib})
    U = torch.zeros(2, 3, 4, 12, dtype=dtype)
    lo, hi = torch.zeros(2, 4, 12, dtype=dtype), torch.zeros(2, 4, 12,
                                                             dtype=dtype)
    Y = torch.empty_like(U)
    assert st.dot_route(U, lo, hi, Y) == "elem"
    ptrs = (U.data_ptr(), lo.data_ptr(), hi.data_ptr(), Y.data_ptr())
    assert lib.calls == [(entry, (12,) + ptrs
                          + ((None,) if dtype == torch.bfloat16 else ()))]


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16], ids=["f32", "f64", "bf16"])
def test_dot_launch_passes_the_fold_counters(monkeypatch, dtype, k):
    """A dot launch's C arguments: the partial-sum scratch sized from the
    dtype's block count, in the reduce dtype; under f32/f64 the fold's ticket
    counters right after it (one launch sums the partials), under bf16
    none (a second launch in the library sums them)."""
    lib = _StandInLibrary()
    monkeypatch.setattr(st, "_libs", {"stencil7": lib})
    tickets = torch.zeros(65535, dtype=torch.int32)
    monkeypatch.setattr(st, "_tickets", lambda u: tickets)
    seen = []
    monkeypatch.setattr(st, "_launch", lambda *a: seen.append(a))
    shape = (4, 9, 256) if k is None else (k, 4, 9, 256)
    U = torch.zeros(shape, dtype=dtype)
    Y = torch.empty_like(U)
    out = torch.empty(() if k is None else (k,),
                      dtype=torch.float32 if dtype == torch.bfloat16 else dtype)
    dims = shape if k else (4, 9, 256)
    name = "stencil7_dot" if k is None else "stencil7_dot_many"
    st._launch_dot(name, U, None, None, Y, out, *dims)
    ((lib_name, fn_name, u, what, *args),) = seen
    assert (lib_name, fn_name, u is U, what) == ("stencil7", name, True,
                                                 f"{name} launch")
    fold = [tickets.data_ptr()] if dtype != torch.bfloat16 else []
    assert args[:4] == [U.data_ptr(), None, None, Y.data_ptr()]
    assert args[5:] == fold + [out.data_ptr(), *dims]
    entry = f"stencil7_dot_blocks_{st._SUFFIX[dtype]}"
    assert lib.calls == [(entry, (4, 9, 256))]

