"""The 7-point stencil kernels and the V-cycle's fused passes: CUDA kernels and
plain versions.

Counterpart of ``mpi_petsc4py_example_tpu/ops/pallas_stencil.py``:

* :func:`stencil3d_apply` replaces ``stencil3d_apply_pallas`` (``:365``);
* :func:`stencil3d_dot` replaces ``stencil3d_dot_pallas`` (``:394``);
* :func:`stencil3d_smooth` replaces ``stencil3d_smooth_pallas`` (``:652``);
* :func:`stencil3d_residual` replaces ``stencil3d_residual_pallas`` (``:686``);
* :func:`stencil3d_smooth0_pair` replaces ``stencil3d_smooth0_pair_pallas``
  (``:1124``);
* :func:`stencil3d_smooth_pair` replaces ``stencil3d_smooth_pair_pallas``
  (``:1251``);
* :func:`stencil3d_residual_restrict` replaces
  ``stencil3d_residual_restrict_pallas`` (``:1090``);
* :func:`stencil3d_apply_many` replaces ``stencil3d_apply_many_pallas``
  (``:591``);
* :func:`stencil3d_dot_many` replaces ``stencil3d_dot_many_pallas``
  (``:620``).

The four kernels of the Krylov loops (apply, dot and their ``_many`` twins)
take float32, float64 and bfloat16 storage, as the TPU kernels take float32
and bfloat16; so do the V-cycle's smooth, residual, smooth0_pair and
smooth_pair, which the TPU V-cycle runs at bfloat16 storage
(``pallas_supported``, ``:721``, is True for bfloat16 there), while
residual_restrict takes float32 and float64 (the TPU V-cycle at bfloat16
never reaches it: ``mg._mm_ok`` is False there). Under bfloat16 (the
storage of the mixed-precision plan, ``solvers/cg_plans.py``) each loaded
value is lifted to fp32, the 7-term sum and the epilogue are formed in fp32
and the result rounded once to bfloat16 (the TPU kernels' ``_compute_dtype``,
``:46``); smooth_pair rounds its first sweep to bfloat16 too, so it equals
two smooth sweeps bit for bit (the TPU's ``_double_sweep_kernel`` computes
in bfloat16 throughout: ``ROADMAP.md`` Queue C). The dots sum ``u * A u``
in fp32 from the unrounded fp32 ``A u`` (``:237``, ``:552``) and return fp32
scalars (the reduce dtype, ``:417-420``), as the plain versions do.

All take a z-slab ``u (lz, ny, nx)`` (x fastest) and compute with
``A u = 6u - (6 neighbours)``, zero fill in x and y. The first four read the z
neighbours of the end planes from halo planes ``halo_lo``/``halo_hi (ny, nx)``;
apply, smooth and residual also take ``None`` for both, zero (Dirichlet)
planes that the kernels' zero-halo instantiation never reads. The last three
are single-slab passes with zero Dirichlet ghosts on every side. The two
``_many`` functions take ``k`` slabs ``U (k, lz, ny, nx)`` with halo blocks
``(k, ny, nx)`` (or ``None`` for both) in one launch: the batched solve's
apply and its fused per-column ``<u_j, A u_j>``.
The first five kernels and the two ``_many`` kernels are in
``csrc/stencil7.cu``: the f32/f64 applies and V-cycle passes one march with
an epilogue per function; the dots of every dtype and the bfloat16 applies
one run kernel of 16-byte runs, whose single-RHS launch is its k = 1 launch,
on a 16-byte or an element route (:func:`dot_route`, :func:`bf16_route`),
and the V-cycle's three bfloat16 passes that kernel with an epilogue. The
f32/f64 dots sum their per-block partials in the same launch (a ticket
counter a column, :func:`_tickets`), the bfloat16 dots in a second one. The
two that need two-deep z neighbourhoods are in ``csrc/mg3d.cu``.

Dispatch is by the device of ``u`` alone: a CPU tensor goes through the plain
PyTorch version beside each kernel, a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other. Each wrapper counts its
kernel launches in ``<wrapper>.launches``. The plain versions repeat the
kernels' order of operations, so on the card the two agree to the last bit
(the dot's sum excepted, which adds in another order).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.dtypes import reduce_dtype
from ..utils.errors import DeviceExecutionError
from . import build

# one axis of the restriction R = (1/2) P^T: the 3-axis product scales the
# restricted residual by 4 (= h_c^2/h_f^2 under the level-independent unit
# stencil) on top of the weight-2-per-axis adjoint, i.e. (2 s)^3 = 4
RSCALE = 4.0 ** (1.0 / 3.0) / 2.0

_SUFFIX = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
# the storage dtypes of residual_restrict (the TPU V-cycle reaches its kernel
# at float32 only; bfloat16 restricts after the residual pass)
_VCYCLE_DTYPES = (torch.float32, torch.float64)
# the entry points with a bfloat16 instantiation
_BF16_KERNELS = ("stencil7_apply", "stencil7_dot", "stencil7_apply_many",
                 "stencil7_dot_many", "stencil7_smooth", "stencil7_residual",
                 "stencil7_smooth0_pair", "mg3d_smooth_pair")
_INT_MAX = 2**31 - 1
_VP, _CI, _CD = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C signatures of the entry points, per library, without the dtype suffix
_SIGNATURES = {
    "stencil7": {
        "stencil7_apply": [_VP] * 4 + [_CI] * 3 + [_VP],
        "stencil7_dot": [_VP] * 6 + [_CI] * 3 + [_VP],
        "stencil7_smooth": [_VP] * 5 + [_CI] * 3 + [_CD, _VP],
        "stencil7_residual": [_VP] * 5 + [_CI] * 3 + [_VP],
        "stencil7_smooth0_pair": [_VP] * 2 + [_CI] * 3 + [_CD, _CD, _VP],
        "stencil7_apply_many": [_VP] * 4 + [_CI] * 4 + [_VP],
        "stencil7_dot_many": [_VP] * 6 + [_CI] * 4 + [_VP],
    },
    "mg3d": {
        "mg3d_smooth_pair": [_VP] * 3 + [_CI] * 3 + [_CD, _CD, _VP],
        "mg3d_residual_restrict": [_VP] * 3 + [_CI] * 3 + [_CD, _VP],
    },
}
# the f32/f64 dots fold their sum in the launch: one more pointer than the
# bfloat16 ones, the ticket counters, after the partial-sum scratch
_FOLD_DTYPES = (torch.float32, torch.float64)
_FOLD_SIGNATURES = {"stencil7_dot": [_VP] * 7 + [_CI] * 3 + [_VP],
                    "stencil7_dot_many": [_VP] * 7 + [_CI] * 4 + [_VP]}
_libs: dict[str, ctypes.CDLL] = {}
# the fold's ticket counters (one a column, up to the 65535 columns of a
# launch), per device; see _tickets
_TICKETS: dict[int, torch.Tensor] = {}
_CAPTURED_TICKETS: list[torch.Tensor] = []


def _kernels(name: str = "stencil7") -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` library with its C signatures declared."""
    lib = _libs.get(name)
    if lib is None:
        lib = build.load(name)
        for fn_name, argtypes in _SIGNATURES[name].items():
            for dtype, sfx in _SUFFIX.items():
                if dtype == torch.bfloat16 and fn_name not in _BF16_KERNELS:
                    continue
                fn = getattr(lib, f"{fn_name}_{sfx}")
                fold = fn_name in _FOLD_SIGNATURES and dtype in _FOLD_DTYPES
                fn.argtypes = _FOLD_SIGNATURES[fn_name] if fold else argtypes
                fn.restype = _CI
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_CI]
        err.restype = ctypes.c_char_p
        if name == "stencil7":
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"stencil7_dot_blocks_{sfx}")
                fn.argtypes = [_CI, _CI, _CI]
                fn.restype = ctypes.c_longlong
            for dtype in _FOLD_DTYPES:
                fn = getattr(lib, f"stencil7_run_route_{_SUFFIX[dtype]}")
                fn.argtypes = [_CI] + [_VP] * 4
                fn.restype = _CI
            lib.stencil7_bf16_route.argtypes = [_CI] + [_VP] * 5
            lib.stencil7_bf16_route.restype = _CI
        _libs[name] = lib
    return lib


def _overlaps(a, b) -> bool:
    lo_a, lo_b = a.data_ptr(), b.data_ptr()
    return (lo_a < lo_b + b.numel() * b.element_size()
            and lo_b < lo_a + a.numel() * a.element_size())


def _check(u, out=None, out_shape=None, many=False, dtypes=_VCYCLE_DTYPES,
           **operands):
    """Validate the slab ``u`` (``many``: the block ``(k, lz, ny, nx)`` of
    ``k`` slabs) and the named operands (``f``, ``halo_lo``, ``halo_hi``;
    the halos, ``(ny, nx)`` planes or ``(k, ny, nx)`` blocks, may be both
    None, zero planes); returns ``u.shape``. Raises on a dtype (outside
    ``dtypes``), shape, layout or device the kernel does not take, and on an
    ``out`` that overlaps an input (on every device, so the plain path
    accepts exactly what the kernel accepts)."""
    if u.dtype not in dtypes:
        names = "/".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"this stencil kernel takes {names}, got {u.dtype}")
    what = "(k, lz, ny, nx) block" if many else "(lz, ny, nx) slab"
    if (u.dim() != 3 + many or min(u.shape) < 1
            or max(u.shape) > _INT_MAX):
        raise ValueError(f"u must be a non-empty {what}, got "
                         f"shape {tuple(u.shape)}")
    full = tuple(u.shape)
    plane = full[:-3] + full[-2:]
    if (operands.get("halo_lo") is None) != (operands.get("halo_hi") is None):
        raise ValueError("pass both halo planes, or None for both")
    expect = {"f": full, "halo_lo": plane, "halo_hi": plane}
    items = [("u", u, full)]
    items += [(k, t, expect[k]) for k, t in operands.items() if t is not None]
    inputs = [t for _, t, _ in items]
    if out is not None:
        items.append(("out", out, out_shape or full))
    for name, t, shape in items:
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != u.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, u has {u.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if out is not None and any(_overlaps(out, t) for t in inputs):
        raise ValueError("out must not overlap an input")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stencil kernels run on cpu or cuda, not {u.device}")
    return full


def _launch(lib_name, fn_name, u, what, *args):
    """Call ``<fn_name>_<dtype>`` of library ``lib_name`` on ``u``'s device
    and current stream; raises on a launch error."""
    lib = _kernels(lib_name)
    fn = getattr(lib, f"{fn_name}_{_SUFFIX[u.dtype]}")
    # the runtime launches on its current device: make it u's
    with torch.cuda.device(u.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream)
        err = fn(*args, stream)
    if err != 0:
        msg = getattr(lib, f"{lib_name}_error_string")(err).decode()
        raise DeviceExecutionError(what, f"CUDA error {err}: {msg}")


def _count(wrapper, dtype):
    """One launch of ``wrapper``'s kernel: ``launches`` counts every
    instantiation, ``launches_bf16`` the bfloat16 one."""
    wrapper.launches += 1
    if dtype == torch.bfloat16:
        wrapper.launches_bf16 += 1


def _dot_partials(lib, dtype, k, lz, ny, nx) -> int:
    """Length of the partial-sum scratch of a dot launch on ``k`` slabs of
    ``(lz, ny, nx)``: ``k`` times one slab's blocks, whose tiling depends on
    the dtype (``lib`` is the loaded ``stencil7`` library)."""
    blocks = getattr(lib, f"stencil7_dot_blocks_{_SUFFIX[dtype]}")
    return k * blocks(lz, ny, nx)


def _tickets(u) -> torch.Tensor:
    """The ticket counters of the f32/f64 dots' fold on ``u``'s device:
    65535 zeros, made once. Each launch's last block sets its columns'
    counters back to 0, so they are zero at every launch that follows it in
    stream order, also at a CUDA graph's replay (a captured launch keeps
    this buffer's address). Launches on one device share them, so dots on
    two streams must not run at once (the port launches on one stream).
    Made under a capture, where the zero fill runs only at replays, the
    buffer stays the graph's own and the cache is left for eager work."""
    index = u.device.index
    t = _TICKETS.get(index)
    if t is None:
        with torch.cuda.device(u.device):
            t = torch.zeros(65535, dtype=torch.int32, device=u.device)
            if torch.cuda.is_current_stream_capturing():
                _CAPTURED_TICKETS.append(t)
            else:
                torch.cuda.current_stream(u.device).synchronize()
                _TICKETS[index] = t
    return t


def _launch_dot(fn_name, u, halo_lo, halo_hi, y, out, *dims):
    """One dot launch, ``dims`` being ``(lz, ny, nx)`` or ``(k, lz, ny,
    nx)``: the partial-sum scratch in ``out``'s dtype, and under f32/f64 the
    ticket counters of the fold, which sums the partials in the same launch
    (bfloat16 sums them in a second one, inside the library)."""
    lib = _kernels()
    k = dims[0] if len(dims) == 4 else 1
    partial = torch.empty(_dot_partials(lib, u.dtype, k, *dims[-3:]),
                          dtype=out.dtype, device=u.device)
    tickets = ([_tickets(u).data_ptr()] if u.dtype in _FOLD_DTYPES else [])
    _launch("stencil7", fn_name, u, f"{fn_name} launch", u.data_ptr(),
            _ptr(halo_lo), _ptr(halo_hi), y.data_ptr(), partial.data_ptr(),
            *tickets, out.data_ptr(), *dims)


def dot_route(u, halo_lo, halo_hi, out) -> str:
    """The route a dot launch of ``csrc/stencil7.cu`` on these CUDA tensors
    takes: ``"vec16"``, 16-byte runs, when ``nx`` is a multiple of the
    points in 16 bytes (4 f32, 2 f64, 8 bf16) and every pointer is 16-byte
    aligned; else ``"elem"``."""
    if u.dtype == torch.bfloat16:
        return bf16_route(u, halo_lo, halo_hi, out)
    route = getattr(_kernels(), f"stencil7_run_route_{_SUFFIX[u.dtype]}")
    vec = route(u.shape[-1], u.data_ptr(), _ptr(halo_lo), _ptr(halo_hi),
                out.data_ptr())
    return "vec16" if vec else "elem"


def bf16_route(u, halo_lo, halo_hi, out, f=None) -> str:
    """The route a bfloat16 launch of ``csrc/stencil7.cu`` on these CUDA
    tensors takes (``stencil7_bf16_route``; ``f`` the V-cycle passes'
    right-hand side): ``"vec16"``, 16-byte runs, when ``nx`` is a multiple
    of 8 and every pointer 16-byte aligned; else ``"elem"``."""
    vec = _kernels().stencil7_bf16_route(u.shape[-1], u.data_ptr(),
                                         _ptr(halo_lo), _ptr(halo_hi),
                                         out.data_ptr(), _ptr(f))
    return "vec16" if vec else "elem"


def _out(u, out, shape=None):
    if out is not None:
        return out
    return torch.empty(shape, dtype=u.dtype, device=u.device) if shape \
        else torch.empty_like(u)


def _zero_plane(u):
    return u.new_zeros(u.shape[1:])


def _ptr(t):
    """A device pointer; a ``None`` halo passes as NULL, which selects the
    kernel's zero-halo instantiation."""
    return None if t is None else t.data_ptr()


# ---- plain versions (pure PyTorch; the CPU path and the card's yardstick) ----

def _lift(*ts):
    """The operands in the arithmetic dtype (fp32 copies for bfloat16;
    ``None`` halos stay ``None``)."""
    return [t if t is None else t.to(reduce_dtype(t.dtype)) for t in ts]


def _apply_body(u, halo_lo, halo_hi):
    if halo_lo is None and halo_hi is None:
        halo_lo = halo_hi = _zero_plane(u)
    ext = torch.cat([halo_lo[None], u, halo_hi[None]], dim=0)
    ym = F.pad(u[:, :-1, :], (0, 0, 1, 0))
    yp = F.pad(u[:, 1:, :], (0, 0, 0, 1))
    xm = F.pad(u[:, :, :-1], (1, 0))
    xp = F.pad(u[:, :, 1:], (0, 1))
    return 6.0 * u - ext[:-2] - ext[2:] - ym - yp - xm - xp


def _apply_many_body(U, halo_lo, halo_hi):
    if halo_lo is None and halo_hi is None:
        halo_lo = halo_hi = U.new_zeros(U.shape[:1] + U.shape[2:])
    ext = torch.cat([halo_lo[:, None], U, halo_hi[:, None]], dim=1)
    ym = F.pad(U[..., :-1, :], (0, 0, 1, 0))
    yp = F.pad(U[..., 1:, :], (0, 0, 0, 1))
    xm = F.pad(U[..., :-1], (1, 0))
    xp = F.pad(U[..., 1:], (0, 1))
    return 6.0 * U - ext[:, :-2] - ext[:, 2:] - ym - yp - xm - xp


def stencil3d_apply_plain(u, halo_lo, halo_hi):
    """``A u`` with pads and slices, as ``StencilPoisson3D._stencil7_jnp``
    (``None`` halos are zero planes). bfloat16 is lifted to fp32, computed
    in the same order and rounded once."""
    y = _apply_body(*_lift(u, halo_lo, halo_hi))
    return y.to(u.dtype)


def stencil3d_dot_plain(u, halo_lo, halo_hi):
    """``(A u, sum(u * A u))`` with the plain apply and a separate sum; under
    bfloat16 the sum is fp32, taken from the unrounded fp32 ``A u``."""
    u32, lo, hi = _lift(u, halo_lo, halo_hi)
    y = _apply_body(u32, lo, hi)
    return y.to(u.dtype), (u32 * y).sum()


def stencil3d_apply_many_plain(U, halo_lo, halo_hi):
    """``A u_j`` for each slab of ``U (k, lz, ny, nx)``, with
    :func:`stencil3d_apply_plain`'s order of operations along the last three
    axes (``None`` halos are zero planes), so each column equals that
    function on the column bit for bit."""
    return _apply_many_body(*_lift(U, halo_lo, halo_hi)).to(U.dtype)


def stencil3d_dot_many_plain(U, halo_lo, halo_hi):
    """``(A U, dots)`` with ``dots[j] = sum(u_j * A u_j)``, shape ``(k,)``
    (fp32 from the unrounded ``A U`` under bfloat16)."""
    U32, lo, hi = _lift(U, halo_lo, halo_hi)
    Y = _apply_many_body(U32, lo, hi)
    return Y.to(U.dtype), (U32 * Y).sum(dim=(1, 2, 3))


def stencil3d_smooth_plain(u, f, halo_lo, halo_hi, w):
    """One damped-Jacobi sweep ``u + w (f - A u)`` (``w`` is omega/6);
    bfloat16 is lifted to fp32, computed and rounded once."""
    u32, f32, lo, hi = _lift(u, f, halo_lo, halo_hi)
    return (u32 + w * (f32 - _apply_body(u32, lo, hi))).to(u.dtype)


def stencil3d_residual_plain(u, f, halo_lo, halo_hi):
    """The residual ``f - A u`` (bfloat16: fp32, rounded once)."""
    u32, f32, lo, hi = _lift(u, f, halo_lo, halo_hi)
    return (f32 - _apply_body(u32, lo, hi)).to(u.dtype)


def stencil3d_smooth0_pair_plain(f, w1, w2):
    """Two sweeps from a zero guess with zero ghosts:
    ``u1 = w1 f``, ``u2 = u1 + w2 (f - A u1) = (w1 + w2) f - w1 w2 (A f)``
    (bfloat16: fp32, rounded once)."""
    (f32,) = _lift(f)
    return ((w1 + w2) * f32
            - (w1 * w2) * _apply_body(f32, None, None)).to(f.dtype)


def stencil3d_smooth_pair_plain(u, f, w1, w2):
    """Two sweeps ``S_w2(S_w1(u))`` with zero ghosts on every side (each
    sweep rounded to bfloat16 under bfloat16 storage)."""
    u1 = stencil3d_smooth_plain(u, f, None, None, w1)
    return stencil3d_smooth_plain(u1, f, None, None, w2)


def restrict1d(f, ax: int, lo=None, hi=None):
    """One axis of the restriction ``R = (1/2) P^T``::

        coarse[i] = s (0.75 (f[2i] + f[2i+1]) + 0.25 (f[2i-1] + f[2i+2]))

    with ``s = RSCALE`` and zero ghosts; ``lo``/``hi`` (the neighbouring
    slabs' boundary planes, ``f[-1]`` and ``f[2m]``) override the ghosts in
    the sharded z pass. The counterpart of ``mg._r1d`` of the JAX package."""
    sh = tuple(f.shape)
    m = sh[ax] // 2
    g = f.reshape(sh[:ax] + (m, 2) + sh[ax + 1:])
    ev = g.select(ax + 1, 0)                  # f[2i]
    od = g.select(ax + 1, 1)                  # f[2i+1]
    if lo is None:
        lo = torch.zeros_like(od.select(ax, 0))
    if hi is None:
        hi = torch.zeros_like(lo)
    odm = torch.cat([lo.unsqueeze(ax), od.narrow(ax, 0, m - 1)], dim=ax)
    evp = torch.cat([ev.narrow(ax, 1, m - 1), hi.unsqueeze(ax)], dim=ax)
    return RSCALE * (0.75 * (ev + od) + 0.25 * (odm + evp))


def stencil3d_residual_restrict_plain(u, f):
    """``restrict(f - A u)`` with zero ghosts: the residual, then the
    four-tap restriction along z, y and x in that order."""
    r = stencil3d_residual_plain(u, f, None, None)
    return restrict1d(restrict1d(restrict1d(r, 0), 1), 2)


# ---- wrappers -----------------------------------------------------------------

def stencil3d_apply(u, halo_lo, halo_hi, out=None):
    """``A u`` for the slab ``u (lz, ny, nx)`` with halo planes ``(ny, nx)``.
    Writes into ``out`` when given; returns the result."""
    lz, ny, nx = _check(u, out, dtypes=_SUFFIX, halo_lo=halo_lo,
                        halo_hi=halo_hi)
    if u.device.type == "cpu":
        y = stencil3d_apply_plain(u, halo_lo, halo_hi)
        return y if out is None else out.copy_(y)
    y = _out(u, out)
    _launch("stencil7", "stencil7_apply", u, "stencil7_apply launch",
            u.data_ptr(), _ptr(halo_lo), _ptr(halo_hi), y.data_ptr(),
            lz, ny, nx)
    _count(stencil3d_apply, u.dtype)
    return y


def stencil3d_dot(u, halo_lo, halo_hi, out=None):
    """``(A u, sum(u * A u))`` in one pass; the sum is a 0-d tensor of the
    reduce dtype (``u.dtype``, fp32 for bfloat16) on ``u``'s device. Writes
    ``A u`` into ``out`` when given. Both halo planes are required."""
    if halo_lo is None or halo_hi is None:
        raise ValueError("stencil3d_dot needs both halo planes")
    lz, ny, nx = _check(u, out, dtypes=_SUFFIX, halo_lo=halo_lo,
                        halo_hi=halo_hi)
    if u.device.type == "cpu":
        y, d = stencil3d_dot_plain(u, halo_lo, halo_hi)
        return (y if out is None else out.copy_(y)), d
    y = _out(u, out)
    # per-block partials, summed in a fixed order: no float atomics, so the
    # sum is the same on every run
    total = torch.empty((), dtype=reduce_dtype(u.dtype), device=u.device)
    _launch_dot("stencil7_dot", u, halo_lo, halo_hi, y, total, lz, ny, nx)
    _count(stencil3d_dot, u.dtype)
    return y, total


def stencil3d_smooth(u, f, halo_lo, halo_hi, w, out=None):
    """One damped-Jacobi sweep ``u + w (f - A u)`` in one pass; ``w`` is the
    sweep's omega/6."""
    lz, ny, nx = _check(u, out, dtypes=_SUFFIX, f=f, halo_lo=halo_lo,
                        halo_hi=halo_hi)
    if u.device.type == "cpu":
        y = stencil3d_smooth_plain(u, f, halo_lo, halo_hi, w)
        return y if out is None else out.copy_(y)
    y = _out(u, out)
    _launch("stencil7", "stencil7_smooth", u, "stencil7_smooth launch",
            u.data_ptr(), f.data_ptr(), _ptr(halo_lo), _ptr(halo_hi),
            y.data_ptr(), lz, ny, nx, float(w))
    _count(stencil3d_smooth, u.dtype)
    return y


def stencil3d_residual(u, f, halo_lo, halo_hi, out=None):
    """The residual ``f - A u`` in one pass."""
    lz, ny, nx = _check(u, out, dtypes=_SUFFIX, f=f, halo_lo=halo_lo,
                        halo_hi=halo_hi)
    if u.device.type == "cpu":
        y = stencil3d_residual_plain(u, f, halo_lo, halo_hi)
        return y if out is None else out.copy_(y)
    y = _out(u, out)
    _launch("stencil7", "stencil7_residual", u, "stencil7_residual launch",
            u.data_ptr(), f.data_ptr(), _ptr(halo_lo), _ptr(halo_hi),
            y.data_ptr(), lz, ny, nx)
    _count(stencil3d_residual, u.dtype)
    return y


def stencil3d_smooth0_pair(f, w1, w2, out=None):
    """Two damped-Jacobi sweeps from a zero guess, zero ghosts:
    ``(w1 + w2) f - w1 w2 (A f)`` in one pass (``w1``/``w2`` are omega/6)."""
    lz, ny, nx = _check(f, out, dtypes=_SUFFIX)
    if f.device.type == "cpu":
        y = stencil3d_smooth0_pair_plain(f, w1, w2)
        return y if out is None else out.copy_(y)
    y = _out(f, out)
    # the coefficients are formed in double, as the plain version's Python
    # floats are, and rounded to the arithmetic dtype in the kernel
    _launch("stencil7", "stencil7_smooth0_pair", f,
            "stencil7_smooth0_pair launch", f.data_ptr(), y.data_ptr(),
            lz, ny, nx, float(w1) + float(w2), float(w1) * float(w2))
    _count(stencil3d_smooth0_pair, f.dtype)
    return y


def stencil3d_smooth_pair(u, f, w1, w2, out=None):
    """Two damped-Jacobi sweeps ``S_w2(S_w1(u))`` from a nonzero guess in one
    pass, zero ghosts on every side (``w1``/``w2`` are omega/6). The kernel
    takes every ``lz``: it has no chunk limit."""
    lz, ny, nx = _check(u, out, dtypes=_SUFFIX, f=f)
    if u.device.type == "cpu":
        y = stencil3d_smooth_pair_plain(u, f, w1, w2)
        return y if out is None else out.copy_(y)
    y = _out(u, out)
    _launch("mg3d", "mg3d_smooth_pair", u, "mg3d_smooth_pair launch",
            u.data_ptr(), f.data_ptr(), y.data_ptr(), lz, ny, nx, float(w1),
            float(w2))
    _count(stencil3d_smooth_pair, u.dtype)
    return y


def stencil3d_residual_restrict(u, f, out=None):
    """The coarse right-hand side ``restrict(f - A u)`` of shape
    ``(lz/2, ny/2, nx/2)`` in one pass, zero ghosts: neither the fine
    residual nor any intermediate is written. Raises ``ValueError`` on odd
    dims."""
    if u.dim() == 3 and any(d % 2 for d in u.shape):
        raise ValueError(f"fused 3-axis restriction needs even dims, got "
                         f"{tuple(u.shape)}")
    coarse = tuple(d // 2 for d in u.shape)
    lz, ny, nx = _check(u, out, coarse, f=f)
    if u.device.type == "cpu":
        y = stencil3d_residual_restrict_plain(u, f)
        return y if out is None else out.copy_(y)
    y = _out(u, out, coarse)
    _launch("mg3d", "mg3d_residual_restrict", u,
            "mg3d_residual_restrict launch", u.data_ptr(), f.data_ptr(),
            y.data_ptr(), lz, ny, nx, RSCALE)
    stencil3d_residual_restrict.launches += 1
    return y

def _check_many(U, out, halo_lo, halo_hi):
    """:func:`_check` for a column block; the kernels' grid takes at most
    65535 columns."""
    shape = _check(U, out, many=True, dtypes=_SUFFIX, halo_lo=halo_lo,
                   halo_hi=halo_hi)
    if shape[0] > 65535:
        raise ValueError(f"at most 65535 columns per launch, got {shape[0]}")
    return shape


def stencil3d_apply_many(U, halo_lo, halo_hi, out=None):
    """``A u_j`` for the ``k`` slabs of ``U (k, lz, ny, nx)`` in one launch;
    the halos are ``(k, ny, nx)`` blocks, or None for both (zero planes).
    Writes into ``out`` when given; returns the result."""
    k, lz, ny, nx = _check_many(U, out, halo_lo, halo_hi)
    if U.device.type == "cpu":
        Y = stencil3d_apply_many_plain(U, halo_lo, halo_hi)
        return Y if out is None else out.copy_(Y)
    Y = _out(U, out)
    _launch("stencil7", "stencil7_apply_many", U, "stencil7_apply_many launch",
            U.data_ptr(), _ptr(halo_lo), _ptr(halo_hi), Y.data_ptr(),
            k, lz, ny, nx)
    _count(stencil3d_apply_many, U.dtype)
    return Y


def stencil3d_dot_many(U, halo_lo, halo_hi, out=None):
    """``(A U, dots)`` for ``U (k, lz, ny, nx)`` in one pass, ``dots[j] =
    sum(u_j * A u_j)`` a ``(k,)`` tensor of the reduce dtype (``U.dtype``,
    fp32 for bfloat16) on ``U``'s device.
    The halos are ``(k, ny, nx)`` blocks, or None for both. On the card each
    column's ``A u_j`` and dot are bit-equal to one :func:`stencil3d_dot` on
    that column (the same blocks, partials and fixed summing order)."""
    k, lz, ny, nx = _check_many(U, out, halo_lo, halo_hi)
    if U.device.type == "cpu":
        Y, d = stencil3d_dot_many_plain(U, halo_lo, halo_hi)
        return (Y if out is None else out.copy_(Y)), d
    Y = _out(U, out)
    dots = torch.empty(k, dtype=reduce_dtype(U.dtype), device=U.device)
    _launch_dot("stencil7_dot_many", U, halo_lo, halo_hi, Y, dots, k, lz, ny,
                nx)
    _count(stencil3d_dot_many, U.dtype)
    return Y, dots

# every kernel wrapper, for code that reads or resets all launch counters
# (``launches``; the eight with a bfloat16 instantiation also count its
# launches alone in ``launches_bf16``)
KERNELS = {
    "stencil7_apply": stencil3d_apply,
    "stencil7_dot": stencil3d_dot,
    "stencil7_smooth": stencil3d_smooth,
    "stencil7_residual": stencil3d_residual,
    "stencil7_smooth0_pair": stencil3d_smooth0_pair,
    "mg3d_smooth_pair": stencil3d_smooth_pair,
    "mg3d_residual_restrict": stencil3d_residual_restrict,
    "stencil7_apply_many": stencil3d_apply_many,
    "stencil7_dot_many": stencil3d_dot_many,
}
for _wrapper in KERNELS.values():
    _wrapper.launches = 0
    _wrapper.launches_bf16 = 0


def reset_launches():
    """Set every launch counter to 0."""
    for wrapper in KERNELS.values():
        wrapper.launches = wrapper.launches_bf16 = 0
