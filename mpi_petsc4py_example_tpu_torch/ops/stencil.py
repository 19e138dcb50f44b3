"""The 7-point stencil apply and fused apply + dot: CUDA kernels and plain versions.

Counterpart of ``mpi_petsc4py_example_tpu/ops/pallas_stencil.py``:

* :func:`stencil3d_apply` replaces ``stencil3d_apply_pallas`` (``:365``);
* :func:`stencil3d_dot` replaces ``stencil3d_dot_pallas`` (``:394``).

Both take a z-slab ``u (lz, ny, nx)`` (x fastest) and its neighbour planes
``halo_lo``/``halo_hi (ny, nx)``, and compute ``A u = 6u - (6 neighbours)``
with zero fill in x and y; the dot form also returns ``sum(u * A u)`` over the
slab (the shard's partial). The kernels are in ``csrc/stencil7.cu``.

Dispatch is by the device of ``u`` alone: a CPU tensor goes through the plain
PyTorch version beside each kernel, a CUDA tensor launches the kernel or
raises. There is no fallback from one to the other. Each wrapper counts its
kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.errors import DeviceExecutionError
from . import build

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_INT_MAX = 2**31 - 1
_lib = None


def _kernels() -> ctypes.CDLL:
    """The built ``stencil7`` library with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = build.load("stencil7")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        for sfx in _SUFFIX.values():
            apply_fn = getattr(lib, f"stencil7_apply_{sfx}")
            apply_fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp]
            apply_fn.restype = ci
            dot_fn = getattr(lib, f"stencil7_dot_{sfx}")
            dot_fn.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
            dot_fn.restype = ci
        lib.stencil7_dot_blocks.argtypes = [ci, ci, ci]
        lib.stencil7_dot_blocks.restype = ctypes.c_longlong
        lib.stencil7_error_string.argtypes = [ci]
        lib.stencil7_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(u, halo_lo, halo_hi, out):
    """Validate operands; returns ``(lz, ny, nx)``. Raises on a dtype, shape,
    layout or device the kernel does not take (on every device, so the plain
    path accepts exactly what the kernel accepts)."""
    if u.dtype not in _SUFFIX:
        raise TypeError(f"stencil kernels take float32/float64, got {u.dtype}")
    if u.dim() != 3 or min(u.shape) < 1 or max(u.shape) > _INT_MAX:
        raise ValueError(f"u must be a non-empty (lz, ny, nx) slab, got "
                         f"shape {tuple(u.shape)}")
    lz, ny, nx = u.shape
    operands = [("u", u, (lz, ny, nx)), ("halo_lo", halo_lo, (ny, nx)),
                ("halo_hi", halo_hi, (ny, nx))]
    if out is not None:
        operands.append(("out", out, (lz, ny, nx)))
    for name, t, shape in operands:
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.dtype != u.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, u has {u.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stencil kernels run on cpu or cuda, not {u.device}")
    return lz, ny, nx


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _kernels().stencil7_error_string(err).decode()
        raise DeviceExecutionError(what, f"CUDA error {err}: {msg}")


def _stream(u) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(u.device).cuda_stream)


# ---- plain versions (pure PyTorch; the CPU path and the card's yardstick) ----

def stencil3d_apply_plain(u, halo_lo, halo_hi):
    """``A u`` with pads and slices, as ``StencilPoisson3D._stencil7_jnp``."""
    ext = torch.cat([halo_lo[None], u, halo_hi[None]], dim=0)
    ym = F.pad(u[:, :-1, :], (0, 0, 1, 0))
    yp = F.pad(u[:, 1:, :], (0, 0, 0, 1))
    xm = F.pad(u[:, :, :-1], (1, 0))
    xp = F.pad(u[:, :, 1:], (0, 1))
    return 6.0 * u - ext[:-2] - ext[2:] - ym - yp - xm - xp


def stencil3d_dot_plain(u, halo_lo, halo_hi):
    """``(A u, sum(u * A u))`` with the plain apply and a separate sum."""
    y = stencil3d_apply_plain(u, halo_lo, halo_hi)
    return y, (u * y).sum()


# ---- wrappers -----------------------------------------------------------------

def stencil3d_apply(u, halo_lo, halo_hi, out=None):
    """``A u`` for the slab ``u (lz, ny, nx)`` with halo planes ``(ny, nx)``.
    Writes into ``out`` when given; returns the result."""
    lz, ny, nx = _check(u, halo_lo, halo_hi, out)
    if u.device.type == "cpu":
        y = stencil3d_apply_plain(u, halo_lo, halo_hi)
        return y if out is None else out.copy_(y)
    y = torch.empty_like(u) if out is None else out
    fn = getattr(_kernels(), f"stencil7_apply_{_SUFFIX[u.dtype]}")
    # the runtime launches on its current device: make it u's
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), halo_lo.data_ptr(), halo_hi.data_ptr(),
                 y.data_ptr(), lz, ny, nx, _stream(u))
    _raise_on(err, "stencil7_apply launch")
    stencil3d_apply.launches += 1
    return y


stencil3d_apply.launches = 0


def stencil3d_dot(u, halo_lo, halo_hi, out=None):
    """``(A u, sum(u * A u))`` in one pass; the sum is a 0-d tensor of
    ``u.dtype`` on ``u``'s device. Writes ``A u`` into ``out`` when given."""
    lz, ny, nx = _check(u, halo_lo, halo_hi, out)
    if u.device.type == "cpu":
        y, d = stencil3d_dot_plain(u, halo_lo, halo_hi)
        return (y if out is None else out.copy_(y)), d
    lib = _kernels()
    y = torch.empty_like(u) if out is None else out
    # per-block partials, summed in a fixed order by the library's second
    # kernel: no float atomics, so the sum is the same on every run
    partial = torch.empty(lib.stencil7_dot_blocks(lz, ny, nx), dtype=u.dtype,
                          device=u.device)
    total = torch.empty((), dtype=u.dtype, device=u.device)
    fn = getattr(lib, f"stencil7_dot_{_SUFFIX[u.dtype]}")
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), halo_lo.data_ptr(), halo_hi.data_ptr(),
                 y.data_ptr(), partial.data_ptr(), total.data_ptr(), lz, ny, nx,
                 _stream(u))
    _raise_on(err, "stencil7_dot launch")
    stencil3d_dot.launches += 1
    return y, total


stencil3d_dot.launches = 0
