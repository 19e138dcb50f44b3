"""Geometric multigrid V-cycle preconditioner for the 3D Poisson stencil.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/mg.py``: a
matrix-free V-cycle on the 7-point operator, used as PC ``mg`` inside CG.
Full coarsening by 2 per level (:func:`mg_levels`), per-axis linear
prolongation ``P`` with zero ghosts and restriction ``R = (1/2) P^T``
(per-axis scale ``RSCALE = 4^(1/3)/2``), pre/post smoothing with the
Chebyshev-root omega schedule (:func:`cheby_omegas`, the default) or damped
Jacobi (omega = 2/3), and 20 damped-Jacobi sweeps on the coarsest level.
R proportional to P^T and equal pre/post smoothing make the cycle a symmetric
operator, so CG accepts it as a preconditioner.

Kernels (``ops/stencil.py``): the single-slab cycle runs each level above the
coarsest as ``smooth0_pair`` (two sweeps from zero), ``residual_restrict``
(the coarse right-hand side in one pass), the prolongation and ``smooth_pair``
(two sweeps); the coarsest level runs the closed-form first sweep and 19
``smooth`` launches. The Chebyshev schedule always has two sweeps, so the pair
kernels serve it; the Jacobi smoother runs single sweeps. Prolongation is three
banded ``torch.einsum`` products with the ``_tmat`` weights, outside any kernel,
as the JAX package leaves it to XLA; it needs full fp32 matmuls (TF32 off,
PyTorch's default), and the cycle raises on the card when TF32 is on.

Distribution: the cycle takes shard-stacked ``(local_shards, lz, ny, nx)``
tensors, the CG loop's carries. With one shard the cycle is local. With more, each
level whose local plane count is even runs slab-decomposed: every sweep,
residual, restriction and prolongation takes the neighbouring shards'
boundary planes through the plane exchange of ``models/stencil.py``, with
the separate ``smooth``/``residual`` kernels and the einsum transfers. At the
first level whose local plane count is odd (``split``) the coarse grid is
gathered (:meth:`DeviceComm.all_gather`) and cycled locally. Slab and local
cycles compute the same arithmetic up to summation order, so solves do not
depend on the shard count.

bfloat16 storage (PC mg under bf16 refinement) follows the route the TPU
takes at bfloat16, where ``pallas_supported`` holds and ``_mm_ok`` does not:
the sweeps run the bfloat16 ``smooth``/``smooth0_pair``/``smooth_pair``
kernels, the coarse right-hand side is the bfloat16 ``residual`` kernel
followed by the per-axis restriction (``restrict1d``) in plain torch, and
the prolongation ``u + P e`` runs the einsum transfers; both transfers are
lifted to fp32 and rounded once to bfloat16 (the TPU computes them in
bfloat16 jnp: ``ROADMAP.md`` Queue C). The fp32 einsums need TF32 off as
above. The slab levels run the bfloat16 ``smooth``/``residual`` kernels with
halo planes, as the f32 slab levels run theirs.

The JAX package gates its Pallas paths on TPU tiling and TPU f64
(``pallas_supported``, ``fullrestrict_supported``, ``_mm_ok``); none of that
applies here. Dispatch is by device alone: a CPU tensor takes each kernel's
plain version, a CUDA tensor launches the kernel or raises, and
``plain=True`` (a test switch) sends every call to the plain versions.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.stencil import make_plane_exchange
from ..ops import stencil as _st
from ..ops.stencil import RSCALE as _RSCALE

_OMEGA = 2.0 / 3.0


class _Ops(NamedTuple):
    """The five fused passes the cycle calls, kernels or plain versions."""
    smooth: object
    residual: object
    smooth0_pair: object
    smooth_pair: object
    residual_restrict: object


KERNEL_OPS = _Ops(_st.stencil3d_smooth, _st.stencil3d_residual,
                  _st.stencil3d_smooth0_pair, _st.stencil3d_smooth_pair,
                  _st.stencil3d_residual_restrict)
PLAIN_OPS = _Ops(_st.stencil3d_smooth_plain, _st.stencil3d_residual_plain,
                 _st.stencil3d_smooth0_pair_plain,
                 _st.stencil3d_smooth_pair_plain,
                 _st.stencil3d_residual_restrict_plain)


def cheby_omegas(degree: int, b: float = 2.0, a_frac: float = 0.25):
    """Per-sweep damping factors realizing a degree-``degree`` Chebyshev
    polynomial smoother as plain damped-Jacobi sweeps: the inverses of the
    Chebyshev-T roots on ``[a_frac*b, b]`` (inside the spectrum of A/6). The
    factors commute, so pre/post smoothing with the same set keeps the cycle
    symmetric."""
    lo = a_frac * b
    mid, half = (b + lo) / 2.0, (b - lo) / 2.0
    roots = [mid + half * math.cos(math.pi * (2 * j - 1) / (2 * degree))
             for j in range(1, degree + 1)]
    return tuple(1.0 / r for r in roots)


class _Slab:
    """Shard-stacked cycle helpers: the plane exchange and per-shard map."""

    def __init__(self, comm):
        self.comm = comm
        self.exchange = make_plane_exchange(comm)

    def map(self, fn, *stacked, **kw):
        """``fn`` on every shard's blocks, restacked."""
        return torch.stack(self.comm.shard_map(
            lambda *blocks: fn(*blocks, **kw))(*stacked))


def _sweeps(u, f, slab, omegas, ops):
    """Damped-Jacobi sweeps ``u + (w/6)(f - A u)``, one pass each."""
    for w in omegas:
        if slab is None:
            u = ops.smooth(u, f, None, None, w / 6.0)
        else:
            lo, hi = slab.exchange(u)
            u = slab.map(ops.smooth, u, f, lo, hi, w=w / 6.0)
    return u


def _smooth(u, f, iters: int, slab, omega=_OMEGA, ops=KERNEL_OPS):
    """Damped-Jacobi sweeps; ``omega`` is a scalar (``iters`` equal sweeps)
    or a tuple of per-sweep factors (a Chebyshev-root schedule). ``slab`` is
    None for one slab with zero ghosts, where a two-sweep schedule runs as
    one ``smooth_pair`` pass, or a :class:`_Slab` for shard-stacked tensors,
    where each sweep exchanges halos first."""
    if isinstance(omega, (tuple, list)):
        if len(omega) == 2 and slab is None:
            return ops.smooth_pair(u, f, float(omega[0]) / 6.0,
                                   float(omega[1]) / 6.0)
        return _sweeps(u, f, slab, omega, ops)
    return _sweeps(u, f, slab, [omega] * max(iters, 0), ops)


def _smooth0(f, iters: int, slab, omega=_OMEGA, ops=KERNEL_OPS):
    """Sweeps from a ZERO initial guess: the first sweep is the closed form
    ``u = (omega/6) f``. A two-sweep schedule on one slab is one
    ``smooth0_pair`` pass: ``(w1 + w2) f - w1 w2 (A f)``."""
    if isinstance(omega, (tuple, list)):
        ws = tuple(float(w) for w in omega)
        if not ws:
            return torch.zeros_like(f)
        if len(ws) == 2 and slab is None:
            return ops.smooth0_pair(f, ws[0] / 6.0, ws[1] / 6.0)
        return _smooth((ws[0] / 6.0) * f, f, 0, slab, ws[1:], ops)
    if iters <= 0:
        return torch.zeros_like(f)
    return _smooth((omega / 6.0) * f, f, iters - 1, slab, omega, ops)


_TMAT_CACHE: dict = {}


def _tmat(n: int, dtype=torch.float64, device="cpu"):
    """(n, n/2) one-axis restriction matrix: column i carries the weights
    ``RSCALE * [1/4, 3/4, 3/4, 1/4]`` on rows ``[2i-1, 2i+2]`` (zero
    ghosts). Its transpose is the one-axis prolongation. Built in float64
    with numpy, converted to ``dtype`` on ``device``, and cached per
    ``(n, dtype, device)``."""
    key = (n, dtype, torch.device(device))
    t = _TMAT_CACHE.get(key)
    if t is None:
        w = np.zeros((n, n // 2))
        i = np.arange(n // 2)
        w[2 * i, i] = 0.75
        w[2 * i + 1, i] = 0.75
        w[2 * i[1:] - 1, i[1:]] = 0.25
        w[2 * i[:-1] + 2, i[:-1]] = 0.25
        t = _TMAT_CACHE[key] = torch.tensor(_RSCALE * w, dtype=dtype,
                                            device=device)
    return t


def _restrict_mm(r, lo=None, hi=None):
    """R as three banded-matrix einsums; the z-halo planes touch only the
    first/last coarse plane, each with total z-weight ``RSCALE/4``."""
    nz, ny, nx = r.shape
    dt, dev = r.dtype, r.device
    wy, wx = _tmat(ny, dt, dev), _tmat(nx, dt, dev)
    out = torch.einsum("zyx,zc->cyx", r, _tmat(nz, dt, dev))
    out = torch.einsum("cyx,yd->cdx", out, wy)
    out = torch.einsum("cdx,xe->cde", out, wx)
    for plane, halo in ((0, lo), (-1, hi)):
        if halo is not None:
            c = torch.einsum("dx,xe->de", torch.einsum("yx,yd->dx", halo, wy),
                             wx)
            out[plane] += (_RSCALE * 0.25) * c
    return out


def _inv_rscale3(dtype) -> float:
    """``1 / RSCALE^3`` divided in ``dtype``, as the JAX package forms it."""
    one = torch.ones((), dtype=dtype)
    return float(one / torch.tensor(_RSCALE ** 3, dtype=dtype))


def _prolong_mm(e, lo=None, hi=None):
    """P as the transposed einsums, the exact adjoint of
    :func:`_restrict_mm` up to the global 1/2 (``P = 2 R^T``, rescaled by
    ``1/RSCALE^3``); coarse z-halo planes add quarter weight to the boundary
    fine planes."""
    nzc, nyc, nxc = e.shape
    dt, dev = e.dtype, e.device
    wy, wx = _tmat(2 * nyc, dt, dev), _tmat(2 * nxc, dt, dev)
    out = torch.einsum("cyx,zc->zyx", e, _tmat(2 * nzc, dt, dev))
    out = torch.einsum("zyx,dy->zdx", out, wy)
    out = torch.einsum("zdx,ex->zde", out, wx)
    out = out * _inv_rscale3(dt)
    for plane, halo in ((0, lo), (-1, hi)):
        if halo is not None:
            c = torch.einsum("dx,xe->de",
                             torch.einsum("yx,yd->dx", halo, wy.T), wx.T)
            out[plane] += (0.25 / _RSCALE ** 2) * c
    return out


def _tf32_allowed() -> bool:
    """Whether CUDA fp32 matmuls may round their inputs to TF32."""
    m = torch.backends.cuda.matmul
    prec = getattr(m, "fp32_precision", None)
    if prec is not None:
        return prec not in ("ieee", "none")
    return m.allow_tf32 or torch.get_float32_matmul_precision() != "highest"


def _check_fp32_matmul(t):
    """The einsum transfers are matmuls: on the card, fp32 ones (those of an
    fp32 cycle, and the lifted ones of a bfloat16 cycle) must run in full
    fp32 (PyTorch's default), or the cycle loses precision and its symmetry
    while restriction inside the kernel stays exact."""
    if (t.is_cuda and t.dtype in (torch.float32, torch.bfloat16)
            and _tf32_allowed()):
        raise RuntimeError(
            "PC mg needs full-precision fp32 matmuls on CUDA for its "
            "prolongation einsums; TF32 is enabled (set "
            "torch.backends.cuda.matmul.fp32_precision = 'ieee', or "
            "torch.set_float32_matmul_precision('highest'))")


def _restrict_lifted(r, lo=None, hi=None):
    """The bfloat16 cycle's restriction: ``restrict1d`` along z (with the
    neighbouring slabs' boundary planes), y and x in fp32, rounded once."""
    r32, lo32, hi32 = (None if t is None else t.float() for t in (r, lo, hi))
    c = _st.restrict1d(r32, 0, lo32, hi32)
    return _st.restrict1d(_st.restrict1d(c, 1), 2).to(r.dtype)


def _correct_lifted(u, e, lo=None, hi=None):
    """The bfloat16 cycle's coarse-grid correction ``u + P e``: the einsum
    prolongation and the add in fp32, rounded once."""
    e32, lo32, hi32 = (None if t is None else t.float() for t in (e, lo, hi))
    return (u.float() + _prolong_mm(e32, lo32, hi32)).to(u.dtype)


def mg_levels(nz: int, ny: int, nx: int, min_dim: int = 4):
    """Grid hierarchy: halve every dimension while all stay even and big."""
    levels = [(nz, ny, nx)]
    while all(d % 2 == 0 and d // 2 >= min_dim for d in levels[-1]):
        levels.append(tuple(d // 2 for d in levels[-1]))
    return levels


def make_vcycle3d(nz: int, ny: int, nx: int, pre: int = 2, post: int = 2,
                  coarse_iters: int = 20, comm=None,
                  smoother: str = "chebyshev", plain: bool = False):
    """Return ``cycle(r (L, lz, ny, nx)) -> z`` approximating ``A^-1 r``
    on shard-stacked tensors of this process's ``L = comm.local_shards``
    shards of ``size = comm.size`` (both 1 without ``comm``), the grid shape
    of the stencil-CG loop's carries. Below the slab levels every process
    cycles the gathered coarse grid and keeps its own shards' slabs.

    ``smoother``: ``'chebyshev'`` (default) runs the pre/post sweeps with
    the Chebyshev-root omega schedule of :func:`cheby_omegas`; ``'jacobi'``
    keeps the fixed omega = 2/3. ``plain`` sends every fused pass to its
    plain PyTorch version (a test switch for holding kernels against them).
    The cycle's route follows the dtype of ``r``: float32/float64 as the
    module docstring says, bfloat16 the TPU's bfloat16 route.
    """
    levels = mg_levels(nz, ny, nx)
    if smoother == "chebyshev":
        pre_w, post_w = cheby_omegas(pre), cheby_omegas(post)
    elif smoother == "jacobi":
        pre_w, post_w = _OMEGA, _OMEGA
    else:
        raise ValueError(f"unknown MG smoother {smoother!r}; "
                         "available: 'chebyshev', 'jacobi'")
    ops = PLAIN_OPS if plain else KERNEL_OPS
    size = 1 if comm is None else comm.size
    first, count = (0, 1) if comm is None else (comm.shard_offset,
                                                 comm.local_shards)

    def local_cycle(f, li: int):
        if li == len(levels) - 1:
            return _smooth0(f, coarse_iters, None, ops=ops)
        u = _smooth0(f, pre, None, omega=pre_w, ops=ops)
        if f.dtype == torch.bfloat16:
            # the residual pass, then the restriction and the correction
            # lifted to fp32
            r = ops.residual(u, f, None, None)
            e_c = local_cycle(_restrict_lifted(r), li + 1)
            u = _correct_lifted(u, e_c)
        else:
            # the coarse right-hand side restrict(f - A u) in one pass;
            # every level above the coarsest has even dims (mg_levels)
            e_c = local_cycle(ops.residual_restrict(u, f), li + 1)
            u = u + _prolong_mm(e_c)
        return _smooth(u, f, post, None, omega=post_w, ops=ops)

    def checked(cycle):
        def run(r):
            _check_fp32_matmul(r)
            return cycle(r)
        return run

    if size == 1:
        return checked(lambda r: local_cycle(r[0], 0)[None])

    if nz % size:
        raise ValueError(f"slab V-cycle needs nz ({nz}) divisible by the "
                         f"device count ({size})")
    slab = _Slab(comm)

    # slab-eligible prefix: levels whose local plane count is even, so the
    # 2x z-coarsening never splits a plane pair across a shard boundary;
    # the first non-eligible level is the gather point for the tiny tail
    split = 0
    while split < len(levels) - 1 and levels[split][0] % (2 * size) == 0:
        split += 1

    def slab_cycle(f, li: int):
        if li == split:
            # tail: gather the (tiny) coarse grid, cycle it locally, and
            # hand each shard its slab of the correction
            e_full = local_cycle(comm.all_gather(f), li)
            return e_full.reshape((size, -1) + tuple(e_full.shape[1:]))[
                first:first + count]
        bf16 = f.dtype == torch.bfloat16
        u = _smooth0(f, pre, slab, omega=pre_w, ops=ops)
        lo, hi = slab.exchange(u)
        r = slab.map(ops.residual, u, f, lo, hi)
        rlo, rhi = slab.exchange(r)
        restrict = _restrict_lifted if bf16 else _restrict_mm
        e_c = slab_cycle(slab.map(restrict, r, rlo, rhi), li + 1)
        elo, ehi = slab.exchange(e_c)
        if bf16:
            u = slab.map(_correct_lifted, u, e_c, elo, ehi)
        else:
            u = u + slab.map(_prolong_mm, e_c, elo, ehi)
        return _smooth(u, f, post, slab, omega=post_w, ops=ops)

    return checked(lambda r: slab_cycle(r, 0))


def make_vcycle(nz: int, ny: int, nx: int, pre: int = 2, post: int = 2,
                coarse_iters: int = 20, comm=None,
                smoother: str = "chebyshev", plain: bool = False):
    """Flat-vector wrapper over :func:`make_vcycle3d`:
    ``vcycle(r (L, lz*ny*nx)) -> z`` (the generic PC-apply shape)."""
    cycle = make_vcycle3d(nz, ny, nx, pre=pre, post=post,
                          coarse_iters=coarse_iters, comm=comm,
                          smoother=smoother, plain=plain)
    size, count = (1, 1) if comm is None else (comm.size, comm.local_shards)

    def vcycle(r_flat):
        return cycle(r_flat.reshape(count, nz // size, ny, nx)).reshape(
            r_flat.shape)

    return vcycle
