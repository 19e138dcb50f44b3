"""Parallel cyclic reduction (PCR): the direct solves of PC lu/cholesky past
the dense cap, for tridiagonal (``crtri``) and banded (``crband``) operators.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/tridiag.py``.
Cyclic reduction turns a tridiagonal solve into ``S = ceil(log2 n)`` sweeps
of shifted fused multiply-adds (a banded one into sweeps of batched ``b x b``
products); the sweep coefficients do not depend on the right-hand side, so
they are made once at set-up and every solve only streams them.

* **Set-up on the host, fp64** (:func:`pcr_setup`, :func:`bpcr_setup`,
  :func:`banded_to_blocks`): numpy, copied from the JAX package, with its two
  probe solves of ``A x = A 1`` (gate 1e-3 in fp64, 0.1 through the apply
  dtype). The cast probe runs the port's own apply (:func:`pcr_apply`,
  :func:`bpcr_apply`) on CPU tensors of the apply dtype, so a bfloat16
  operator is probed through torch's bfloat16 rounding.
* **Set-up on the card** (:func:`bpcr_setup_device_csr`,
  :func:`bpcr_setup_device`): the same block reduction as torch code on the
  communicator's device, in fp64, from COO triplets scatter-built into the
  ``(3, N, b, b)`` block stacks there; both probes run there too, and the
  factors stay on the device. A probe that fails returns ``None`` (the
  caller then takes the host set-up, which raises the proper error); an
  exception is never turned into a host run.
* **Apply on the card** (:func:`pcr_apply`, :func:`bpcr_apply`): each sweep
  is one copy and two in-place products on slices, with no shifted copies
  (XLA fuses the JAX package's ``concatenate`` form into one pass per sweep;
  eager PyTorch would not).

PCR is pivotless: it is exact for diagonally dominant / SPD systems and runs
in fp64 by default; KSP preonly's refinement steps polish the rest. A
complex operator is set up in complex128 (``utils.dtypes.host_dtype``) on
either side, and its sweeps run in its own complex dtype.
"""

from __future__ import annotations

import os
import time
import warnings

import numpy as np
import torch

from ..ops.spmv import index_put_acc_
from ..parallel.mesh import torch_dtype
from ..utils.dtypes import host_dtype, real_eps

# the probe gates: catastrophic growth gives errors of order >= 1, while
# legitimate ill-conditioning stays ~kappa*eps in fp64; the cast-dtype probe
# gates only catastrophic loss, since preonly's refinement recovers roundoff
PROBE_GATE = 1e-3
CAST_PROBE_GATE = 0.1


def _pmap_blocks(fn, *arrays):
    """Apply ``fn`` over chunks of the leading (batch) axis on a host
    thread pool: numpy/LAPACK release the GIL, so the set-up's batched
    ``b x b`` work scales with cores. Single-core hosts run inline."""
    ncpu = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") \
        else (os.cpu_count() or 1)
    N = arrays[0].shape[0]
    if ncpu <= 1 or N < 2 * ncpu:
        return fn(*arrays)
    import concurrent.futures as cf
    bounds = np.linspace(0, N, 2 * ncpu + 1, dtype=int)
    out = None
    with cf.ThreadPoolExecutor(ncpu) as ex:
        futs = {ex.submit(fn, *(a[s:e] for a in arrays)): (s, e)
                for s, e in zip(bounds[:-1], bounds[1:]) if e > s}
        for fut in cf.as_completed(futs):
            s, e = futs[fut]
            res = fut.result()
            if out is None:
                out = np.empty((N,) + res.shape[1:], res.dtype)
            out[s:e] = res
    return out


def _neg_right_div(X, B):
    """``-X @ B^{-1}`` via a batched LAPACK solve (fewer flops than forming
    the inverse). Raises LinAlgError on a singular ``B``."""
    Yt = np.linalg.solve(np.swapaxes(B, -1, -2), -np.swapaxes(X, -1, -2))
    return np.ascontiguousarray(np.swapaxes(Yt, -1, -2))


def _sweeps(n: int) -> int:
    return max(1, int(np.ceil(np.log2(n)))) if n > 1 else 1


def _cast_probe_error(apply, rhs, factors, dtype) -> float:
    """``max|x - 1|`` of the probe solve run by the port's apply on CPU
    tensors of ``dtype`` (inf when not finite)."""
    dt = torch_dtype(dtype)
    cast = [torch.from_numpy(np.ascontiguousarray(a)).to(dt)
            for a in (rhs,) + tuple(factors)]
    x = apply(cast[0].reshape(-1), *cast[1:]).to(
        torch.complex128 if dt.is_complex else torch.float64)
    if not bool(torch.isfinite(x).all()):
        return float("inf")
    return float((x - 1.0).abs().max())


def pcr_setup(a: np.ndarray, b: np.ndarray, c: np.ndarray,
              apply_dtype=None):
    """Precompute PCR sweep coefficients for the tridiagonal (a, b, c).

    ``a`` is the subdiagonal (a[0] ignored), ``b`` the diagonal, ``c`` the
    superdiagonal (c[-1] ignored), all length n; set-up runs in host fp64.
    Returns ``(alphas, gammas, bfin)``: two (S, n) arrays of per-sweep
    neighbour multipliers (S = ceil(log2 n)) and the fully reduced diagonal,
    such that for any rhs d::

        for k in range(S):
            s = 1 << k
            d = d + alphas[k] * shift_up(d, s) + gammas[k] * shift_down(d, s)
        x = d / bfin

    with ``shift_up(d, s)[i] = d[i-s]`` (zero fill) and ``shift_down`` its
    mirror. ``apply_dtype``: the dtype the device apply runs in; when it is
    less precise than fp64 the probe solve is run again through it (gate
    0.1). Raises ``ValueError`` on a zero diagonal, a breakdown or a failed
    probe.
    """
    host_dt = host_dtype(np.result_type(*(np.asarray(v) for v in (a, b, c))))
    a = np.asarray(a, host_dt).copy()
    b = np.asarray(b, host_dt).copy()
    c = np.asarray(c, host_dt).copy()
    n = b.shape[0]
    if n == 0:
        raise ValueError("pcr_setup: empty system")
    a[0] = 0.0
    c[-1] = 0.0
    if np.any(b == 0):
        raise ValueError(
            "PCR hit a zero diagonal entry — the pivotless tridiagonal "
            "reduction needs a nonzero (ideally dominant) diagonal; use an "
            "iterative KSP with pc 'jacobi' instead")
    b0_mul_ones = a + b + c   # A · ones, for the post-setup probe solve
    S = _sweeps(n)
    alphas = np.zeros((S, n), host_dt)
    gammas = np.zeros((S, n), host_dt)

    def up(v, s):      # v[i-s], identity-row fill
        return np.concatenate([np.zeros(s, host_dt), v[:-s]]) if s < n else \
            np.zeros(n, host_dt)

    def down(v, s):    # v[i+s]
        return np.concatenate([v[s:], np.zeros(s, host_dt)]) if s < n else \
            np.zeros(n, host_dt)

    def upb(v, s):     # diagonal of identity rows is 1, not 0
        return (np.concatenate([np.ones(s, host_dt), v[:-s]]) if s < n
                else np.ones(n, host_dt))

    def downb(v, s):
        return (np.concatenate([v[s:], np.ones(s, host_dt)]) if s < n
                else np.ones(n, host_dt))

    for k in range(S):
        s = 1 << k
        alpha = -a / upb(b, s)
        gamma = -c / downb(b, s)
        alphas[k] = alpha
        gammas[k] = gamma
        a_new = alpha * up(a, s)
        c_new = gamma * down(c, s)
        b_new = b + alpha * up(c, s) + gamma * down(a, s)
        if np.any(b_new == 0) or not np.all(np.isfinite(b_new)):
            raise ValueError(
                "PCR reduction broke down (zero/non-finite reduced "
                "diagonal) — the pivotless factorization is unstable for "
                "this matrix; use an iterative KSP with pc 'jacobi'")
        a, b, c = a_new, b_new, c_new
    if np.any(a != 0) or np.any(c != 0):
        raise AssertionError("PCR did not fully reduce — internal error")
    # probe: element growth can destroy accuracy while every intermediate
    # stays finite; solve A x = A 1 and demand 1 back
    d1 = b0_mul_ones
    x1 = pcr_apply_np(d1, alphas, gammas, b)
    if not np.all(np.isfinite(x1)) or np.max(np.abs(x1 - 1.0)) > PROBE_GATE:
        raise ValueError(
            "PCR factorization failed its probe solve (pivotless element "
            "growth) — this tridiagonal needs a pivoted factorization; use "
            "an iterative KSP with pc 'jacobi' instead")
    if apply_dtype is not None and real_eps(apply_dtype) > real_eps(host_dt):
        err = _cast_probe_error(pcr_apply, d1, (alphas, gammas, b),
                                apply_dtype)
        if err > CAST_PROBE_GATE:
            raise ValueError(
                f"PCR factorization failed its probe solve in the operator "
                f"dtype {torch_dtype(apply_dtype)} (the fp64 factorization "
                "is fine, but the reduced-precision apply loses it) — "
                "assemble the operator in float64 or use an iterative KSP")
    return alphas, gammas, b


def pcr_apply_np(d, alphas, gammas, bfin):
    """Host-numpy mirror of :func:`pcr_apply` (the fp64 probe, and an oracle
    in tests), in the common dtype of the rhs and the sweep arrays."""
    dt = np.result_type(np.asarray(d).dtype, alphas.dtype)
    d = np.asarray(d, dt).copy()
    n = d.shape[0]
    for k in range(alphas.shape[0]):
        s = 1 << k
        du = np.concatenate([np.zeros(s, dt), d[:-s]]) if s < n else \
            np.zeros(n, dt)
        dd = np.concatenate([d[s:], np.zeros(s, dt)]) if s < n else \
            np.zeros(n, dt)
        d = d + alphas[k] * du + gammas[k] * dd
    return d / bfin


def pcr_apply(d: torch.Tensor, alphas: torch.Tensor, gammas: torch.Tensor,
              bfin: torch.Tensor) -> torch.Tensor:
    """PCR solve of the full-length (n,) rhs ``d`` with the sweep arrays of
    :func:`pcr_setup` (tensors of one dtype on ``d``'s device): per sweep
    one copy and two slice ``addcmul_`` (3 launches), then one divide, so
    ``3 S + 1`` launches in all. ``d`` is not modified."""
    n = d.shape[0]
    for k in range(alphas.shape[0]):
        s = 1 << k
        if s >= n:                 # every neighbour is an identity row
            continue
        out = d.clone()
        out[s:].addcmul_(alphas[k, s:], d[:-s])
        out[:-s].addcmul_(gammas[k, :-s], d[s:])
        d = out
    return d / bfin


# ---------------------------------------------------------------------------
# BLOCK cyclic reduction: direct solves for bandwidth b > 1
# ---------------------------------------------------------------------------
# A matrix with offsets in [-b..b] is block-tridiagonal in b x b blocks; the
# same log2(N) sweeps apply with the scalar divisions replaced by batched
# b x b inverses and products.


def banded_to_blocks(A_csr, b: int):
    """Block-tridiagonal (sub, diag, super) = (N, b, b) stacks of a sparse
    matrix with bandwidth <= b. Rows are grouped b at a time; the tail block
    is padded with identity rows, which decouple."""
    n = A_csr.shape[0]
    N = -(-n // b)
    host_dt = host_dtype(A_csr.dtype)
    Ab = np.zeros((N, b, b), host_dt)
    Cb = np.zeros((N, b, b), host_dt)
    Bb = np.zeros((N, b, b), host_dt)
    Bb[:] = np.eye(b, dtype=host_dt)        # padded tail rows stay identity
    for o in range(-b, b + 1):
        vals = np.asarray(A_csr.diagonal(o))
        if o >= 0:
            r = np.arange(0, n - o)
        else:
            r = np.arange(-o, n)
        c = r + o
        i_r, br = r // b, r % b
        i_c, bc = c // b, c % b
        mid = i_c == i_r
        lo = i_c == i_r - 1
        hi = i_c == i_r + 1
        if o == 0:
            # overwrite the identity diagonal for every REAL row first
            Bb[i_r, br, bc] = vals
            continue
        Bb[i_r[mid], br[mid], bc[mid]] = vals[mid]
        Ab[i_r[lo], br[lo], bc[lo]] = vals[lo]
        Cb[i_r[hi], br[hi], bc[hi]] = vals[hi]
    return Ab, Bb, Cb


def bpcr_setup(Ab, Bb, Cb, apply_dtype=None):
    """Precompute block-PCR sweep coefficients for the block-tridiagonal
    ``(Ab, Bb, Cb)``, each ``(N, b, b)`` (``Ab[0]``/``Cb[-1]`` ignored).

    Returns ``(alphas, gammas, binv)``: two ``(S, N, b, b)`` stacks of
    per-sweep multiplier blocks (``S = ceil(log2 N)``) and the batched
    inverse of the fully reduced diagonal, such that for any rhs ``D``
    (N, b)::

        for k in range(S):
            s = 1 << k
            D = D + alphas[k] @ shift_up(D, s) + gammas[k] @ shift_down(D, s)
        X = binv @ D

    Host fp64 set-up with the probes of :func:`pcr_setup`; within-block
    arithmetic is pivoted (LAPACK), the cross-block elimination pivotless.
    """
    host_dt = host_dtype(
        np.result_type(*(np.asarray(v) for v in (Ab, Bb, Cb))))
    A = np.asarray(Ab, host_dt).copy()
    B = np.asarray(Bb, host_dt).copy()
    C = np.asarray(Cb, host_dt).copy()
    N, b = B.shape[0], B.shape[1]
    if N == 0:
        raise ValueError("bpcr_setup: empty system")
    A[0] = 0.0
    C[-1] = 0.0
    ones_b = np.ones(b, host_dt)
    d1 = (A + B + C) @ ones_b               # A · ones, for the probe solve
    S = _sweeps(N)
    alphas = np.zeros((S, N, b, b), host_dt)
    gammas = np.zeros((S, N, b, b), host_dt)

    def shift(M, s, fill_identity=False):
        """out[i] = M[i - s] (s may be negative); out-of-range blocks are
        zero (identity when fill_identity: the virtual rows' diagonal)."""
        out = np.zeros_like(M)
        if fill_identity:
            out[:] = np.eye(b, dtype=host_dt)
        if abs(s) < N:
            if s > 0:
                out[s:] = M[:-s]
            elif s < 0:
                out[:s] = M[-s:]
            else:
                out[:] = M
        return out

    def binv_or_raise(M, what):
        try:
            return _pmap_blocks(np.linalg.inv, M)
        except np.linalg.LinAlgError:
            raise ValueError(
                f"block PCR hit a singular {what} block — the pivotless "
                "cross-block reduction needs nonsingular (ideally "
                "dominant) diagonal blocks; use an iterative KSP with pc "
                "'jacobi' instead") from None

    for k in range(S):
        s = 1 << k
        try:
            alpha = _pmap_blocks(_neg_right_div, A,
                                 shift(B, s, fill_identity=True))
            gamma = _pmap_blocks(_neg_right_div, C,
                                 shift(B, -s, fill_identity=True))
        except np.linalg.LinAlgError:
            raise ValueError(
                "block PCR hit a singular shifted block — the pivotless "
                "cross-block reduction needs nonsingular (ideally "
                "dominant) diagonal blocks; use an iterative KSP with pc "
                "'jacobi' instead") from None
        alphas[k] = alpha
        gammas[k] = gamma
        A_new = _pmap_blocks(np.matmul, alpha, shift(A, s))
        C_new = _pmap_blocks(np.matmul, gamma, shift(C, -s))
        B_new = (B + _pmap_blocks(np.matmul, alpha, shift(C, s))
                 + _pmap_blocks(np.matmul, gamma, shift(A, -s)))
        if not np.all(np.isfinite(B_new)):
            raise ValueError(
                "block PCR reduction broke down (non-finite reduced "
                "diagonal) — the pivotless cross-block factorization is "
                "unstable for this matrix; use an iterative KSP with pc "
                "'jacobi' instead")
        A, B, C = A_new, B_new, C_new
    if np.any(A != 0) or np.any(C != 0):
        raise AssertionError("block PCR did not fully reduce — internal "
                             "error")
    binv = binv_or_raise(B, "reduced diagonal")
    x1 = bpcr_apply_np(d1, alphas, gammas, binv)
    if not np.all(np.isfinite(x1)) or np.max(np.abs(x1 - 1.0)) > PROBE_GATE:
        raise ValueError(
            "block PCR factorization failed its probe solve (pivotless "
            "cross-block element growth) — this banded system needs a "
            "pivoted factorization; use an iterative KSP with pc "
            "'jacobi' instead")
    if apply_dtype is not None and real_eps(apply_dtype) > real_eps(host_dt):
        err = _cast_probe_error(bpcr_apply, d1, (alphas, gammas, binv),
                                apply_dtype)
        if err > CAST_PROBE_GATE:
            raise ValueError(
                f"block PCR factorization failed its probe solve in the "
                f"operator dtype {torch_dtype(apply_dtype)} — assemble the "
                "operator in float64 or use an iterative KSP")
    return alphas, gammas, binv


def bpcr_apply_np(D, alphas, gammas, binv):
    """Host-numpy mirror of :func:`bpcr_apply` (probe and test oracle);
    ``D``: (N, b) rhs blocks."""
    dt = np.result_type(np.asarray(D).dtype, alphas.dtype)
    D = np.asarray(D, dt).copy()
    N, b = D.shape
    for k in range(alphas.shape[0]):
        s = 1 << k
        Du = np.zeros_like(D)
        Dd = np.zeros_like(D)
        if s < N:
            Du[s:] = D[:-s]
            Dd[:-s] = D[s:]
        D = (D + np.einsum("nij,nj->ni", alphas[k], Du)
             + np.einsum("nij,nj->ni", gammas[k], Dd))
    return np.einsum("nij,nj->ni", binv, D)


def bpcr_apply(d: torch.Tensor, alphas: torch.Tensor, gammas: torch.Tensor,
               binv: torch.Tensor) -> torch.Tensor:
    """Block-PCR solve of the flat (N*b,) rhs ``d`` with the arrays of
    :func:`bpcr_setup`: per sweep one copy and two batched products added
    in place into slices (``baddbmm_``, 3 launches), then one batched
    product with ``binv``: ``3 S + 1`` launches. ``d`` is not modified."""
    N, b = binv.shape[0], binv.shape[1]
    D = d.reshape(N, b, 1)
    for k in range(alphas.shape[0]):
        s = 1 << k
        if s >= N:
            continue
        out = D.clone()
        out[s:].baddbmm_(alphas[k, s:], D[:-s])
        out[:-s].baddbmm_(gammas[k, :-s], D[s:])
        D = out
    return torch.bmm(binv, D).reshape(-1)


# ---- block PCR set-up on the card ------------------------------------------

def bpcr_setup_device_csr(A_csr, b: int, comm, dtype, timings=None):
    """Block-PCR factorization on the communicator's device from the banded
    CSR itself: the COO triplets (duplicates summed on the host first, so no
    real entry repeats) ship as one flat int32 index and fp64 values, and
    the ``(3, N, b, b)`` block stacks are scatter-built on the device.

    ``timings``: optional dict filled with ``extract_s`` (host triplets) and
    ``invert_s`` (shipping and the device factorization, synced). Returns
    :func:`_bpcr_device_factor`'s result.
    """
    t0 = time.perf_counter()
    n = A_csr.shape[0]
    N = -(-n // b)
    coo = A_csr.tocoo()
    coo.sum_duplicates()
    row = coo.row.astype(np.int64)
    col = coo.col.astype(np.int64)
    bi, bj = row // b, col // b
    delta = bj - bi
    if delta.size and (delta.min() < -1 or delta.max() > 1):
        raise ValueError(
            f"bpcr_setup_device_csr: operator bandwidth exceeds the block "
            f"size {b}")
    pad_r = np.arange(n, N * b)          # identity diagonal of tail padding
    lin = np.concatenate([
        _flat_index(N, b, delta + 1, bi, row - bi * b, col - bj * b),
        _flat_index(N, b, 1, pad_r // b, pad_r % b, pad_r % b)])
    vals = np.concatenate([np.asarray(coo.data, host_dtype(A_csr.dtype)),
                           np.ones(pad_r.size)])
    t1 = time.perf_counter()
    out = _bpcr_device_factor(comm, dtype, N, b, vals, lin)
    if timings is not None:
        timings["extract_s"] = round(t1 - t0, 4)
        timings["invert_s"] = round(time.perf_counter() - t1, 4)
    return out


def bpcr_setup_device(Ab, Bb, Cb, comm, dtype):
    """Block-PCR factorization on the device from dense (N, b, b) stacks
    (:func:`banded_to_blocks` layout): the nonzeros, rounded to ``dtype``
    first, go through :func:`_bpcr_device_factor`."""
    dt = torch_dtype(dtype)
    B0 = np.asarray(Bb)
    if B0.shape[0] == 0:
        raise ValueError("bpcr_setup_device: empty system")
    host_dt = host_dtype(dt)
    T = np.stack([np.asarray(Ab), B0, np.asarray(Cb)]).astype(host_dt)
    T[0, 0] = 0.0
    T[2, -1] = 0.0
    T = torch.from_numpy(T).to(dt).to(torch_dtype(host_dt)).numpy()
    d, bi, rr, cc = np.nonzero(T)
    N, b = B0.shape[0], B0.shape[1]
    return _bpcr_device_factor(comm, dt, N, b, T[d, bi, rr, cc],
                               _flat_index(N, b, d, bi, rr, cc))


def _flat_index(N, b, d, bi, rr, cc) -> np.ndarray:
    """Flat int32 index of entry ``(d, bi, rr, cc)`` of a ``(3, N, b, b)``
    stack (``_BCR_ELEM_CAP`` keeps it far below 2**31)."""
    return (((np.asarray(d, np.int64) * N + bi) * b + rr) * b
            + cc).astype(np.int32)


def polished_inverse(B: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """Batched inverse (``torch.linalg.inv_ex``) plus two Newton steps
    ``X <- X + X (I - B X)``, NaN wherever LAPACK/cuSOLVER found a block
    singular: ``torch.linalg.inv`` would raise, and the probes and gates
    must see it as ``jnp.linalg.inv``'s non-finite result."""
    X, info = torch.linalg.inv_ex(B)
    X = torch.where((info != 0)[..., None, None],
                    torch.full((), float("nan"), dtype=B.dtype,
                               device=B.device), X)
    X = X + X @ (eye - B @ X)
    return X + X @ (eye - B @ X)


def _probe(alphas, gammas, binv, d1) -> torch.Tensor:
    """``max|x - 1|`` of the probe solve on the device (inf if not finite),
    as a 0-d tensor: no host read."""
    x1 = bpcr_apply(d1, alphas, gammas, binv)
    err = (x1 - 1.0).abs().max()
    return torch.where(torch.isfinite(x1).all(), err,
                       torch.full_like(err, float("inf")))


def _bpcr_device_factor(comm, dtype, N: int, b: int, vals, lin):
    """The block-PCR reduction of :func:`bpcr_setup` on ``comm.device``, in
    fp64, from the ``(3, N, b, b)`` stack whose nonzeros are ``vals`` at
    the flat indices ``lin``. A static Python loop runs the ``S`` sweeps on
    slices; each block inverse is ``torch.linalg.inv_ex`` in fp64 plus two
    Newton steps (CUDA has a native fp64 LU). Both probes run on the device
    (1e-3 in fp64, 0.1 with the factors cast to ``dtype``), with one host
    read of the two errors. Returns the cast ``(alphas, gammas, binv)`` on
    the device, or ``None`` with a ``RuntimeWarning`` when a probe fails."""
    dev = comm.device
    dt = torch_dtype(dtype)
    cdt = torch_dtype(host_dtype(dt))          # complex128 for complex
    S = _sweeps(N)
    T = torch.zeros(3 * N * b * b, dtype=cdt, device=dev)
    index_put_acc_(T, (torch.from_numpy(lin).to(dev).long(),),
                   torch.from_numpy(np.asarray(vals)).to(dev, cdt))
    A, B, C = T.view(3, N, b, b).unbind(0)
    d1 = (A + B + C).sum(-1).reshape(-1)          # A · ones, the probe rhs
    eye = torch.eye(b, dtype=cdt, device=dev)
    al = torch.zeros((S, N, b, b), dtype=cdt, device=dev)
    ga = torch.zeros_like(al)
    for k in range(S):
        s = 1 << k
        invB = polished_inverse(B, eye)
        # alpha[i] = -A[i] B[i-s]^-1 and gamma[i] = -C[i] B[i+s]^-1; the
        # out-of-range rows keep alpha = gamma = 0 (their A, C are 0)
        torch.matmul(A[s:], invB[:-s], out=al[k, s:])
        torch.matmul(C[:-s], invB[s:], out=ga[k, :-s])
        al[k].neg_()
        ga[k].neg_()
        A2 = torch.zeros_like(A)
        C2 = torch.zeros_like(C)
        torch.matmul(al[k, s:], A[:-s], out=A2[s:])
        torch.matmul(ga[k, :-s], C[s:], out=C2[:-s])
        B2 = B.clone()
        B2[s:] += al[k, s:] @ C[:-s]
        B2[:-s] += ga[k, :-s] @ A[s:]
        A, B, C = A2, B2, C2
    binv = polished_inverse(B, eye)
    finite = (torch.isfinite(al).all() & torch.isfinite(ga).all()
              & torch.isfinite(binv).all())
    q64 = _probe(al, ga, binv, d1)
    q64 = torch.where(finite, q64, torch.full_like(q64, float("inf")))
    out = (al.to(dt), ga.to(dt), binv.to(dt))
    qc = _probe(*out, d1.to(dt)).to(q64.dtype) if dt != cdt else q64
    q64, qc = torch.stack([q64, qc]).tolist()     # the one host read
    if not (np.isfinite(q64) and np.isfinite(qc)) \
            or q64 > PROBE_GATE or qc > CAST_PROBE_GATE:
        warnings.warn(
            f"device block-PCR factorization failed its probe solve "
            f"(max|x-1| = {q64:.2e} in float64, {qc:.2e} cast to {dt}); "
            "using the host fp64 setup", RuntimeWarning, stacklevel=3)
        return None
    return out
