"""Smoothed-aggregation algebraic multigrid: PC ``gamg`` (alias ``amg``).

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/amg.py``. The
split is the JAX package's, which is PETSc's own: the set-up (strength
graph, greedy aggregation, tentative and smoothed prolongators, Galerkin
products) runs once on the host over scipy CSR, and the apply is device
code, one V(1,1)-cycle over row-sharded ELL operators with weighted-Jacobi
smoothing, all-gathered products and a replicated dense inverse on the
coarsest level.

* :func:`sa_setup` builds the same hierarchy as JAX ``sa_setup`` (:141): the
  symmetric strength filter ``|a_ij| >= theta sqrt(a_ii a_jj)``, the
  three-pass greedy aggregation (:func:`_aggregate_py`, the Python loop the
  JAX package holds its native kernel equal to), the column-normalized
  tentative prolongator, its damped-Jacobi smoothing with ``rho(D^-1 A)``
  from ten power steps seeded by ``default_rng(7)``, and the adjoint
  Galerkin product ``P^H A P``, which keeps a Hermitian operator Hermitian
  on every level.
* :class:`AMGHierarchy` places each level's ``A_l`` and ``P_l`` as ELL rows
  with the inverse diagonal, and the coarsest operator's explicit inverse,
  replicated. Its :meth:`AMGHierarchy.local_apply` is JAX's V-cycle
  (:223-275) on shard-stacked ``(local_shards, lsize)`` tensors, written on
  ``comm.local_shards``, so it runs on a ``ProcessComm`` as on the virtual
  mesh.

**The restriction.** JAX forms ``P^H r`` as a scatter-add over the padded
coarse vector followed by a ``psum``. A scatter-add on the card accumulates
with atomics, in no fixed order, and the port's iterates are bit-equal run
to run and between ``DeviceComm`` and ``ProcessComm``. So the set-up also
stores ``R = P^H`` (conjugated on complex operators) as its own ELL,
row-sharded by coarse rows, and the cycle applies it to the all-gathered
fine residual with the same gather and row sum as every other product: one
pass in a fixed order, and no reduction of a whole vector across shards.
The coarse solve multiplies the unpadded ``(nc, nc)`` inverse by the first
``nc`` gathered entries, so its shape, and with it the order of its sums,
does not depend on the shard count either.
"""

from __future__ import annotations

import time

import numpy as np
import torch.nn.functional as F

from ..ops.spmv import csr_to_ell, ell_spmv_local, widened_einsum
from ..utils.dtypes import host_dtype

DEFAULT_THRESHOLD = 0.0     # PCGAMG default: keep all connections
DEFAULT_COARSE_SIZE = 64
DEFAULT_MAX_LEVELS = 10
JACOBI_OMEGA = 2.0 / 3.0    # smoother weight


# ---- host set-up ------------------------------------------------------------

def _strength_graph(A, theta: float):
    """Symmetric strength-of-connection filter, kept as a CSR pattern (JAX
    ``amg.py:41``)."""
    import scipy.sparse as sp
    if theta <= 0.0:
        return A.tocsr()
    C = A.tocoo()
    d = np.abs(A.diagonal())
    d[d == 0] = 1.0
    scale = np.sqrt(d[C.row] * d[C.col])
    keep = (np.abs(C.data) >= theta * scale) | (C.row == C.col)
    return sp.csr_matrix(
        (C.data[keep], (C.row[keep], C.col[keep])), shape=A.shape)


def _aggregate(S):
    """Greedy (Vanek) aggregation over the strength graph: the Python passes
    of :func:`_aggregate_py` (a native kernel is ROADMAP.md Queue A item 8,
    ``utils/native.py``)."""
    return _aggregate_py(S.indptr, S.indices, S.shape[0])


def _aggregate_py(indptr, indices, n):
    """The three passes (JAX ``amg.py:73``). Pass 1: a node none of whose
    strong neighbours is aggregated seeds an aggregate with them. Pass 2: a
    leftover attaches to a neighbouring aggregate. Pass 3: what remains
    becomes aggregates of its own."""
    agg = np.full(n, -1, dtype=np.int64)
    nagg = 0
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if nbrs.size and np.any(agg[nbrs] != -1):
            continue
        agg[i] = nagg
        agg[nbrs] = nagg
        nagg += 1
    attach = agg.copy()
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        cand = agg[nbrs[nbrs != i]] if nbrs.size else np.empty(0, np.int64)
        cand = cand[cand != -1]
        if cand.size:
            attach[i] = cand[0]
    agg = attach
    for i in range(n):
        if agg[i] != -1:
            continue
        agg[i] = nagg
        nbrs = indices[indptr[i]:indptr[i + 1]]
        for j in nbrs:
            if agg[j] == -1:
                agg[j] = nagg
        nagg += 1
    return agg, int(nagg)


def _tentative_prolongator(agg: np.ndarray, nagg: int):
    """Piecewise-constant ``P0`` with unit columns (``1/sqrt(size)``)."""
    import scipy.sparse as sp
    n = agg.shape[0]
    counts = np.bincount(agg, minlength=nagg).astype(np.float64)
    vals = 1.0 / np.sqrt(counts[agg])
    return sp.csr_matrix((vals, (np.arange(n), agg)), shape=(n, nagg))


def _smoothed_prolongator(A, P0, omega: float = 4.0 / 3.0):
    """``P = (I - omega / rho(D^-1 A) D^-1 A) P0``, ``rho`` from ten power
    steps from a ``default_rng(7)`` start (JAX ``amg.py:118``)."""
    import scipy.sparse as sp
    host_dt = host_dtype(A.dtype)
    d = A.diagonal().astype(host_dt)
    d[d == 0] = 1.0
    dinv = 1.0 / d
    rng = np.random.default_rng(7)
    x = rng.standard_normal(A.shape[0]).astype(host_dt)
    x /= np.linalg.norm(x)
    rho = 1.0
    for _ in range(10):
        x = dinv * (A @ x)
        nrm = np.linalg.norm(x)
        if nrm == 0:
            break
        rho, x = nrm, x / nrm
    rho = max(rho, 1e-12)
    DinvA = sp.diags(dinv) @ A
    return (P0 - (omega / rho) * (DinvA @ P0)).tocsr()


def sa_setup(A, threshold: float = DEFAULT_THRESHOLD,
             max_levels: int = DEFAULT_MAX_LEVELS,
             coarse_size: int = DEFAULT_COARSE_SIZE,
             times: dict | None = None):
    """The smoothed-aggregation hierarchy on the host (JAX ``amg.py:141``):
    ``(levels, A_coarse)``, each level ``(A_l, P_l)`` in scipy CSR and
    ``A_coarse`` the last Galerkin operator, left for a direct solve.
    ``times``, when given, gains the seconds spent in each part
    (``strength_s``, ``aggregate_s``, ``prolongator_s``, ``galerkin_s``)."""
    t = {"strength_s": 0.0, "aggregate_s": 0.0, "prolongator_s": 0.0,
         "galerkin_s": 0.0}
    A = A.tocsr()
    levels = []
    while A.shape[0] > coarse_size and len(levels) < max_levels - 1:
        t0 = time.perf_counter()
        S = _strength_graph(A, threshold)
        t1 = time.perf_counter()
        agg, nagg = _aggregate(S)
        t2 = time.perf_counter()
        t["strength_s"] += t1 - t0
        t["aggregate_s"] += t2 - t1
        if nagg >= A.shape[0] or nagg == 0:
            break       # no coarsening progress
        Pl = _smoothed_prolongator(A, _tentative_prolongator(agg, nagg))
        t3 = time.perf_counter()
        levels.append((A, Pl))
        # the ADJOINT restriction: P^H A P stays Hermitian on a Hermitian
        # operator (P^T A P on a real one)
        A = (Pl.conj().T @ A @ Pl).tocsr()
        t["prolongator_s"] += t3 - t2
        t["galerkin_s"] += time.perf_counter() - t3
    if times is not None:
        times.update(t)
    return levels, A


# ---- device hierarchy -------------------------------------------------------

class AMGHierarchy:
    """The sharded device form of the SA hierarchy (JAX ``amg.py:170``).

    Each fine level holds seven tensors: ``A_l``'s ELL columns and values
    and the inverse diagonal ``(local_shards, lsize_l)``, ``P_l``'s ELL, and
    ``R_l = P_l^H``'s ELL over the coarse rows (module docstring); the
    coarsest level the ``(nc, nc)`` inverse, replicated. :attr:`arrays` is
    the flat tuple of all of them (the PC's device data), and
    :attr:`setup_breakdown` the seconds of each part of the set-up.
    """

    def __init__(self, comm, A_scipy, dtype,
                 threshold: float = DEFAULT_THRESHOLD,
                 max_levels: int = DEFAULT_MAX_LEVELS,
                 coarse_size: int = DEFAULT_COARSE_SIZE):
        from .pc import _synced, dense_inverse_padded
        times = {}
        levels, Ac = sa_setup(A_scipy, threshold, max_levels, coarse_size,
                              times=times)
        t0 = time.perf_counter()
        self.comm = comm
        self.n_levels = len(levels)
        self.sizes = [int(A.shape[0]) for A, _ in levels] + [int(Ac.shape[0])]
        host_dt = host_dtype(dtype)
        self._levels = []
        # the JAX package's arrays' global shapes, for program_key
        self._jax_shapes = []
        for A, Pl in levels:
            R = Pl.conj().T.tocsr()
            R.sort_indices()
            acols, avals = csr_to_ell(A.indptr, A.indices, A.data)
            pcols, pvals = csr_to_ell(Pl.indptr, Pl.indices, Pl.data)
            rcols, rvals = csr_to_ell(R.indptr, R.indices, R.data)
            d = A.diagonal().astype(host_dt)
            d[d == 0] = 1.0
            dinv = comm.put_rows(1.0 / d, dtype).view(comm.local_shards, -1)
            self._levels.append((
                comm.put_rows(acols), comm.put_rows(avals, dtype), dinv,
                comm.put_rows(pcols), comm.put_rows(pvals, dtype),
                comm.put_rows(rcols), comm.put_rows(rvals, dtype)))
            n_pad = comm.padded_size(A.shape[0])
            self._jax_shapes += [(n_pad, acols.shape[1]),
                                 (n_pad, acols.shape[1]), (n_pad,),
                                 (n_pad, pcols.shape[1]),
                                 (n_pad, pcols.shape[1])]
        t1 = _synced(comm.device)
        nc = self.sizes[-1]
        inv = dense_inverse_padded(
            comm, Ac, dtype,
            f"GAMG coarsening stalled at n={nc}: the coarsest level is "
            "solved by dense factorization, which would densify a matrix "
            "this large — lower -pc_gamg_threshold (strength filter too "
            "aggressive) or raise -pc_mg_levels")
        self._coarse_inv = inv[:nc, :nc].contiguous()
        self._jax_shapes.append(tuple(int(s) for s in inv.shape))
        t2 = _synced(comm.device)
        self.arrays = tuple(t for lv in self._levels for t in lv) + (
            self._coarse_inv,)
        self.setup_breakdown = {
            **{k: round(v, 4) for k, v in times.items()},
            "upload_s": round(t1 - t0, 4),
            "coarse_inverse_s": round(t2 - t1, 4)}

    def program_key(self) -> tuple:
        """``("gamg", sizes, shapes)`` as the JAX ``AMGHierarchy`` gives it,
        ``shapes`` being its arrays' (the padded global ELL, inverse diagonal
        and coarse inverse shapes)."""
        return ("gamg", tuple(self.sizes), tuple(self._jax_shapes))

    def local_apply(self, comm):
        """One V(1,1)-cycle ``z = M r`` on shard-stacked tensors (JAX
        ``amg.py:223-275``): one weighted-Jacobi step from zero, the
        residual through the all-gathered ``A z``, restriction by ``R``, the
        coarse correction, prolongation by ``P`` and one post-smoothing
        step."""
        shards = comm.local_shards
        omega = JACOBI_OMEGA
        levels, n_levels = self._levels, self.n_levels
        nc = self.sizes[-1]
        nc_pad = comm.padded_size(nc)
        c0, c1 = comm.local_row_range(nc)
        cinv = self._coarse_inv

        def product(cols, vals, x):
            return ell_spmv_local(cols, vals,
                                  comm.all_gather(x)).view(shards, -1)

        def coarse(r):
            z = widened_einsum("ij,j->i", cinv, comm.all_gather(r)[:nc])
            if nc_pad > nc:
                z = F.pad(z, (0, nc_pad - nc))
            return z[c0:c1].view(shards, -1)

        def cycle(lvl, r):
            if lvl == n_levels:
                return coarse(r)
            acols, avals, dinv, pcols, pvals, rcols, rvals = levels[lvl]
            z = omega * dinv * r
            rc = product(rcols, rvals, r - product(acols, avals, z))
            z = z + product(pcols, pvals, cycle(lvl + 1, rc))
            return z + omega * dinv * (r - product(acols, avals, z))

        return lambda r: cycle(0, r)

