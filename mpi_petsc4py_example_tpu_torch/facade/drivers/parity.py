"""Parity cases of the process communicator: one problem definition, run on
any communicator, so a run on a :class:`ProcessComm` is held against the
same run on a :class:`DeviceComm` of the same shard count.

:func:`run_case` solves one case on the given communicator and returns plain
values (iterations, reasons, the whole iterate on every process, launch and
host-copy counts, wall times). As a driver under the runner's process mode
it runs a list of cases, each on a ``ProcessComm`` of the case's
``local_shards`` per process, and rank 0 writes one ``.npz`` per case::

    python -m mpi_petsc4py_example_tpu_torch.run -n 2 --procs --device cpu \\
        mpi_petsc4py_example_tpu_torch/facade/drivers/parity.py \\
        CASES.json OUT_DIR

``CASES.json`` is a list of case dicts (see :func:`run_case`). The problems
are made from their seeds with numpy, so every process and the reference
build the same arrays. ``python .../parity.py CASES.json OUT_DIR --virtual
N --device cpu`` runs the same cases on ``DeviceComm(N)`` in one process:
the reference, made with the same thread settings as the workers.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

import mpi_petsc4py_example_tpu_torch as pt
from mpi_petsc4py_example_tpu_torch.facade.drivers.helmholtz import (
    helmholtz2d)
from mpi_petsc4py_example_tpu_torch.models.generators import (
    convdiff2d, random_system, tridiag_family)
from mpi_petsc4py_example_tpu_torch.models.poisson import (poisson1d_csr,
                                                           poisson2d_csr,
                                                           poisson3d_csr)
from mpi_petsc4py_example_tpu_torch.ops import stencil as st
from mpi_petsc4py_example_tpu_torch.solvers import pc as pc_mod

def _far_diagonals(n: int = 100):
    """A diagonally dominant unsymmetric DIA matrix whose outer diagonals
    (+-40) reach past the neighbouring shard: the gathered DIA route."""
    return sp.diags([np.full(n - 40, -0.3), np.full(n - 1, -1.0),
                     np.full(n, 6.0), np.full(n - 1, -1.2),
                     np.full(n - 40, 0.5)], [-40, -1, 0, 1, 40],
                    format="csr")


def _neumann2d(nx: int):
    """The pure-Neumann 5-point Laplacian on an nx x nx grid: singular, its
    null space the constant vector."""
    A = poisson2d_csr(nx).tolil()
    A.setdiag(0.0)
    A = A.tocsr()
    return (A - sp.diags(np.asarray(A.sum(axis=1)).ravel())).tocsr()


def _neumann3d(nx: int):
    """The 7-point Poisson with pure Neumann boundaries on an nx^3 grid:
    each row's missing neighbours taken off its diagonal (singular, its
    null space the constant vector)."""
    A = poisson3d_csr(nx).tocsr()
    return (A - sp.diags(A @ np.ones(A.shape[0]))).tocsr()


def _mass(n: int):
    """An SPD diagonal mass matrix, the B of the generalized cases."""
    return sp.diags(1.0 + np.arange(n) / n, format="csr")


# the assembled operators of the AIJ, EPS and refinement cases: small cuts of
# the benchmark's cfg1/cfg3/cfg4, the reference test.py and test2.py
# systems, and the shapes that reach each route of the products and of PC
# lu (a tridiagonal and a band, past a lowered dense cap)
AIJ_OPERATORS = {
    "cfg1": lambda: poisson3d_csr(6),
    "cfg3": lambda: poisson2d_csr(20),
    "cfg4": lambda: convdiff2d(16, beta=0.4),
    "testpy": lambda: random_system(100)[0],
    "test2": lambda: tridiag_family(100),
    "p2d8": lambda: poisson2d_csr(8),
    "mass64": lambda: _mass(64),
    "p1d120": lambda: poisson1d_csr(120),
    "tri": lambda: poisson1d_csr(4096),
    "band": lambda: poisson2d_csr(32),
    "far": _far_diagonals,
    "neumann": lambda: _neumann2d(16),
    # well conditioned, for the transpose types: banded DIA and ELL
    "cd12": lambda: (convdiff2d(12, beta=0.3) + 4.0 * sp.eye(144)).tocsr(),
    "ell64": lambda: (sp.random(64, 64, density=0.1, random_state=5)
                      + 4.0 * sp.eye(64)).tocsr(),
    # the card's sizes
    "neumann128": lambda: _neumann3d(128),
    "neumann64": lambda: _neumann3d(64),
    "convdiff1024": lambda: convdiff2d(1024),
    "tri2p20": lambda: poisson1d_csr(1 << 20),
    # complex128: the Helmholtz driver's operator
    "helmholtz128": lambda: helmholtz2d(128),
    "helmholtz12": lambda: helmholtz2d(12),
}
_DTYPES = {"f64": torch.float64, "f32": torch.float32,
           "bf16": torch.bfloat16, "c128": torch.complex128}


def rhs(n: int, seed: int, k: int | None = None) -> np.ndarray:
    """The seeded right-hand side: ``(n,)``, or ``(n, k)`` for a block."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (n, k))


def _sync(comm):
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)


_BF16_WRAPPERS = ("stencil3d_dot", "stencil3d_apply", "stencil3d_dot_many",
                  "stencil3d_apply_many")


def _counts() -> dict:
    out = {name: getattr(st, name).launches for name in _BF16_WRAPPERS + (
        "stencil3d_smooth", "stencil3d_residual", "stencil3d_smooth0_pair",
        "stencil3d_smooth_pair", "stencil3d_residual_restrict")}
    out.update({f"{name}_bf16": getattr(st, name).launches_bf16
                for name in _BF16_WRAPPERS + (
                    "stencil3d_smooth", "stencil3d_residual",
                    "stencil3d_smooth0_pair", "stencil3d_smooth_pair")})
    return out


def _called(comm, before: dict) -> dict:
    """``calls_<collective>``: the communicator's calls since ``before``."""
    return {f"calls_{k}": v - before[k] for k, v in comm.collectives.items()}


def _launched(before: dict) -> dict:
    """``launches_<wrapper>``: the launches since ``before``."""
    after = _counts()
    return {f"launches_{k}": after[k] - before[k] for k in after}


# a case's Krylov parameters: key -> the KSP attribute it sets
_KSP_PARAMS = {"sstep_s": "sstep_s", "restart": "restart",
               "aug": "lgmres_augment", "ell": "bcgsl_ell"}


def configure_ksp(ksp, case):
    """``case``'s KSP type (``ksp``, default cg) and its parameters
    (``sstep_s``, ``restart``, ``aug``, ``ell``) on ``ksp``, a KSP of
    either package (their attributes are the same); returns ``ksp``."""
    ksp.set_type(case.get("ksp", "cg"))
    for key, attr in _KSP_PARAMS.items():
        if key in case:
            setattr(ksp, attr, int(case[key]))
    return ksp


def _stencil_ksp(comm, case, op):
    ksp = configure_ksp(pt.KSP().create(comm), case)
    ksp.get_pc().set_type(case.get("pc", "jacobi"))
    ksp.set_tolerances(rtol=case.get("rtol", 1e-8), atol=0.0,
                       max_it=case.get("max_it", 10000))
    ksp.set_operators(op, case.get("pmat"))
    ksp.megasolve = bool(case.get("megasolve", False))
    ksp.megasolve_stencil_fastpath = bool(case.get("fastpath", False))
    ksp.reduction_auto = bool(case.get("reduction_auto", False))
    return ksp


def _fused(res) -> dict:
    """A fused solve's outer steps, replays, masked steps and whether CUDA
    graphs ran (nothing for an unfused solve)."""
    if not hasattr(res, "megasolve_steps"):
        return {}
    return {"steps": res.megasolve_steps, "replays": res.replays,
            "masked_steps": res.masked_steps, "graph": res.graph}


def _reduction_report(ksp) -> dict:
    """``-ksp_reduction_auto``'s choice and the latencies it came from."""
    rep = ksp._reduction_report
    if rep is None:
        return {}
    return {"auto_type": rep.ksp_type, "auto_s": rep.s,
            "psum_us": rep.psum_us, "apply_us": rep.apply_us,
            "ranking": json.dumps(rep.ranking)}


def _true_residual(comm, geometry, b, x):
    """``||b - A x||`` and ``||b||`` in fp64 on the device: the iterate
    widened, one fp64 stencil product, two reductions."""
    op64 = pt.StencilPoisson3D(comm, *geometry, dtype=torch.float64)
    x64 = pt.Vec(comm, op64.shape[0], data=x.data.to(torch.float64))
    b64 = pt.Vec(comm, op64.shape[0], data=b.data.to(torch.float64))
    r = op64.mult(x64)
    r.aypx(-1.0, b64)
    return r.norm(), b64.norm()


def psum_us(comm, dtype=torch.float32, reps: int = 200) -> float:
    """Microseconds of one ``psum`` of the local 0-d partials, ended by
    reading the sum on the host, as a Krylov loop reads its scalars (the
    mean over ``reps`` after a warm-up)."""
    parts = [torch.ones((), dtype=dtype, device=comm.device)
             for _ in range(comm.local_shards)]
    float(comm.psum(parts))
    t0 = time.perf_counter()
    for _ in range(reps):
        float(comm.psum(parts))
    return (time.perf_counter() - t0) / reps * 1e6


def _case_cg(comm, case):
    geometry = tuple(case["grid"])
    dt = _DTYPES[case.get("dtype", "f64")]
    op = pt.StencilPoisson3D(comm, *geometry, dtype=dt)
    n = op.shape[0]
    b = pt.Vec.from_global(comm, rhs(n, case.get("seed", 0)), dtype=dt)
    ksp = _stencil_ksp(comm, case, op)
    out = {}
    for rep in range(int(case.get("repeat", 1))):
        x = op.get_vecs()[0]
        _sync(comm)
        before, calls = _counts(), dict(comm.collectives)
        copies = getattr(comm, "host_copies", 0)
        res = ksp.solve(b, x)
        _sync(comm)
        out = {"its": res.iterations, "reason": int(res.reason),
               "rnorm": res.residual_norm, "wall_s": res.wall_time,
               "host_syncs": res.host_syncs,
               "host_copies": getattr(comm, "host_copies", 0) - copies,
               **_launched(before), **_called(comm, calls), **_fused(res),
               **_reduction_report(ksp)}
    if case.get("true_res"):
        out["true_res"], out["bnorm"] = _true_residual(comm, geometry, b, x)
    if case.get("time_psum"):
        out["psum_us"] = psum_us(comm, dt)
        if getattr(comm, "backend", None) == "gloo" \
                and comm.device.type == "cuda":
            # the same gloo group on host tensors: its transport alone,
            # without the copies to and from the card
            out["psum_host_us"] = psum_us(
                pt.ProcessComm(comm.local_shards, "cpu"), dt)
    if case.get("keep_x", True):
        out["x"] = x.to_numpy()
    return out


def _case_many(comm, case):
    geometry = tuple(case["grid"])
    dt = _DTYPES[case.get("dtype", "f64")]
    op = pt.StencilPoisson3D(comm, *geometry, dtype=dt)
    n, k = op.shape[0], int(case["k"])
    B = rhs(n, case.get("seed", 0), k)
    if case.get("route") == "general":
        # a distinct PC operator sends the solve down the general route
        case = dict(case, pmat=pt.StencilPoisson3D(comm, *geometry,
                                                   dtype=dt))
    ksp = _stencil_ksp(comm, case, op)
    _sync(comm)
    before, calls = _counts(), dict(comm.collectives)
    res = ksp.solve_many(B)
    _sync(comm)
    return {"its": np.asarray(res.iterations),
            "reason": np.asarray([int(r) for r in res.reasons]),
            "x": np.asarray(res.X), "wall_s": res.wall_time,
            "host_syncs": res.host_syncs, **_launched(before),
            **_called(comm, calls), **_fused(res)}


class _DenseCap:
    """PC lu's dense cap lowered to ``cap`` rows while a case runs, so that
    a small operator takes the cyclic-reduction modes (None: unchanged)."""

    def __init__(self, cap):
        self.cap, self.saved = cap, pc_mod._DENSE_CAP

    def __enter__(self):
        if self.cap is not None:
            pc_mod._DENSE_CAP = int(self.cap)

    def __exit__(self, *exc):
        pc_mod._DENSE_CAP = self.saved


def shell_mat(comm, A, dtype=torch.float64):
    """A ``ShellMat`` applying the scipy matrix ``A`` densely on the whole
    vector (and its transpose), with its diagonal for PC jacobi."""
    Ad = torch.tensor(A.toarray(), dtype=dtype, device=comm.device)
    return pt.ShellMat(comm, A.shape, lambda v: Ad @ v,
                       mult_transpose=lambda v: Ad.T @ v,
                       diagonal=np.asarray(A.diagonal()), dtype=dtype)


def shell_pc_apply(comm, A, dtype=torch.float64):
    """A PC shell's apply on the whole vector: the inverse diagonal of
    ``A``, a torch callable."""
    d = torch.tensor(1.0 / A.diagonal(), dtype=dtype, device=comm.device)
    return lambda r: d * r


def aij_rhs(case, A) -> np.ndarray:
    """The case's right-hand side (complex for a complex ``dtype``: the
    seeded real part plus ``1j`` times the next seed's); with a null space,
    made compatible."""
    b = rhs(A.shape[0], case.get("seed", 3))
    if _DTYPES[case.get("dtype", "f64")].is_complex:
        b = b + 1j * rhs(A.shape[0], case.get("seed", 3) + 1)
    if case.get("nullspace"):
        b = b - b.mean()
    return b


def _setup_pc(comm, pc, case, A):
    """The case's ``pc`` with its shell apply or composite children."""
    pc.set_type(case["pc"])
    pc.setup_device = case.get("setup_device", "auto")
    if case["pc"] == "shell":
        pc.set_shell_apply(shell_pc_apply(comm, A))
    if case["pc"] == "composite":
        pc.set_composite_type(case.get("ctype", "additive"))
        pc.set_composite_pcs(*case["children"])


def _case_aij(comm, case):
    A = AIJ_OPERATORS[case["op"]]()
    op = (shell_mat(comm, A) if case.get("shellmat")
          else pt.Mat.from_scipy(comm, A,
                                 dtype=_DTYPES[case.get("dtype", "f64")]))
    if case.get("nullspace"):
        op.set_nullspace(pt.NullSpace(constant=True))
    ksp = configure_ksp(pt.KSP().create(comm), case)
    _setup_pc(comm, ksp.get_pc(), case, A)
    ksp.set_tolerances(rtol=case.get("rtol", 1e-8), atol=0.0,
                       max_it=case.get("max_it", 5000))
    ksp.set_true_residual_check(case.get("gate", False))
    ksp.set_operators(op)
    x, b = op.get_vecs()
    b.set_global(aij_rhs(case, A))
    with _DenseCap(case.get("dense_cap")):
        res = ksp.solve(b, x)
    out = {"its": res.iterations, "reason": int(res.reason),
           "x": x.to_numpy(), "wall_s": res.wall_time,
           "pc_kind": ksp.get_pc().kind}
    if not case.get("shellmat"):
        out["route"] = op.spmv_route(comm)
    return out


def _case_mult_t(comm, case):
    """``A^T v`` through ``Mat.mult_transpose`` on a seeded ``v``."""
    A = AIJ_OPERATORS[case["op"]]()
    mat = pt.Mat.from_scipy(comm, A)
    v = pt.Vec.from_global(comm, rhs(A.shape[0], case.get("seed", 5)))
    return {"x": mat.mult_transpose(v).to_numpy(),
            "route": mat.spmv_route(comm)}


def _case_io(comm, case):
    """A PETSc binary round trip: the operator and a right-hand side saved
    to one file (rank 0 writes), loaded back on every process and solved."""
    A = AIJ_OPERATORS[case["op"]]()
    path = os.path.join(case["dir"], case["name"] + ".petsc")
    b = pt.Vec.from_global(comm, rhs(A.shape[0], case.get("seed", 3)))
    if comm.rank == 0:
        os.makedirs(case["dir"], exist_ok=True)
    # rank 0 alone opens the file; the saves end at a barrier
    with (open(path, "wb") if comm.rank == 0
          else contextlib.nullcontext()) as f:
        pt.petsc_io.save_mat(f, pt.Mat.from_scipy(comm, A))
        pt.petsc_io.save_vec(f, b)
    with open(path, "rb") as f:
        mat = pt.petsc_io.load_mat(f, comm)
        bl = pt.petsc_io.load_vec(f, comm)
    ksp = pt.KSP().create(comm)
    ksp.set_type(case["ksp"])
    ksp.get_pc().set_type(case["pc"])
    ksp.set_tolerances(rtol=case.get("rtol", 1e-8), atol=0.0, max_it=5000)
    ksp.set_operators(mat)
    x = mat.get_vecs()[0]
    res = ksp.solve(bl, x)
    return {"its": res.iterations, "reason": int(res.reason),
            "x": x.to_numpy(), "pc_kind": ksp.get_pc().kind,
            "loaded_equal": bool(
                (abs(mat.to_scipy() - A) > 0).nnz == 0
                and np.array_equal(bl.to_numpy(), b.to_numpy()))}


def _eps_operator(comm, name, case):
    if name == "stencil":
        return pt.StencilPoisson3D(comm, *case["grid"], dtype=torch.float64)
    return pt.Mat.from_scipy(comm, AIJ_OPERATORS[name]())


def configure_eps(E, case):
    """``case``'s eigensolver settings on ``E``, an EPS of either package
    (their setters are the same); returns ``E``."""
    E.set_problem_type(case.get("ptype", "hep"))
    E.set_type(case.get("eps_type", "krylovschur"))
    if case.get("which"):
        E.set_which_eigenpairs(case["which"])
    E.set_dimensions(nev=case.get("nev"), ncv=case.get("ncv"))
    E.set_tolerances(tol=case.get("tol"), max_it=case.get("max_it"))
    if case.get("target") is not None:
        E.set_target(case["target"])
    if case.get("st"):
        E.get_st().set_type(case["st"])
    if case.get("shift") is not None:
        E.get_st().set_shift(case["shift"])
    if case.get("antishift") is not None:
        E.get_st().set_antishift(case["antishift"])
    return E


def _case_eps(comm, case):
    """An eigensolve: restarts, reason, nconv, the stored pairs, each
    pair's ``compute_error`` (collective) and the operator's launches."""
    A = _eps_operator(comm, case["op"], case)
    B = _eps_operator(comm, case["bop"], case) if case.get("bop") else None
    E = configure_eps(pt.EPS().create(comm).set_operators(A, B), case)
    _sync(comm)
    before, calls = _counts(), dict(comm.collectives)
    E.solve()
    _sync(comm)
    out = {"its": E.get_iteration_number(), "reason": int(E.result.reason),
           "nconv": E.get_converged(), "lam": np.asarray(E._eigenvalues),
           "x": np.asarray(E._eigenvectors), "wall_s": E.result.wall_time,
           "host_syncs": E.result.host_syncs}
    out.update({f"calls_{k}": v - calls[k]
                for k, v in comm.collectives.items()})
    out.update(_launched(before))
    out["err"] = np.asarray([E.compute_error(i)
                             for i in range(len(E._eigenvalues))])
    return out


def refine_rhs(case, A) -> np.ndarray:
    """The refinement case's right-hand side ``A x`` for a seeded ``x``;
    with ``k``, the ``(n, k)`` block of its scaled and shifted copies."""
    b = A @ np.random.default_rng(case.get("seed", 4)).random(A.shape[0])
    if not case.get("k"):
        return b
    return np.stack([b * (j + 1) + j for j in range(case["k"])], axis=1)


def _case_refine(comm, case):
    """``RefinedKSP``: the fp64 outer loop around an inner CG at ``prec``,
    on the stencil (``grid``) or an assembled operator (``op``); ``k``
    columns go through ``solve_many``; ``megasolve`` runs the fused program
    (on the stencil with an fp64 stencil as the outer operator)."""
    dt = _DTYPES[case.get("prec", "f32")]
    outer = None
    if case.get("grid"):
        A = poisson3d_csr(*case["grid"])
        inner = pt.StencilPoisson3D(comm, *case["grid"], dtype=dt)
        if case.get("megasolve"):
            outer = pt.StencilPoisson3D(comm, *case["grid"],
                                        dtype=torch.float64)
    else:
        A, inner = AIJ_OPERATORS[case["op"]](), None
    rk = pt.RefinedKSP().create(comm)
    rk.megasolve = bool(case.get("megasolve", False))
    rk.set_inner_precision(case.get("prec", "f32"))
    rk.set_operators(A, inner_op=inner, outer_op=outer)
    rk.set_type("cg")
    rk.get_pc().set_type(case.get("pc", "jacobi"))
    rk.set_tolerances(rtol=case.get("rtol", 1e-10))
    b = refine_rhs(case, A)
    _sync(comm)
    before = _counts()
    x, res = rk.solve_many(b) if case.get("k") else rk.solve(b)
    _sync(comm)
    out = {"its": res.iterations, "reason": int(res.reason), "x": x,
           "steps": rk.refine_steps, "rnorm": res.residual_norm,
           "wall_s": res.wall_time, "host_syncs": res.host_syncs,
           **_fused(res)}
    out.update(_launched(before))
    return out


def _case_comm(comm, case):
    """Every collective of the communicator on seeded data; the results are
    whole arrays, the same on every process."""
    n, k = int(case["n"]), 3
    rng = np.random.default_rng(case.get("seed", 0))
    v, blk = rng.standard_normal(n), rng.standard_normal((n, k))
    d = comm.put_rows(v)
    stack = d.view(comm.local_shards, -1)
    parts = [torch.dot(stack[i], stack[i]) for i in range(comm.local_shards)]
    cols = comm.put_cols(blk)
    return {
        "put_fetch": comm.host_fetch(d),
        "psum": comm.psum(parts).cpu().numpy(),
        "pmax": comm.pmax([stack[i].max()
                           for i in range(comm.local_shards)]).cpu().numpy(),
        "shift_up": comm.host_fetch(comm.shift(stack, 1).reshape(-1)),
        "shift_down": comm.host_fetch(comm.shift(stack, -1).reshape(-1)),
        "open_up": comm.host_fetch(comm.shift_open(stack, 1).reshape(-1)),
        "open_down": comm.host_fetch(comm.shift_open(stack, -1).reshape(-1)),
        "all_gather": comm.all_gather(stack).cpu().numpy(),
        "cols": comm.fetch_cols(cols, n),
        "replicated": comm.put_replicated(v).cpu().numpy(),
    }


def _case_sdc(comm, case):
    """The silent-corruption guard under an injected fault: the stencil CG
    of ``grid`` (``ksp`` cg/pipecg/sstep, ``pc``, ``dtype``, ``rtol``) with
    ``-ksp_abft`` and ``-ksp_residual_replacement rr``, the fault ``spec``
    armed; the detection (detector, iteration, the rolled-back iterate),
    then ``resilient_solve``'s recovery (iterations, attempts, the events,
    the final iterate, and ``graph``: whether the fused program ran as CUDA
    graphs, with ``megasolve``). ``k`` columns go through ``solve_many``
    and ``resilient_solve_many`` instead."""
    from mpi_petsc4py_example_tpu_torch.resilience import faults
    geometry = tuple(case["grid"])
    dt = _DTYPES[case.get("dtype", "f64")]
    op = pt.StencilPoisson3D(comm, *geometry, dtype=dt)
    n = op.shape[0]
    k = case.get("k")
    B = rhs(n, case.get("seed", 0), k)
    ksp = _stencil_ksp(comm, case, op)
    ksp.abft = True
    ksp.residual_replacement = int(case.get("rr", 8))
    policy = pt.RetryPolicy(sleep=lambda _d: None)
    out = {}
    with faults.inject_faults(case["spec"]):
        try:
            if k:
                ksp.solve_many(B, np.zeros((n, k)))
            else:
                x = op.get_vecs()[0]
                ksp.solve(pt.Vec.from_global(comm, B, dtype=dt), x)
        except pt.SilentCorruptionError as e:
            out.update(detector=e.detector, det_it=e.iteration,
                       x_rollback=(x.to_numpy() if not k else 0))
    # the same fault again, now under the resilient wrapper
    with faults.inject_faults(case["spec"]):
        if k:
            X = np.zeros((n, k))
            res = pt.resilient_solve_many(ksp, B, X, policy)
            out["x"] = X
        else:
            b = pt.Vec.from_global(comm, B, dtype=dt)
            x = op.get_vecs()[0]
            res = pt.resilient_solve(ksp, b, x, policy)
            out["x"] = x.to_numpy()
    out.update(its=np.asarray(res.iterations), attempts=res.attempts,
               sdc=res.sdc_detections, graph=bool(getattr(res, "graph",
                                                          False)),
               events=json.dumps([(e.kind, e.attempt, e.detector)
                                  for e in res.recovery_events]))
    return out


_KINDS = {"cg": _case_cg, "many": _case_many, "aij": _case_aij,
          "comm": _case_comm, "eps": _case_eps, "refine": _case_refine,
          "mult_t": _case_mult_t, "io": _case_io, "sdc": _case_sdc}


def run_case(comm, case: dict) -> dict:
    """Run ``case`` on ``comm`` and return its results as plain values.

    ``case["kind"]`` is 'comm' (every collective on a seeded vector of
    ``n`` rows), 'cg' (a stencil solve on ``grid`` with ``pc``
    none/jacobi/mg, KSP ``ksp``, CG by default,
    ``dtype`` f64/f32, ``rtol``; ``true_res`` adds the fp64 true residual,
    ``repeat`` solves again and reports the last, ``time_psum`` adds
    :func:`psum_us`, and for gloo on the card also ``psum_host_us``, the
    same group's psum of host tensors), 'many' (``solve_many``
    of ``k`` columns, ``route`` 'fast' or 'general', KSP ``ksp``), 'aij'
    (``ksp`` with ``pc`` on the assembled operator ``op`` of
    :data:`AIJ_OPERATORS`, in ``dtype`` f64 or c128, whose right-hand
    side is then complex; ``gate`` turns on the true-residual gate,
    ``setup_device`` is the PC's ``-pc_setup_device``, ``dense_cap``
    lowers PC lu's dense cap, ``shellmat`` wraps the operator in a
    :func:`shell_mat`, ``nullspace`` attaches the constant null space;
    ``pc`` 'shell' applies :func:`shell_pc_apply`, 'composite' combines
    ``children`` by ``ctype``), 'mult_t' (``A^T v`` of ``op``), 'io' (a
    PETSc binary round trip of ``op`` through the directory ``dir``, then
    ``ksp`` with ``pc``), 'eps' (an eigensolve of ``op``, the stencil on
    ``grid`` when ``op`` is 'stencil', with ``bop`` as B, ``ptype``,
    ``eps_type``, ``which``, ``nev``, ``ncv``, ``tol``, ``max_it``,
    ``target``, ``st``, ``shift``, ``antishift``) or 'refine'
    (``RefinedKSP`` at inner precision ``prec`` on the stencil of ``grid``
    or on ``op``, CG with ``pc``; ``k`` columns through ``solve_many``) or
    'sdc' (:func:`_case_sdc`: the guarded stencil solve under the fault
    ``spec``, its detection and ``resilient_solve``'s recovery).
    The solve kinds take the Krylov parameters ``sstep_s``, ``restart``,
    ``aug`` and ``ell`` (:func:`configure_ksp`), and 'cg' and 'many' report
    the solve's host syncs and its collective calls (``calls_psum``,
    ``calls_shift``, ...). ``megasolve`` (with ``fastpath``) sends 'cg',
    'many' and 'refine' through the fused program, which adds ``steps``,
    ``replays``, ``masked_steps`` and ``graph``; ``reduction_auto`` on 'cg'
    lets ``-ksp_reduction_auto`` choose the type and adds its report
    (``auto_type``, ``auto_s``, ``psum_us``, ``apply_us``, ``ranking``)."""
    return _KINDS[case["kind"]](comm, case)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="parity.py")
    ap.add_argument("cases", help="JSON list of case dicts")
    ap.add_argument("out", help="directory of the per-case .npz files")
    ap.add_argument("--virtual", type=int, default=0, metavar="N",
                    help="run every case on DeviceComm(N) in this one "
                         "process instead (no runner needed)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the --virtual mesh's device")
    opts = ap.parse_args(argv[1:])
    with open(opts.cases) as f:
        cases = json.load(f)
    if opts.virtual:
        base = pt.DeviceComm(opts.virtual,
                             device=None if opts.device == "cuda" else "cpu")
    else:
        from mpi4py import MPI      # the runner's facade: the process group
        base = MPI.COMM_WORLD.device_comm
    rank = base.rank
    os.makedirs(opts.out, exist_ok=True)
    for case in cases:
        comm = (base if opts.virtual else
                pt.ProcessComm(case.get("local_shards", 1), base.device))
        t0 = time.perf_counter()
        res = run_case(comm, case)
        res["case_wall_s"] = time.perf_counter() - t0
        res["host_copies_total"] = getattr(comm, "host_copies", 0)
        res["backend"] = getattr(comm, "backend", "none")
        res["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib")
                                  for m in sys.modules)
        if rank == 0:
            np.savez(os.path.join(opts.out, case["name"] + ".npz"),
                     **{k: np.asarray(v) for k, v in res.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
