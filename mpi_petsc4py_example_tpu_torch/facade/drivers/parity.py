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

import json
import os
import sys
import time

import numpy as np
import torch

import mpi_petsc4py_example_tpu_torch as pt
from mpi_petsc4py_example_tpu_torch.models.generators import (convdiff2d,
                                                              random_system)
from mpi_petsc4py_example_tpu_torch.models.poisson import (poisson2d_csr,
                                                           poisson3d_csr)
from mpi_petsc4py_example_tpu_torch.ops import stencil as st

# the assembled operators of the AIJ cases (small cuts of the benchmark's
# cfg1/cfg3/cfg4 and the reference test.py system)
AIJ_OPERATORS = {
    "cfg1": lambda: poisson3d_csr(6),
    "cfg3": lambda: poisson2d_csr(20),
    "cfg4": lambda: convdiff2d(16, beta=0.4),
    "testpy": lambda: random_system(100)[0],
}
_DTYPES = {"f64": torch.float64, "f32": torch.float32}


def rhs(n: int, seed: int, k: int | None = None) -> np.ndarray:
    """The seeded right-hand side: ``(n,)``, or ``(n, k)`` for a block."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (n, k))


def _sync(comm):
    if comm.device.type == "cuda":
        torch.cuda.synchronize(comm.device)


def _counts() -> dict:
    return {name: getattr(st, name).launches for name in (
        "stencil3d_dot", "stencil3d_apply", "stencil3d_dot_many",
        "stencil3d_apply_many", "stencil3d_smooth", "stencil3d_residual",
        "stencil3d_smooth0_pair", "stencil3d_smooth_pair",
        "stencil3d_residual_restrict")}


def _stencil_ksp(comm, case, op):
    ksp = pt.KSP().create(comm)
    ksp.set_type("cg")
    ksp.get_pc().set_type(case.get("pc", "jacobi"))
    ksp.set_tolerances(rtol=case.get("rtol", 1e-8), atol=0.0,
                       max_it=case.get("max_it", 10000))
    ksp.set_operators(op, case.get("pmat"))
    return ksp


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
        before = _counts()
        copies = getattr(comm, "host_copies", 0)
        res = ksp.solve(b, x)
        _sync(comm)
        after = _counts()
        out = {"its": res.iterations, "reason": int(res.reason),
               "rnorm": res.residual_norm, "wall_s": res.wall_time,
               "host_copies": getattr(comm, "host_copies", 0) - copies}
        out.update({f"launches_{k}": after[k] - before[k] for k in after})
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
    before = _counts()
    res = ksp.solve_many(B)
    _sync(comm)
    after = _counts()
    out = {"its": np.asarray(res.iterations),
           "reason": np.asarray([int(r) for r in res.reasons]),
           "x": np.asarray(res.X), "wall_s": res.wall_time}
    out.update({f"launches_{k}": after[k] - before[k] for k in after})
    return out


def _case_aij(comm, case):
    A = AIJ_OPERATORS[case["op"]]()
    mat = pt.Mat.from_scipy(comm, A)
    ksp = pt.KSP().create(comm)
    ksp.set_type(case["ksp"])
    ksp.get_pc().set_type(case["pc"])
    ksp.get_pc().setup_device = case.get("setup_device", "auto")
    ksp.set_tolerances(rtol=case.get("rtol", 1e-8), atol=0.0,
                       max_it=case.get("max_it", 5000))
    ksp.set_true_residual_check(case.get("gate", False))
    ksp.set_operators(mat)
    x, b = mat.get_vecs()
    b.set_global(rhs(A.shape[0], case.get("seed", 3)))
    res = ksp.solve(b, x)
    return {"its": res.iterations, "reason": int(res.reason),
            "x": x.to_numpy(), "route": mat.spmv_route(comm),
            "wall_s": res.wall_time}


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


def _out_of_slice(comm):
    """What the rest of the stack does on ``comm``: each entry is the
    ``NotImplementedError`` it raised, or 'ran'; any other error ends the
    run."""
    from mpi_petsc4py_example_tpu_torch.solvers.pc import PC
    from mpi_petsc4py_example_tpu_torch.solvers.st import STOperator
    A = poisson2d_csr(8)
    mat = pt.Mat.from_scipy(comm, A)

    def ksp_of(ksp_type, pc_type="none"):
        ksp = pt.KSP().create(comm)
        ksp.set_type(ksp_type)
        ksp.get_pc().set_type(pc_type)
        ksp.set_operators(mat)
        x, b = mat.get_vecs()
        b.set_global(np.ones(A.shape[0]))
        return lambda: ksp.solve(b, x)

    def pc_of(pc_type):
        pc = PC(comm)
        pc.set_type(pc_type)
        if pc_type == "shell":
            pc.set_shell_apply(lambda r: r)
        if pc_type == "composite":
            pc.set_composite_pcs("jacobi", "jacobi")
        return lambda: pc.set_up(mat)

    def with_nullspace():
        m = pt.Mat.from_scipy(comm, A)
        m.set_nullspace(pt.NullSpace(constant=True))
        ksp = pt.KSP().create(comm)
        ksp.set_type("cg")
        ksp.set_operators(m)
        x, b = m.get_vecs()
        return ksp.solve(b, x)

    attempts = {
        "EPS": lambda: pt.EPS().create(comm),
        "RefinedKSP": lambda: pt.RefinedKSP().create(comm),
        "ShellMat": lambda: pt.ShellMat(comm, A.shape[0], lambda x: x),
        "NullSpace": with_nullspace,
        "mult_transpose": lambda: mat.mult_transpose(mat.get_vecs()[0]),
        "petsc_io": lambda: pt.petsc_io.save_vec(os.devnull,
                                                 mat.get_vecs()[0]),
        "ST": lambda: STOperator(mat, None, "shift", 1.0),
    }
    attempts.update({f"KSP {t}": ksp_of(t) for t in ("lsqr", "bicg", "cgne")})
    attempts.update({f"PC {t}": pc_of(t) for t in (
        "sor", "ssor", "ilu", "icc", "asm", "shell", "composite")})
    out = {}
    for name, fn in attempts.items():
        try:
            fn()
            out[name] = "ran"
        except NotImplementedError as err:
            out[name] = f"NotImplementedError: {err}"
    return out


_KINDS = {"cg": _case_cg, "many": _case_many, "aij": _case_aij,
          "comm": _case_comm}


def run_case(comm, case: dict) -> dict:
    """Run ``case`` on ``comm`` and return its results as plain values.

    ``case["kind"]`` is 'comm' (every collective on a seeded vector of
    ``n`` rows), 'cg' (stencil CG on ``grid`` with ``pc`` none/jacobi/mg,
    ``dtype`` f64/f32, ``rtol``; ``true_res`` adds the fp64 true residual,
    ``repeat`` solves again and reports the last, ``time_psum`` adds
    :func:`psum_us`, and for gloo on the card also ``psum_host_us``, the
    same group's psum of host tensors), 'many' (``solve_many``
    of ``k`` columns, ``route`` 'fast' or 'general') or 'aij' (``ksp``
    with ``pc`` on the assembled operator ``op`` of
    :data:`AIJ_OPERATORS`; ``gate`` turns on the true-residual gate,
    ``setup_device`` is the PC's ``-pc_setup_device``)."""
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
        if case["kind"] == "out_of_slice":
            res = {k: np.asarray(v)
                   for k, v in _out_of_slice(base).items()}
        else:
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
