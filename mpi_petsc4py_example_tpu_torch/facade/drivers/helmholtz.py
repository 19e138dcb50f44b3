"""Complex-scalar demo on the port: 2D Helmholtz with an absorbing shift.

The port's counterpart of ``examples/helmholtz.py``, the complex-build
analog of the reference ``test.py`` flow. It builds the shifted Helmholtz
operator

    A = -Δh - (k² + iε) I,   k² = 1.5, ε = 0.5,

on an nx × nx grid (5-point Laplacian, Dirichlet), manufactures a complex
solution from ``default_rng(42)``, solves with GMRES + Jacobi in complex128
at rtol 1e-10, and prints the same two lines as the JAX example: the
solve's summary and ``True`` when ``np.allclose(x, x_true, atol=1e-6)``.

Run::

    python -m mpi_petsc4py_example_tpu_torch.facade.drivers.helmholtz \\
        [--device cpu] [-n 48] [-ksp_type bcgs] [-ksp_rtol 1e-10]

It runs on the card unless ``--device cpu`` is given; the options after it
seed the options database, which ``set_from_options`` reads. Under the
port's runner (``python -m mpi_petsc4py_example_tpu_torch.run -n N [--procs]
[--device cpu] helmholtz.py``) it runs on the runner's device communicator:
with thread ranks the rank-0 thread solves on the mesh of all N shards, with
rank processes every rank solves on its shards of the ``ProcessComm``; rank
0 alone prints.
"""

import sys

import numpy as np
import scipy.sparse as sp
import torch

import mpi_petsc4py_example_tpu_torch as pt
from mpi_petsc4py_example_tpu_torch.models.poisson import poisson2d_csr

K2, EPS = 1.5, 0.5


def helmholtz2d(nx: int, k2: float = K2, eps: float = EPS):
    """-Δh - (k² + iε) I on an nx² grid (h = 1 5-point stencil,
    Dirichlet), complex128 CSR."""
    lap = poisson2d_csr(nx).astype(np.complex128)
    return (lap - (k2 + 1j * eps) * sp.eye(nx * nx)).tocsr()


def manufactured(A):
    """``(x_true, b)``: the example's complex solution from
    ``default_rng(42)`` and ``b = A x_true``."""
    rng = np.random.default_rng(42)
    n = A.shape[0]
    x_true = rng.random(n) + 1j * rng.random(n)
    return x_true, A @ x_true


def solve(comm, A, b, dtype=torch.complex128, ksp_type="gmres",
          pc_type="jacobi", rtol=1e-10, max_it=5000, from_options=True):
    """Assemble ``A`` on ``comm`` in ``dtype``, solve ``A x = b`` with
    ``ksp_type`` + ``pc_type`` at ``rtol`` (then the options database, when
    ``from_options``), and return ``(ksp, result, x on the host)``."""
    M = pt.Mat.from_scipy(comm, A, dtype=dtype)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=rtol, max_it=max_it)
    if from_options:
        ksp.set_from_options()
    x, bv = M.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    return ksp, res, x.to_numpy()


def main(argv=None, device=None, comm=None, verbose=True):
    """Solve the example on ``comm`` (default: one shard on ``device``, None
    being the card), printing its two lines when ``verbose``; returns 0
    when the solution matches, else 1."""
    argv = list(sys.argv if argv is None else argv)
    pt.init(argv)
    if comm is None:
        comm = pt.DeviceComm(device=device)
    nx = pt.global_options().get_int("n", 48)
    A = helmholtz2d(nx)
    x_true, b = manufactured(A)
    ksp, res, xs = solve(comm, A, b)
    ok = bool(np.allclose(xs, x_true, atol=1e-6))
    if verbose:
        print(f"Helmholtz {nx}x{nx} (complex128): {ksp.get_type()} "
              f"{res.iterations} its, rel res "
              f"{np.linalg.norm(b - A @ xs) / np.linalg.norm(b):.2e}")
        print(ok)
    return 0 if ok else 1


def _runner_world():
    """``MPI.COMM_WORLD`` of the port's MPI facade when the runner (``run.py``)
    executes this script, which imports the facade first; None otherwise."""
    world = getattr(sys.modules.get("mpi4py.MPI"), "COMM_WORLD", None)
    return world if hasattr(world, "device_comm") else None


if __name__ == "__main__":
    world = _runner_world()
    if world is None:
        args = sys.argv[1:]
        dev = None
        if args[:2] == ["--device", "cpu"]:
            dev, args = "cpu", args[2:]
        sys.exit(main([sys.argv[0]] + args, device=dev))
    # no sys.exit under the runner: a rank thread's exit counts as a failure
    rank, dc = world.Get_rank(), world.device_comm
    if dc.multiprocess or rank == 0:
        main(sys.argv, comm=dc, verbose=rank == 0)
