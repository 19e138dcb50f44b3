"""Advanced-feature tour on the port: a matrix-free operator, PC
composition, PETSc binary I/O.

The port's counterpart of scenarios 1-3 of ``examples/advanced.py``, on the
same problem (the 24^2 Laplacian plus a variable diagonal, ``x_true`` from
``default_rng(7)``, rtol 1e-10), printing the same lines:

1. ``ShellMat``: the never-assembled operator (a torch ``mult`` on the whole
   vector) solved with CG + Jacobi.
2. PC ``composite``: multiplicative jacobi then sor, under FGMRES.
3. PETSc binary: the system written to one file (Mat, then Vec), read back
   and solved with CG + Jacobi.

Run::

    python -m mpi_petsc4py_example_tpu_torch.facade.drivers.advanced \\
        [--device cpu] [-ksp_type bcgs] ...

It runs on the card unless ``--device cpu`` is given; the options after it
seed the options database, which scenario 1's ``set_from_options`` reads.
Under the port's runner (``python -m mpi_petsc4py_example_tpu_torch.run -n
N [--procs] [--device cpu] advanced.py``) it runs on the runner's device
communicator: with thread ranks the rank-0 thread runs the tour on the mesh
of all N shards, with rank processes every rank runs it on its shards of
the ``ProcessComm``; rank 0 alone prints, so both print the same lines.
"""

import os
import sys
import tempfile

import numpy as np
import scipy.sparse as sp
import torch

import mpi_petsc4py_example_tpu_torch as pt


def laplacian2d(nx):
    T = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    return (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def main(argv=None, device=None, comm=None, verbose=True):
    """Run the three scenarios on ``comm`` (default: one shard on
    ``device``, None being the card), printing their lines when
    ``verbose``; returns 0."""
    argv = list(sys.argv if argv is None else argv)
    pt.init(argv)
    if comm is None:
        comm = pt.DeviceComm(device=device)
    print_ = print if verbose else (lambda *a, **k: None)
    nx = 24
    n = nx * nx
    A = laplacian2d(nx)
    w = 1.0 + np.arange(n) / n                     # variable coefficient
    Aw = (A + sp.diags(w)).tocsr()
    rng = np.random.default_rng(7)
    x_true = rng.random(n)
    b = Aw @ x_true

    # -- 1. matrix-free ShellMat --------------------------------------------
    Ad = torch.tensor(A.toarray(), device=comm.device)
    wt = torch.tensor(w, device=comm.device)
    S = pt.ShellMat(comm, n, lambda v: Ad @ v + wt * v,
                    diagonal=A.diagonal() + w)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(S)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=1e-10)
    ksp.set_from_options()
    x, bv = S.get_vecs()
    bv.set_global(b)
    res = ksp.solve(bv, x)
    print_(f"1. shell operator: {res.reason_name} in {res.iterations} its, "
          f"max err {np.abs(x.to_numpy() - x_true).max():.2e}")

    # -- 2. composite preconditioning ---------------------------------------
    M = pt.Mat.from_scipy(comm, Aw)
    pc = pt.PC(comm)
    pc.set_type("composite")
    pc.set_composite_type("multiplicative")
    pc.set_composite_pcs("jacobi", "sor")
    ksp2 = pt.KSP().create(comm)
    ksp2.set_operators(M)
    ksp2.set_type("fgmres")
    ksp2.set_pc(pc)
    ksp2.set_tolerances(rtol=1e-10)
    x2, b2 = M.get_vecs()
    b2.set_global(b)
    res2 = ksp2.solve(b2, x2)
    print_(f"2. composite(jacobi,sor): {res2.reason_name} in "
          f"{res2.iterations} its")

    # -- 3. PETSc binary round trip -----------------------------------------
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "system.petsc")
        with open(path, "wb") as f:
            pt.petsc_io.write_mat(f, Aw)
            pt.petsc_io.write_vec(f, b)
        with open(path, "rb") as f:
            A2 = pt.petsc_io.read_mat(f)
            b2h = pt.petsc_io.read_vec(f)
    M3 = pt.Mat.from_scipy(comm, A2)
    ksp3 = pt.KSP().create(comm)
    ksp3.set_operators(M3)
    ksp3.set_type("cg")
    ksp3.get_pc().set_type("jacobi")
    ksp3.set_tolerances(rtol=1e-10)
    x3, b3 = M3.get_vecs()
    b3.set_global(b2h)
    res3 = ksp3.solve(b3, x3)
    print_(f"3. petsc-binary round trip: {res3.reason_name}, "
          f"max err {np.abs(x3.to_numpy() - x_true).max():.2e}")
    return 0


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
