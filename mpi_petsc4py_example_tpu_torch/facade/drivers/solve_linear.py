"""Distributed direct solve of A X = B: the reference ``test.py`` flow on the
port's petsc4py/mpi4py facade.

Rank 0 builds a seeded random sparse system with a manufactured solution,
cuts it into contiguous CSR row blocks (indptr rebased, columns global) and
sends each rank its block and right-hand side; every rank then takes part in
a KSP ``preonly`` + PC ``lu`` solve (factor package string ``'mumps'``), the
solution is gathered with the true per-rank counts and rank 0 prints
``np.allclose(X, X_actual)``. It imports only numpy, scipy, mpi4py and
petsc4py.

Run::

    python -m mpi_petsc4py_example_tpu_torch.run -n 4 \\
        mpi_petsc4py_example_tpu_torch/facade/drivers/solve_linear.py

(``--device cpu`` after ``run`` for the CPU; options such as ``-ksp_type
gmres -pc_type none`` after the script override the solver.)
"""

import sys

import numpy as np
import scipy.sparse

import petsc4py

petsc4py.init(sys.argv)

from mpi4py import MPI  # noqa: E402
from petsc4py import PETSc  # noqa: E402


def create_system(n=100, seed=42, density=0.1):
    rng = np.random.default_rng(seed=seed)
    A = scipy.sparse.random(n, n, density=density, format="csr",
                            dtype=np.float64, random_state=rng)
    X = rng.random(n)
    B = A.dot(X)
    return A, X, B


def solve(comm, shape, indptr, indices, data, rhs):
    a = PETSc.Mat().createAIJ(comm=comm, size=shape,
                              csr=(indptr, indices, data))
    a.setUp()
    a.assemblyBegin()
    a.assemblyEnd()
    x, b = a.getVecs()
    b.setArray(rhs)
    ksp = PETSc.KSP().create(comm)
    ksp.setType("preonly")
    pc = ksp.getPC()
    pc.setType("lu")
    pc.setFactorSolverType("mumps")
    ksp.setOperators(a)
    ksp.setFromOptions()
    ksp.setUp()
    ksp.solve(b, x)
    return x


comm = MPI.COMM_WORLD
nprocs = comm.Get_size()
rank = comm.Get_rank()

if rank == 0:
    A, X_actual, B = create_system()
    shape = A.shape
    nrows = shape[0]
    # contiguous row blocks, the remainder spread over the lowest ranks
    base, extra = divmod(nrows, nprocs)
    count = np.array([base + 1 if i < extra else base
                      for i in range(nprocs)])
    displ = np.concatenate(([0], np.cumsum(count)[:-1]))
    for i in range(1, nprocs):
        rs, re = displ[i], displ[i] + count[i]
        indptr = A.indptr[rs:re + 1] - A.indptr[rs]
        indices = A.indices[A.indptr[rs]:A.indptr[re]]
        data = A.data[A.indptr[rs]:A.indptr[re]]
        rhs = B[rs:re]
        comm.send({"indptr": len(indptr), "indices": len(indices),
                   "data": len(data), "rhs": len(rhs)}, dest=i)
        comm.Send(np.ascontiguousarray(indptr, dtype=np.int32), dest=i)
        comm.Send(np.ascontiguousarray(indices, dtype=np.int32), dest=i)
        comm.Send(np.ascontiguousarray(data), dest=i)
        comm.Send(np.ascontiguousarray(rhs), dest=i)
    rs, re = displ[0], displ[0] + count[0]
    indptr = A.indptr[rs:re + 1] - A.indptr[rs]
    indices = A.indices[A.indptr[rs]:A.indptr[re]]
    data = A.data[A.indptr[rs]:A.indptr[re]]
    rhs = B[rs:re]
else:
    lengths = comm.recv(source=0)
    indptr = np.empty(lengths["indptr"], dtype=np.int32)
    indices = np.empty(lengths["indices"], dtype=np.int32)
    data = np.empty(lengths["data"], dtype=np.double)
    rhs = np.empty(lengths["rhs"], dtype=np.double)
    comm.Recv(indptr, source=0)
    comm.Recv(indices, source=0)
    comm.Recv(data, source=0)
    comm.Recv(rhs, source=0)
    shape = None

shape = comm.bcast(shape, root=0)
x = solve(comm, shape, indptr, indices, data, rhs)

X = np.empty(shape[0], dtype=np.double) if rank == 0 else None
comm.Gatherv(x.array, X)

if rank == 0:
    ok = bool(np.allclose(X, X_actual))
    print(ok)
    if not ok:
        raise SystemExit("solution mismatch")
