"""Distributed Hermitian eigensolve: the reference ``test2.py`` flow on the
port's petsc4py/slepc4py/mpi4py facade.

Rank 0 builds the symmetric tridiagonal family ``A[i, j] = i + j + 1`` (n =
100), cuts it into contiguous CSR row blocks (indptr rebased, columns
global) and sends each rank its block with typed ``[buf, MPI.INT]`` /
``[buf, MPI.DOUBLE]`` buffers; every rank assembles through
``petsc_funcs.createPETScMat`` and takes part in
``petsc_funcs.solveSLEPcEigenvalues`` (Krylov-Schur, nev 1, the largest
magnitude, unless ``-eps_*`` options say otherwise); rank 0 alone reads the
pairs with ``getEigenpair`` and prints each eigenvalue.

Run::

    python -m mpi_petsc4py_example_tpu_torch.run -n 4 \\
        mpi_petsc4py_example_tpu_torch/facade/drivers/eigensolve.py

(``--device cpu`` after ``run`` for the CPU; options such as ``-eps_nev 4``
after the script.)
"""

import sys

import numpy as np

import slepc4py

slepc4py.init(sys.argv)

from mpi4py import MPI  # noqa: E402

import petsc_funcs as pet  # noqa: E402

from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    tridiag_family)
from mpi_petsc4py_example_tpu_torch.parallel.partition import (  # noqa: E402
    row_partition, slice_csr_block)


def main():
    comm = MPI.COMM_WORLD
    rank = comm.Get_rank()
    nprocs = comm.Get_size()

    if rank == 0:
        CSR = tridiag_family(100)
        shape = CSR.shape
        count, displ = row_partition(shape[0], nprocs)
        for i in range(1, nprocs):
            rs, re = int(displ[i]), int(displ[i] + count[i])
            indptr, indices, data = slice_csr_block(
                CSR.indptr, CSR.indices, CSR.data, rs, re)
            comm.send({"indptr": len(indptr), "indices": len(indices),
                       "data": len(data)}, dest=i)
            comm.Send([indptr.astype(np.int32), MPI.INT], dest=i)
            comm.Send([indices.astype(np.int32), MPI.INT], dest=i)
            comm.Send([data, MPI.DOUBLE], dest=i)
        rs, re = int(displ[0]), int(displ[0] + count[0])
        indptr, indices, data = slice_csr_block(CSR.indptr, CSR.indices,
                                                CSR.data, rs, re)
    else:
        lengths = comm.recv(source=0)
        indptr = np.empty(lengths["indptr"], dtype=np.int32)
        indices = np.empty(lengths["indices"], dtype=np.int32)
        data = np.empty(lengths["data"], dtype=np.double)
        comm.Recv([indptr, MPI.INT], source=0)
        comm.Recv([indices, MPI.INT], source=0)
        comm.Recv([data, MPI.DOUBLE], source=0)
        shape = None

    shape = comm.bcast(shape, root=0)

    A = pet.createPETScMat(comm, shape, (indptr, indices, data))
    E = pet.solveSLEPcEigenvalues(comm, A)

    nconv = E.getConverged()
    vr, wr = A.getVecs()
    vi, wi = A.getVecs()

    if rank == 0:
        for i in range(nconv):
            k = E.getEigenpair(i, vr, vi)
            print("Eigenvalue: ", k)


if __name__ == "__main__":
    main()
