"""The reference wrapper's matrix factory on the port's facade.

``createPETScMat(comm, shape, csr)``: the contract *(communicator, global
shape, local rebased CSR with global column indices)* -> an assembled
distributed AIJ matrix. The eigensolver wrapper (``solveSLEPcEigenvalues``)
comes with the port's eigensolver slice.
"""

from petsc4py import PETSc


def createPETScMat(comm, shape, csr):
    """(comm, global shape, local rebased CSR) -> assembled ``PETSc.Mat``."""
    A = PETSc.Mat().createAIJ(comm=comm, size=shape, csr=csr)
    A.assemble()
    return A
