"""The reference wrapper's two functions on the port's facade.

``createPETScMat(comm, shape, csr)``: the contract *(communicator, global
shape, local rebased CSR with global column indices)* -> an assembled
distributed AIJ matrix. ``solveSLEPcEigenvalues(comm, A)``: a Hermitian
eigensolve with SLEPc's defaults (Krylov-Schur, nev 1, the largest
magnitude), which the ``-eps_*`` and ``-st_*`` options reconfigure.
"""

from petsc4py import PETSc
from slepc4py import SLEPc


def createPETScMat(comm, shape, csr):
    """(comm, global shape, local rebased CSR) -> assembled ``PETSc.Mat``."""
    A = PETSc.Mat().createAIJ(comm=comm, size=shape, csr=csr)
    A.assemble()
    return A


def solveSLEPcEigenvalues(comm, A):
    """``A`` (a ``PETSc.Mat``) -> the solved ``SLEPc.EPS``: HEP, then the
    options database, then one collective solve."""
    E = SLEPc.EPS().create(comm=comm)
    E.setOperators(A)
    E.setProblemType(SLEPc.EPS.ProblemType.HEP)
    E.setFromOptions()
    E.solve()
    return E
