"""The reference wrapper's two functions on the port's facade.

``createPETScMat(comm, shape, csr)``: the contract *(communicator, global
shape, local rebased CSR with global column indices)* -> an assembled
distributed AIJ matrix. ``solveSLEPcEigenvalues(comm, A)``: a Hermitian
eigensolve with SLEPc's defaults (Krylov-Schur, nev 1, the largest
magnitude), which the ``-eps_*`` and ``-st_*`` options reconfigure.

Both take the JAX wrapper's ``backend=`` keyword (``compat/petsc_funcs.py:33``,
``:46``), by default ``TPU_SOLVE_BACKEND`` (``tpu``): ``tpu``, ``torch`` and
``petsc`` all resolve to the ``petsc4py``/``slepc4py`` first on the path,
which under the runner is this facade (as in the JAX package, whose
``petsc`` choice imports the same names); another value raises
``ValueError``.
"""

import os

from mpi_petsc4py_example_tpu_torch.utils.phases import stamp
from petsc4py import PETSc
from slepc4py import SLEPc

_BACKENDS = ("tpu", "torch", "petsc")


def _modules(backend=None):
    backend = (backend or os.environ.get("TPU_SOLVE_BACKEND", "tpu")).lower()
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {_BACKENDS}")
    return PETSc, SLEPc


def createPETScMat(comm, shape, csr, backend=None):
    """(comm, global shape, local rebased CSR) -> assembled ``PETSc.Mat``."""
    petsc, _ = _modules(backend)
    A = petsc.Mat().createAIJ(comm=comm, size=shape, csr=csr)
    A.assemble()
    stamp("mat_assembled")
    return A


def solveSLEPcEigenvalues(comm, A, backend=None):
    """``A`` (a ``PETSc.Mat``) -> the solved ``SLEPc.EPS``: HEP, then the
    options database, then one collective solve."""
    _, slepc = _modules(backend)
    E = slepc.EPS().create(comm=comm)
    E.setOperators(A)
    E.setProblemType(slepc.EPS.ProblemType.HEP)
    E.setFromOptions()
    E.solve()
    stamp("eps_solved")
    return E
