"""slepc4py-shaped facade over the PyTorch port: ``EPS``, ``ST`` and ``SVD``.

The port's counterpart of ``compat/slepc4py/SLEPc.py``
(the surface of ``petsc_funcs.py:13-20`` and ``test2.py:88-96``). ``solve``
is collective. Under thread ranks (the runner's ``-n N``) the rank-0 thread
runs the eigensolve on the port's virtual mesh and every rank shares its
solver context; under rank processes (``-n N --procs``) every rank runs it
on its shards of the ``ProcessComm`` (SPMD) and holds the same pairs. The
queries, ``getEigenpair`` included, read host-replicated results and make no
collective call, so a driver may call them on one rank only, as the
reference ``test2.py`` does under ``if rank == 0``; ``computeError`` is
collective under rank processes (the operator's product and one
reduction), so every rank calls it. ``SVD.solve`` is collective in the same
way, and its queries read host-replicated triplets.
"""

from __future__ import annotations

from mpi_petsc4py_example_tpu_torch.solvers.eps import EPS as _CoreEPS
from mpi_petsc4py_example_tpu_torch.solvers.eps import (EPSProblemType,
                                                        EPSWhich)
from mpi_petsc4py_example_tpu_torch.solvers.st import ST as _CoreST
from mpi_petsc4py_example_tpu_torch.solvers.svd import SVD as _CoreSVD

from mpi4py import MPI as _MPI
from petsc4py.PETSc import Mat as _Mat
from petsc4py.PETSc import Vec as _Vec
from petsc4py.PETSc import _mpi_comm


class ST:
    """Spectral-transformation handle (fronts the port's ``ST``)."""

    Type = _CoreST.Type

    def __init__(self, core: _CoreST | None = None):
        self._core = core if core is not None else _CoreST()

    def setType(self, st_type):
        self._core.set_type(st_type)

    def getType(self):
        return self._core.get_type()

    def setShift(self, sigma):
        self._core.set_shift(sigma)

    def getShift(self):
        return self._core.get_shift()

    def setCayleyAntishift(self, nu):
        self._core.set_antishift(nu)

    def getCayleyAntishift(self):
        return self._core.get_antishift()

    def setFromOptions(self):
        self._core.set_from_options()

    @property
    def core(self):
        return self._core


class EPS:
    """Eigensolver handle (fronts the port's ``EPS``)."""

    class ProblemType:
        HEP = EPSProblemType.HEP
        NHEP = EPSProblemType.NHEP
        GHEP = EPSProblemType.GHEP

    class Which:
        LARGEST_MAGNITUDE = EPSWhich.LARGEST_MAGNITUDE
        SMALLEST_MAGNITUDE = EPSWhich.SMALLEST_MAGNITUDE
        LARGEST_REAL = EPSWhich.LARGEST_REAL
        SMALLEST_REAL = EPSWhich.SMALLEST_REAL
        TARGET_MAGNITUDE = EPSWhich.TARGET_MAGNITUDE
        TARGET_REAL = EPSWhich.TARGET_REAL

    class ErrorType:
        ABSOLUTE = "absolute"
        RELATIVE = "relative"

    Type = _CoreEPS.Type

    def __init__(self):
        self._core = _CoreEPS()
        self._comm = None

    def create(self, comm=None):
        self._comm = _mpi_comm(comm)
        self._core.create(self._comm.device_comm)
        return self

    def setOperators(self, A: _Mat, B: _Mat | None = None):
        self._core.set_operators(A.core, B.core if B is not None else None)

    def setProblemType(self, ptype):
        self._core.set_problem_type(ptype)

    def setDimensions(self, nev=None, ncv=None, mpd=None):
        self._core.set_dimensions(nev=nev, ncv=ncv)

    def getDimensions(self):
        """``(nev, ncv, mpd)``, slepc4py's 3-tuple (mpd follows ncv)."""
        nev, ncv = self._core.get_dimensions()
        return (nev, ncv, ncv)

    def setTolerances(self, tol=None, max_it=None):
        self._core.set_tolerances(tol=tol, max_it=max_it)

    def getTolerances(self):
        return self._core.get_tolerances()

    def setWhichEigenpairs(self, which):
        self._core.set_which_eigenpairs(which)

    def setTarget(self, target):
        self._core.set_target(target)

    def setType(self, eps_type):
        self._core.set_type(eps_type)

    def getType(self):
        return self._core.get_type()

    def getST(self):
        return ST(self._core.get_st())

    def setMonitor(self, fn):
        self._core.set_monitor(fn)

    def cancelMonitor(self):
        self._core.cancel_monitor()

    def setFromOptions(self):
        self._core.set_from_options()

    def solve(self):
        """Collective: under thread ranks the rank-0 thread runs the
        eigensolve and all ranks share its solver context (pairs, restarts,
        reason); under rank processes every rank runs it on its shards and
        holds the same context."""
        comm = self._comm or _MPI.COMM_WORLD

        def build(_):
            self._core.solve()
            return self._core

        self._core = comm._collective("eps_solve", None, build)

    def getConverged(self):
        return self._core.get_converged()

    def getIterationNumber(self):
        return self._core.get_iteration_number()

    def getEigenvalue(self, i):
        return self._core.get_eigenvalue(i)

    def getEigenpair(self, i, vr=None, vi=None):
        """Not collective: fills ``vr``/``vi`` from host-replicated arrays,
        so the reference's rank-0-only call (``test2.py:94-96``) cannot
        block the other ranks."""
        return self._core.get_eigenpair(
            i, vr.core if isinstance(vr, _Vec) else vr,
            vi.core if isinstance(vi, _Vec) else vi)

    def getErrorEstimate(self, i):
        return self._core.get_error_estimate(i)

    def computeError(self, i, etype="relative"):
        """Collective under rank processes: every rank calls it (one
        product of the operator and one reduction)."""
        return self._core.compute_error(i, etype)

    def destroy(self):
        return self

    @property
    def core(self):
        return self._core


class SVD:
    """Singular value solver handle (fronts the port's ``SVD``)."""

    Which = _CoreSVD.Which

    def __init__(self):
        self._core = _CoreSVD()
        self._comm = None

    def create(self, comm=None):
        self._comm = _mpi_comm(comm)
        self._core.create(self._comm.device_comm)
        return self

    def setOperator(self, A: _Mat):
        self._core.set_operator(A.core)

    def setDimensions(self, nsv=None, ncv=None, mpd=None):
        self._core.set_dimensions(nsv=nsv, ncv=ncv)

    def setTolerances(self, tol=None, max_it=None):
        self._core.set_tolerances(tol=tol, max_it=max_it)

    def setWhichSingularTriplets(self, which):
        self._core.set_which_singular_triplets(which)

    def setFromOptions(self):
        self._core.set_from_options()

    def solve(self):
        """Collective, as ``EPS.solve``."""
        comm = self._comm or _MPI.COMM_WORLD

        def build(_):
            self._core.solve()
            return self._core

        self._core = comm._collective("svd_solve", None, build)

    def getConverged(self):
        return self._core.get_converged()

    def getValue(self, i):
        return self._core.get_value(i)

    def getSingularTriplet(self, i, U=None, V=None):
        return self._core.get_singular_triplet(
            i, U.core if isinstance(U, _Vec) else U,
            V.core if isinstance(V, _Vec) else V)

    def getIterationNumber(self):
        return self._core.get_iteration_number()

    def destroy(self):
        return self

    @property
    def core(self):
        return self._core
