"""petsc4py-shaped facade over the PyTorch port.

The port's counterpart of ``compat/petsc4py/PETSc.py``: ``InsertMode``;
``Vec`` (``setArray``, ``array``, ``getArray``, ``norm``, ``set``,
``duplicate``, ``copy``, ``dot``, ``scale``, ``axpy``, ``view``,
``load``); ``Mat`` (``createAIJ``, the ``setSizes``/``setValues``/assembly
flow, ``createShell``, ``getVecs``, ``getDiagonal``, ``mult``,
``multTranspose``, ``zeroRows``, ``setNullSpace``/``getNullSpace``,
``view``, ``load``, ``getSize``, ``getOwnershipRange``); ``Viewer`` (the
PETSc binary file viewer); ``NullSpace``; ``KSP`` (with monitors, the
convergence history and a nonzero initial guess); ``PC`` (with
``shell`` and ``composite``) and ``Options``. A shell's ``mult`` and a PC
shell's apply are torch callables on the whole vector.

Collective semantics under virtual ranks (the runner's ``-n N``):
constructors and ``solve`` are rendezvous points. Every rank contributes its
local block or arrives at the call, the rank-0 thread performs the one
operation on the port's virtual mesh, and all ranks share the result, as the
MPIAIJ path behaves over real MPI.
"""

from __future__ import annotations

import sys

import numpy as np

import mpi_petsc4py_example_tpu_torch as _pt
from mpi_petsc4py_example_tpu_torch.core.mat import Mat as _CoreMat
from mpi_petsc4py_example_tpu_torch.core.mat import coo_to_csr
from mpi_petsc4py_example_tpu_torch.parallel.partition import RowLayout

from mpi4py import MPI as _MPI

DECIDE = -1
DEFAULT = -2


class InsertMode:
    """petsc4py's InsertMode values the facade honors: INSERT_VALUES (the
    last write to a slot wins) and ADD_VALUES (duplicates sum)."""
    NOT_SET_VALUES = 0
    INSERT_VALUES = 1
    ADD_VALUES = 2
    INSERT = INSERT_VALUES
    ADD = ADD_VALUES


def _insert_mode(addv) -> str:
    """petsc4py's ``addv`` (None, a bool or an InsertMode) as 'insert' or
    'add'. Booleans are tested first: ``True == INSERT_VALUES`` as ints, and
    petsc4py's ``addv=True`` means ADD."""
    if isinstance(addv, (bool, np.bool_)):
        return "add" if bool(addv) else "insert"
    if addv in (None, InsertMode.INSERT_VALUES, "insert"):
        return "insert"
    if addv in (InsertMode.ADD_VALUES, "add"):
        return "add"
    raise ValueError(f"unsupported InsertMode {addv!r}")


def _mpi_comm(comm):
    """The facade's comm argument (None, an MPI.Comm or a DeviceComm) as an
    MPI.Comm."""
    if comm is None or isinstance(comm, _pt.DeviceComm):
        return _MPI.COMM_WORLD
    return comm


class _UnevenLayout:
    """Row layout with explicit (possibly driver-chosen) per-rank counts."""

    def __init__(self, counts):
        self.counts = np.asarray(counts, dtype=np.int64)
        self.displ = np.concatenate(([0], np.cumsum(self.counts)[:-1]))
        self.nrows = int(self.counts.sum())
        self.nparts = len(self.counts)

    def range(self, rank):
        return int(self.displ[rank]), int(self.displ[rank] + self.counts[rank])


class Vec:
    """Distributed vector view: a shared core Vec and this rank's block."""

    def __init__(self, core_vec, layout, rank: int, comm):
        self._core = core_vec
        self._layout = layout
        self._rank = rank
        self._comm = comm

    def setArray(self, local):
        """Set this rank's local block (collective under virtual ranks)."""
        local = np.asarray(local)
        rank = self._rank if self._comm.Get_size() > 1 else 0

        def build(blocks):
            if (self._comm.Get_size() == 1
                    and local.shape[0] == self._core.n):
                self._core.set_global(local)
                return True
            host = self._core.to_numpy()
            for r, blk in blocks:
                rs, re = self._layout.range(r)
                host[rs:re] = blk
            self._core.set_global(host)
            return True

        self._comm._collective("vec_setarray", (rank, local), build)

    def getArray(self):
        rs, re = self._layout.range(self._rank)
        return self._core.to_numpy()[rs:re]

    @property
    def array(self):
        return self.getArray()

    def getSize(self):
        return self._core.n

    def getLocalSize(self):
        rs, re = self._layout.range(self._rank)
        return re - rs

    def norm(self):
        return self._core.norm()

    def set(self, alpha: float):
        def build(_):
            self._core.set_global(np.full(self._core.n, alpha))
            return True
        self._comm._collective("vec_set", None, build)

    def duplicate(self):
        def build(_):
            return self._core.duplicate()
        core = self._comm._collective("vec_duplicate", None, build)
        return Vec(core, self._layout, self._rank, self._comm)

    def copy(self, other=None):
        """A new Vec holding these values, or, given ``other``, these values
        copied into it."""
        if other is None:
            core = self._comm._collective("vec_copy_new", None,
                                          lambda _: self._core.copy())
            return Vec(core, self._layout, self._rank, self._comm)
        if other._core.n != self._core.n:
            raise ValueError(
                f"Vec.copy size mismatch: {self._core.n} vs "
                f"{other._core.n} (petsc4py errors on this too)")

        def build(_):
            other._core.data = self._core.data.clone()
            return True
        self._comm._collective("vec_copy", None, build)
        return other

    def dot(self, other):
        return self._core.dot(other._core)

    def scale(self, alpha):
        def build(_):
            self._core.scale(alpha)
            return True
        self._comm._collective("vec_scale", (float(alpha),), build)

    def axpy(self, alpha, other):
        def build(_):
            self._core.axpy(alpha, other._core)
            return True
        self._comm._collective("vec_axpy", (float(alpha),), build)

    def view(self, viewer=None):
        """Write to a binary Viewer (VecView, collective), or print a
        summary."""
        if isinstance(viewer, Viewer):
            viewer._check_mode(read=False)

            def build(_):
                _pt.petsc_io.save_vec(viewer.handle, self._core)
                viewer.handle.flush()
                return True
            self._comm._collective("vec_view_binary", None, build)
            return
        if self._comm.Get_rank() == 0:
            print(repr(self._core), file=sys.stderr)

    def load(self, viewer):
        """VecLoad: fill this Vec from a PETSc binary Vec (collective)."""
        viewer._check_mode(read=True)

        def build(_):
            arr = _pt.petsc_io.read_vec(viewer.handle)
            if arr.shape[0] != self._core.n:
                raise ValueError(
                    f"VecLoad size mismatch: file has {arr.shape[0]} "
                    f"entries, Vec has {self._core.n} (PETSc errors on "
                    "this too)")
            self._core.set_global(arr)
            return True
        self._comm._collective("vec_load_binary", None, build)
        return self

    def destroy(self):
        return self

    @property
    def core(self):
        return self._core


class Mat:
    """Distributed AIJ matrix handle."""

    def __init__(self):
        self._core: _CoreMat | None = None
        self._layout = None
        self._comm = None
        # the setValues flow: COO triplets stashed on the host until
        # assemblyEnd builds the CSR
        self._size = None
        self._stash = None
        self._stash_mode = None       # 'insert' | 'add' | None

    def create(self, comm=None):
        """``Mat().create(comm)``: start the setValues assembly flow (the
        ``csr=`` constructor bypasses the stash)."""
        self._comm = _mpi_comm(comm)
        self._stash = [[], [], []]
        self._stash_mode = None
        return self

    def setSizes(self, size, bsize=None):
        """Global shape: ``n``, ``(m, n)`` or petsc4py's ``((m_local,
        m_global), (n_local, n_global))`` (the local sizes are ignored)."""
        if np.isscalar(size):
            size = (int(size), int(size))
        m, n = size
        if not np.isscalar(m):
            m = m[1] if m[1] not in (DECIDE, DEFAULT, None) else m[0]
        if not np.isscalar(n):
            n = n[1] if n[1] not in (DECIDE, DEFAULT, None) else n[0]
        self._size = (int(m), int(n))
        return self

    def setType(self, mat_type):
        t = str(mat_type).lower()
        if t not in ("aij", "mpiaij", "seqaij"):
            raise ValueError(f"facade Mat supports AIJ types, got {mat_type!r}")
        return self

    def setFromOptions(self):
        return self

    def setPreallocationNNZ(self, nnz):
        """Accepted for driver compatibility; the stash needs none."""
        return self

    def setValues(self, rows, cols, values, addv=None):
        """MatSetValues: ``values[i, j] -> A[rows[i], cols[j]]``, inserted
        (the last write wins) or added. Mixing the two without an assembly
        in between raises, as PETSc does."""
        if self._stash is None:
            raise RuntimeError(
                "Mat.setValues needs the create()/setSizes() flow (the "
                "createAIJ csr= constructor assembles directly)")
        if self._core is not None:
            raise RuntimeError(
                "Mat.setValues after assemblyEnd is not supported by the "
                "facade — build a new Mat")
        mode = _insert_mode(addv)
        if self._stash_mode is not None and mode != self._stash_mode:
            raise RuntimeError(
                "cannot mix ADD_VALUES and INSERT_VALUES without an "
                "intervening assemble() (PETSc MatSetValues semantics)")
        self._stash_mode = mode
        rows = np.atleast_1d(np.asarray(rows, dtype=np.int64))
        cols = np.atleast_1d(np.asarray(cols, dtype=np.int64))
        values = np.asarray(values, dtype=np.float64).reshape(
            len(rows), len(cols))
        self._stash[0].append(np.repeat(rows, len(cols)))
        self._stash[1].append(np.tile(cols, len(rows)))
        self._stash[2].append(values.ravel())
        return self

    def setValue(self, row, col, value, addv=None):
        return self.setValues([row], [col], [value], addv=addv)

    def createAIJ(self, size=None, bsize=None, nnz=None, csr=None,
                  comm=None):
        """The reference contract: global ``size``, this rank's local
        rebased CSR ``csr``, the communicator (collective)."""
        comm = _mpi_comm(comm)
        self._comm = comm
        if csr is None:
            raise ValueError("createAIJ requires csr=(indptr, indices, data)")
        rank = comm.Get_rank()

        def build(blocks):
            blocks = [b for _, b in sorted(blocks, key=lambda t: t[0])]
            counts = [len(b[0]) - 1 for b in blocks]
            core = _CoreMat.from_local_blocks(comm.device_comm, size, blocks)
            return core, _UnevenLayout(counts)

        self._core, self._layout = comm._collective(
            "mat_createaij", (rank, tuple(np.asarray(a) for a in csr)), build)
        return self

    def createShell(self, size, mult, mult_transpose=None, diagonal=None,
                    comm=None):
        """MatCreateShell: a matrix-free operator from a torch ``mult`` on
        the whole vector (collective)."""
        comm = _mpi_comm(comm)
        self._comm = comm
        if np.isscalar(size):
            size = (int(size), int(size))

        def build(_):
            core = _pt.ShellMat(comm.device_comm, size, mult,
                                mult_transpose=mult_transpose,
                                diagonal=diagonal)
            return core, _UnevenLayout(
                RowLayout(size[0], comm.Get_size()).count)

        self._core, self._layout = comm._collective("mat_createshell", None,
                                                    build)
        return self

    # ---- assembly ---------------------------------------------------------
    def setUp(self):
        return self

    def assemblyBegin(self):
        return self

    def assemblyEnd(self):
        """The setValues flow builds the global CSR from every rank's stash
        here (collective); after ``createAIJ`` it is a no-op."""
        if self._stash is None or self._core is not None:
            return self
        if self._size is None:
            raise RuntimeError("Mat.assemblyEnd: setSizes was never called")
        rank = self._comm.Get_rank()
        size = self._size
        empty = lambda dt: np.zeros(0, dt)
        payload = (np.concatenate(self._stash[0]) if self._stash[0]
                   else empty(np.int64),
                   np.concatenate(self._stash[1]) if self._stash[1]
                   else empty(np.int64),
                   np.concatenate(self._stash[2]) if self._stash[2]
                   else empty(np.float64),
                   self._stash_mode or "insert")

        def build(blocks):
            blocks = [b for _, b in sorted(blocks, key=lambda t: t[0])]
            modes = {b[3] for b in blocks if len(b[0])}
            if len(modes) > 1:
                raise RuntimeError(
                    "ranks disagree on InsertMode (ADD vs INSERT) — PETSc "
                    "MatAssembly rejects this too")
            csr = coo_to_csr(size, np.concatenate([b[0] for b in blocks]),
                             np.concatenate([b[1] for b in blocks]),
                             np.concatenate([b[2] for b in blocks]),
                             mode=next(iter(modes), "insert"))
            core = _CoreMat.from_csr(self._comm.device_comm, size, csr)
            return core, _UnevenLayout(
                RowLayout(size[0], self._comm.Get_size()).count)

        self._core, self._layout = self._comm._collective(
            "mat_assembly_setvalues", (rank, payload), build)
        self._stash = [[], [], []]
        self._stash_mode = None
        return self

    def assemble(self):
        return self.assemblyBegin().assemblyEnd()

    def isAssembled(self):
        return self._core is not None and self._core.assembled

    # ---- queries ----------------------------------------------------------
    def getSize(self):
        return self._core.shape

    def getLocalSize(self):
        rs, re = self._layout.range(self._comm.Get_rank())
        return (re - rs, self._core.shape[1])

    def getOwnershipRange(self):
        return self._layout.range(self._comm.Get_rank())

    def getVecs(self):
        """Compatibly laid out ``(x, b)`` views (``a.getVecs()``)."""
        rank = self._comm.Get_rank()
        x_core, b_core = self._comm._collective(
            "mat_getvecs", None, lambda _: self._core.get_vecs())
        return (Vec(x_core, self._layout, rank, self._comm),
                Vec(b_core, self._layout, rank, self._comm))

    createVecs = getVecs

    def getDiagonal(self):
        rank = self._comm.Get_rank()

        def build(_):
            core = self._core
            return _pt.Vec.from_global(core.comm, core.diagonal(),
                                       dtype=core.dtype, layout=core.layout)

        core = self._comm._collective("mat_getdiag", None, build)
        return Vec(core, self._layout, rank, self._comm)

    def mult(self, x: Vec, y: Vec):
        def build(_):
            self._core.mult(x.core, y.core)
            return True
        self._comm._collective("mat_mult", None, build)

    def multTranspose(self, x: Vec, y: Vec):
        def build(_):
            self._core.mult_transpose(x.core, y.core)
            return True
        self._comm._collective("mat_mult_t", None, build)

    def norm(self, norm_type="frobenius"):
        return self._core.norm(norm_type)

    def zeroRows(self, rows, diag=1.0, x=None, b=None):
        """MatZeroRows (collective): one thread changes the shared Mat."""
        rows = tuple(int(r) for r in np.atleast_1d(rows))

        def build(_):
            self._core.zero_rows(list(rows), diag=diag,
                                 x=x.core if isinstance(x, Vec) else x,
                                 b=b.core if isinstance(b, Vec) else b)
            return True

        self._comm._collective("mat_zerorows", (rows, float(diag)), build)
        return self

    def setNullSpace(self, ns):
        """MatSetNullSpace (collective): KSP then solves the compatible
        singular system by projection."""
        core_ns = ns.core if isinstance(ns, NullSpace) else ns

        def build(_):
            self._core.set_nullspace(core_ns)
            return True

        self._comm._collective("mat_setnullspace", None, build)

    def getNullSpace(self):
        return self._core.get_nullspace()

    def view(self, viewer=None):
        """Write to a binary Viewer (MatView, collective), or print a
        summary."""
        if isinstance(viewer, Viewer):
            viewer._check_mode(read=False)

            def build(_):
                _pt.petsc_io.save_mat(viewer.handle, self._core)
                viewer.handle.flush()
                return True
            self._comm._collective("mat_view_binary", None, build)
            return
        if self._comm.Get_rank() == 0:
            print(repr(self._core), file=sys.stderr)

    def load(self, viewer):
        """MatLoad: read a PETSc binary Mat (collective)."""
        viewer._check_mode(read=True)
        comm = self._comm or _MPI.COMM_WORLD
        self._comm = comm

        def build(_):
            core = _pt.petsc_io.load_mat(viewer.handle, comm.device_comm)
            return core, _UnevenLayout(
                RowLayout(core.shape[0], comm.Get_size()).count)

        self._core, self._layout = comm._collective("mat_load", None, build)
        return self

    def destroy(self):
        return self

    @property
    def core(self):
        return self._core


class Viewer:
    """The PETSc binary file viewer (PetscViewerBinaryOpen): the file stays
    open across objects, so several ``view`` calls write one file in turn
    and several ``load`` calls read it back in order (``utils/petsc_io.py``
    documents the byte layout)."""

    def __init__(self):
        self.path = None
        self.mode = "r"
        self._file = None

    def createBinary(self, name, mode="r", comm=None):
        if self._file is not None:      # reuse: close the old file first
            self._file.close()
            self._file = None
        self.path = str(name)
        self.mode = str(mode).lower()
        if self.mode not in ("r", "w", "a"):
            raise ValueError(f"unknown viewer mode {mode!r}")
        return self

    @property
    def handle(self):
        """The open file, its cursor kept between objects."""
        if self._file is None:
            if self.path is None:
                raise RuntimeError(
                    "Viewer has no file — call createBinary(path, mode) "
                    "first")
            self._file = open(self.path,
                              {"r": "rb", "w": "wb", "a": "ab"}[self.mode])
        return self._file

    def _check_mode(self, read: bool):
        if self.path is None:
            raise RuntimeError(
                "Viewer has no file — call createBinary(path, mode) first")
        if read and self.mode != "r":
            raise ValueError(
                f"viewer opened with mode {self.mode!r} cannot be read "
                "(PETSc raises on this too)")
        if not read and self.mode == "r":
            raise ValueError(
                "viewer opened read-only cannot be written "
                "(PETSc raises on this too)")

    def destroy(self):
        if self._file is not None:
            self._file.close()
            self._file = None
        return self

    def flush(self):
        """Flush the buffered writes; the file and its cursor stay."""
        if self._file is not None and self.mode != "r":
            self._file.flush()
        return self


class NullSpace:
    """Null-space handle (fronts the port's ``NullSpace``)."""

    def __init__(self):
        self._core = None

    def create(self, constant=False, vectors=(), comm=None):
        vecs = [v.core.to_numpy() if isinstance(v, Vec) else np.asarray(v)
                for v in vectors]
        self._core = _pt.NullSpace(constant=constant, vectors=vecs)
        return self

    def test(self, mat):
        return self._core.test(mat.core if isinstance(mat, Mat) else mat)

    def destroy(self):
        return self

    @property
    def core(self):
        return self._core


class PC:
    """Preconditioner handle (fronts the port's ``PC``)."""

    def __init__(self, core_pc):
        self._core = core_pc

    def setType(self, t):
        self._core.set_type(t)

    def getType(self):
        return self._core.get_type()

    def setFactorSolverType(self, t):
        """Accepts the reference's 'mumps': the port's lu modes serve it."""
        self._core.set_factor_solver_type(t)

    def getFactorSolverType(self):
        return self._core._factor_solver_type

    def setShellApply(self, fn):
        self._core.set_shell_apply(fn)

    def setCompositeType(self, ctype):
        self._core.set_composite_type(ctype)

    def setCompositePCs(self, *types):
        self._core.set_composite_pcs(*types)

    def getCompositePC(self, i):
        return PC(self._core.get_composite_pc(i))

    def setFromOptions(self):
        pass


class KSP:
    """Krylov solver handle (fronts the port's ``KSP``)."""

    class NormType:
        DEFAULT = -1
        NONE = 0
        PRECONDITIONED = 1
        UNPRECONDITIONED = 2
        NATURAL = 3

    def __init__(self):
        self._core = _pt.KSP()
        self._comm = None

    def create(self, comm=None):
        comm = _mpi_comm(comm)
        self._comm = comm
        self._core.create(comm.device_comm)
        return self

    def setType(self, t):
        self._core.set_type(t)

    def getType(self):
        return self._core.get_type()

    def getPC(self):
        return PC(self._core.get_pc())

    def setOperators(self, A: Mat, P=None):
        self._core.set_operators(A.core, P.core if P else None)

    def setTolerances(self, rtol=None, atol=None, divtol=None, max_it=None):
        self._core.set_tolerances(rtol=rtol, atol=atol, divtol=divtol,
                                  max_it=max_it)

    def setInitialGuessNonzero(self, flag):
        self._core.set_initial_guess_nonzero(flag)

    def setNormType(self, norm_type):
        self._core.set_norm_type(norm_type)

    def getNormType(self):
        return self._core.get_norm_type()

    def setFromOptions(self):
        self._core.set_from_options()

    def setUp(self):
        """Collective: the rank-0 thread sets the PC up (factors)."""
        comm = self._comm or _MPI.COMM_WORLD

        def build(_):
            self._core.set_up()
            return self._core

        self._core = comm._collective("ksp_setup", None, build)

    def solve(self, b: Vec, x: Vec):
        """Collective: the rank-0 thread runs the solve; its solver context
        (iterations, residual, reason) is shared by all ranks."""
        comm = self._comm or _MPI.COMM_WORLD

        def build(_):
            self._core.solve(b.core, x.core)
            return self._core

        self._core = comm._collective("ksp_solve", None, build)

    def getIterationNumber(self):
        return self._core.get_iteration_number()

    def getResidualNorm(self):
        return self._core.get_residual_norm()

    def getConvergedReason(self):
        return self._core.get_converged_reason()

    def getTolerances(self):
        return self._core.get_tolerances()

    def setMonitor(self, cb):
        self._core.set_monitor(cb)

    def setConvergenceHistory(self, length=None, reset=False):
        self._core.set_convergence_history(length=length, reset=reset)

    def getConvergenceHistory(self):
        return self._core.get_convergence_history()

    def destroy(self):
        return self

    @property
    def core(self):
        return self._core


class Options:
    """PETSc.Options-shaped access to the port's options database."""

    def __init__(self, prefix: str = ""):
        self._prefix = prefix or ""

    def _k(self, key):
        return self._prefix + key.lstrip("-")

    def setValue(self, key, value):
        _pt.global_options().set(self._k(key), value)

    def getString(self, key, default=None):
        return _pt.global_options().get_string(self._k(key), default)

    def getInt(self, key, default=None):
        return _pt.global_options().get_int(self._k(key), default)

    def getReal(self, key, default=None):
        return _pt.global_options().get_real(self._k(key), default)

    def getBool(self, key, default=False):
        return _pt.global_options().get_bool(self._k(key), default)

    def hasName(self, key):
        return _pt.global_options().has(self._k(key))

    def delValue(self, key):
        _pt.global_options().clear(self._k(key))


COMM_WORLD = _MPI.COMM_WORLD
COMM_SELF = _MPI.COMM_SELF
