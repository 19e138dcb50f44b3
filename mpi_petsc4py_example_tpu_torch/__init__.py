"""PyTorch + CUDA port of the JAX sparse-solver package, for NVIDIA Hopper.

Mirrors the layout of ``mpi_petsc4py_example_tpu`` (the reference, which this
package never imports): ``parallel`` (communicator, layout, CSR row blocks),
``core`` (Vec, the assembled Mat, the matrix-free ShellMat, NullSpace),
``models`` (the matrix-free 3D Poisson
stencil, the CSR model problems), ``ops`` (hand-written CUDA kernels in
``csrc/``, their plain PyTorch versions, the nvcc build; the ELL/DIA SpMV),
``solvers`` (KSP, PC, the Krylov loops and their precision plans, the
mixed-precision refinement ``RefinedKSP``, the eigensolver EPS, its
spectral transformations ST and the singular value solver SVD), ``utils`` (the options database, the PETSc
binary format ``petsc_io``), and ``facade`` (the petsc4py/mpi4py/slepc4py
facade that ``python -m mpi_petsc4py_example_tpu_torch.run`` puts first on
``sys.path``).

Entry points run on the card: ``DeviceComm()`` means CUDA and raises without
it; pass ``device="cpu"`` to run on the CPU, where every kernel is replaced by
its plain PyTorch version. ``init_multihost()`` joins a ``torch.distributed``
group and returns a ``ProcessComm``, the same mesh with one process per
rank (``python -m mpi_petsc4py_example_tpu_torch.run -n N --procs``).

``serving`` holds the solve server (``SolveServer``: request coalescing, QoS,
admission control, resilient dispatch, the persistent request queue) and the
fleet in front of it (``SolveRouter``: sessions sharded over replicas,
migration, autoscale, heal; ``FleetManager``: replicas behind the RPC
transport, the lease failure detector, failover and reconcile).
``resilience`` holds fault injection, the silent-corruption guard's ABFT
checksums, ``resilient_solve``, ``KSPFallbackChain`` and the elastic
shrink; ``utils.checkpoint`` the mesh-portable checkpoints; ``telemetry``
the spans, metrics registry, flight recorder and trace export
(``-telemetry``, ``-log_view``).
"""

from .core.mat import Mat
from .core.nullspace import NullSpace
from .core.shell import ShellMat
from .core.vec import Vec
from .models.poisson import poisson2d_ell, poisson3d_csr, poisson3d_ell
from .models.stencil import StencilPoisson3D
from .parallel.mesh import (DeviceComm, ProcessComm, as_comm,
                            get_default_comm, init_multihost,
                            set_default_comm)
from .parallel.partition import (RowLayout, concat_csr_blocks,
                                 ownership_range, partition_csr,
                                 row_partition, slice_csr_block)
from . import resilience, telemetry
from .resilience.faults import HealthMonitor, inject_faults
from .solvers.cg_plans import PrecisionPlan, precision_plan
from .solvers.eps import EPS
from .solvers.ksp import KSP
from .solvers.pc import PC
from .solvers.refine import RefinedKSP
from .solvers.st import ST
from .solvers.svd import SVD
from .utils.convergence import (BatchedSolveResult, ConvergedReason,
                                RecoveryEvent, SolveResult)
from .utils.errors import (DeadlineExceededError, DeviceExecutionError,
                           ServerOverloadedError, SilentCorruptionError)
from .utils import checkpoint, petsc_io
from .utils.options import Options, backend, global_options, init

__all__ = ["DeviceComm", "ProcessComm", "init_multihost",
           "get_default_comm", "set_default_comm", "as_comm",
           "RowLayout", "row_partition", "ownership_range",
           "slice_csr_block", "partition_csr", "concat_csr_blocks",
           "Vec", "Mat", "ShellMat", "NullSpace", "KSP", "PC",
           "EPS", "ST", "SVD", "petsc_io", "checkpoint",
           "RefinedKSP", "PrecisionPlan", "precision_plan",
           "StencilPoisson3D",
           "poisson3d_csr", "poisson3d_ell", "poisson2d_ell",
           "ConvergedReason", "RecoveryEvent", "SolveResult",
           "BatchedSolveResult",
           "DeviceExecutionError", "SilentCorruptionError",
           "DeadlineExceededError", "ServerOverloadedError",
           "Options", "global_options", "init", "backend",
           "resilience", "telemetry", "inject_faults", "HealthMonitor", "RetryPolicy",
           "resilient_solve", "resilient_solve_many", "KSPFallbackChain",
           "ElasticPolicy",
           "SolveServer", "ServedSolveResult", "ServerClosedError",
           "SolveRouter", "QoSClass", "AutoscalePolicy"]


def __getattr__(name):
    # the resilience wrappers load on first use (JAX __init__.py:108-113)
    if name in ("RetryPolicy", "resilient_solve", "resilient_solve_many",
                "KSPFallbackChain", "ElasticPolicy"):
        return getattr(resilience, name)
    if name in ("SolveServer", "ServedSolveResult", "ServerClosedError",
                "SolveRouter", "QoSClass", "AutoscalePolicy"):
        # the serving layer pulls in KSP and the resilience wrappers: lazy,
        # as JAX __init__.py:116-121
        from . import serving as _serving
        return getattr(_serving, name)
    raise AttributeError(name)
