"""PyTorch + CUDA port of the JAX sparse-solver package, for NVIDIA Hopper.

Mirrors the layout of ``mpi_petsc4py_example_tpu`` (the reference, which this
package never imports): ``parallel`` (communicator, layout, CSR row blocks),
``core`` (Vec, the assembled Mat), ``models`` (the matrix-free 3D Poisson
stencil, the CSR model problems), ``ops`` (hand-written CUDA kernels in
``csrc/``, their plain PyTorch versions, the nvcc build; the ELL/DIA SpMV),
``solvers`` (KSP, PC, the Krylov loops, the eigensolver EPS and its spectral
transformations ST), ``utils``, and ``facade`` (the petsc4py/mpi4py/slepc4py
facade that ``python -m mpi_petsc4py_example_tpu_torch.run`` puts first on
``sys.path``).

Entry points run on the card: ``DeviceComm()`` means CUDA and raises without
it; pass ``device="cpu"`` to run on the CPU, where every kernel is replaced by
its plain PyTorch version.
"""

from .core.mat import Mat
from .core.vec import Vec
from .models.poisson import poisson3d_csr
from .models.stencil import StencilPoisson3D
from .parallel.mesh import DeviceComm
from .solvers.eps import EPS
from .solvers.ksp import KSP
from .solvers.pc import PC
from .solvers.st import ST
from .utils.convergence import (BatchedSolveResult, ConvergedReason,
                                SolveResult)
from .utils.options import global_options, init

__all__ = ["DeviceComm", "Vec", "Mat", "KSP", "PC", "EPS", "ST",
           "StencilPoisson3D",
           "poisson3d_csr", "ConvergedReason", "SolveResult",
           "BatchedSolveResult",
           "global_options", "init"]
