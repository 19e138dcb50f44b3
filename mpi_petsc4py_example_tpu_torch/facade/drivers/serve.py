"""A solve server as an SPMD script: every rank builds the communicator's
server and operator, registers it and shuts down; rank 0 submits and
prints. Under the runner's thread mode the ranks are threads over one
``DeviceComm``; under ``--procs`` the server leads from rank 0 and the
other ranks run its command stream (``parallel/control.py``). Both print
the same::

    python -m mpi_petsc4py_example_tpu_torch.run -n 2 [--procs] \\
        [--device cpu] mpi_petsc4py_example_tpu_torch/facade/drivers/serve.py \\
        [NX] [REQUESTS]

(on the card with more ranks than cards: ``--procs --backend gloo``).
"""

import sys

from mpi4py import MPI

import mpi_petsc4py_example_tpu_torch as pt
from mpi_petsc4py_example_tpu_torch.facade.drivers.serving_procs import (
    rhs, stencil_relres)

nx = int(sys.argv[1]) if len(sys.argv) > 1 else 16
requests = int(sys.argv[2]) if len(sys.argv) > 2 else 6
world = MPI.COMM_WORLD
comm = world.device_comm
spec = {"grid": [nx] * 3}
op = pt.StencilPoisson3D(comm, nx)
srv = pt.SolveServer(comm, max_k=8, autostart=False)
srv.register_operator("poisson", op, pc_type="jacobi", rtol=1e-8)
if world.Get_rank() == 0:
    futs = [srv.submit("poisson", rhs(spec, j)) for j in range(requests)]
    srv.start()
    for j, f in enumerate(futs):
        r = f.result(120)
        rel = stencil_relres(spec["grid"], rhs(spec, j)[None], r.x[None])[0]
        print(f"request {j}: {pt.ConvergedReason.name(r.reason)} in "
              f"{r.iterations} iterations, block of {r.batch_width}, "
              f"relres {rel:.2e}")
srv.shutdown()
