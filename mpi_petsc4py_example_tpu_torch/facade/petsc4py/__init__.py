"""petsc4py facade package of the port: ``petsc4py.init(argv)`` and
``petsc4py.PETSc``.

Drivers call ``petsc4py.init(sys.argv)`` before importing ``PETSc`` to seed
the options database; here that seeds the port's options database
(``mpi_petsc4py_example_tpu_torch.utils.options``).
"""

import mpi_petsc4py_example_tpu_torch as _pt


def init(argv=None, arch=None, comm=None):
    _pt.init(argv)


def get_config():
    return {"backend": "torch"}


from . import PETSc  # noqa: E402  (petsc4py's submodule layout)
