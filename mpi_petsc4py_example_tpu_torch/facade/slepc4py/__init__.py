"""slepc4py facade package of the port: ``slepc4py.init(argv)`` and
``slepc4py.SLEPc``.

``slepc4py.init(sys.argv)`` seeds the port's options database
(``mpi_petsc4py_example_tpu_torch.utils.options``), as ``petsc4py.init``
does.
"""

import mpi_petsc4py_example_tpu_torch as _pt


def init(argv=None, arch=None):
    _pt.init(argv)


from . import SLEPc  # noqa: E402  (slepc4py's submodule layout)
