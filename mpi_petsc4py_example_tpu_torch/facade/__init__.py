"""The port's petsc4py/mpi4py/slepc4py facade.

``mpi4py/``, ``petsc4py/`` and ``slepc4py/`` here are imported as the
top-level packages ``mpi4py``, ``petsc4py`` and ``slepc4py`` when this
directory leads ``sys.path``, as the runner (``python -m
mpi_petsc4py_example_tpu_torch.run``) puts it, so a driver written for
petsc4py, slepc4py and mpi4py runs on the port unchanged.
``petsc_funcs.py`` is the reference wrapper (``createPETScMat``,
``solveSLEPcEigenvalues``); ``drivers/`` holds the reference flows written
against the facade.
"""
