"""The port's petsc4py/mpi4py facade.

``mpi4py/`` and ``petsc4py/`` here are imported as the top-level packages
``mpi4py`` and ``petsc4py`` when this directory leads ``sys.path``, as the
runner (``python -m mpi_petsc4py_example_tpu_torch.run``) puts it, so a
driver written for petsc4py and mpi4py runs on the port unchanged.
``petsc_funcs.py`` is the reference wrapper's ``createPETScMat``;
``drivers/`` holds the reference flows written against the facade.
"""
