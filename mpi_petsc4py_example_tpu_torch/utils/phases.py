"""Environment-gated phase stamps for the wall accounting of a fresh process.

The port's copy of ``mpi_petsc4py_example_tpu/utils/phases.py``. With
``TPU_SOLVE_PHASE_LOG=<path>`` set, :func:`stamp` appends ``(name,
time.time())`` pairs and rewrites the JSON file each time (crash-safe, an
atomic replace), so a parent process can diff the absolute times against its
own spawn time and itemize interpreter start, CUDA initialisation, assembly,
solve and teardown. Without the variable every call is one dictionary
lookup.

Stamp sites: ``run.py`` (``tpurun_main``, ``driver_exec``),
``parallel/mesh.py`` (``cuda_init_begin``/``cuda_init_end`` around the
first CUDA initialisation of a ``DeviceComm``, where the JAX package stamps
its first ``jax.devices()``), ``facade/petsc_funcs.py`` (``mat_assembled``,
``eps_solved``).
"""

from __future__ import annotations

import json
import os
import threading
import time

from .options import env_value

_STAMPS: list = []
_LOCK = threading.Lock()   # the runner's thread ranks share one process;
#                            serialize list append + file rewrite so
#                            concurrent stamps cannot interleave writes


def stamp(name: str) -> None:
    path = env_value("PHASE_LOG")
    if not path:
        return
    with _LOCK:
        _STAMPS.append((name, time.time()))
        try:
            # write-then-atomic-replace: a reader (the parent process) can
            # never observe a truncated/partial JSON file
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(_STAMPS, f)
            os.replace(tmp, path)
        except OSError:
            pass
