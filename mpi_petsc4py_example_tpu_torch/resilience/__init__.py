"""Resilient solves: fault injection, silent-error detection, retry with
checkpoint-resume, graceful solver fallback and elastic recovery.

The port's counterpart of ``mpi_petsc4py_example_tpu/resilience/``:

* :mod:`.faults`: the deterministic fault-injection harness (named fault
  points, the ``TPU_SOLVE_FAULTS`` spec or :func:`inject_faults`);
* :mod:`.abft`: the ABFT column checksums and the silent-corruption kinds;
* :mod:`.retry`: :class:`RetryPolicy`, :func:`resilient_solve`,
  :func:`resilient_solve_many`;
* :mod:`.fallback`: :class:`KSPFallbackChain`;
* :mod:`.elastic`: :class:`ElasticPolicy` and :class:`MeshRebuilder`.

``faults`` imports nothing of torch and loads eagerly (``parallel/mesh.py``
depends on it); the others load on first use (JAX ``resilience/
__init__.py:40``).
"""

from . import faults
from .faults import FaultSpecError, HealthMonitor, inject_faults

__all__ = [
    "faults", "abft", "inject_faults", "FaultSpecError", "HealthMonitor",
    "RetryPolicy", "resilient_solve", "resilient_solve_many",
    "default_checkpoint_path",
    "KSPFallbackChain", "reduced_dtype",
    "ElasticPolicy", "MeshRebuilder",
]


_LAZY = {"abft": ("abft", None),
         "RetryPolicy": ("retry", "RetryPolicy"),
         "resilient_solve": ("retry", "resilient_solve"),
         "resilient_solve_many": ("retry", "resilient_solve_many"),
         "default_checkpoint_path": ("retry", "default_checkpoint_path"),
         "KSPFallbackChain": ("fallback", "KSPFallbackChain"),
         "reduced_dtype": ("fallback", "reduced_dtype"),
         "ElasticPolicy": ("elastic", "ElasticPolicy"),
         "MeshRebuilder": ("elastic", "MeshRebuilder")}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(name)
    import importlib
    module, attr = _LAZY[name]
    mod = importlib.import_module(f"{__name__}.{module}")
    return mod if attr is None else getattr(mod, attr)
