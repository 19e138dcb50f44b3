"""The serving layer: long-lived solve sessions on the card.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/``, first half:
:mod:`.server` (``SolveServer``: sessions, coalescing, QoS, admission
control, resilient dispatch, shrink adoption and regrow), :mod:`.coalescer`
(the pure request grouping), :mod:`.qos` (classes, the deadline-weighted
scheduler, shedding, the autoscale policy) and :mod:`.persistent` (the
resident multi-request program). The fleet, transport and remote modules
are ROADMAP.md Queue A item 7.2.
"""

from .coalescer import SolveRequest, coalesce, padded_width
from .persistent import PersistentRunner
from .qos import AutoscalePolicy, QoSClass, ScaleDecision
from .server import ServedSolveResult, ServerClosedError, SolveServer

__all__ = [
    "SolveServer", "ServedSolveResult", "ServerClosedError",
    "SolveRequest", "coalesce", "padded_width",
    "PersistentRunner",
    "QoSClass", "AutoscalePolicy", "ScaleDecision",
]
