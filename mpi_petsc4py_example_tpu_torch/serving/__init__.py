"""The serving layer: long-lived solve sessions on the card, and the fleet.

The port's counterpart of ``mpi_petsc4py_example_tpu/serving/``:
:mod:`.server` (``SolveServer``: sessions, coalescing, QoS, admission
control, resilient dispatch, shrink adoption and regrow), :mod:`.coalescer`
(the pure request grouping), :mod:`.qos` (classes, the deadline-weighted
scheduler, shedding, the autoscale policy), :mod:`.persistent` (the
resident multi-request program), :mod:`.fleet` (``SolveRouter``:
consistent-hash session sharding over replicas, migration, autoscale, heal),
:mod:`.transport` (the deadline, retry and idempotency RPC layer; loopback
and localhost-socket transports) and :mod:`.remote` (remote replicas, the
lease failure detector, failover and reconcile: ``FleetManager``). Each
runs on a ``ProcessComm`` of several processes too: rank 0 leads, and the
other ranks run its ordered command stream (``parallel/control.py``).
"""

from .coalescer import SolveRequest, coalesce, padded_width
from .fleet import HashRing, SolveRouter
from .persistent import PersistentRunner
from .qos import AutoscalePolicy, QoSClass, ScaleDecision
from .remote import (FailoverEvent, FleetManager, RemoteReplica,
                     ReplicaHost)
from .server import ServedSolveResult, ServerClosedError, SolveServer
from .transport import (LoopbackTransport, Message, RpcClient,
                        RpcDeadlineError, RpcHost, SocketHostServer,
                        SocketTransport, TransportError,
                        TransportUnreachableError)

__all__ = [
    "SolveServer", "ServedSolveResult", "ServerClosedError",
    "SolveRequest", "coalesce", "padded_width",
    "PersistentRunner",
    "SolveRouter", "HashRing",
    "QoSClass", "AutoscalePolicy", "ScaleDecision",
    "Message", "RpcHost", "RpcClient",
    "LoopbackTransport", "SocketTransport", "SocketHostServer",
    "TransportError", "TransportUnreachableError", "RpcDeadlineError",
    "ReplicaHost", "RemoteReplica", "FleetManager", "FailoverEvent",
]
