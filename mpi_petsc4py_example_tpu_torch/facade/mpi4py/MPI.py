"""mpi4py-shaped facade of the PyTorch port: the MPI shim.

The port's copy of ``compat/mpi4py/MPI.py``. It lets drivers written for
mpi4py (``from mpi4py import MPI``; ``comm.Get_rank``, ``send/recv``,
``Send/Recv``, ``bcast``, ``Gatherv``) run with no MPI installed:

* Single-process mode (default): ``COMM_WORLD`` has size 1.
* Virtual multi-rank mode (``python -m mpi_petsc4py_example_tpu_torch.run -n N
  driver.py``): N *threads* each execute the driver with a thread-local rank;
  point-to-point and collective calls are queue/barrier rendezvous inside one
  process. The device work happens once, on the rank-0 thread, over the
  port's virtual mesh (``Comm.device_comm``): threads emulate MPI control
  flow, the mesh does the data parallelism.
* Process mode (``run -n N --procs driver.py``): N processes of a
  ``torch.distributed`` group, one per rank (:class:`ProcessContext`).
  Point-to-point and collective calls move pickled host objects over a gloo
  group, which exists even when the device group is NCCL; in a collective
  every rank runs the build, SPMD-style, on its own objects, and
  ``Comm.device_comm`` is the :class:`ProcessComm` of one shard per rank.
  A message carries its tag, and a receive takes the oldest message of its
  source and tag: one that arrives before its receive waits in a buffer, as
  MPI matches tags.

``Gatherv`` uses the true per-rank counts (unlike bare-buffer mpi4py, whose
equal-block assumption misassembles uneven partitions).

``Comm.device_comm`` is a :class:`DeviceComm` (threads) or
:class:`ProcessComm` (processes) with one shard per rank on the device the
runner was given (``--device``; the card when it was not given).
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np

# MPI datatype tokens (accepted and ignored — buffers carry numpy dtypes)
INT = "MPI_INT"
DOUBLE = "MPI_DOUBLE"
FLOAT = "MPI_FLOAT"
INT32_T = INT
INT64_T = "MPI_INT64"
ANY_SOURCE = -1
ANY_TAG = -1


class VirtualContext:
    """Shared rendezvous state for N virtual ranks (threads)."""

    def __init__(self, nprocs: int):
        self.nprocs = nprocs
        self.barrier = threading.Barrier(nprocs)
        self._p2p: dict = {}
        self._p2p_lock = threading.Lock()
        self._coll_lock = threading.Lock()
        self._coll: dict = {}
        self._gen: dict = {}
        self._local = threading.local()

    # ---- thread registry ----------------------------------------------------
    def register(self, rank: int):
        self._local.rank = rank

    @property
    def rank(self) -> int:
        return getattr(self._local, "rank", 0)

    # ---- point-to-point -----------------------------------------------------
    def chan(self, src: int, dst: int, tag) -> queue.Queue:
        key = (src, dst, tag)
        with self._p2p_lock:
            q = self._p2p.get(key)
            if q is None:
                q = self._p2p[key] = queue.Queue()
            return q

    # ---- generic collective -------------------------------------------------
    def collective(self, name: str, contribution, build, root: int = 0):
        """All ranks contribute; ``root`` runs ``build(list_by_rank)``; the
        result is shared to every rank. Repeated calls with the same name are
        separated by generation counters."""
        with self._coll_lock:
            gen = self._gen.get(name, 0)
            slot = self._coll.setdefault((name, gen), {})
            slot[self.rank] = contribution
            if len(slot) == self.nprocs:
                self._gen[name] = gen + 1
        self.barrier.wait()
        key = (name, gen)
        if self.rank == root:
            data = [self._coll[key][r] for r in range(self.nprocs)]
            self._coll[key]["result"] = build(data)
        self.barrier.wait()
        result = self._coll[key]["result"]
        self.barrier.wait()
        if self.rank == root:
            with self._coll_lock:
                del self._coll[key]
        return result


class _ObjectChannel:
    """One direction and tag between two ranks of a
    :class:`ProcessContext`: the queue-shaped ``put``/``get`` of
    :meth:`VirtualContext.chan`."""

    def __init__(self, ctx, src: int, dst: int, tag):
        self._ctx, self._src, self._dst, self._tag = ctx, src, dst, tag

    def put(self, obj):
        import torch.distributed as dist
        dist.send_object_list([(self._tag, obj)], dst=self._dst,
                              group=self._ctx.group)

    def get(self):
        return self._ctx.take(self._src, self._tag)


class _GroupBarrier:
    def __init__(self, group):
        self._group = group

    def wait(self):
        import torch.distributed as dist
        dist.barrier(group=self._group)


class ProcessContext:
    """N ranks as the N processes of a joined ``torch.distributed`` group,
    fronting ``device_comm`` (a :class:`ProcessComm`). Host objects travel
    pickled over gloo: the default group when it is gloo, else a gloo group
    made over the same ranks."""

    def __init__(self, device_comm):
        import torch.distributed as dist
        self.device_comm = device_comm
        self.nprocs = dist.get_world_size()
        self.rank = dist.get_rank()
        self.group = (None if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))
        self.barrier = _GroupBarrier(self.group)
        # (source, tag) -> messages that arrived before their receive
        self._early: dict = collections.defaultdict(collections.deque)

    def chan(self, src: int, dst: int, tag) -> _ObjectChannel:
        return _ObjectChannel(self, src, dst, tag)

    def take(self, src: int, tag):
        """The oldest message from ``src`` with ``tag``: from the buffer,
        else received, buffering any other tag's messages on the way."""
        import torch.distributed as dist
        early = self._early[(src, tag)]
        if early:
            return early.popleft()
        while True:
            box = [None]
            dist.recv_object_list(box, src=src, group=self.group)
            got, obj = box[0]
            if got == tag:
                return obj
            self._early[(src, got)].append(obj)

    def collective(self, name: str, contribution, build, root: int = 0):
        """Every rank's contribution goes to every rank, and every rank
        runs ``build(list_by_rank)`` on its own objects (SPMD)."""
        import torch.distributed as dist
        data = [None] * self.nprocs
        dist.all_gather_object(data, contribution, group=self.group)
        return build(data)


_context: VirtualContext | ProcessContext | None = None
# the device of Comm.device_comm: None is the card (the runner's --device)
_device = None
_device_comms: dict = {}
_device_comms_lock = threading.Lock()


def _set_context(ctx: VirtualContext | ProcessContext | None):
    global _context
    _context = ctx


def _set_device(device):
    """The device ``Comm.device_comm`` places data on: ``None`` (the card)
    or ``'cpu'``."""
    global _device
    _device = device


def _unwrap(buf):
    """Accept both bare arrays and mpi4py's ``[buf, datatype]`` lists."""
    if isinstance(buf, (list, tuple)) and len(buf) >= 1 \
            and isinstance(buf[0], np.ndarray):
        return buf[0]
    return buf


class Comm:
    """COMM_WORLD-shaped communicator."""

    @property
    def _ctx(self) -> VirtualContext | ProcessContext | None:
        return _context

    # ---- rank info ----------------------------------------------------------
    def Get_rank(self) -> int:
        ctx = self._ctx
        return ctx.rank if ctx else 0

    def Get_size(self) -> int:
        ctx = self._ctx
        return ctx.nprocs if ctx else 1

    @property
    def rank(self) -> int:
        return self.Get_rank()

    @property
    def size(self) -> int:
        return self.Get_size()

    # ---- the device mesh behind the communicator ----------------------------
    @property
    def device_comm(self):
        """The port's :class:`DeviceComm` this communicator fronts (one shard
        per rank, on the runner's device), made once per size and device;
        in process mode the group's :class:`ProcessComm`."""
        if isinstance(self._ctx, ProcessContext):
            return self._ctx.device_comm
        from mpi_petsc4py_example_tpu_torch import DeviceComm
        key = (self.Get_size(), _device)
        with _device_comms_lock:
            dc = _device_comms.get(key)
            if dc is None:
                dc = _device_comms[key] = DeviceComm(n_devices=key[0],
                                                     device=_device)
        return dc

    # ---- point-to-point ------------------------------------------------------
    def send(self, obj, dest: int, tag: int = 0):
        ctx = self._require_ctx("send")
        ctx.chan(ctx.rank, dest, tag).put(obj)

    def recv(self, buf=None, source: int = 0, tag: int = 0):
        ctx = self._require_ctx("recv")
        if isinstance(buf, int):  # mpi4py allows recv(source=0)
            source, buf = buf, None
        return ctx.chan(source, ctx.rank, tag).get()

    def Send(self, buf, dest: int, tag: int = 0):
        ctx = self._require_ctx("Send")
        arr = np.ascontiguousarray(_unwrap(buf))
        ctx.chan(ctx.rank, dest, (tag, "buf")).put(arr)

    def Recv(self, buf, source: int = 0, tag: int = 0):
        ctx = self._require_ctx("Recv")
        out = _unwrap(buf)
        arr = ctx.chan(source, ctx.rank, (tag, "buf")).get()
        np.copyto(out, arr.astype(out.dtype, copy=False))

    # ---- collectives ---------------------------------------------------------
    def bcast(self, obj, root: int = 0):
        ctx = self._ctx
        if ctx is None:
            return obj
        return ctx.collective("bcast", obj,
                              lambda data: data[root], root=root)

    def barrier(self):
        ctx = self._ctx
        if ctx is not None:
            ctx.barrier.wait()

    Barrier = barrier

    def Gatherv(self, sendbuf, recvbuf, root: int = 0):
        """Gather variable-size blocks in rank order using TRUE counts."""
        ctx = self._ctx
        send = np.asarray(_unwrap(sendbuf))
        if ctx is None:
            out = _unwrap(recvbuf)
            np.copyto(out[: send.shape[0]], send)
            return
        gathered = ctx.collective("gatherv", send,
                                  lambda data: np.concatenate(data),
                                  root=root)
        if ctx.rank == root:
            out = _unwrap(recvbuf)
            np.copyto(out[: gathered.shape[0]],
                      gathered.astype(out.dtype, copy=False))

    def gather(self, obj, root: int = 0):
        ctx = self._ctx
        if ctx is None:
            return [obj]
        res = ctx.collective("gather", obj, lambda data: list(data),
                             root=root)
        return res if ctx.rank == root else None

    def allreduce(self, value, op=None):
        ctx = self._ctx
        if ctx is None:
            return value
        return ctx.collective("allreduce", value, lambda data: sum(data))

    # ---- helpers -------------------------------------------------------------
    def _require_ctx(self, what: str) -> VirtualContext | ProcessContext:
        ctx = self._ctx
        if ctx is None:
            raise RuntimeError(
                f"MPI.{what} needs virtual ranks — run the driver under "
                "python -m mpi_petsc4py_example_tpu_torch.run -n N "
                "(single-process COMM_WORLD has size 1)")
        return ctx

    # generic collective used by the PETSc facade
    def _collective(self, name, contribution, build, root: int = 0):
        ctx = self._ctx
        if ctx is None:
            return build([contribution])
        return ctx.collective(name, contribution, build, root=root)


COMM_WORLD = Comm()
COMM_SELF = Comm()


def Init():
    pass


def Finalize():
    pass


def Is_initialized():
    return True
