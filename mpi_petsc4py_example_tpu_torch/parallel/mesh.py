"""Device communicators: a virtual mesh of z-slab shards in one process, and
the same mesh spread over processes by ``torch.distributed``.

The port's counterpart of ``mpi_petsc4py_example_tpu/parallel/mesh.py``
(``DeviceComm``, ``init_multihost``). The JAX package spreads shards over a
1-D device mesh and runs ``shard_map`` programs with
``lax.psum``/``lax.ppermute``. Here a process holds ``local_shards`` of the
``size`` shards, global shards ``shard_offset ... shard_offset +
local_shards - 1``, on one device: a distributed vector is one padded tensor
whose leading axis, viewed as ``(local_shards, local_size)``, is the shard
axis.

* :class:`DeviceComm` is the virtual mesh: one process holds every shard
  (``local_shards == size``).
* :class:`ProcessComm` is one process per rank of a ``torch.distributed``
  process group (NCCL on the card, gloo on the CPU); each holds
  ``local_shards`` shards, so 2 processes x 2 local shards is a 4-shard
  mesh. :func:`init_multihost` joins the group and returns it.

The collectives keep their meaning, and give the same bits on either:

* :meth:`DeviceComm.psum` sums per-shard partials in global shard order (a
  process comm all-gathers the partials and folds them in that order,
  never ``all_reduce``, whose order NCCL does not fix); complex partials
  cross processes as their (re, im) pairs (``view_as_real``), so the fold
  is the same on every backend;
* :meth:`DeviceComm.shift` is the ring ``ppermute``: shard ``i`` receives
  the block of shard ``i - step``; :meth:`DeviceComm.shift_open` is the
  open chain, zeros entering at the global ends;
* :meth:`DeviceComm.all_gather` is the tiled ``lax.all_gather``: the shard
  blocks concatenated in shard order, on every process;
* :meth:`DeviceComm.shard_map` runs a per-shard body on every local shard
  in turn.

Placement follows the JAX ``_put`` model: every process holds the same host
array and places only its own rows (:meth:`DeviceComm.put_rows`,
:meth:`DeviceComm.put_cols`); :meth:`DeviceComm.host_fetch` and
:meth:`DeviceComm.fetch_cols` return the whole array on every process.

:func:`full_vector_local_apply` lifts a callable on the whole vector (a
``ShellMat``'s ``mult``, a PC shell's apply) to the shard-stacked form.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..resilience import faults as _faults

# a dead peer ends a process-group run after this long instead of hanging it
TIMEOUT_S = 300.0


def torch_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` for a torch dtype or anything numpy reads as one."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype host arrays of ``dtype`` travel in (for a
    ``torch.dtype`` or anything :func:`torch_dtype` reads): the same dtype,
    or float32 for bfloat16, which numpy lacks and float32 holds exactly."""
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty(0, dtype=dt).numpy().dtype


def to_host(x: torch.Tensor) -> np.ndarray:
    """A host numpy view of a CPU tensor; bfloat16 values come back as
    float32 (:func:`numpy_dtype`)."""
    if x.dtype == torch.bfloat16:
        x = x.to(torch.float32)
    return x.numpy()


def _resolve_device(device) -> torch.device:
    """``None`` is the card, and raises without CUDA; ``cuda`` gets the
    current device's index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceComm: no CUDA device is available; pass "
                "device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_initialized():
        # the first CUDA initialisation of the process (the JAX package
        # stamps its first jax.devices() here)
        from ..utils.phases import stamp
        stamp("cuda_init_begin")
        torch.cuda.init()
        stamp("cuda_init_end")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class DeviceComm:
    """A communicator-shaped object over ``n_devices`` virtual shards, all
    held by this process.

    ``device=None`` means the card (``cuda``) and raises ``RuntimeError`` when
    CUDA is absent; the CPU is used only when the caller asks for it with
    ``device="cpu"``.

    ``device_ids`` names the shards for the fault layer
    (``resilience/faults.py``: ``device.lost``, the lost registry), the
    analog of the JAX mesh's device ids: ``0 ... n_devices - 1`` unless a
    rebuild onto surviving shards gives others (``resilience/elastic.py``).
    Placements onto a mesh holding a lost id raise (``comm.put``), as in
    JAX.
    """

    def __init__(self, n_devices: int = 1, device=None, device_ids=None):
        device = _resolve_device(device)
        if int(n_devices) < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.device = device
        self._size = int(n_devices)
        ids = (tuple(range(self._size)) if device_ids is None
               else tuple(int(i) for i in device_ids))
        if len(ids) != self._size:
            raise ValueError(f"{len(ids)} device ids for {self._size} "
                             "shards")
        self.device_ids = ids
        # calls of each collective, for the logs (the same on either comm)
        self.collectives = {"psum": 0, "shift": 0, "all_gather": 0}

    @property
    def size(self) -> int:
        """Number of shards, the analog of ``comm.Get_size()``."""
        return self._size

    # ---- the shards this process holds --------------------------------------
    @property
    def local_shards(self) -> int:
        """Shards held by this process: the leading axis of every
        shard-stacked device tensor."""
        return self._size

    @property
    def shard_offset(self) -> int:
        """Global index of this process's first shard."""
        return 0

    @property
    def nprocs(self) -> int:
        """Processes the mesh spans."""
        return 1

    @property
    def rank(self) -> int:
        """This process's rank in the group."""
        return 0

    @property
    def multiprocess(self) -> bool:
        """True when the shards are spread over several processes (JAX
        ``DeviceComm.multiprocess``)."""
        return self.nprocs > 1

    def __repr__(self):
        return f"DeviceComm(size={self.size}, device={self.device})"

    def fingerprint(self) -> dict:
        """Plain-data mesh descriptor (JAX ``mesh.py:150``): platform, shard
        count, processes and local shards; no device handles, so it
        pickles across processes."""
        return {"platform": self.device.type, "size": int(self.size),
                "nprocs": int(self.nprocs),
                "local_shards": int(self.local_shards)}

    # ---- padded row-block layout -------------------------------------------
    # Every shard owns exactly ``local_size(n)`` rows; global arrays are
    # zero-padded to ``padded_size(n)``. The user-visible (possibly uneven)
    # ownership ranges are a RowLayout (parallel/partition.py).
    def local_size(self, n: int) -> int:
        return -(-n // self.size)

    def padded_size(self, n: int) -> int:
        return self.local_size(n) * self.size

    def local_padded_size(self, n: int) -> int:
        """Rows of a length-``n`` vector this process holds, padding
        included: the length of its device data."""
        return self.local_size(n) * self.local_shards

    def local_row_range(self, n: int) -> tuple[int, int]:
        """Global padded rows ``[start, stop)`` this process holds."""
        start = self.shard_offset * self.local_size(n)
        return start, start + self.local_padded_size(n)

    def pad_rows(self, arr: np.ndarray) -> np.ndarray:
        """Zero-pad the leading axis of a host array to ``padded_size``."""
        n_pad = self.padded_size(arr.shape[0])
        if arr.shape[0] == n_pad:
            return arr
        pad = [(0, n_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad)

    def local_rows(self, arr) -> np.ndarray:
        """This process's rows of the padded host array ``arr`` (the whole
        padded array on the virtual mesh)."""
        arr = self.pad_rows(np.asarray(arr))
        start, stop = self.local_row_range(arr.shape[0])
        return arr[start:stop]

    def put_rows(self, arr, dtype=None) -> torch.Tensor:
        """Host array -> this process's padded rows on the device (always a
        copy: later writes to ``arr`` never reach the device data). A
        bfloat16 target is rounded by torch's cast, once from the host
        values (an fp64 value rounds through fp32, as ``ml_dtypes`` rounds
        it)."""
        self._check_put()
        arr = np.asarray(arr)
        dt = torch_dtype(arr.dtype if dtype is None else dtype)
        return torch.tensor(self.local_rows(arr), dtype=dt,
                            device=self.device)

    def _check_put(self):
        """The ``comm.put`` fault point and the lost-device guard of every
        placement (JAX ``mesh.py:205-206``)."""
        _faults.check("comm.put")
        _faults.check_lost(self.device_ids)

    def put_replicated(self, arr, dtype=None) -> torch.Tensor:
        """Host array -> the whole array on this process's device (JAX
        ``mesh.py:261``, the analog of ``bcast``)."""
        self._check_put()
        arr = np.asarray(arr)
        dt = torch_dtype(arr.dtype if dtype is None else dtype)
        return torch.tensor(arr, dtype=dt, device=self.device)

    def host_fetch(self, x: torch.Tensor) -> np.ndarray:
        """Row-sharded device tensor -> the whole padded host array on every
        process (bfloat16 as float32). The ``comm.fetch`` fault point
        (JAX ``mesh.py:280``): ``unavailable`` raises, ``drop`` zeroes the
        result, ``corrupt`` makes its first element NaN."""
        out = to_host(self.gather_shards(x.detach()).to("cpu")).copy()
        fault = _faults.triggered("comm.fetch")
        if fault is not None:
            if fault.kind == "unavailable":
                raise fault.error()
            if fault.kind == "drop":
                out[...] = 0
            elif out.size:
                flat = out.reshape(-1)
                flat[0] = (np.nan if np.issubdtype(out.dtype, np.inexact)
                           else ~flat[0])
        return out

    # ---- column blocks (the batched solve's k right-hand sides) -------------
    # A block of k columns lives shard-stacked as (local_shards, k,
    # local_size): each shard's part is then contiguous column by column,
    # the (k, lz, ny, nx) operand of the batched stencil kernels.
    def put_cols(self, arr, dtype=None) -> torch.Tensor:
        """Host ``(n, k)`` block -> ``(local_shards, k, local_size)`` device
        tensor of this process's shards. The transpose (and any dtype cast)
        is done in one pass on the host, so the device receives the block
        in ONE copy, already laid out (a bfloat16 block travels as float32
        and is rounded on arrival)."""
        self._check_put()
        arr = self.pad_rows(np.asarray(arr))
        dt = torch_dtype(arr.dtype if dtype is None else dtype)
        lsize, k = arr.shape[0] // self.size, arr.shape[1]
        mine = arr.reshape(self.size, lsize, k)[
            self.shard_offset:self.shard_offset + self.local_shards]
        host = np.empty((self.local_shards, k, lsize), dtype=numpy_dtype(dt))
        host[...] = mine.transpose(0, 2, 1)
        return torch.from_numpy(host).to(device=self.device, dtype=dt)

    def fetch_cols(self, x: torch.Tensor, n: int) -> np.ndarray:
        """``(local_shards, k, local_size)`` device tensor -> the host
        ``(n, k)`` block on every process (one copy back, transposed on the
        host; padding rows dropped; bfloat16 as float32)."""
        h = to_host(self.gather_shards(x.detach()).to("cpu"))
        return h.transpose(0, 2, 1).reshape(-1, h.shape[1])[:n]

    # ---- collectives over the shard axis ------------------------------------
    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's ``x`` (the same shape on each: a shard stack
        ``(local_shards, ...)``, or a process's rows) joined along axis 0 in
        rank order, on every process: ``x`` itself on the virtual mesh."""
        return x

    def psum(self, parts):
        """Sum per-shard partials (a sequence, one per local shard) in
        global shard order: the analog of ``MPI_Allreduce(SUM)``, with a
        fixed order."""
        self.collectives["psum"] += 1
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def pmax(self, parts):
        """The largest of the per-shard values (JAX ``mesh.py:300``), taken
        in global shard order."""
        total = parts[0]
        for p in parts[1:]:
            total = torch.maximum(total, p)
        return total

    def shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Ring shift of a shard-stacked tensor: shard ``i`` receives the block
        of shard ``i - step`` (``lax.ppermute`` with pairs ``(i, i+step)``)."""
        self.collectives["shift"] += 1
        return torch.roll(x, shifts=step, dims=0)

    def shift_open(self, x: torch.Tensor, step: int) -> torch.Tensor:
        """:meth:`shift` by ``±1`` along the open chain: the global first
        shard (``step=1``) or last shard (``step=-1``) receives zeros."""
        y = self.shift(x, step)
        if step > 0 and self.shard_offset == 0:
            y[0].zero_()
        elif step < 0 and self.shard_offset + self.local_shards == self.size:
            y[-1].zero_()
        return y

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole array from a shard-stacked one: ``(local_shards, lz,
        ...)`` becomes ``(size * lz, ...)`` in shard order on every process
        (``lax.all_gather`` with ``tiled=True``). On the virtual mesh it is
        made once; a view when ``x`` is contiguous."""
        if x.shape[0] != self.local_shards:
            raise ValueError(f"all_gather needs a leading shard axis of "
                             f"{self.local_shards}, got shape "
                             f"{tuple(x.shape)}")
        self.collectives["all_gather"] += 1
        x = self.gather_shards(x)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def barrier(self):
        """Return once every process has reached it (nothing to wait for
        on the virtual mesh)."""

    def shard_map(self, fn):
        """Wrap a per-shard body: ``run(*stacked)`` calls ``fn`` on the
        ``i``-th block of every shard-stacked argument, for each local shard
        in order, and returns the per-shard results as a list."""
        def run(*stacked):
            return [fn(*(a[i] for a in stacked))
                    for i in range(self.local_shards)]
        return run


class ProcessComm(DeviceComm):
    """The mesh spread over the processes of a ``torch.distributed`` group,
    one process per rank, each holding ``local_shards`` shards on its own
    ``device``: ``size = local_shards * nprocs``, and rank ``r`` holds
    global shards ``r * local_shards ...``.

    The group must be joined first (:func:`init_multihost`). On NCCL the
    payloads stay on the card; gloo moves CUDA payloads through the host,
    its documented transport, and :attr:`host_copies` counts those copies
    (one each way). ``psum`` and ``pmax`` all-gather the partials and fold
    them in global shard order, so the values are those of a
    :class:`DeviceComm` of ``size`` shards, bit for bit.
    """

    def __init__(self, local_shards: int = 1, device=None):
        if not dist.is_initialized():
            raise RuntimeError("ProcessComm: join the process group first "
                               "(init_multihost)")
        if int(local_shards) < 1:
            raise ValueError(f"local_shards must be >= 1, got {local_shards}")
        self._nprocs = dist.get_world_size()
        self._rank = dist.get_rank()
        self._local = int(local_shards)
        super().__init__(self._local * self._nprocs, device)
        self.backend = str(dist.get_backend())
        self._via_host = (self.backend == "gloo"
                          and self.device.type == "cuda")
        self.host_copies = 0

    @property
    def local_shards(self) -> int:
        return self._local

    @property
    def shard_offset(self) -> int:
        return self._rank * self._local

    @property
    def nprocs(self) -> int:
        return self._nprocs

    @property
    def rank(self) -> int:
        return self._rank

    def __repr__(self):
        return (f"ProcessComm(size={self.size}, nprocs={self.nprocs}, "
                f"rank={self.rank}, local_shards={self.local_shards}, "
                f"backend={self.backend}, device={self.device})")

    def fingerprint(self) -> dict:
        return dict(super().fingerprint(), backend=self.backend)

    # ---- transport ----------------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend sends it: contiguous, on the host for gloo."""
        t = t.contiguous()
        if self._via_host:
            self.host_copies += 1
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        """A received payload on this process's device."""
        if self._via_host:
            self.host_copies += 1
            return t.to(self.device)
        return t

    def gather_shards(self, x: torch.Tensor) -> torch.Tensor:
        if self._nprocs == 1:
            return x
        if x.is_complex():
            # complex payloads travel as their (re, im) pairs: the bits
            # arrive unchanged on either backend
            return torch.view_as_complex(
                self.gather_shards(torch.view_as_real(x.contiguous())))
        w = self._out(x)
        if self.backend == "nccl":
            out = torch.empty((self._nprocs * w.shape[0],)
                              + tuple(w.shape[1:]), dtype=w.dtype,
                              device=w.device)
            dist.all_gather_into_tensor(out, w)
        else:
            bufs = [torch.empty_like(w) for _ in range(self._nprocs)]
            dist.all_gather(bufs, w)
            out = torch.cat(bufs)
        return self._back(out)

    # ---- collectives --------------------------------------------------------
    def _fold(self, parts, op):
        if len(parts) != self._local:
            raise ValueError(f"expected {self._local} local partials, got "
                             f"{len(parts)}")
        g = self.gather_shards(torch.stack([torch.as_tensor(p)
                                            for p in parts]))
        total = g[0]
        for i in range(1, g.shape[0]):
            total = op(total, g[i])
        return total

    def psum(self, parts):
        self.collectives["psum"] += 1
        return self._fold(parts, torch.add)

    def pmax(self, parts):
        return self._fold(parts, torch.maximum)

    def barrier(self):
        """One all-gather of a scalar, read on the host: no process returns
        before every process has called it (on either backend)."""
        if self._nprocs > 1:
            self.gather_shards(torch.zeros(1, device=self.device)).cpu()

    def shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """The ring shift across processes: a roll inside the local stack,
        and the edge block swapped with the neighbouring ranks
        (``batch_isend_irecv``). Steps of ``±1`` only; complex blocks
        travel as their (re, im) pairs."""
        if x.is_complex() and self._nprocs > 1:
            return torch.view_as_complex(
                self.shift(torch.view_as_real(x.contiguous()), step)
                .contiguous())
        self.collectives["shift"] += 1
        y = torch.roll(x, shifts=step, dims=0)
        if self._nprocs == 1:
            return y
        if step not in (1, -1):
            raise ValueError(f"ProcessComm.shift supports steps of ±1, got "
                             f"{step}")
        P, r = self._nprocs, self._rank
        # step 1: my last block goes up, the block below lands in slot 0
        send, dst, src, slot = ((x[-1], (r + 1) % P, (r - 1) % P, 0)
                                if step == 1 else
                                (x[0], (r - 1) % P, (r + 1) % P, -1))
        out = self._out(send)
        inbox = torch.empty_like(out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, dst),
                dist.P2POp(dist.irecv, inbox, src)]):
            req.wait()
        y[slot].copy_(self._back(inbox))
        return y


_default_comm = None


def get_default_comm() -> DeviceComm:
    """The process-wide default communicator (JAX ``mesh.py:373``): one
    shard on the card, built at the first call (raises without CUDA, as
    every entry point does), or what :func:`set_default_comm` set."""
    global _default_comm
    if _default_comm is None:
        _default_comm = DeviceComm()
    return _default_comm


def set_default_comm(comm: DeviceComm | None):
    """Set (or, with None, reset) the default communicator."""
    global _default_comm
    _default_comm = comm


def as_comm(comm) -> DeviceComm:
    """``None`` (the default communicator), a communicator, or a facade
    communicator carrying one (``device_comm``), as a communicator (JAX
    ``mesh.py:386``)."""
    if comm is None:
        return get_default_comm()
    if isinstance(comm, DeviceComm):
        return comm
    dc = getattr(comm, "device_comm", None)
    if dc is not None:
        return as_comm(dc)
    raise TypeError(f"cannot interpret {comm!r} as a DeviceComm")


def resolve_backend(backend: str | None, device_type: str,
                    world_size: int) -> str:
    """The process group's backend: ``backend``, or NCCL on the card and
    gloo on the CPU. NCCL needs CUDA and at most one rank per card (it
    refuses two ranks on one card): otherwise ``ValueError``."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; use 'nccl' or "
                         "'gloo'")
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA tensors; use 'gloo' "
                             "on the CPU")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"backend 'nccl' with {world_size} ranks on {cards} card(s): "
                "NCCL refuses two ranks on one card; use backend 'gloo'")
    return backend


def init_multihost(backend: str | None = None, device=None,
                   init_method: str | None = None, rank: int | None = None,
                   world_size: int | None = None) -> ProcessComm:
    """Join a ``torch.distributed`` process group and return the
    :class:`ProcessComm` of one shard per process over it (JAX
    ``mesh.py:351``, the analog of launching under ``mpirun``); a
    ``ProcessComm(k)`` made after it holds ``k`` shards per process.

    ``rank``/``world_size`` default to the ``RANK``/``WORLD_SIZE``
    environment variables, ``init_method`` to
    ``tcp://MASTER_ADDR:MASTER_PORT``. ``device=None`` is the card (rank
    ``r`` takes card ``r % device_count``) and ``backend=None`` NCCL there,
    gloo on the CPU. NCCL with more ranks than cards raises before the
    group is joined: NCCL refuses two ranks on one card (use gloo). The
    group's timeout, :data:`TIMEOUT_S`, ends a run whose peer died instead
    of hanging it.
    """
    rank = int(os.environ["RANK"] if rank is None else rank)
    world_size = int(os.environ["WORLD_SIZE"] if world_size is None
                     else world_size)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost: no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    device = torch.device(device)
    backend = resolve_backend(backend, device.type, world_size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is None:
        init_method = (f"tcp://{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                       f"{os.environ['MASTER_PORT']}")
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return ProcessComm(1, device)


def full_vector_local_apply(fn, comm: DeviceComm, n: int):
    """Lift ``y = fn(x)`` on the whole unpadded length-``n`` vector to a
    shard-stacked apply (JAX ``parallel/mesh.py:329``): ``apply(x
    (local_shards, lsize)) -> y (local_shards, lsize)`` all-gathers the
    shards, applies ``fn`` to the first ``n`` entries, zero-pads the result
    and keeps this process's shards' rows."""
    lsize = comm.local_size(n)
    n_pad = lsize * comm.size
    first, count = comm.shard_offset, comm.local_shards

    def apply(x):
        x_full = comm.all_gather(x)
        y = fn(x_full[:n] if n_pad != n else x_full)
        if n_pad != n:
            y = torch.nn.functional.pad(y, (0, n_pad - n))
        return y.reshape(comm.size, lsize)[first:first + count]

    return apply
