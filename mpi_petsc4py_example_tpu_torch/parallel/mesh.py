"""Device communicator: a single-process virtual mesh of z-slab shards.

The port's counterpart of ``mpi_petsc4py_example_tpu/parallel/mesh.py``
(``DeviceComm``). The JAX package spreads shards over a 1-D device mesh and
runs ``shard_map`` programs with ``lax.psum``/``lax.ppermute``. Here the
``size`` shards all live on ONE device (the card, or the CPU in the tests):
a distributed vector is one padded tensor whose leading axis, viewed as
``(size, local_size)``, is the shard axis. The collectives keep their meaning:

* :meth:`DeviceComm.psum` sums per-shard partials in a fixed shard order, so a
  reduction gives the same bits on every run;
* :meth:`DeviceComm.shift` is the ring ``ppermute``: shard ``i`` receives the
  block of shard ``i - step``;
* :meth:`DeviceComm.all_gather` is the tiled ``lax.all_gather``: the shard
  blocks concatenated in shard order;
* :meth:`DeviceComm.shard_map` runs a per-shard body on every shard in turn.

:func:`full_vector_local_apply` lifts a callable on the whole vector (a
``ShellMat``'s ``mult``, a PC shell's apply) to the shard-stacked form.

Several devices through ``torch.distributed`` are later work.
"""

from __future__ import annotations

import numpy as np
import torch


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


class DeviceComm:
    """A communicator-shaped object over ``n_devices`` virtual shards.

    ``device=None`` means the card (``cuda``) and raises ``RuntimeError`` when
    CUDA is absent; the CPU is used only when the caller asks for it with
    ``device="cpu"``.
    """

    def __init__(self, n_devices: int = 1, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceComm: no CUDA device is available; pass "
                    "device='cpu' to run on the CPU")
            device = "cuda"
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if int(n_devices) < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        self.device = device
        self._size = int(n_devices)

    @property
    def size(self) -> int:
        """Number of shards, the analog of ``comm.Get_size()``."""
        return self._size

    def __repr__(self):
        return f"DeviceComm(size={self.size}, device={self.device})"

    # ---- padded row-block layout -------------------------------------------
    # Every shard owns exactly ``local_size(n)`` rows; global arrays are
    # zero-padded to ``padded_size(n)``. The user-visible (possibly uneven)
    # ownership ranges are a RowLayout (parallel/partition.py).
    def local_size(self, n: int) -> int:
        return -(-n // self.size)

    def padded_size(self, n: int) -> int:
        return self.local_size(n) * self.size

    def pad_rows(self, arr: np.ndarray) -> np.ndarray:
        """Zero-pad the leading axis of a host array to ``padded_size``."""
        n_pad = self.padded_size(arr.shape[0])
        if arr.shape[0] == n_pad:
            return arr
        pad = [(0, n_pad - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
        return np.pad(arr, pad)

    def put_rows(self, arr, dtype=None) -> torch.Tensor:
        """Host array -> padded device tensor (always a copy: later writes to
        ``arr`` never reach the device data). A bfloat16 target is rounded
        by torch's cast, once from the host values (an fp64 value rounds
        through fp32, as ``ml_dtypes`` rounds it)."""
        arr = self.pad_rows(np.asarray(arr))
        dt = torch_dtype(arr.dtype if dtype is None else dtype)
        return torch.tensor(arr, dtype=dt, device=self.device)

    def host_fetch(self, x: torch.Tensor) -> np.ndarray:
        """Device tensor -> host numpy copy (bfloat16 as float32)."""
        return to_host(x.detach().to("cpu")).copy()

    # ---- column blocks (the batched solve's k right-hand sides) -------------
    # A block of k columns lives shard-stacked as (size, k, local_size): each
    # shard's part is then contiguous column by column, the (k, lz, ny, nx)
    # operand of the batched stencil kernels.
    def put_cols(self, arr, dtype=None) -> torch.Tensor:
        """Host ``(n, k)`` block -> ``(size, k, local_size)`` device tensor.
        The transpose (and any dtype cast) is done in one pass on the host,
        so the device receives the block in ONE copy, already laid out (a
        bfloat16 block travels as float32 and is rounded on arrival)."""
        arr = self.pad_rows(np.asarray(arr))
        dt = torch_dtype(arr.dtype if dtype is None else dtype)
        host = np.empty((self.size, arr.shape[1], arr.shape[0] // self.size),
                        dtype=numpy_dtype(dt))
        host[...] = arr.reshape(self.size, -1, arr.shape[1]).transpose(0, 2, 1)
        return torch.from_numpy(host).to(device=self.device, dtype=dt)

    def fetch_cols(self, x: torch.Tensor, n: int) -> np.ndarray:
        """``(size, k, local_size)`` device tensor -> host ``(n, k)`` block
        (one copy back, transposed on the host; padding rows dropped;
        bfloat16 as float32)."""
        h = to_host(x.detach().to("cpu"))
        return h.transpose(0, 2, 1).reshape(-1, h.shape[1])[:n]

    # ---- collectives over the shard axis ------------------------------------
    def psum(self, parts):
        """Sum per-shard partials (a sequence, one per shard) in shard order:
        the analog of ``MPI_Allreduce(SUM)``, with a fixed order."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    def shift(self, x: torch.Tensor, step: int = 1) -> torch.Tensor:
        """Ring shift of a shard-stacked tensor: shard ``i`` receives the block
        of shard ``i - step`` (``lax.ppermute`` with pairs ``(i, i+step)``)."""
        return torch.roll(x, shifts=step, dims=0)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole array from a shard-stacked one: ``(size, lz, ...)``
        becomes ``(size * lz, ...)`` in shard order (``lax.all_gather`` with
        ``tiled=True``). Every shard would receive the same array, so it is
        made once; a view when ``x`` is contiguous."""
        if x.shape[0] != self.size:
            raise ValueError(f"all_gather needs a leading shard axis of "
                             f"{self.size}, got shape {tuple(x.shape)}")
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def shard_map(self, fn):
        """Wrap a per-shard body: ``run(*stacked)`` calls ``fn`` on the
        ``i``-th block of every shard-stacked argument, for each shard in
        order, and returns the per-shard results as a list."""
        def run(*stacked):
            return [fn(*(a[i] for a in stacked)) for i in range(self.size)]
        return run


def full_vector_local_apply(fn, comm: DeviceComm, n: int):
    """Lift ``y = fn(x)`` on the whole unpadded length-``n`` vector to a
    shard-stacked apply (JAX ``parallel/mesh.py:329``): ``apply(x (size,
    lsize)) -> y (size, lsize)`` all-gathers the shards, applies ``fn`` to
    the first ``n`` entries, zero-pads the result and hands each shard its
    rows. On the virtual mesh every shard's rows come from the one call."""
    lsize = comm.local_size(n)
    n_pad = lsize * comm.size

    def apply(x):
        x_full = comm.all_gather(x)
        y = fn(x_full[:n] if n_pad != n else x_full)
        if n_pad != n:
            y = torch.nn.functional.pad(y, (0, n_pad - n))
        return y.reshape(comm.size, lsize)

    return apply
