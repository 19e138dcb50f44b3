"""Row-block partitioning: the user-visible ownership map of a vector.

The port's copy of the ``RowLayout`` part of
``mpi_petsc4py_example_tpu/parallel/partition.py``: a 1-D contiguous row-block
decomposition, ``divmod`` split with the remainder spread over the lowest
shards (PETSc's split).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def row_partition(nrows: int, nparts: int) -> tuple[np.ndarray, np.ndarray]:
    """Split ``nrows`` into ``nparts`` contiguous blocks: ``(count, displ)``."""
    base, extra = divmod(nrows, nparts)
    count = np.full(nparts, base, dtype=np.int64)
    count[:extra] += 1
    displ = np.concatenate(([0], np.cumsum(count)[:-1]))
    return count, displ


def ownership_range(nrows: int, nparts: int, rank: int) -> tuple[int, int]:
    """Half-open row range ``[start, end)`` owned by ``rank``."""
    count, displ = row_partition(nrows, nparts)
    return int(displ[rank]), int(displ[rank] + count[rank])


@dataclass(frozen=True)
class RowLayout:
    """The user-visible (possibly uneven) row ownership map of a vector.

    Kept separate from the uniform padded device layout of
    :class:`..parallel.mesh.DeviceComm`.
    """
    nrows: int
    nparts: int

    @property
    def count(self) -> np.ndarray:
        return row_partition(self.nrows, self.nparts)[0]

    @property
    def displ(self) -> np.ndarray:
        return row_partition(self.nrows, self.nparts)[1]

    def range(self, rank: int) -> tuple[int, int]:
        return ownership_range(self.nrows, self.nparts, rank)
