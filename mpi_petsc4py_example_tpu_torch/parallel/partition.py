"""Row-block partitioning: the user-visible ownership map of a vector.

The port's copy of ``mpi_petsc4py_example_tpu/parallel/partition.py``: a 1-D
contiguous row-block decomposition, ``divmod`` split with the remainder spread
over the lowest shards (PETSc's split), and the CSR row-block slicing of the
reference drivers: a sliced block is ``(indptr, indices, data)`` with the
indptr rebased to start at zero while column indices stay global.
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


def slice_csr_block(indptr, indices, data, rstart: int, rend: int):
    """Rows ``[rstart, rend)`` of a CSR matrix as a local block: the indptr
    rebased to start at 0, column indices global."""
    indptr = np.asarray(indptr)
    pstart, pend = indptr[rstart], indptr[rend]
    local_indptr = indptr[rstart:rend + 1] - pstart
    return (np.ascontiguousarray(local_indptr),
            np.ascontiguousarray(np.asarray(indices)[pstart:pend]),
            np.ascontiguousarray(np.asarray(data)[pstart:pend]))


def partition_csr(indptr, indices, data, nparts: int):
    """A global CSR cut into ``nparts`` row blocks (a list of triples)."""
    nrows = len(indptr) - 1
    count, displ = row_partition(nrows, nparts)
    return [slice_csr_block(indptr, indices, data, int(displ[i]),
                            int(displ[i] + count[i]))
            for i in range(nparts)]


def concat_csr_blocks(blocks):
    """Local CSR row blocks joined into one global CSR triple (the inverse of
    :func:`partition_csr`; how ``Mat.from_local_blocks`` reassembles the
    per-rank blocks)."""
    indptrs, indices, datas = zip(*blocks)
    out_indptr = [np.asarray(indptrs[0], dtype=np.int64)]
    offset = out_indptr[0][-1]
    for p in indptrs[1:]:
        p = np.asarray(p, dtype=np.int64)
        out_indptr.append(p[1:] + offset)
        offset += p[-1]
    return (np.concatenate(out_indptr),
            np.concatenate([np.asarray(i) for i in indices]),
            np.concatenate([np.asarray(d) for d in datas]))


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
