"""The mixed-precision dtype vocabulary, on torch dtypes.

The port's counterpart of ``mpi_petsc4py_example_tpu/utils/dtypes.py``
(``:35-88``). A solve has a STORAGE dtype (the operator, PC and iterate
channel: what the halo exchanges and the vector updates move) and a REDUCE
dtype (the dot-product and norm accumulation channel). For fp32/fp64 the two
coincide; for bfloat16 storage the reduce channel is fp32.

Each function takes a ``torch.dtype`` or anything numpy reads as a dtype
(bfloat16 exists only as ``torch.bfloat16``: numpy has none).
"""

from __future__ import annotations

import torch

from ..parallel.mesh import torch_dtype

# the -ksp_inner_precision spellings (solvers/refine.RefinedKSP)
_SPELLINGS = {
    torch.bfloat16: ("bf16", "bfloat16"),
    torch.float32: ("f32", "fp32", "float32", "single"),
    torch.float64: ("f64", "fp64", "float64", "double"),
}


def inner_precision_dtype(name: str) -> torch.dtype:
    """Map a ``-ksp_inner_precision`` spelling to a storage dtype; raises
    ``ValueError`` on an unknown one."""
    key = str(name).lower()
    for dtype, names in _SPELLINGS.items():
        if key in names:
            return dtype
    raise ValueError(
        f"unknown inner precision {name!r}; choose from bf16/f32/f64")


def is_low_precision(dtype) -> bool:
    """Sub-32-bit float storage (bfloat16/float16): the precisions whose
    reductions must accumulate in a wider dtype."""
    dt = torch_dtype(dtype)
    return dt.is_floating_point and dt.itemsize < 4


def reduce_dtype(storage) -> torch.dtype:
    """The accumulation dtype of the reduction channel: fp32 for sub-32-bit
    storage, the storage dtype itself otherwise."""
    dt = torch_dtype(storage)
    return torch.float32 if is_low_precision(dt) else dt


def tolerance_dtype(storage) -> torch.dtype:
    """The real scalar dtype tolerances and norms travel in: the real
    counterpart of the reduce dtype (fp32 under bf16 storage)."""
    rdt = reduce_dtype(storage)
    return rdt.to_real() if rdt.is_complex else rdt


def real_eps(dtype) -> float:
    """Machine epsilon of the real scalar of ``dtype`` (2^-7 for
    bfloat16, as ``ml_dtypes.finfo`` gives it)."""
    dt = torch_dtype(dtype)
    return float(torch.finfo(dt.to_real() if dt.is_complex else dt).eps)
