"""Checkpoint and resume of distributed objects.

The port's counterpart of ``mpi_petsc4py_example_tpu/utils/checkpoint.py``,
in its file format: ``.npz`` files with a ``kind`` field (``vec``, ``mat``,
``solve_state``, ``solve_state_many``), the matrix as a global CSR triple,
the vectors as global arrays, the storage dtype by name. Nothing records a
shard count, so a checkpoint written on one mesh restores onto any other
(the elastic resume of ``resilience/elastic.py``), and files written by
either package load into the other. A bfloat16 payload is stored as the raw
2-byte words (numpy writes the JAX package's ``ml_dtypes`` arrays so) and
revived through the recorded dtype.

Crash safety, as in the JAX package: every save writes ``path + ".tmp"``
and ``os.replace``s it into place, so a crash mid-save never leaves a
truncated file at the final path; every load validates structure, dtype and
shapes and raises ``ValueError`` on anything malformed (a missing file
raises ``FileNotFoundError``).
"""

from __future__ import annotations

import contextlib
import os
import zipfile

import numpy as np
import torch

from ..core.mat import Mat
from ..core.vec import Vec
from ..parallel.mesh import torch_dtype

_BF16 = "bfloat16"


def _npz_path(path) -> str:
    """The ``.npz`` name ``np.savez`` would write."""
    path = os.fspath(path)
    return path if path.endswith(".npz") else path + ".npz"


def _atomic_savez(path, **payload):
    """Compressed savez through a temporary file and an atomic
    ``os.replace``."""
    final = _npz_path(path)
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as f:
            # a file object keeps numpy from appending '.npz' to the name
            np.savez_compressed(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _check(cond: bool, path, what: str):
    if not cond:
        raise ValueError(f"invalid checkpoint {path!r}: {what}")


@contextlib.contextmanager
def _open_npz(path, want_kind: str):
    """``np.load`` with truncation and corruption surfaced as
    ``ValueError``."""
    p = _npz_path(path)
    try:
        z = np.load(p)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError) as e:
        raise ValueError(
            f"invalid checkpoint {p!r}: unreadable or truncated ({e})") from e
    try:
        _check("kind" in z.files, p, "no 'kind' field: not a checkpoint "
               "written by utils.checkpoint")
        kind = str(z["kind"])
        _check(kind == want_kind, p,
               f"a {kind!r} checkpoint, expected {want_kind!r}")
        yield z
    finally:
        z.close()


def _dtype_name(dtype) -> str:
    """The recorded name of a storage dtype (numpy's, ``bfloat16`` for
    torch's bfloat16)."""
    dt = torch_dtype(dtype)
    if dt == torch.bfloat16:
        return _BF16
    return str(torch.empty(0, dtype=dt).numpy().dtype)


def _encode(arr, dtype) -> np.ndarray:
    """A host array in the file's form of ``dtype``: raw 2-byte words for
    bfloat16 (the JAX package's ``ml_dtypes`` arrays save so), the dtype
    itself otherwise."""
    if torch_dtype(dtype) == torch.bfloat16:
        t = torch.as_tensor(np.asarray(arr, dtype=np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view("V2")
    return np.asarray(arr, dtype=torch.empty(0, dtype=torch_dtype(
        dtype)).numpy().dtype)


def _checked_dtype(z, path) -> torch.dtype:
    _check("dtype" in z.files, path, "missing 'dtype'")
    name = str(z["dtype"])
    if name == _BF16:
        return torch.bfloat16
    try:
        return torch_dtype(np.dtype(name))
    except TypeError as e:
        raise ValueError(
            f"invalid checkpoint {path!r}: unknown dtype {name!r}") from e


def _revive(arr, dtype: torch.dtype) -> np.ndarray:
    """A loaded payload as host values of ``dtype``: bfloat16 words come
    back as their exact float32 values (the port's host form of bfloat16),
    other payloads cast to the recorded dtype."""
    if dtype == torch.bfloat16:
        if arr.dtype.kind == "V":
            _check(arr.dtype.itemsize == 2, "<payload>",
                   f"raw payload width {arr.dtype.itemsize} does not match "
                   "recorded dtype bfloat16")
            words = torch.from_numpy(arr.view(np.int16).copy())
            return words.view(torch.bfloat16).to(torch.float32).numpy()
        return np.asarray(arr, dtype=np.float32)
    return arr.astype(torch.empty(0, dtype=dtype).numpy().dtype, copy=False)


def _checked_csr(z, path):
    """The CSR triple, validated against the stored shape (a truncated or
    tampered file fails here, not in a resumed solve)."""
    for key in ("shape", "indptr", "indices", "data"):
        _check(key in z.files, path, f"missing {key!r}")
    shape = tuple(int(s) for s in z["shape"])
    _check(len(shape) == 2 and shape[0] > 0 and shape[1] > 0, path,
           f"bad matrix shape {shape}")
    indptr, indices, data = z["indptr"], z["indices"], z["data"]
    _check(indptr.ndim == 1 and indptr.shape[0] == shape[0] + 1, path,
           f"indptr length {indptr.shape} does not match {shape[0]} rows")
    _check(int(indptr[0]) == 0 and int(indptr[-1]) == indices.shape[0],
           path, "indptr does not span the index array: truncated?")
    _check(data.shape == indices.shape, path,
           f"data/indices length mismatch ({data.shape} vs {indices.shape})")
    _check(indices.size == 0
           or (0 <= int(indices.min()) and int(indices.max()) < shape[1]),
           path, "column indices out of range")
    return shape, (indptr, indices, data)


def _csr_payload(mat) -> dict:
    A = mat.to_scipy().tocsr()
    return dict(shape=np.asarray(mat.shape), indptr=A.indptr,
                indices=A.indices, data=_encode(A.data, mat.dtype),
                dtype=_dtype_name(mat.dtype))


def _load_mat(comm, shape, csr, dtype) -> Mat:
    indptr, indices, data = csr
    return Mat.from_csr(comm, shape, (indptr, indices, _revive(data, dtype)),
                        dtype=dtype)


def save_vec(path: str, vec: Vec):
    """Persist a Vec as its global array."""
    _atomic_savez(path, kind="vec", n=vec.n,
                  data=_encode(vec.to_numpy(), vec.dtype),
                  dtype=_dtype_name(vec.dtype))


def load_vec(path: str, comm) -> Vec:
    """A Vec on ``comm`` (any shard count) from :func:`save_vec`'s file."""
    with _open_npz(path, "vec") as z:
        _check("data" in z.files and "n" in z.files, path, "missing data/n")
        data = z["data"]
        dtype = (_checked_dtype(z, path) if "dtype" in z.files
                 else torch_dtype(data.dtype))
        data = _revive(data, dtype)
        _check(data.ndim == 1 and data.shape[0] == int(z["n"]), path,
               f"vector length {data.shape} does not match n={int(z['n'])}")
        return Vec.from_global(comm, data, dtype=dtype)


def save_mat(path: str, mat: Mat):
    """Persist a Mat as its global CSR (layout-independent)."""
    _atomic_savez(path, kind="mat", **_csr_payload(mat))


def load_mat(path: str, comm) -> Mat:
    """A Mat on ``comm`` from :func:`save_mat`'s file."""
    with _open_npz(path, "mat") as z:
        dtype = _checked_dtype(z, path)
        shape, csr = _checked_csr(z, path)
        return _load_mat(comm, shape, csr, dtype)


def save_solve_state(path: str, mat: Mat, x: Vec, b: Vec,
                     iteration: int = 0):
    """One file for an in-progress solve: operator, iterate, RHS and the
    iterations done (``resilience.resilient_solve`` writes it after a
    retriable failure)."""
    _atomic_savez(path, kind="solve_state", **_csr_payload(mat),
                  x=_encode(x.to_numpy(), mat.dtype),
                  b=_encode(b.to_numpy(), mat.dtype),
                  iteration=int(iteration))


def load_solve_state(path: str, comm):
    """``(mat, x, b, iteration)`` restored onto ``comm``."""
    with _open_npz(path, "solve_state") as z:
        dtype = _checked_dtype(z, path)
        shape, csr = _checked_csr(z, path)
        for key in ("x", "b", "iteration"):
            _check(key in z.files, path, f"missing {key!r}")
        xh, bh = z["x"], z["b"]
        _check(xh.ndim == 1 and xh.shape[0] == shape[0], path,
               f"iterate length {xh.shape} does not match n={shape[0]}")
        _check(bh.ndim == 1 and bh.shape[0] == shape[0], path,
               f"rhs length {bh.shape} does not match n={shape[0]}")
        mat = _load_mat(comm, shape, csr, dtype)
        x = Vec.from_global(comm, _revive(xh, dtype), dtype=dtype,
                            layout=mat.layout)
        b = Vec.from_global(comm, _revive(bh, dtype), dtype=dtype,
                            layout=mat.layout)
        return mat, x, b, int(z["iteration"])


def save_solve_state_many(path: str, mat: Mat, X, B, iteration: int = 0):
    """One file for an in-progress batched solve: operator and the ``(n,
    nrhs)`` iterate and RHS blocks (``resilience.resilient_solve_many``)."""
    X = np.asarray(X)
    B = np.asarray(B)
    if X.ndim != 2 or B.shape != X.shape:
        raise ValueError(
            f"save_solve_state_many: X/B must be matching (n, nrhs) "
            f"blocks, got {X.shape} and {B.shape}")
    _atomic_savez(path, kind="solve_state_many", **_csr_payload(mat),
                  x=_encode(X, mat.dtype), b=_encode(B, mat.dtype),
                  iteration=int(iteration))


def load_solve_state_many(path: str, comm):
    """``(mat, X, B, iteration)``: the operator rebuilt on ``comm``, the
    blocks as host ``(n, nrhs)`` arrays."""
    with _open_npz(path, "solve_state_many") as z:
        dtype = _checked_dtype(z, path)
        shape, csr = _checked_csr(z, path)
        for key in ("x", "b", "iteration"):
            _check(key in z.files, path, f"missing {key!r}")
        Xh, Bh = z["x"], z["b"]
        _check(Xh.ndim == 2 and Xh.shape[0] == shape[0], path,
               f"iterate block {Xh.shape} does not match n={shape[0]}")
        _check(Bh.shape == Xh.shape, path,
               f"rhs block {Bh.shape} does not match iterate {Xh.shape}")
        mat = _load_mat(comm, shape, csr, dtype)
        return (mat, _revive(Xh, dtype), _revive(Bh, dtype),
                int(z["iteration"]))
