"""PETSc binary viewer format: Mat/Vec file interop, on the host.

The port's copy of ``mpi_petsc4py_example_tpu/utils/petsc_io.py``. Files
written by PETSc (``PetscViewerBinaryOpen`` + ``MatView``/``VecView``) load
here and files written here load in PETSc; the host functions are the JAX
package's, byte for byte.

Format (PETSc's documented binary layout, all **big-endian**):

* Mat (AIJ):  int32 classid ``1211216``, int32 nrows, int32 ncols,
  int32 nnz, int32[nrows] row lengths, int32[nnz] global column indices,
  float64[nnz] values.
* Vec:        int32 classid ``1211214``, int32 n, float64[n] values.

Standard PETSc builds use 32-bit indices and float64 scalars; complex
builds (``--with-scalar-type=complex``) write the same header with 16-byte
``(re, im)`` scalar pairs. The host writers detect the input dtype and the
host readers take ``scalar='real'|'complex'`` (the file carries no flag);
a real-scalar read of a complex-build file is detected by its leftover
payload and raises, pointing at ``scalar='complex'``, for path loads and
seekable streamed reads alike. Loading rejects ``--with-64-bit-indices``
files. ``load_mat``/``load_vec`` build the port's ``Mat``/``Vec``, which
hold real scalars only: ``scalar='complex'`` raises ``NotImplementedError``
there (complex scalars are ROADMAP.md Queue A item 5).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.mat import Mat
from ..core.vec import Vec

MAT_FILE_CLASSID = 1211216
VEC_FILE_CLASSID = 1211214

_I = np.dtype(">i4")     # PetscInt32, big-endian
_R = np.dtype(">f8")     # PetscScalar (real build, double), big-endian
_C = np.dtype(">c16")    # PetscScalar (complex build): (re, im) f8 pairs


def _scalar_dtype(scalar: str):
    if scalar == "real":
        return _R, np.float64
    if scalar == "complex":
        return _C, np.complex128
    raise ValueError(f"scalar must be 'real' or 'complex', got {scalar!r}")


@contextlib.contextmanager
def _open(path_or_file, mode):
    """Accept a path (opened fresh) or an open binary file object (used in
    place, cursor advances) — the latter is how a Viewer streams several
    objects through one file, PETSc's standard Mat-then-Vec layout."""
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        yield path_or_file
    else:
        with open(path_or_file, mode) as f:
            yield f


def _display_name(path_or_file):
    """Readable name for error messages: the path itself, or the underlying
    file's name when streamed through an open Viewer file object."""
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return getattr(path_or_file, "name", repr(path_or_file))
    return repr(path_or_file)


def _read(f, dtype, count):
    buf = f.read(dtype.itemsize * count)
    if len(buf) != dtype.itemsize * count:
        raise ValueError("truncated PETSc binary file")
    return np.frombuffer(buf, dtype=dtype, count=count)


def _check_trailing(f, path):
    """Complex-build detection after a real-scalar parse.

    A complex-scalar PETSc build (``--with-scalar-type=complex``) writes an
    identical header but 16-byte scalars, so a real-build parse consumes only
    half the payload. Any legitimate following bytes must start another
    PETSc object header; leftover imaginary halves never do.

    Path-opened reads consume the 4 peeked bytes (the file is closed right
    after). Streamed Viewer file objects get the SAME check via
    peek-and-rewind when the stream is seekable (regular files are), so the
    cursor stays at the object boundary for the next ``load``;
    non-seekable streams skip the check — they cannot look ahead.
    """
    streamed = hasattr(path, "read") or hasattr(path, "write")
    if streamed:
        try:
            if not f.seekable():
                return
            pos = f.tell()
        except (AttributeError, OSError):
            return
    peek = f.read(4)
    if not peek:
        return
    if len(peek) < 4:
        raise ValueError(
            f"{_display_name(path)}: {len(peek)} stray byte(s) after the "
            "object — corrupt or truncated PETSc binary file")
    cid = int(np.frombuffer(peek, dtype=_I, count=1)[0])
    # any PETSc object classid (Vec 1211214, Mat 1211216, IS 1211218, Bag,
    # DM, ... — all allocated from the same small block) means a legitimate
    # multi-object file; a complex-build leftover starts mid-payload at some
    # double (re or im half), whose big-endian high 4 bytes only decode into
    # this range for ~1e-308 subnormals — never real data
    if 1211200 <= cid <= 1211240:
        if streamed:
            f.seek(pos)        # leave the cursor at the object boundary
        return
    raise ValueError(
        f"{_display_name(path)}: bytes after the object do not start "
        "another PETSc object — this looks like a PETSc complex-scalar "
        "build file (--with-scalar-type=complex); load it with "
        "scalar='complex'")


def write_vec(path, arr) -> None:
    """Write a 1-D array as a PETSc binary Vec (``VecView`` layout).

    Complex input writes the complex-build layout ((re, im) f8 pairs)."""
    arr = np.asarray(arr).ravel()
    file_dt, _ = _scalar_dtype("complex" if np.iscomplexobj(arr) else "real")
    with _open(path, "wb") as f:
        f.write(np.array([VEC_FILE_CLASSID, arr.size], dtype=_I).tobytes())
        f.write(arr.astype(file_dt).tobytes())


def read_vec(path, scalar: str = "real") -> np.ndarray:
    """Read a PETSc binary Vec -> float64 (or complex128) numpy array."""
    file_dt, host_dt = _scalar_dtype(scalar)
    with _open(path, "rb") as f:
        classid, n = _read(f, _I, 2)
        if classid != VEC_FILE_CLASSID:
            raise ValueError(
                f"{_display_name(path)} is not a PETSc Vec (classid {classid}, "
                f"expected {VEC_FILE_CLASSID})")
        if n < 0:
            raise ValueError(f"corrupt PETSc Vec file: n={n}")
        vals = _read(f, file_dt, int(n)).astype(host_dt)
        _check_trailing(f, path)
        return vals


def write_mat(path, A) -> None:
    """Write a scipy sparse matrix as a PETSc binary Mat (AIJ layout).

    Complex input writes the complex-build layout ((re, im) f8 pairs)."""
    A = A.tocsr()
    # PETSc's SeqAIJ invariant: column indices sorted within each row
    if not A.has_sorted_indices:
        A = A.copy()
        A.sort_indices()
    indptr = np.asarray(A.indptr, dtype=np.int64)
    rowlens = (indptr[1:] - indptr[:-1]).astype(np.int64)
    nnz = int(indptr[-1])
    if max(A.shape[0], A.shape[1], nnz) >= 2 ** 31:
        raise ValueError("matrix too large for 32-bit PETSc binary format")
    with _open(path, "wb") as f:
        f.write(np.array([MAT_FILE_CLASSID, A.shape[0], A.shape[1], nnz],
                         dtype=_I).tobytes())
        f.write(rowlens.astype(_I).tobytes())
        f.write(np.asarray(A.indices, dtype=np.int64).astype(_I).tobytes())
        file_dt, _ = _scalar_dtype("complex" if np.iscomplexobj(A.data)
                                   else "real")
        f.write(np.asarray(A.data).astype(file_dt).tobytes())


def read_mat(path, scalar: str = "real"):
    """Read a PETSc binary Mat -> scipy CSR matrix (float64/complex128)."""
    import scipy.sparse as sp
    file_dt, host_dt = _scalar_dtype(scalar)
    with _open(path, "rb") as f:
        classid, nrows, ncols, nnz = _read(f, _I, 4)
        if classid != MAT_FILE_CLASSID:
            raise ValueError(
                f"{_display_name(path)} is not a PETSc Mat (classid {classid}, "
                f"expected {MAT_FILE_CLASSID})")
        if nrows < 0 or ncols < 0 or nnz < 0:
            raise ValueError(
                "corrupt or unsupported PETSc Mat file (negative header "
                "field — 64-bit-index PETSc builds are not supported)")
        rowlens = _read(f, _I, int(nrows)).astype(np.int64)
        if rowlens.sum() != nnz:
            raise ValueError(
                "corrupt PETSc Mat file: row lengths do not sum to nnz")
        indices = _read(f, _I, int(nnz)).astype(np.int32)
        data = _read(f, file_dt, int(nnz)).astype(host_dt)
        _check_trailing(f, path)
    if len(indices) and (indices.min() < 0 or indices.max() >= ncols):
        raise ValueError("corrupt PETSc Mat file: column index out of range")
    indptr = np.concatenate(([0], np.cumsum(rowlens)))
    return sp.csr_matrix((data, indices, indptr),
                         shape=(int(nrows), int(ncols)))


# ---- the port's Mat and Vec ------------------------------------------------

def _real_only(scalar: str):
    _scalar_dtype(scalar)
    if scalar == "complex":
        raise NotImplementedError(
            "complex scalars are not ported (ROADMAP.md Queue A item 5): the "
            "port's Mat and Vec hold bfloat16/float32/float64; read the file "
            "with read_mat/read_vec(scalar='complex') on the host")


def save_mat(path, mat) -> None:
    """``MatView(mat, binary_viewer)``: write an assembled Mat."""
    write_mat(path, mat.to_scipy())


def load_mat(path, comm, dtype=None, scalar: str = "real"):
    """``MatLoad``: read a PETSc binary Mat into a row-sharded Mat on
    ``comm`` (float64 unless ``dtype`` says otherwise)."""
    _real_only(scalar)
    A = read_mat(path, scalar=scalar)
    return Mat.from_scipy(comm, A, dtype=dtype or torch.float64)


def save_vec(path, vec) -> None:
    """``VecView(vec, binary_viewer)``."""
    write_vec(path, vec.to_numpy())


def load_vec(path, comm, dtype=None, scalar: str = "real"):
    """``VecLoad``: read a PETSc binary Vec into a row-sharded Vec on
    ``comm``."""
    _real_only(scalar)
    arr = read_vec(path, scalar=scalar)
    return Vec.from_global(comm, arr, dtype=dtype)
