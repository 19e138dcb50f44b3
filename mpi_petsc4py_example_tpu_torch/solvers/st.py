"""ST: spectral transformations, the counterpart of SLEPc's ST object.

The port's counterpart of ``mpi_petsc4py_example_tpu/solvers/st.py`` (``ST``,
``:51``; ``STOperator``, ``:177``). Types:

* ``shift``: operate on ``A - sigma I`` (theta = lambda - sigma);
* ``sinvert``: operate on ``(A - sigma I)^-1`` (theta = 1/(lambda - sigma)),
  the route to the eigenvalues nearest a target;
* ``cayley``: operate on ``(A - sigma B)^-1 (A + nu B)`` (theta = (lambda +
  nu)/(lambda - sigma)), SLEPc's STCAYLEY; the antishift ``nu`` defaults to
  sigma and ``-st_cayley_antishift`` overrides it.

With a generalized problem ``A x = lambda B x`` (B SPD) the operators become
``B^-1 A - sigma I``, ``(A - sigma B)^-1 B`` and ``I + (sigma + nu)(A - sigma
B)^-1 B``, each self-adjoint in the B-inner product the eigensolver then
orthogonalizes in.

The inverses are dense, made on the host in fp64 under the cap of the JAX
package (``_dense_inverse_padded``, ``:153``; here PC lu's
``dense_inverse_padded``), zero-padded to the communicator's padded size;
each process keeps its rows and applies them on the device with one
``torch.matmul`` against the gathered vector. Forward products use the
operator's own ``local_spmv``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.options import global_options
from .pc import _DENSE_CAP, dense_inverse_padded

ST_TYPES = ("shift", "sinvert", "cayley")


class STType:
    SHIFT = "shift"
    SINVERT = "sinvert"
    CAYLEY = "cayley"


class ST:
    """Spectral-transformation context, slepc4py-``ST``-shaped."""

    Type = STType

    def __init__(self):
        self._type = "shift"
        self.sigma = 0.0
        self.nu = None      # cayley antishift (None: sigma, SLEPc's default)

    def set_type(self, st_type: str):
        st_type = str(st_type).lower()
        if st_type not in ST_TYPES:
            raise ValueError(f"unknown ST type {st_type!r}; "
                             f"available: {ST_TYPES}")
        self._type = st_type
        return self

    setType = set_type

    def get_type(self) -> str:
        return self._type

    getType = get_type

    def set_shift(self, sigma: float):
        self.sigma = float(sigma)
        return self

    setShift = set_shift

    def get_shift(self) -> float:
        return self.sigma

    getShift = get_shift

    def set_antishift(self, nu: float):
        """Cayley antishift ``nu`` (STCayleySetAntishift)."""
        self.nu = float(nu)
        return self

    setCayleyAntishift = set_antishift

    def get_antishift(self) -> float:
        return self.sigma if self.nu is None else self.nu

    getCayleyAntishift = get_antishift

    def set_from_options(self):
        """``-st_type``, ``-st_shift`` and ``-st_cayley_antishift``."""
        opt = global_options()
        st_type = opt.get_string("st_type")
        if st_type:
            self.set_type(st_type)
        self.sigma = opt.get_real("st_shift", self.sigma)
        nu = opt.get_real("st_cayley_antishift", None)
        if nu is not None:
            self.nu = float(nu)
        return self

    setFromOptions = set_from_options

    # ---- eigenvalue mapping -------------------------------------------------
    def back_transform(self, theta):
        """Map transformed eigenvalues theta back to the original lambda."""
        theta = np.asarray(theta)
        if self._type == "shift":
            return theta + self.sigma
        if self._type == "cayley":
            # theta = (lambda + nu)/(lambda - sigma)
            #   -> lambda = (sigma theta + nu)/(theta - 1)
            nu = self.get_antishift()
            safe = np.where(theta == 1, 2.0, theta)
            lam = (self.sigma * safe + nu) / (safe - 1.0)
            return np.where(theta == 1, np.inf, lam)
        # sinvert: theta = 1/(lambda - sigma)
        safe = np.where(theta == 0, 1.0, theta)
        lam = self.sigma + 1.0 / safe
        return np.where(theta == 0, np.inf, lam)

    def is_identity(self) -> bool:
        return self._type == "shift" and self.sigma == 0.0

    # ---- operator construction ----------------------------------------------
    def build_operator(self, A, B=None):
        """``(op, inner)``: the transformed operator the eigensolver runs and
        the B-inner-product operator (``None`` for a standard problem)."""
        if B is None and self.is_identity():
            return A, None
        return STOperator(A, B, self._type, self.sigma,
                          nu=self.get_antishift()), B

    def __repr__(self):
        return f"ST(type={self._type!r}, shift={self.sigma})"


def _dense_inverse(comm, M, n, dtype):
    """This process's rows of the padded dense inverse of ``M``."""
    return dense_inverse_padded(
        comm, M, dtype,
        f"ST 'sinvert'/generalized solve densifies the operator; n={n} is "
        f"too large for the host factorization path (cap {_DENSE_CAP}): "
        "use ST 'shift' with an iterative which", local=True)


class STOperator:
    """The transformed operator: ``A - sI``, ``(A - sI)^-1``, ``B^-1 A -
    sI``, ``(A - sB)^-1 B`` or the Cayley forms, on the port's operator
    protocol (``local_spmv(comm)`` -> ``spmv(x (local_shards, lsize))``).
    Every process factors the global host matrix (SPMD) and keeps its rows
    of the inverse."""

    def __init__(self, A, B, st_type: str, sigma: float, nu: float = 0.0):
        if st_type in ("sinvert", "cayley") and not hasattr(A, "to_scipy"):
            raise ValueError(
                f"ST {st_type!r} needs an assembled matrix (Mat): "
                "matrix-free operators expose no entries to factorize")
        if st_type == "cayley" and nu == -sigma:
            # (A - sB)^-1 (A + nB) with n = -s is the identity: every theta
            # is 1 and nothing converges (SLEPc's STCAYLEY rejects it too)
            raise ValueError(
                "ST 'cayley' with antishift nu == -sigma (including the "
                "sigma=0 default with no target) is the identity "
                "transform: set a target/shift, or a different "
                "-st_cayley_antishift")
        self.A = A
        self.B = B
        self.st_type = st_type
        self.sigma = float(sigma)
        self.nu = float(nu)
        self.shape = A.shape
        self.dtype = A.dtype
        self.comm = A.comm
        n = A.shape[0]
        self._inv = self._binv = None
        if st_type in ("sinvert", "cayley"):
            M = A.to_scipy()
            if B is not None:
                M = M - sigma * B.to_scipy()
            elif sigma != 0.0:
                import scipy.sparse as sp
                M = M - sigma * sp.eye(n, format="csr")
            self._inv = _dense_inverse(self.comm, M, n, self.dtype)
        elif B is not None:
            self._binv = _dense_inverse(self.comm, B.to_scipy(), n,
                                        self.dtype)

    def local_spmv(self, comm):
        shards = comm.local_shards

        def matinv_apply(minv, x):
            # this process's rows of the inverse times the gathered vector:
            # its shards' rows of the product
            return torch.matmul(minv, comm.all_gather(x)).view(shards, -1)

        b_spmv = self.B.local_spmv(comm) if self.B is not None else None
        if self.st_type == "cayley":
            # (A - sB)^-1 (A + nB) = I + (s + n)(A - sB)^-1 B: one product
            # of A fewer per application than the literal form
            scale = self.sigma + self.nu
            if b_spmv is None:
                return lambda x: x + scale * matinv_apply(self._inv, x)
            return lambda x: x + scale * matinv_apply(self._inv, b_spmv(x))
        if self.st_type == "sinvert":
            if b_spmv is None:
                return lambda x: matinv_apply(self._inv, x)
            return lambda x: matinv_apply(self._inv, b_spmv(x))
        a_spmv = self.A.local_spmv(comm)
        sigma = self.sigma
        if b_spmv is None:
            return lambda x: a_spmv(x) - sigma * x
        return lambda x: matinv_apply(self._binv, a_spmv(x)) - sigma * x

    def __repr__(self):
        return (f"STOperator({self.st_type!r}, sigma={self.sigma}, "
                f"generalized={self.B is not None})")
