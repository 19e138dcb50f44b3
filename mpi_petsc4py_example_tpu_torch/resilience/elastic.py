"""Elastic degraded-mesh recovery: rebuild a solve on fewer shards, and back.

The port's counterpart of ``mpi_petsc4py_example_tpu/resilience/
elastic.py``, on :class:`..parallel.mesh.DeviceComm`, whose virtual shards
play the JAX mesh's devices (named by ``DeviceComm.device_ids``). A
persistently lost shard (a fired ``device.lost`` fault, or
:func:`..faults.mark_lost`) fails every same-mesh retry; this tier, which
``resilience/retry.py`` engages once the :class:`..faults.HealthMonitor`
classifies the loss, rebuilds the session on the largest power of two of
the surviving shards and resumes from the checkpointed (or in-memory)
iterate, and after :func:`..faults.heal` grows it back, never past the mesh
it started on:

* :class:`ElasticPolicy`: the ``-elastic_*`` options;
* :class:`MeshRebuilder`: plans the smaller (:meth:`~MeshRebuilder.
  shrunk_comm`) or larger (:meth:`~MeshRebuilder.grown_comm`) mesh;
* :func:`rebuild_operator`, :func:`rebuild_ksp`, :func:`rebind_vec`,
  :func:`replant_vectors`, :func:`warm`, :func:`shrink_solve_session`,
  :func:`regrow_solve_session`.

A :class:`..parallel.mesh.ProcessComm` cannot shrink or grow: a lost process
leaves the ``torch.distributed`` group only if the survivors form a new one,
which the JAX package (one controller) never needs. Its elastic calls raise
``NotImplementedError`` naming ROADMAP.md Queue A item 6.4; the guard,
faults, retry and fallback run on it as on a ``DeviceComm``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.options import global_options
from . import faults as _faults


@dataclass
class ElasticPolicy:
    """When and how far to escalate past same-mesh retries (JAX
    ``elastic.py:60``): ``enabled`` (``-elastic_enable``),
    ``max_same_mesh_retries`` (``-elastic_max_same_mesh_retries``, also the
    HealthMonitor's threshold), ``min_devices`` (``-elastic_min_devices``),
    ``shrink_unattributed`` (``-elastic_shrink_unattributed``: halve a mesh
    whose failures name no shard), ``regrow`` (``-elastic_regrow``) and
    ``prefer_pow2`` (land on power-of-two sizes)."""
    enabled: bool = True
    max_same_mesh_retries: int = 2
    min_devices: int = 1
    shrink_unattributed: bool = False
    regrow: bool = True
    prefer_pow2: bool = True

    @classmethod
    def from_options(cls) -> "ElasticPolicy":
        """The policy from the options database (``-elastic_*``)."""
        opt = global_options()
        p = cls()
        p.enabled = opt.get_bool("elastic_enable", p.enabled)
        p.max_same_mesh_retries = opt.get_int(
            "elastic_max_same_mesh_retries", p.max_same_mesh_retries)
        p.min_devices = opt.get_int("elastic_min_devices", p.min_devices)
        p.shrink_unattributed = opt.get_bool(
            "elastic_shrink_unattributed", p.shrink_unattributed)
        p.regrow = opt.get_bool("elastic_regrow", p.regrow)
        return p


def _largest_pow2_at_most(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n >= 1 else 0


def _check_rebuildable(comm):
    """A process communicator cannot drop or add a process: raise."""
    if getattr(comm, "multiprocess", False):
        raise NotImplementedError(
            "elastic shrink/regrow on a ProcessComm: a lost process leaves "
            "the torch.distributed group only if the survivors form a new "
            "one (ROADMAP.md Queue A item 6.4); the same-mesh retry, the "
            "guard and the fallback chain run on it")


class MeshRebuilder:
    """Plans degraded-mesh rebuilds (JAX ``elastic.py:123``)."""

    def __init__(self, policy: ElasticPolicy | None = None):
        self.policy = policy or ElasticPolicy()

    def survivors(self, comm, lost=frozenset()):
        """Shard ids of ``comm`` marked neither in the lost registry nor in
        ``lost`` (a HealthMonitor's classification)."""
        dead = set(int(d) for d in lost) | set(_faults.lost_devices())
        return [d for d in comm.device_ids if int(d) not in dead]

    def _comm(self, comm, ids):
        from ..parallel.mesh import DeviceComm
        return DeviceComm(len(ids), device=comm.device, device_ids=ids)

    def shrunk_comm(self, comm, lost=frozenset()):
        """The largest viable strictly smaller communicator over the
        surviving shards, or None (already at ``min_devices``, nothing
        survives, or unattributed failures without speculative
        shrinking)."""
        _check_rebuildable(comm)
        cur = comm.size
        surv = self.survivors(comm, lost)
        n = len(surv)
        if n < 1 or cur <= 1:
            return None
        if n < cur:
            size = _largest_pow2_at_most(n) if self.policy.prefer_pow2 else n
        elif self.policy.shrink_unattributed:
            size = _largest_pow2_at_most(cur - 1)
        else:
            return None
        if size < max(1, self.policy.min_devices) or size >= cur:
            return None
        return self._comm(comm, surv[:size])

    def grown_comm(self, comm, full_comm=None):
        """The largest viable strictly larger communicator over the healthy
        shards of ``full_comm`` (the mesh the session started on; None: no
        regrow), or None."""
        _check_rebuildable(comm)
        if not self.policy.regrow or full_comm is None:
            return None
        healthy = self.survivors(full_comm)
        n, cur = len(healthy), comm.size
        if n <= cur:
            return None
        size = _largest_pow2_at_most(n) if self.policy.prefer_pow2 else n
        if size <= cur:
            return None
        return self._comm(comm, healthy[:size])


def rebuild_operator(mat, comm_new):
    """The operator re-placed on ``comm_new``: ``with_comm`` for the
    matrix-free stencil, the host CSR round trip for a Mat (its null space
    rides along); ``ValueError`` when neither exists or the new size does
    not fit the operator (JAX ``elastic.py:216``)."""
    _check_rebuildable(comm_new)
    if hasattr(mat, "with_comm"):
        return mat.with_comm(comm_new)
    if hasattr(mat, "to_scipy"):
        from ..core.mat import Mat
        m2 = Mat.from_scipy(comm_new, mat.to_scipy(), dtype=mat.dtype)
        ns = getattr(mat, "nullspace", None)
        if ns is not None:
            m2.set_nullspace(ns)
        return m2
    raise ValueError(
        f"operator {type(mat).__name__} cannot be rebuilt on a new mesh: "
        "no with_comm() and no to_scipy(); provide one to make it elastic")


def rebuild_ksp(ksp, mat_new):
    """Rebind a KSP to ``mat_new`` and its communicator: a fresh PC of the
    same type and tunables, set up on the new geometry; the guard's
    checksum placement re-keys on the new operator (JAX
    ``elastic.py:243``)."""
    from ..solvers.pc import PC
    old_pc = ksp.get_pc()
    comm_new = mat_new.comm
    pc = PC(comm_new)
    pc.set_type(old_pc.get_type())
    for attr in ("sor_omega", "asm_overlap", "factor_fill",
                 "gamg_threshold", "gamg_coarse_size", "gamg_max_levels",
                 "mg_smoother", "bjacobi_blocks", "setup_device",
                 "_factor_solver_type"):
        if hasattr(old_pc, attr):
            setattr(pc, attr, getattr(old_pc, attr))
    ksp.comm = comm_new
    ksp.set_pc(pc)
    ksp.set_operators(mat_new)
    ksp.set_up()
    return ksp


def rebind_vec(vec, new):
    """Re-point a caller's Vec at ``new``'s storage in place, so the Vecs a
    driver holds stay valid across the rebuild."""
    vec.comm = new.comm
    vec.layout = new.layout
    vec.n = new.n
    vec.data = new.data
    return vec


def replant_vectors(comm_new, mat_new, *vecs):
    """Move Vecs onto ``comm_new`` through the host, each rebound in
    place (the in-memory path of an operator without a checkpoint)."""
    from ..core.vec import Vec
    return [rebind_vec(v, Vec.from_global(comm_new, v.to_numpy(),
                                          dtype=mat_new.dtype,
                                          layout=mat_new.layout))
            for v in vecs]


def warm(ksp, widths=()):
    """Run the rebuilt session once at zero cost: a zero RHS converges at
    iteration 0, so each solve is one set-up and no iteration; ``widths``
    adds batched blocks of those widths."""
    from ..core.vec import Vec
    mat = ksp.get_operators()[0]
    comm = mat.comm
    n = int(mat.shape[0])
    x0 = Vec(comm, n, dtype=mat.dtype, layout=mat.layout)
    b0 = Vec(comm, n, dtype=mat.dtype, layout=mat.layout)
    ksp.solve(b0, x0)
    from ..parallel.mesh import numpy_dtype
    for w in sorted(set(int(w) for w in widths if int(w) > 0)):
        ksp.solve_many(np.zeros((n, w), dtype=numpy_dtype(mat.dtype)))
    return ksp


def shrink_solve_session(ksp, comm_new, *, checkpoint_path=None, b=None,
                         x=None, B=None, X=None, many=False):
    """Reshard a failed solve onto ``comm_new`` and rebuild the session
    (JAX ``elastic.py:300``): the state moves through the checkpoint when
    one was written, else through the host; one RHS rebinds the caller's
    ``b``/``x`` in place, a block restores into the caller's ``X``. Returns
    the checkpoint's iteration (0 when unknown); ``ValueError`` when the
    operator cannot be rebuilt there."""
    mat = ksp.get_operators()[0]
    iteration = 0
    if many:
        if checkpoint_path is not None:
            from ..utils.checkpoint import load_solve_state_many
            mat2, X2, _B2, iteration = load_solve_state_many(
                checkpoint_path, comm_new)
            X[...] = X2.astype(X.dtype, copy=False)
        else:
            mat2 = rebuild_operator(mat, comm_new)
        rebuild_ksp(ksp, mat2)
        return iteration
    if checkpoint_path is not None:
        from ..utils.checkpoint import load_solve_state
        mat2, x2, b2, iteration = load_solve_state(checkpoint_path,
                                                   comm_new)
        rebuild_ksp(ksp, mat2)
        rebind_vec(x, x2)
        rebind_vec(b, b2)
    else:
        mat2 = rebuild_operator(mat, comm_new)
        rebuild_ksp(ksp, mat2)
        replant_vectors(comm_new, mat2, x, b)
    return iteration


def regrow_solve_session(ksp, comm_new, *, checkpoint_path=None, b=None,
                         x=None, B=None, X=None, many=False):
    """The upward twin of :func:`shrink_solve_session` after a heal: the
    same resharding (the checkpoint format records no shard count)."""
    return shrink_solve_session(ksp, comm_new,
                                checkpoint_path=checkpoint_path,
                                b=b, x=x, B=B, X=X, many=many)
