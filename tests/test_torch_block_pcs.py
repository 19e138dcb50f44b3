"""The block preconditioners of the PyTorch port against the JAX package:
PC sor/ssor (``-pc_sor_omega``), ilu/icc (``-pc_factor_fill``) and asm
(``-pc_asm_overlap``), their block inverses, CG/GMRES solves through them on
1/2/4/8 shards, their options, ``configure_pc`` and the batched route.

Both packages solve the same numpy problem in fp64: iterations and reasons
equal, iterates within 1e-10. The operators are cuts of the benchmark's
2D configurations: ``poisson2d_csr`` (cfg3's operator) and ``convdiff2d``
(cfg4's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    convdiff2d)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson2d_csr)
from mpi_petsc4py_example_tpu_torch.utils.carry import (  # noqa: E402
    configure_pc, from_host_csr)

# (type, tunable, value)
BLOCK_PCS = [("sor", "sor_omega", 1.0), ("sor", "sor_omega", 1.5),
             ("ssor", "sor_omega", 0.8), ("ilu", "factor_fill", 10.0),
             ("ilu", "factor_fill", 1.5), ("icc", "factor_fill", 10.0),
             ("asm", "asm_overlap", 0), ("asm", "asm_overlap", 1),
             ("asm", "asm_overlap", 3)]


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _pcs(A, ndev, pc_type, tunable, value):
    jcomm = tps.DeviceComm(n_devices=ndev)
    jpc = tps.PC(jcomm).set_type(pc_type)
    setattr(jpc, tunable, value)
    jpc.set_up(tps.Mat.from_scipy(jcomm, A))
    pc = pt.PC(pt.DeviceComm(ndev, device="cpu")).set_type(pc_type)
    setattr(pc, tunable, value)
    pc.set_up(pt.Mat.from_scipy(pc.comm, A))
    return jpc, pc


@pytest.mark.parametrize("ndev", [1, 3, 4])
@pytest.mark.parametrize("pc_type,tunable,value", BLOCK_PCS)
def test_block_inverses_match_jax(pc_type, tunable, value, ndev):
    A = convdiff2d(10)                # n = 100: 3 shards leave padding
    jpc, pc = _pcs(A, ndev, pc_type, tunable, value)
    assert pc.kind == jpc.kind
    assert pc.program_key() == jpc.program_key()
    inv = pc._arrays[0].numpy()
    jinv = np.asarray(jpc.device_arrays()[0]).reshape(inv.shape)
    np.testing.assert_allclose(inv, jinv, rtol=0, atol=1e-12)


def _solve_both(A, b, ndev, ksp_type, pc_type, options):
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=ndev)),
                      (pt, pt.DeviceComm(ndev, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type(ksp_type)
        ksp.get_pc().set_type(pc_type)
        ksp.set_tolerances(rtol=1e-10, atol=0.0, max_it=2000)
        pkg.init(["prog", *options])
        ksp.set_from_options()
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((res, x.to_numpy(), ksp.get_pc()))
    tps.global_options().clear()
    return out


SOLVES = [("poisson", "cg", "ssor", ("-pc_sor_omega", "1.2")),
          ("poisson", "cg", "sor", ()),
          ("convdiff", "gmres", "sor", ("-pc_sor_omega", "1.4")),
          ("convdiff", "gmres", "ilu", ("-pc_factor_fill", "2")),
          ("poisson", "gmres", "icc", ()),
          ("convdiff", "gmres", "asm", ()),
          ("convdiff", "gmres", "asm", ("-pc_asm_overlap", "4"))]


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("op,ksp_type,pc_type,options", SOLVES)
def test_krylov_through_block_pcs_matches_jax(op, ksp_type, pc_type,
                                              options, ndev):
    A = poisson2d_csr(16) if op == "poisson" else convdiff2d(16, beta=0.4)
    b = np.random.default_rng(3).standard_normal(A.shape[0])
    (jres, jx, jpc), (res, x, pc) = _solve_both(A, b, ndev, ksp_type,
                                                pc_type, options)
    for name in ("sor_omega", "asm_overlap", "factor_fill"):
        assert getattr(pc, name) == getattr(jpc, name)
    assert jres.converged
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason))
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=1e-10 * max(np.abs(jx).max(), 1.0))


@pytest.mark.parametrize("pc_type,batched", [("sor", True), ("ilu", True),
                                             ("asm", False)])
def test_solve_many_through_block_pcs(pc_type, batched):
    """sor/ilu take bjacobi's batched apply; asm, which has none (as in the
    JAX package), solves the columns one by one. Each column equals its
    single solve."""
    A = poisson2d_csr(12)
    B = np.random.default_rng(5).random((A.shape[0], 3))
    comm = pt.DeviceComm(4, device="cpu")
    m = pt.Mat.from_scipy(comm, A)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(m)
    ksp.set_type("cg")
    ksp.get_pc().set_type(pc_type)
    # restricted Schwarz with overlap is unsymmetric, so CG takes it without
    ksp.get_pc().asm_overlap = 0
    ksp.set_tolerances(rtol=1e-10, atol=0.0)
    res = ksp.solve_many(B)
    assert res.converged
    has_many = ksp.get_pc().local_apply_many(comm, A.shape[0]) is not None
    assert has_many is batched
    assert (res.host_syncs == 1 + max(res.iterations)) is batched
    for j in range(B.shape[1]):
        x, b = m.get_vecs()
        b.set_global(B[:, j])
        single = ksp.solve(b, x)
        assert abs(single.iterations - res.iterations[j]) <= 1
        np.testing.assert_allclose(x.to_numpy(), res.X[:, j], rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("pc_type,attrs", [
    ("asm", {"asm_overlap": 2}),
    ("sor", {"sor_omega": 1.3}),
    ("ilu", {"factor_fill": 4.0}),
    ("bjacobi", {"bjacobi_blocks": 8, "setup_device": "1"}),
])
def test_configure_pc_carries_block_pcs(pc_type, attrs):
    """asm travels in its ``program_key`` (``("asm", overlap)``); the
    tunables the key does not hold, and the block type behind kind
    'bjacobi', travel beside it."""
    jcomm = tps.DeviceComm(n_devices=2)
    A = poisson2d_csr(8)
    jpc = tps.PC(jcomm).set_type(pc_type)
    for name, value in attrs.items():
        setattr(jpc, name, value)
    jpc.set_up(tps.Mat.from_scipy(jcomm, A))
    key = jpc.program_key() if pc_type == "asm" else (pc_type,)
    tunables = {k: v for k, v in attrs.items() if k != "asm_overlap"}
    pc = configure_pc(pt.PC(pt.DeviceComm(2, device="cpu")), key,
                      **tunables)
    m, _, _ = from_host_csr(pc.comm, A.shape, (A.indptr, A.indices, A.data),
                            np.ones(A.shape[0]))
    pc.set_up(m)
    assert pc.program_key() == jpc.program_key()
    for name, value in attrs.items():
        assert getattr(pc, name) == value
    np.testing.assert_allclose(
        pc._arrays[0].numpy(),
        np.asarray(jpc.device_arrays()[0]).reshape(pc._arrays[0].shape),
        rtol=0, atol=1e-12)


def test_configure_pc_refuses_unknown_tunable():
    with pytest.raises(ValueError, match="tunable"):
        configure_pc(pt.PC(), ("sor",), omega=1.0)


@pytest.mark.parametrize("pc_type,item", [("gamg", 7), ("amg", 7),
                                          ("shell", 3), ("composite", 3)])
def test_unported_pc_types_name_their_item(pc_type, item):
    """Every JAX PC type is either ported (the Queue A items that landed:
    shell and composite came with item 3) or refused with
    ``NotImplementedError`` naming the item that brings it."""
    assert pc_type in tps.PC(None).set_type(pc_type).get_type()
    if item <= 3:
        assert pt.PC().set_type(pc_type).get_type() == pc_type
        return
    with pytest.raises(NotImplementedError, match=f"Queue A item {item}"):
        pt.PC().set_type(pc_type)


def test_block_pc_refusals_like_jax():
    A = convdiff2d(6)
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=2)),
                      (pt, pt.DeviceComm(2, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        pc = pkg.PC(comm).set_type("sor")
        pc.sor_omega = 2.0
        with pytest.raises(ValueError, match="omega"):
            pc.set_up(M)
        pc = pkg.PC(comm).set_type("asm")
        pc.asm_overlap = 19          # > 18 local rows
        with pytest.raises(ValueError, match="overlap"):
            pc.set_up(M)
    op = pt.StencilPoisson3D(pt.DeviceComm(device="cpu"), 4)
    for t in ("sor", "ilu", "asm"):
        with pytest.raises(ValueError, match="assembled"):
            pt.PC().set_type(t).set_up(op)
