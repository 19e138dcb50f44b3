"""The port's fused whole-solve program (``-ksp_megasolve``,
``solvers/megasolve.py``) against the JAX package's.

The same problem (the 16^3 Poisson system, ``b`` from a numpy seed) goes
through both packages' fused programs: ``KSP`` with cg (general route and
the stencil fast path), pipecg and sstep (s = 4), with PC jacobi, none and
mg, one RHS and ``solve_many`` blocks, a nonzero guess; ``RefinedKSP`` with
an f64, f32 and bf16 inner stencil and an fp64 outer stencil, PC jacobi and
mg, and its block form. On the CPU the program's pieces run uncaptured:
the plain version of the CUDA graphs. The JAX programs run with their disk
cache off (``TPU_SOLVE_AOT=0``) and are cached per module in
``_JAX_RESULTS``.

Tolerances, with their reasons:

* fp64: outer steps, total inner iterations and reasons equal; ``x`` within
  1e-10 of the largest entry;
* f32 (cg, pipecg): steps, iterations and reasons equal; ``x`` within 1e-4
  of the largest entry (fp32 sums fold in another order, which the
  iteration amplifies);
* f32 sstep: the reason equal, the steps within one and the iterations
  inside the JAX package's own spread across 1, 2 and 4 devices at this
  size (38-43; ``ROADMAP.md`` Queue C);
* bf16 refinement: the reason equal, outer steps within one, inner
  iterations within 10% (the bands of ``tests/test_torch_refine.py``),
  the fp64 relative residual at most ``1.05 rtol``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson3d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers.refine import (  # noqa: E402
    RefinedKSP as JaxRefinedKSP)
from mpi_petsc4py_example_tpu.utils.dtypes import (  # noqa: E402
    inner_precision_dtype as jax_dtype)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import megasolve  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.dtypes import (  # noqa: E402
    inner_precision_dtype)

CR = pt.ConvergedReason
NX = 16
A = poisson3d_csr(NX)
B = A @ np.random.default_rng(4).random(A.shape[0])
BLOCK = np.stack([B, A @ np.random.default_rng(5).random(A.shape[0]),
                  np.random.default_rng(6).standard_normal(A.shape[0])], 1)
DT = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}
_JAX_RESULTS: dict = {}


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    pt.global_options().clear()
    yield
    pt.global_options().clear()
    megasolve.clear_cache()


def _ksp(pkg, ndev, ksp_type, pc_type, dt, fast=False):
    if pkg is tps:
        comm = tps.DeviceComm(n_devices=ndev)
        op = JaxStencil(comm, NX, NX, NX, dtype=DT[dt][0])
    else:
        comm = pt.DeviceComm(ndev, device="cpu")
        op = pt.StencilPoisson3D(comm, NX, dtype=DT[dt][1])
    ksp = pkg.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=1e-8 if dt == "f64" else 1e-5, max_it=500)
    ksp.megasolve = True
    ksp.megasolve_stencil_fastpath = fast
    ksp.sstep_s = 4
    return ksp, op


def _run(pkg, ndev, ksp_type, pc_type, dt, fast=False, guess=False,
         many=False):
    ksp, op = _ksp(pkg, ndev, ksp_type, pc_type, dt, fast)
    if many:
        X = np.zeros(BLOCK.shape)
        res = ksp.solve_many(BLOCK.astype(DT[dt][0]), X)
        return (list(res.iterations), [int(r) for r in res.reasons],
                res.megasolve_steps, X.astype(np.float64), res)
    x, bv = op.get_vecs()
    bv.set_global(B)
    if guess:
        ksp.set_initial_guess_nonzero(True)
        x.set_global(np.linspace(0.0, 1.0, A.shape[0]))
    res = ksp.solve(bv, x)
    return (res.iterations, int(res.reason), res.megasolve_steps,
            x.to_numpy().astype(np.float64), res)


def _jax(*key):
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = _run(tps, *key)[:4]
    return _JAX_RESULTS[key]


def _assert_match(j, p, dt, ksp_type):
    if dt == "f32" and ksp_type == "sstep":
        assert p[1] == j[1]
        assert abs(p[2] - j[2]) <= 1
        assert all(38 <= i <= 43 for i in np.atleast_1d(p[0]))
        return
    assert p[:3] == j[:3]
    tol = 1e-10 if dt == "f64" else 1e-4
    assert np.abs(p[3] - j[3]).max() <= tol * np.abs(j[3]).max()


KSP_CASES = [  # (ksp_type, pc, fast path, dtype, shard counts)
    ("cg", "jacobi", False, "f64", (1, 2, 4)),
    ("cg", "jacobi", True, "f64", (1, 2, 4)),
    ("cg", "none", True, "f32", (2,)),
    ("cg", "jacobi", False, "f32", (2,)),
    ("cg", "mg", False, "f64", (1, 4)),
    ("cg", "mg", False, "f32", (2,)),
    ("pipecg", "jacobi", False, "f64", (1, 4)),
    ("pipecg", "jacobi", False, "f32", (2,)),
    ("sstep", "jacobi", False, "f64", (1, 4)),
    ("sstep", "jacobi", False, "f32", (1, 2, 4)),
]


@pytest.mark.parametrize("ksp_type,pc_type,fast,dt,ndev", [
    (t, p, f, d, n) for t, p, f, d, ns in KSP_CASES for n in ns])
def test_ksp_megasolve_matches_jax(ksp_type, pc_type, fast, dt, ndev):
    j = _jax(ndev, ksp_type, pc_type, dt, fast)
    p = _run(pt, ndev, ksp_type, pc_type, dt, fast)
    _assert_match(j, p, dt, ksp_type)
    res = p[4]
    assert res.converged and res.graph is False
    # 1 + steps (chunks + 1) runs of the pieces, one read each, one more
    # for the result
    assert res.host_syncs == res.replays + 1
    chunks = res.replays - 1 - res.megasolve_steps
    assert chunks * megasolve.MEGASOLVE_CHUNK - res.masked_steps == \
        res.iterations or ksp_type == "sstep"


@pytest.mark.parametrize("ksp_type,fast,ndev", [
    ("cg", False, 2), ("cg", True, 1), ("cg", True, 4), ("pipecg", False, 2),
    ("sstep", False, 2)])
def test_ksp_megasolve_many_matches_jax(ksp_type, fast, ndev):
    """k = 3 columns (one a random right-hand side) in one fused block."""
    j = _jax(ndev, ksp_type, "jacobi", "f64", fast, False, True)
    p = _run(pt, ndev, ksp_type, "jacobi", "f64", fast, many=True)
    _assert_match(j, p, "f64", ksp_type)
    assert p[4].converged


@pytest.mark.parametrize("fast", [False, True])
def test_nonzero_guess_matches_jax(fast):
    j = _jax(2, "cg", "jacobi", "f64", fast, True)
    p = _run(pt, 2, "cg", "jacobi", "f64", fast, guess=True)
    _assert_match(j, p, "f64", "cg")


def _refined(pkg, ndev, prec, pc_type, ksp_type="cg"):
    if pkg is tps:
        comm = tps.DeviceComm(n_devices=ndev)
        rk = JaxRefinedKSP().create(comm)
        inner = JaxStencil(comm, NX, NX, NX, dtype=jax_dtype(prec))
        outer = JaxStencil(comm, NX, NX, NX, dtype=np.float64)
    else:
        comm = pt.DeviceComm(ndev, device="cpu")
        rk = pt.RefinedKSP().create(comm)
        inner = pt.StencilPoisson3D(comm, NX,
                                    dtype=inner_precision_dtype(prec))
        outer = pt.StencilPoisson3D(comm, NX, dtype=torch.float64)
    rk.set_inner_precision(prec)
    rk.set_operators(A, inner_op=inner, outer_op=outer)
    rk.set_type(ksp_type)
    rk.get_pc().set_type(pc_type)
    rk.set_tolerances(rtol=1e-10)
    rk.megasolve = True
    return rk


def _refined_run(pkg, ndev, prec, pc_type, ksp_type="cg", many=False):
    rk = _refined(pkg, ndev, prec, pc_type, ksp_type)
    x, res = rk.solve_many(BLOCK) if many else rk.solve(B)
    return (res.iterations, int(res.reason), rk.refine_steps,
            np.asarray(x, np.float64), res)


@pytest.mark.parametrize("prec,pc_type,ndev,ksp_type", [
    ("f64", "jacobi", 1, "cg"), ("f64", "mg", 4, "cg"),
    ("f32", "jacobi", 2, "cg"), ("f32", "mg", 1, "cg"),
    ("f32", "mg", 4, "cg"), ("f64", "jacobi", 2, "pipecg"),
    ("bf16", "jacobi", 2, "cg"), ("bf16", "mg", 1, "cg"),
    ("bf16", "mg", 4, "cg")])
def test_refined_megasolve_matches_jax(prec, pc_type, ndev, ksp_type):
    key = ("refined", ndev, prec, pc_type, ksp_type)
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = _refined_run(tps, *key[1:])[:4]
    j = _JAX_RESULTS[key]
    p = _refined_run(pt, ndev, prec, pc_type, ksp_type)
    assert p[1] == j[1] == CR.CONVERGED_RTOL
    if prec == "bf16":
        assert abs(p[2] - j[2]) <= 1
        assert abs(p[0] - j[0]) <= 0.1 * j[0]
    else:
        assert (p[0], p[2]) == (j[0], j[2])
        tol = 1e-12 if prec == "f64" else 1e-9
        assert np.abs(p[3] - j[3]).max() <= tol * np.abs(j[3]).max()
    rel = np.linalg.norm(B - A @ p[3]) / np.linalg.norm(B)
    assert rel <= 1.05e-10
    assert p[4].megasolve_steps == p[2] and p[4].graph is False


@pytest.mark.parametrize("prec", ["f32", "bf16"])
def test_refined_megasolve_many_matches_jax(prec):
    key = ("refined_many", prec)
    if key not in _JAX_RESULTS:
        _JAX_RESULTS[key] = _refined_run(tps, 2, prec, "jacobi",
                                         many=True)[:4]
    j = _JAX_RESULTS[key]
    p = _refined_run(pt, 2, prec, "jacobi", many=True)
    assert p[1] == j[1] == CR.CONVERGED_RTOL
    if prec == "f32":
        assert (p[0], p[2]) == (j[0], j[2])
    else:
        assert abs(p[2] - j[2]) <= 1
        assert abs(p[0] - j[0]) <= 0.1 * j[0]
    for c in range(BLOCK.shape[1]):
        rel = (np.linalg.norm(BLOCK[:, c] - A @ p[3][:, c])
               / np.linalg.norm(BLOCK[:, c]))
        assert rel <= 1.05e-10


def test_refined_sstep_inner_raises_naming_item_6():
    """An sstep inner solve arms -ksp_sstep_auto_replacement 25 (the guard,
    as in JAX ``refine.py:177-201``): the fused refinement, which raised
    before the guarded modes were ported, runs the guarded program as the
    JAX package does: the reason and the outer steps equal, the inner
    iterations within 10% (fp32 sums), the fp64 relative residual at most
    ``1.05 rtol``."""
    j = _refined_run(tps, 1, "f32", "jacobi", "sstep")
    p = _refined_run(pt, 1, "f32", "jacobi", "sstep")
    assert p[1] == j[1] == CR.CONVERGED_RTOL and p[2] == j[2]
    assert abs(p[0] - j[0]) <= 0.1 * j[0]
    assert np.linalg.norm(B - A @ p[3]) / np.linalg.norm(B) <= 1.05e-10


@pytest.mark.parametrize("chunk", [1, 7])
def test_chunk_length_changes_no_bit(chunk):
    """Masked steps past an inner loop's end change no carry: chunks of 1,
    7 and the default give the same bits, every count but the masked
    steps and the replays equal."""
    comm = pt.DeviceComm(2, device="cpu")
    out = []
    for c in (chunk, megasolve.MEGASOLVE_CHUNK):
        for ksp_type, pc_type, prec in (("cg", "mg", "bf16"),
                                        ("pipecg", "jacobi", "f64"),
                                        ("sstep", "jacobi", "f64")):
            inner = pt.StencilPoisson3D(
                comm, NX, dtype=inner_precision_dtype(prec))
            outer = pt.StencilPoisson3D(comm, NX, dtype=torch.float64)
            pc = pt.PC(comm).set_type(pc_type)
            pc.set_operators(inner)
            prog = megasolve._build(
                comm, ksp_type, pc, inner, None if prec == "f64" else outer,
                nrhs=None, chunk=c)
            b = torch.from_numpy(B).view(2, -1)
            r = prog(b, None, 1e-10, 0.0, 1e-6 if prec == "f64" else 0.03,
                     1e5, 200, 20, CR.DIVERGED_BREAKDOWN)
            out.append((r.x, r.steps, r.iters, r.rnorm, r.reason))
    for a, b in zip(out[:3], out[3:]):
        assert torch.equal(a[0], b[0]) and a[1:] == b[1:]


def test_ineligible_configurations_route_as_jax():
    """No fused equivalent, the unfused path, in both packages alike:
    non-CG types, a monitor, a history, a norm type other than the
    default, ``unroll`` above 1; a null space."""
    def both(mutate):
        got = []
        for pkg in (tps, pt):
            ksp, op = _ksp(pkg, 2, "cg", "jacobi", "f64")
            mutate(ksp, pkg)
            got.append(ksp._megasolve_eligible())
        return got

    cases = [
        lambda k, pkg: None,
        lambda k, pkg: k.set_type("gmres"),
        lambda k, pkg: k.set_type("bcgs"),
        lambda k, pkg: k.set_monitor(lambda *a: None),
        lambda k, pkg: k.set_convergence_history(),
        lambda k, pkg: k.set_norm_type("natural"),
        lambda k, pkg: setattr(k, "unroll", 2),
        lambda k, pkg: setattr(k, "megasolve", False),
    ]
    routes = [both(c) for c in cases]
    assert routes[0] == [True, True]
    for jr, pr in routes:
        assert jr == pr
    # a monitored solve runs the unfused program and hears every norm
    ksp, op = _ksp(pt, 2, "cg", "jacobi", "f64")
    seen = []
    ksp.set_monitor(lambda k, it, rn: seen.append(it))
    x, bv = op.get_vecs()
    bv.set_global(B)
    res = ksp.solve(bv, x)
    assert res.converged and not hasattr(res, "megasolve_steps")
    assert seen == list(range(res.iterations + 1))


def test_null_space_routes_unfused_like_jax():
    got = []
    for pkg in (tps, pt):
        comm = (tps.DeviceComm(n_devices=2) if pkg is tps
                else pt.DeviceComm(2, device="cpu"))
        m = pkg.Mat.from_scipy(comm, A)
        m.set_nullspace(pkg.NullSpace(constant=True))
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(m)
        ksp.set_type("cg")
        ksp.megasolve = True
        got.append(ksp._megasolve_eligible())
    assert got == [False, False]


def test_forced_fastpath_on_flat_operator_raises():
    comm = pt.DeviceComm(2, device="cpu")
    m = pt.Mat.from_scipy(comm, A)
    pc = pt.PC(comm).set_type("jacobi")
    pc.set_operators(m)
    assert not megasolve.megasolve_stencil_supported("cg", pc, m)
    with pytest.raises(ValueError, match="stencil"):
        megasolve.build_megasolve_program(comm, "cg", pc, m, m,
                                          stencil_fastpath=True)
    op = pt.StencilPoisson3D(comm, NX)
    pc.set_operators(op)
    assert megasolve.megasolve_stencil_supported("cg", pc, op, nrhs=4)
    assert not megasolve.megasolve_stencil_supported("pipecg", pc, op)
    assert not megasolve.megasolve_stencil_supported("cg", pc, op,
                                                     guard=True)


@pytest.mark.parametrize("flags", [
    ["-ksp_abft"], ["-ksp_residual_replacement", "10"],
    ["-ksp_type", "pipecg", "-ksp_pipeline_auto_replacement", "10"]])
def test_guard_flags_raise_naming_item_6_before_capture(flags):
    """The guard flags with ``-ksp_megasolve``, which raised before the
    fused guarded modes were ported: the fused guarded program runs (one
    program in the cache) and matches the JAX package's fp64 solve: the
    iterations, reason and steps equal, the ABFT checks and replacements
    equal, ``x`` within 1e-10 of its largest entry."""
    out = []
    for pkg in (tps, pt):
        pkg.global_options().clear()
        pkg.init(["prog", "-ksp_megasolve", *flags])
        ksp, op = _ksp(pkg, 1, "cg", "jacobi", "f64")
        ksp.set_from_options()
        assert ksp.megasolve and ksp._guard_requested()
        x, bv = op.get_vecs()
        bv.set_global(B)
        res = ksp.solve(bv, x)
        out.append((res.iterations, int(res.reason), res.megasolve_steps,
                    res.abft_checks, res.residual_replacements,
                    x.to_numpy()))
        pkg.global_options().clear()
    j, p = out
    assert p[:5] == j[:5] and p[1] > 0
    assert np.abs(p[5] - j[5]).max() <= 1e-10 * np.abs(j[5]).max()
    assert len(megasolve._CACHE) == 1


def test_program_cache_follows_the_pc_operator():
    """A repeated solve takes the program the first one built (jacobi's
    inverse diagonal exists before the key is read); a PC operator whose
    values change gets a new program, whose solve equals a fresh KSP's."""
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.Mat.from_scipy(comm, A)
    pmat = pt.Mat.from_scipy(comm, A)

    def solve(ksp):
        x, bv = op.get_vecs()
        bv.set_global(B)
        res = ksp.solve(bv, x)
        return res.iterations, res.megasolve_steps, x.to_numpy()

    def fresh():
        ksp = pt.KSP().create(comm)
        ksp.set_operators(op, pmat)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-8, max_it=500)
        ksp.megasolve = True
        return ksp

    ksp = fresh()
    first = solve(ksp)
    assert solve(ksp)[:2] == first[:2] and len(megasolve._CACHE) == 1
    import scipy.sparse as sp
    pmat.axpy(1.0, pt.Mat.from_scipy(comm, sp.diags(
        np.linspace(0.0, 30.0, A.shape[0])).tocsr()))
    got = solve(ksp)
    assert len(megasolve._CACHE) == 2
    megasolve.clear_cache()
    want = solve(fresh())
    assert got[:2] == want[:2] and np.array_equal(got[2], want[2])
    assert got[0] != first[0]


def test_megasolve_flags_read_from_options():
    pt.init(["prog", "-ksp_megasolve", "-ksp_megasolve_stencil_fastpath",
             "-ksp_type", "cg"])
    ksp, op = _ksp(pt, 1, "cg", "jacobi", "f64")
    ksp.megasolve = ksp.megasolve_stencil_fastpath = False
    ksp.set_from_options()
    assert ksp.megasolve and ksp.megasolve_stencil_fastpath
    x, bv = op.get_vecs()
    bv.set_global(B)
    res = ksp.solve(bv, x)
    assert res.converged and res.megasolve_steps == 1


def test_capture_is_decided_by_the_communicator():
    """CUDA graphs on a CUDA device in one process, never over gloo or
    across processes; the CPU runs the pieces uncaptured."""
    from types import SimpleNamespace as NS
    cuda = torch.device("cuda")
    assert not megasolve._capturable(pt.DeviceComm(2, device="cpu"))
    assert megasolve._capturable(NS(device=cuda, nprocs=1))
    assert megasolve._capturable(NS(device=cuda, nprocs=1, backend="nccl"))
    assert not megasolve._capturable(NS(device=cuda, nprocs=2,
                                        backend="nccl"))
    assert not megasolve._capturable(NS(device=cuda, nprocs=1,
                                        backend="gloo"))
