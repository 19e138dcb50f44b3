"""The silent-corruption guard of ROADMAP.md Queue A item 6 against the JAX
package: the ABFT checksums, the guarded cg/pipecg/sstep loops (one RHS and
batched), the trace-time fault sites and their detection.

The cases of ``tests/test_sdc.py``, each run through both packages on the
same seeded numpy problem in fp64 (``poisson2d_csr(10)``, the 8x12x16
stencil), on 1, 2 and 4 shards: iterations, reasons, the detector and the
detection iteration, ``abft_checks`` and ``residual_replacements`` equal,
iterates (the rolled-back one too) within 1e-12 relative. One count differs
by design and is held as such: on the stencil fast path the JAX package
counts a PC channel (``1 + 2 its``) its loop never checks (the Jacobi apply
is a scalar there); the port counts ``1 + its`` (ROADMAP.md Queue C).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.resilience import abft as jabft  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import abft  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import cg_plans  # noqa: E402

RTOL = 1e-10
GRID = (8, 12, 16)
X_TOL = 1e-12


@pytest.fixture(autouse=True)
def _clean():
    faults.reset()
    jfaults.reset()
    faults.heal()
    pt.global_options().clear()
    yield
    assert not faults.active() and not jfaults.active()
    pt.global_options().clear()


def _problem(pkg, nsh, op="mat", typ="cg", pc="jacobi", abft_on=True, rr=8):
    if pkg == "jax":
        comm = tps.DeviceComm(n_devices=nsh)
        M = (JaxStencil(comm, *GRID) if op == "stencil"
             else tps.Mat.from_scipy(comm, poisson2d_csr(10)))
        ksp = tps.KSP().create(comm)
    else:
        comm = pt.DeviceComm(nsh, device="cpu")
        M = (pt.StencilPoisson3D(comm, *GRID) if op == "stencil"
             else pt.Mat.from_scipy(comm, poisson2d_csr(10)))
        ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(typ)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=RTOL)
    ksp.abft = abft_on
    ksp.residual_replacement = rr
    return ksp, M


def _run(pkg, nsh, spec=None, many=False, **kw):
    """One solve (``many``: a 3-column block) under ``spec``: the result's
    fields, or the detection's, and the iterate (rolled back on
    detection)."""
    ksp, M = _problem(pkg, nsh, **kw)
    inj = jfaults.inject_faults if pkg == "jax" else faults.inject_faults
    n = M.shape[0]
    rng = np.random.default_rng(0)
    b = rng.random(n)
    out = {}
    X = np.zeros((n, 3))
    if many:
        B = np.stack([b, 1e-3 * rng.random(n), rng.random(n)], axis=1)
    else:
        x, bv = M.get_vecs()
        bv.set_global(b)
    try:
        with (inj(spec) if spec else _null()):
            if many:
                res = ksp.solve_many(B, X)
                out.update(its=list(res.iterations),
                           reason=[int(r) for r in res.reasons])
            else:
                res = ksp.solve(bv, x)
                out.update(its=res.iterations, reason=int(res.reason))
        out.update(checks=res.abft_checks, rrc=res.residual_replacements,
                   sdc=res.sdc_detections)
    except (tps.SilentCorruptionError, pt.SilentCorruptionError) as e:
        out.update(detector=e.detector, det_it=e.iteration,
                   cls=e.failure_class, retriable=e.retriable)
    out["x"] = X.copy() if many else x.to_numpy()
    return out


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def _same(a, p, checks=True):
    xa, xp = a.pop("x"), p.pop("x")
    if not checks:
        a.pop("checks", None), p.pop("checks", None)
    assert a == p
    scale = max(np.abs(xa).max(), 1e-300)
    np.testing.assert_allclose(xp, xa, rtol=0, atol=X_TOL * scale)


# ---------------------------------------------------------------- checksums

class TestColumnChecksum:
    def test_ell_checksum_matches_dense_and_jax(self):
        rng = np.random.default_rng(3)
        A = (sp.random(96, 96, density=0.05, random_state=rng, format="csr")
             + sp.eye(96, format="csr") * 4).tocsr()
        M = pt.Mat.from_scipy(pt.DeviceComm(2, device="cpu"), A)
        c = abft.column_checksum(M)
        jc = jabft.column_checksum(tps.Mat.from_scipy(
            tps.DeviceComm(n_devices=2), A))
        np.testing.assert_allclose(c, np.asarray(A.sum(axis=0)).ravel(),
                                   rtol=1e-14)
        np.testing.assert_array_equal(c, jc)

    @pytest.mark.parametrize("nsh", [1, 2, 4])
    def test_stencil_checksum_bit_equal_to_jax(self, nsh):
        op = pt.StencilPoisson3D(pt.DeviceComm(nsh, device="cpu"), *GRID)
        jop = JaxStencil(tps.DeviceComm(n_devices=nsh), *GRID)
        c = op.column_checksum_host()
        np.testing.assert_array_equal(c, jop.column_checksum_host())
        assert set(np.unique(c)) <= {0.0, 1.0, 2.0, 3.0}
        # the boundary index list sums each shard's <c, u> exactly as c
        comm = op.comm
        u = torch.from_numpy(np.random.default_rng(nsh).standard_normal(
            (nsh,) + op.grid3d))
        idx = op.checksum_boundary(comm)
        got = torch.stack([u[i].reshape(-1)[idx[i]].sum()
                           for i in range(nsh)])
        want = (torch.from_numpy(c).reshape(nsh, -1)
                * u.reshape(nsh, -1)).sum(1)
        torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13)

    def test_checksum_cache_invalidates_on_mutation(self):
        A = poisson2d_csr(6)
        M = pt.Mat.from_scipy(pt.DeviceComm(device="cpu"), A)
        c1 = abft.column_checksum(M).copy()
        M.scale(2.0)
        np.testing.assert_allclose(abft.column_checksum(M), 2.0 * c1)

    @pytest.mark.parametrize("kind", ["none", "jacobi", "bjacobi"])
    def test_pc_checksum_kinds(self, kind):
        A = poisson2d_csr(6)
        M = pt.Mat.from_scipy(pt.DeviceComm(device="cpu"), A)
        pc = pt.PC(M.comm)
        pc.set_type(kind)
        pc.set_operators(M)
        pc.set_up(M)
        jM = tps.Mat.from_scipy(tps.DeviceComm(n_devices=1), A)
        jpc = tps.PC(jM.comm)
        jpc.set_type(kind)
        jpc.set_operators(jM)
        jpc.set_up(jM)
        got, want = abft.pc_checksum(pc, M), jabft.pc_checksum(jpc, jM)
        assert (got is None) == (want is None) == (kind == "bjacobi")
        if got is not None:
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
    def test_bitflip_hits_jax_element_and_bit(self, dtype):
        """``apply_silent_fault``'s bitflip: element 0 of each shard, the
        exponent bit of JAX ``_bitflip`` (a zero word becomes 1.0)."""
        vals = np.array([[1.5, -2.0, 3.0], [0.0, 4.0, 5.0]], np.float32)
        jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.dtype(dtype)
        tdt = getattr(torch, dtype)
        fault = faults.parse_spec("spmv.result=bitflip")[0]
        got = abft.apply_silent_fault(fault, torch.tensor(vals, dtype=tdt))
        for i in range(2):
            want = np.asarray(jabft._bitflip(jnp.asarray(vals[i], jdt)),
                              np.float32)
            np.testing.assert_array_equal(
                got[i].to(torch.float32).numpy(), want)
        scale = faults.parse_spec("pc.apply=scale:mag=0.5")[0]
        np.testing.assert_array_equal(
            abft.apply_silent_fault(scale, torch.tensor(vals)).numpy(),
            vals * 1.5)

    def test_tolerance_eps_is_the_storage_dtype(self):
        for dt, jdt in ((torch.float32, np.float32),
                        (torch.float64, np.float64),
                        (torch.bfloat16, jnp.bfloat16)):
            assert abft.checksum_tolerance_dtype(dt) == \
                jabft.checksum_tolerance_dtype(jdt)
        assert abft.DEFAULT_ABFT_TOL == jabft.DEFAULT_ABFT_TOL


# ---------------------------------------------------------- the control case

def test_scale_corruption_sails_through_unguarded():
    """Without the guard a silent scale corruption of every loop apply
    converges on the recurrence's word, far from the answer, in both
    packages alike; with it, the same fault is detected."""
    A = poisson2d_csr(10)
    spec = "spmv.result=scale:mag=1e-3:times=*"
    a = _run("jax", 2, spec, abft_on=False, rr=0)
    p = _run("torch", 2, spec, abft_on=False, rr=0)
    b = np.random.default_rng(0).random(A.shape[0])
    rtrue = np.linalg.norm(b - A @ p["x"]) / np.linalg.norm(b)
    assert p["reason"] > 0 and rtrue > 1e3 * RTOL
    _same(a, p)
    a = _run("jax", 2, spec)
    p = _run("torch", 2, spec)
    assert p["detector"] in ("abft", "drift") and p["retriable"]
    _same(a, p)


# ---------------------------------------------------------------- detection

SPECS = ["spmv.result=bitflip:at=2:times=1",
         "spmv.result=scale:mag=1e-3:at=2:times=1",
         "pc.apply=bitflip:at=2:times=1",
         "pc.apply=scale:mag=1e-3:at=2:times=1",
         "comm.psum=corrupt:times=*",
         "comm.psum=corrupt:times=1:at=3",
         "spmv.result=bitflip:at=1:times=1",
         None]

DETECTION = [
    # (type, operator, spec, shards)
    ("cg", "mat", SPECS[0], 1), ("cg", "mat", SPECS[1], 2),
    ("cg", "mat", SPECS[2], 4), ("cg", "mat", SPECS[3], 1),
    ("cg", "mat", SPECS[4], 2), ("cg", "mat", SPECS[5], 4),
    ("cg", "mat", SPECS[6], 2), ("cg", "mat", SPECS[7], 4),
    ("cg", "stencil", SPECS[0], 2), ("cg", "stencil", SPECS[1], 4),
    ("cg", "stencil", SPECS[4], 1), ("cg", "stencil", SPECS[7], 2),
    ("pipecg", "mat", SPECS[0], 4), ("pipecg", "mat", SPECS[2], 2),
    ("pipecg", "mat", SPECS[5], 1), ("pipecg", "stencil", SPECS[7], 4),
    ("sstep", "mat", SPECS[0], 2), ("sstep", "mat", SPECS[3], 4),
    ("sstep", "stencil", SPECS[4], 1), ("sstep", "mat", SPECS[7], 1),
]


@pytest.mark.parametrize("typ,op,spec,nsh", DETECTION)
def test_detection_matches_jax(typ, op, spec, nsh):
    """Each silent kind at each injectable point is detected by the same
    detector at the same iteration (``at=2``: the loop's apply; ``at=1``:
    the initial residual's, whose zero word the bitflip makes 1.0), the
    iterate rolled back alike; a clean guarded solve converges with the
    same counters."""
    a = _run("jax", nsh, spec, op=op, typ=typ)
    p = _run("torch", nsh, spec, op=op, typ=typ)
    if spec is not None:
        assert p["cls"] == "detected_sdc"
    stencil_cg = (typ, op) == ("cg", "stencil")
    if stencil_cg and "checks" in p:
        assert p["checks"] == 1 + p["its"]
        assert a["checks"] == 1 + 2 * a["its"]
    _same(a, p, checks=not stencil_cg)


@pytest.mark.parametrize("typ,spec,nsh", [
    ("cg", SPECS[0], 1), ("cg", SPECS[2], 2), ("cg", SPECS[7], 4),
    ("pipecg", SPECS[1], 2), ("sstep", SPECS[2], 4), ("sstep", SPECS[7], 1)])
def test_batched_detection_matches_jax(typ, spec, nsh):
    """Per-column detection (the corruption hits column 0): the flagged
    column rolls back to its verified iterate while the clean ones keep
    theirs; clean blocks converge with the same counters."""
    a = _run("jax", nsh, spec, many=True, typ=typ)
    p = _run("torch", nsh, spec, many=True, typ=typ)
    _same(a, p)
    if spec is not None and typ == "cg":
        X = _run("torch", nsh, spec, many=True, typ=typ)["x"]
        np.testing.assert_array_equal(X[:, 0], 0.0)
        assert all(np.linalg.norm(X[:, j]) > 0 for j in (1, 2))


@pytest.mark.parametrize("abft_on,rr", [(True, 0), (False, 10)])
def test_clean_guard_counters_match_jax(abft_on, rr):
    """ABFT alone runs the unguarded recurrence (iterations equal to the
    plain solve; an init check, then the operator's and the PC's a step);
    the replacement alone counts no checks."""
    a = _run("jax", 2, abft_on=abft_on, rr=rr)
    p = _run("torch", 2, abft_on=abft_on, rr=rr)
    plain = _run("torch", 2, abft_on=False, rr=0)
    if rr == 0:
        assert p["its"] == plain["its"] and p["checks"] == 1 + 2 * p["its"]
    else:
        assert p["checks"] == 0 and p["rrc"] >= 1
    _same(a, p)


# bf16 pipecg on the stencil diverges, which the monotonic detector flags
# (a detection, not a clean run), so it has no case here
CLEAN_ROUTES = [(t, r, d) for t in ("cg", "pipecg", "sstep")
                for r in ("general", "stencil", "many", "many_stencil")
                for d in ("float64", "bfloat16")
                if not (t == "pipecg" and "stencil" in r and d == "bfloat16")]


@pytest.mark.parametrize("typ,route,dtype", CLEAN_ROUTES)
def test_clean_guard_gives_the_unguarded_bits(typ, route, dtype):
    """The guarded loops of ``cg_plans`` are copies of the unguarded
    recurrences with the ABFT partials stacked into their reductions: with
    ``-ksp_abft`` on, no fault and no replacement, every route gives the
    unguarded solve's iterations, reasons and iterate bit for bit. Routes:
    the general one (an assembled matrix), the stencil fast path (one RHS),
    a 3-column ``ManyBatch`` block on the matrix and on the stencil (with
    Pmat != Amat, the general batched route the guarded block takes), each
    in fp64 and under the mixed plan (bfloat16 storage, fp32 reductions).
    2 shards, max_it 300 (bf16 pipecg does not converge here)."""
    dt = getattr(torch, dtype)
    many = route.startswith("many")
    out = []
    for abft_on in (False, True):
        comm = pt.DeviceComm(2, device="cpu")
        if route in ("stencil", "many_stencil"):
            M = pt.StencilPoisson3D(comm, *GRID, dtype=dt)
        else:
            M = pt.Mat.from_scipy(comm, poisson2d_csr(10), dtype=dt)
        ksp = pt.KSP().create(comm)
        ksp.set_operators(M, M.with_comm(comm) if route == "many_stencil"
                          else None)
        ksp.set_type(typ)
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-4 if dtype == "bfloat16" else RTOL,
                           max_it=300)
        ksp.abft = abft_on
        rng = np.random.default_rng(0)
        if many:
            X = np.zeros((M.shape[0], 3))
            res = ksp.solve_many(rng.standard_normal((M.shape[0], 3)), X)
            out.append((list(res.iterations), list(res.reasons), X))
        else:
            x, b = M.get_vecs()
            b.set_global(rng.standard_normal(M.shape[0]))
            res = ksp.solve(b, x)
            out.append((res.iterations, res.reason, x.to_numpy()))
        assert res.abft_checks > 0 if abft_on else res.abft_checks == 0
    (its, reasons, x), (its_g, reasons_g, x_g) = out
    assert (its_g, reasons_g) == (its, reasons)
    assert np.array_equal(x_g, x)


def test_clean_program_after_spent_fault():
    """A spent clause leaves the next solve clean (JAX ``trace_key``)."""
    ksp, M = _problem("torch", 2)
    x, bv = M.get_vecs()
    bv.set_global(np.random.default_rng(0).random(M.shape[0]))
    with faults.inject_faults("spmv.result=bitflip:at=2:times=1") as plan:
        with pytest.raises(pt.SilentCorruptionError):
            ksp.solve(bv, x)
        hits = plan[0].hits
        res = ksp.solve(bv, x)
        assert plan[0].hits == hits        # no live clause: no site counted
    assert res.converged and res.sdc_detections == 0


def test_guard_unsupported_configurations_raise():
    """Other types raise as JAX ``_check_guard`` does; so do a null space
    and the natural norm (JAX ``krylov.py:2191-2207``)."""
    ksp, M = _problem("torch", 1)
    x, bv = M.get_vecs()
    ksp.set_type("gmres")
    with pytest.raises(ValueError, match="guard"):
        ksp.solve(bv, x)
    ksp.set_type("cg")
    M.set_nullspace(pt.NullSpace(constant=True))
    with pytest.raises(ValueError, match="null-space"):
        ksp.solve(bv, x)


def test_replacement_bounds_drift_fp32():
    """f32, a tight target: periodic true-residual replacement keeps the
    recurrence honest, as in the JAX package (the same replacements;
    iterations within 2, as f32 rounds differently in XLA's fused
    updates)."""
    A = poisson2d_csr(24)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    out = []
    for pkg, P, comm in (("jax", tps, tps.DeviceComm(n_devices=2)),
                         ("torch", pt, pt.DeviceComm(2, device="cpu"))):
        M = P.Mat.from_scipy(comm, A, dtype=np.float32)
        ksp = P.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=2e-6)
        ksp.residual_replacement = 25
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        rtrue = (np.linalg.norm(b - A @ x.to_numpy().astype(np.float64))
                 / np.linalg.norm(b))
        out.append((res.iterations, res.residual_replacements, rtrue))
    assert abs(out[0][0] - out[1][0]) <= 2 and out[0][1] == out[1][1]
    assert out[1][1] >= 1 and out[1][2] <= 2e-6 * 1.6


def test_sstep_demotion_matches_jax():
    """An s-step solve whose drift gate spends its restart budget demotes
    to classic CG from its trusted iterate, recorded as a ``sstep_demote``
    event, in both packages alike."""
    A = poisson2d_csr(10)
    b = np.random.default_rng(0).random(A.shape[0])
    out = []
    for P, comm, inj in (
            (tps, tps.DeviceComm(n_devices=2), jfaults.inject_faults),
            (pt, pt.DeviceComm(2, device="cpu"), faults.inject_faults)):
        M = P.Mat.from_scipy(comm, A)
        ksp = P.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("sstep")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=RTOL)
        ksp.residual_replacement = 8
        ksp.sstep_max_replacements = 0
        x, bv = M.get_vecs()
        bv.set_global(b)
        with inj("comm.psum=corrupt:times=1:at=3"):
            res = ksp.solve(bv, x)
        out.append((res.iterations, int(res.reason),
                    [e.kind for e in res.recovery_events], x.to_numpy()))
    assert out[0][:3] == out[1][:3]
    assert out[1][2][:1] == ["sstep_demote"]
    np.testing.assert_allclose(out[1][3], out[0][3], rtol=0,
                               atol=X_TOL * np.abs(out[0][3]).max())


def test_options_wiring_matches_jax():
    argv = ["prog", "-ksp_abft", "-ksp_abft_tol", "512",
            "-ksp_residual_replacement", "40",
            "-ksp_sstep_max_replacements", "5"]
    tps.init(argv)
    pt.init(argv)
    try:
        jksp = tps.KSP().create(tps.DeviceComm(n_devices=1))
        jksp.set_from_options()
        ksp = pt.KSP().create(pt.DeviceComm(device="cpu"))
        ksp.set_from_options()
        for attr in ("abft", "abft_tol", "residual_replacement",
                     "sstep_max_replacements"):
            assert getattr(ksp, attr) == getattr(jksp, attr)
        assert ksp._guard_requested()
    finally:
        tps.global_options().clear()


def test_sdc_codes_match_jax():
    from mpi_petsc4py_example_tpu.solvers import cg_plans as jplans
    for name in ("SDC_NONE", "SDC_ABFT", "SDC_ABFT_PC", "SDC_DRIFT",
                 "SDC_NAN", "SDC_MONO", "SDC_DEMOTE", "SDC_DETECTOR_NAMES",
                 "_SDC_MONO_FACTOR", "_SDC_DRIFT_REL",
                 "_SDC_DRIFT_FLOOR_EPS", "_SSTEP_STALL_FACTOR"):
        assert getattr(cg_plans, name) == getattr(jplans, name), name
    from mpi_petsc4py_example_tpu.solvers.krylov import GUARDED_TYPES
    from mpi_petsc4py_example_tpu_torch.solvers import krylov
    assert tuple(krylov.GUARDED_TYPES) == tuple(GUARDED_TYPES)


@pytest.mark.parametrize("op,guarded,per_iter", [
    ("mat", False, 3), ("mat", True, 2), ("stencil", False, 2),
    ("stencil", True, 2)])
def test_guard_adds_no_reduction(op, guarded, per_iter):
    """The ABFT partials ride the reductions the loop makes: the guarded
    general route reduces twice an iteration where the plain one reduces
    three times (JAX: 2 sites against 3, README's silent-error section),
    and the stencil fast path keeps its two (the fused dot's and
    ``||r||^2``'s); a replacement adds its plain verifier's one."""
    ksp, M = _problem("torch", 2, op=op, abft_on=guarded,
                      rr=10 if guarded else 0)
    x, bv = M.get_vecs()
    bv.set_global(np.random.default_rng(0).random(M.shape[0]))
    comm = M.comm
    before = comm.collectives["psum"]
    res = ksp.solve(bv, x)
    calls = comm.collectives["psum"] - before
    # set-up: ||b||, ||r0|| and <r0, z0> (stencil: the initial fused
    # apply's dot and ||r0||^2; guarded, one stacked reduction each)
    init = {("mat", False): 3, ("mat", True): 2, ("stencil", False): 3,
            ("stencil", True): 2}[(op, guarded)]
    assert calls == init + per_iter * res.iterations \
        + res.residual_replacements
