"""The fused program's guarded modes (``-ksp_megasolve`` with ``-ksp_abft``,
a replacement interval, the auto-replacement flags, and ``RefinedKSP``'s
guarded inners) against the JAX package's.

The JAX package's ``TestFusedGuardResilience`` (``tests/test_megasolve.py``)
ported: the same operator, right-hand side and fault spec go through both
packages' fused programs, fp64, on 2 and 8 shards. Held equal: the detector,
the iterations, the ABFT checks and the replacements (the result's and the
registry's ``abft.*`` counters), ``x`` within 1e-12 of its largest entry
(the verified carry after a detection). On the CPU the fused program's
pieces run uncaptured, the plain version of its CUDA graphs; the JAX
programs run with their disk cache off (``TPU_SOLVE_AOT=0``).
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu import telemetry as jtel  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson3d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa
from mpi_petsc4py_example_tpu.solvers.refine import (  # noqa: E402
    RefinedKSP as JaxRefinedKSP)
from mpi_petsc4py_example_tpu.utils.errors import (  # noqa: E402
    SilentCorruptionError as JaxSDC)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch import telemetry as ptel  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import megasolve  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils.errors import (  # noqa: E402
    SilentCorruptionError)

PKGS = {"jax": (tps, jtel, jfaults), "torch": (pt, ptel, faults)}
X_TOL = 1e-12


@pytest.fixture(autouse=True)
def _isolation(monkeypatch):
    monkeypatch.setenv("TPU_SOLVE_AOT", "0")
    for _, tel, flt in PKGS.values():
        tel.disable()
        tel.reset()
        flt.reset()
    yield
    for _, tel, flt in PKGS.values():
        tel.reset()
        flt.reset()
    megasolve.clear_cache()


def _spd(n, seed=3):
    """The JAX test's diagonally dominant SPD operator."""
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=0.02, random_state=rng, format="csr")
    A = A + A.T
    A = A + sp.eye(n, format="csr") * (abs(A).sum(axis=1).max() + 1.0)
    return A.tocsr()


A512 = _spd(512)


def _ksp(pkg, ndev, A=A512, ksp_type="cg", fused=True, rtol=1e-10,
         **knobs):
    P = PKGS[pkg][0]
    comm = (tps.DeviceComm(n_devices=ndev) if pkg == "jax"
            else pt.DeviceComm(ndev, device="cpu"))
    M = P.Mat.from_scipy(comm, A)
    ksp = P.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=rtol, max_it=20000)
    ksp.megasolve = fused
    for k, v in knobs.items():
        setattr(ksp, k, v)
    return ksp, M


def _sdc(pkg):
    snap = PKGS[pkg][1].snapshot()
    return tuple(int(snap.get(k, {}).get("total", 0))
                 for k in ("abft.checks", "abft.detections",
                           "abft.replacements"))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=0,
                               atol=X_TOL * max(np.abs(b).max(), 1.0))


def _detect(pkg, ndev, spec, many=False):
    ksp, M = _ksp(pkg, ndev, abft=True)
    P = PKGS[pkg][0]
    err = JaxSDC if pkg == "jax" else SilentCorruptionError
    if many:
        B = np.random.default_rng(16).standard_normal((512, 3))
        X = np.zeros_like(B)
        with P.inject_faults(spec):
            with pytest.raises(err) as ei:
                ksp.solve_many(B, X)
        return ei.value.detector, ei.value.iteration, X, _sdc(pkg)
    x, bv = M.get_vecs()
    bv.set_global(np.random.default_rng(14).standard_normal(512))
    with P.inject_faults(spec):
        with pytest.raises(err) as ei:
            ksp.solve(bv, x)
    return ei.value.detector, ei.value.iteration, x.to_numpy(), _sdc(pkg)


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("spec", ["spmv.result=bitflip:at=2:times=1",
                                  "pc.apply=scale:at=2:times=1:mag=0.5"])
def test_bitflip_detected_and_rolled_back(ndev, spec):
    """A corrupted body apply is detected in the first correction: the
    detector and the counters as JAX's, ``x`` the verified carry, the
    zero initial iterate."""
    j = _detect("jax", ndev, spec)
    p = _detect("torch", ndev, spec)
    assert p[0] == j[0] and p[1] == j[1] and p[3] == j[3]
    _close(p[2], j[2])
    if spec.startswith("spmv"):
        assert p[0] == "abft"
        np.testing.assert_array_equal(p[2], 0.0)


@pytest.mark.parametrize("ndev", [2, 8])
def test_resilient_reentry_to_verified_answer(ndev):
    out = []
    for pkg in PKGS:
        P = PKGS[pkg][0]
        ksp, M = _ksp(pkg, ndev, abft=True)
        x_true = np.random.default_rng(15).random(512)
        x, bv = M.get_vecs()
        bv.set_global(A512 @ x_true)
        with P.inject_faults("spmv.result=bitflip:at=2:times=1"):
            res = P.resilient_solve(
                ksp, bv, x, P.RetryPolicy(sleep=lambda _d: None))
        assert res.converged
        np.testing.assert_allclose(x.to_numpy(), x_true, atol=1e-7)
        out.append(([(e.kind, e.detector) for e in res.recovery_events],
                    res.iterations, res.attempts, res.abft_checks,
                    res.residual_replacements, _sdc(pkg), x.to_numpy()))
    assert out[0][:6] == out[1][:6]
    assert ("fault", "abft") in out[1][0] and out[1][0][-1][0] == "verify"
    _close(out[1][6], out[0][6])


@pytest.mark.parametrize("ndev", [2, 8])
def test_batched_fused_guard_detects(ndev):
    j = _detect("jax", ndev, "spmv.result=bitflip:at=2:times=1", many=True)
    p = _detect("torch", ndev, "spmv.result=bitflip:at=2:times=1",
                many=True)
    assert p[0] == j[0] == "abft" and p[3] == j[3]
    _close(p[2], j[2])


def _clean(pkg, ndev, ksp_type, many, **knobs):
    ksp, M = _ksp(pkg, ndev, ksp_type=ksp_type, **knobs)
    if many:
        B = np.random.default_rng(18).standard_normal((512, 3))
        res = ksp.solve_many(B)
        return (list(res.iterations), list(res.reasons), res.abft_checks,
                res.residual_replacements, getattr(res, "megasolve_steps",
                                                   None), _sdc(pkg),
                np.asarray(res.X))
    x, bv = M.get_vecs()
    bv.set_global(np.random.default_rng(17).standard_normal(512))
    res = ksp.solve(bv, x)
    return (res.iterations, res.reason, res.abft_checks,
            res.residual_replacements, res.megasolve_steps, _sdc(pkg),
            x.to_numpy())


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("ksp_type,knobs", [
    ("cg", {"abft": True}),
    ("cg", {"abft": True, "residual_replacement": 10}),
    ("cg", {"residual_replacement": 7}),
    ("pipecg", {"abft": True, "pipeline_auto_replacement": 10}),
    ("sstep", {"abft": True, "sstep_auto_replacement": 8}),
    ("sstep", {"sstep_auto_replacement": 25})])
@pytest.mark.parametrize("many", [False, True])
def test_clean_guarded_fused_matches_jax(ndev, ksp_type, knobs, many):
    """A clean guarded fused solve: iterations, reasons, steps, checks and
    replacements equal JAX's, ``x`` within 1e-12; the guard adds checks,
    not error (the unguarded fused answer within 1e-9)."""
    j = _clean("jax", ndev, ksp_type, many, **knobs)
    p = _clean("torch", ndev, ksp_type, many, **knobs)
    assert p[:6] == j[:6]
    _close(p[6], j[6])
    plain = _clean("torch", ndev, ksp_type, many)
    assert np.linalg.norm(plain[6] - p[6]) <= 1e-9 * np.linalg.norm(
        plain[6])


def test_faulted_program_never_serves_a_clean_solve():
    """The fired site set is part of the program key: a faulted build gets
    a program of its own, and the next clean solve takes the clean one and
    gives its bits."""
    ksp, M = _ksp("torch", 2, abft=True)
    x, bv = M.get_vecs()
    bv.set_global(np.random.default_rng(14).standard_normal(512))
    ksp.solve(bv, x)
    clean = x.to_numpy()
    n0 = len(megasolve._CACHE)
    x2, _ = M.get_vecs()
    with pt.inject_faults("spmv.result=bitflip:at=2:times=1"):
        with pytest.raises(SilentCorruptionError):
            ksp.solve(bv, x2)
    assert len(megasolve._CACHE) == n0 + 1
    x3, _ = M.get_vecs()
    ksp.solve(bv, x3)
    assert len(megasolve._CACHE) == n0 + 1
    np.testing.assert_array_equal(x3.to_numpy(), clean)


def test_guard_without_a_fused_plan_raises():
    """No fallback: the guard with the stencil fast path, or ABFT without
    the checksums, raises instead of running another program."""
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 8)
    pc = pt.PC()
    pc.set_type("jacobi")
    pc.set_up(op)
    with pytest.raises(ValueError, match="stencil fast path"):
        megasolve.build_megasolve_program(comm, "cg", pc, op, rr=True,
                                          rr_n=5, stencil_fastpath=True)
    with pytest.raises(ValueError, match="checksum"):
        megasolve.build_megasolve_program(comm, "cg", pc, op, abft=True)


def _refined(pkg, ndev, prec, ksp_type, A=None):
    A = poisson3d_csr(10) if A is None else A
    comm = (tps.DeviceComm(n_devices=ndev) if pkg == "jax"
            else pt.DeviceComm(ndev, device="cpu"))
    rk = (JaxRefinedKSP if pkg == "jax" else pt.RefinedKSP)().create(comm)
    rk.set_inner_precision(prec)
    rk.set_operators(A)
    rk.set_type(ksp_type)
    rk.get_pc().set_type("jacobi")
    rk.set_tolerances(rtol=1e-10)
    rk.megasolve = True
    b = A @ np.random.default_rng(9).random(A.shape[0])
    x, res = rk.solve(b)
    rel = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    return (rk.refine_steps, res.iterations, res.reason, _sdc(pkg), rel, x)


@pytest.mark.parametrize("ndev", [1, 4])
@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_refined_sstep_inner_fused_matches_jax(ndev, prec):
    """An sstep inner arms ``-ksp_sstep_auto_replacement 25`` at any
    precision: the fused refinement runs the guarded program, with JAX's
    outer steps, inner iterations, reason and counters in fp64, ``x``
    within 1e-12. f32: the inner solves' fp32 sums fold in another order,
    which moves a replacement by a block on 4 shards, so the reason and the
    steps are equal, the iterations within 10% and the fp64 residual meets
    ``rtol``."""
    j = _refined("jax", ndev, prec, "sstep")
    p = _refined("torch", ndev, prec, "sstep")
    assert p[4] <= 1e-10
    if prec == "f64":
        assert p[:4] == j[:4]
        _close(p[5], j[5])
    else:
        assert (p[0], p[2]) == (j[0], j[2])
        assert abs(p[1] - j[1]) <= 0.1 * j[1]


def _refined_outcome(pkg, ndev):
    try:
        out = _refined(pkg, ndev, "bf16", "pipecg", A=A512)
    except (JaxSDC, SilentCorruptionError) as exc:
        return ("sdc", exc.detector, exc.iteration, _sdc(pkg))
    return ("ok",) + out[:4]


@pytest.mark.parametrize("ndev", [1, 4])
def test_refined_bf16_pipecg_inner_fused_matches_jax(ndev):
    """A bf16 pipecg inner arms ``-ksp_pipeline_auto_replacement 25``: the
    fused refinement runs the guarded program, on the JAX test's SPD
    operator, with the bands of the bf16 refinement
    (``tests/test_torch_megasolve.py``): the reason equal, the outer steps
    within one, the inner iterations within 10%, no detection, and the
    replacement count within one."""
    j = _refined_outcome("jax", ndev)
    p = _refined_outcome("torch", ndev)
    assert p[0] == j[0] == "ok"
    (ps, pi, pr, pc), (js, ji, jr, jc) = p[1:], j[1:]
    assert pr == jr and abs(ps - js) <= 1 and abs(pi - ji) <= 0.1 * ji
    assert pc[1] == jc[1] == 0 and abs(pc[2] - jc[2]) <= 1
