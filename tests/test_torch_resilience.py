"""Resilient solves of ROADMAP.md Queue A item 6 against the JAX package:
fault injection (the spec grammar, the fault points, their classes),
NaN/Inf residuals, ``resilient_solve`` (checkpoint, backoff, resume),
``KSPFallbackChain``, the mesh-portable checkpoints and the failure
classes of ``utils/errors.py``.

The cases of ``tests/test_resilience.py``: each scenario runs through both
packages on the same seeded problem (``poisson2d_csr(10)``,
``convdiff2d(10)``) in fp64 on 1, 2 or 4 shards, and the recovery-event
sequences (kind, attempt, delay), iterations, reasons and counters are held
equal, the iterates within 1e-12 relative. Checkpoints written by either
package load into the other.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402
from mpi_petsc4py_example_tpu.models.generators import (  # noqa: E402
    convdiff2d)
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import fallback as jfallback  # noqa: E402
from mpi_petsc4py_example_tpu.resilience import retry as jretry  # noqa: E402
from mpi_petsc4py_example_tpu.utils import checkpoint as jckpt  # noqa: E402
from mpi_petsc4py_example_tpu.utils import errors as jerrors  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import fallback  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import retry  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import checkpoint  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import errors  # noqa: E402

CR = pt.ConvergedReason
X_TOL = 1e-12
PKG = {"jax": (tps, jfaults, jfallback, jretry),
       "torch": (pt, faults, fallback, retry)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    for f in (faults, jfaults):
        f.reset()
    pt.global_options().clear()
    yield
    assert not faults.active() and not jfaults.active()
    for f in (faults, jfaults):
        f.reset()
        f.heal()


def _setup(pkg, nsh=2, op="poisson", rtol=1e-10, ksp_type="cg", pc="none",
           n_side=10):
    P = PKG[pkg][0]
    comm = (tps.DeviceComm(n_devices=nsh) if pkg == "jax"
            else pt.DeviceComm(nsh, device="cpu"))
    A = poisson2d_csr(n_side) if op == "poisson" else convdiff2d(n_side)
    M = P.Mat.from_scipy(comm, A)
    ksp = P.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type(ksp_type)
    ksp.get_pc().set_type(pc)
    ksp.set_tolerances(rtol=rtol)
    x, b = M.get_vecs()
    # b = A x_true with a seeded x_true (tests/test_sdc.py's _setup): on
    # A @ ones the guarded, direction-restarting tail runs at the rounding
    # floor, where the two packages' reduction orders part at ~1e-11
    b.set_global(A @ np.random.default_rng(0).random(A.shape[0]))
    return ksp, M, x, b, A


def _events(res):
    return [(e.kind, e.attempt, e.error_class, e.detector, e.delay,
             e.iterations) for e in res.recovery_events]


def _close(xp, xa):
    np.testing.assert_allclose(xp, xa, rtol=0,
                               atol=X_TOL * max(np.abs(xa).max(), 1.0))


# ---------------------------------------------------------------- the specs

def test_every_jax_fault_point_parses_identically():
    """The port's registry is the JAX package's, and every (point, kind)
    clause parses to the same fields in both, schedules and messages
    included."""
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert faults.RAISING_KINDS == jfaults.RAISING_KINDS
    assert faults.TRACE_TIME_POINTS == jfaults.TRACE_TIME_POINTS
    fields = ("point", "kind", "at", "times", "forever", "iter_k", "prob",
              "mag", "mean", "device")
    for point, kinds in jfaults.FAULT_POINTS.items():
        for kind in kinds:
            spec = (f"{point}={kind}:at=2:times=3:iter=7:mag=0.25:"
                    f"mean=0.5:device=1")
            (a,), (p,) = jfaults.parse_spec(spec), faults.parse_spec(spec)
            assert [getattr(p, f) for f in fields] == \
                [getattr(a, f) for f in fields]
            assert [p.check() for _ in range(6)] == \
                [a.check() for _ in range(6)]
            if kind in faults.RAISING_KINDS:
                assert str(p.error()) == str(a.error())
                assert errors.classify_failure(str(p.error()))[0].name == \
                    jerrors.classify_failure(str(a.error()))[0].name


@pytest.mark.parametrize("spec,match", [
    ("ksp.typo=unavailable", "unknown fault point"),
    ("ksp.result=unavailable", "supports kinds"),
    ("ksp.solve", "expected"), ("ksp.solve=oom:at", "not 'key=value'"),
    ("ksp.solve=oom:at=x", "bad value"),
    ("ksp.solve=oom:prob=0.5", "needs seed"), ("", "empty")])
def test_malformed_spec_rejected_like_jax(spec, match):
    for mod in (faults, jfaults):
        with pytest.raises(mod.FaultSpecError, match=match):
            mod.parse_spec(spec)


@pytest.mark.parametrize("spec", [
    "ksp.solve=oom:at=2:times=2", "ksp.solve=oom:times=*",
    "ksp.solve=oom:seed=7:prob=0.5", "ksp.solve=unavailable:at=1"])
def test_schedules_match_jax(spec):
    out = []
    for mod in (faults, jfaults):
        with mod.inject_faults(spec) as plan:
            out.append(([mod.triggered("ksp.solve") is not None
                         for _ in range(20)], plan[0].fired,
                        plan[0].spent()))
    assert out[0] == out[1]


def test_env_var_activation(monkeypatch):
    """``TPU_SOLVE_FAULTS`` arms the plan through the options module's
    environment reader."""
    monkeypatch.setenv("TPU_SOLVE_FAULTS", "ksp.solve=unavailable")
    faults.reset()
    assert faults.active()
    assert faults.triggered("ksp.solve").kind == "unavailable"
    monkeypatch.delenv("TPU_SOLVE_FAULTS")
    faults.reset()
    assert not faults.active()


def test_synthetic_error_and_classes_match_jax():
    (f,) = faults.parse_spec("ksp.solve=unavailable")
    assert type(f.error()).__name__ == "XlaRuntimeError"
    assert [c.name for c in errors.FAILURE_CLASSES] == \
        [c.name for c in jerrors.FAILURE_CLASSES]
    assert [c.retriable for c in errors.FAILURE_CLASSES] == \
        [c.retriable for c in jerrors.FAILURE_CLASSES]
    for msg in ("Singular matrix in LuDecomposition",
                "op is Not Implemented here", "UNAVAILABLE: x",
                "RESOURCE_EXHAUSTED: Out of memory", "jax.debug.callback",
                "SILENT_DATA_CORRUPTION: abft"):
        assert [c.name for c in errors.classify_failure(msg)] == \
            [c.name for c in jerrors.classify_failure(msg)]


@pytest.mark.parametrize("exc,cls", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     "oom"),
    (RuntimeError("CUDA error: out of memory"), "oom"),
    (RuntimeError("CUDA error: unspecified launch failure"), "unavailable"),
    (RuntimeError("CUDA error: no kernel image is available"),
     "unsupported"),
    (ValueError("not a device failure"), None)])
def test_cuda_failures_land_in_the_jax_classes(exc, cls):
    @errors.wrap_device_errors("KSPSolve")
    def boom():
        raise exc
    if cls is None:
        with pytest.raises(ValueError):
            boom()
        return
    with pytest.raises(errors.DeviceExecutionError) as ei:
        boom()
    assert ei.value.failure_class == cls
    assert ei.value.original is exc


# ------------------------------------------------- injected device failures

@pytest.mark.parametrize("spec,cls,retriable", [
    ("ksp.solve=unavailable", "unavailable", True),
    ("ksp.solve=oom", "oom", False),
    ("ksp.program=oom", "oom", False)])
def test_injected_solve_fault_classified_like_jax(spec, cls, retriable):
    for pkg in PKG:
        P, mod = PKG[pkg][:2]
        ksp, M, x, b, _ = _setup(pkg)
        with mod.inject_faults(spec):
            with pytest.raises(P.DeviceExecutionError) as ei:
                ksp.solve(b, x)
            assert (ei.value.failure_class, ei.value.retriable) == (
                cls, retriable)
            assert ksp.solve(b, x).converged     # fired once


def test_eps_solve_and_placement_faults():
    A = poisson2d_csr(6)
    comm = pt.DeviceComm(2, device="cpu")
    eps = pt.EPS().create(comm)
    eps.set_operators(pt.Mat.from_scipy(comm, A))
    eps.set_problem_type("hep")
    with faults.inject_faults("eps.solve=unavailable"):
        with pytest.raises(pt.DeviceExecutionError) as ei:
            eps.solve()
    assert ei.value.failure_class == "unavailable"
    with faults.inject_faults("comm.put=unavailable"):
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            pt.Vec.from_global(comm, np.ones(16))
    v = pt.Vec.from_global(comm, np.arange(8.0))
    with faults.inject_faults("comm.fetch=corrupt"):
        assert np.isnan(v.to_numpy()).any()
    assert not np.isnan(v.to_numpy()).any()
    with faults.inject_faults("comm.fetch=drop"):
        assert (v.to_numpy() == 0).all()
    with faults.inject_faults("comm.fetch=unavailable"):
        with pytest.raises(RuntimeError, match="UNAVAILABLE"):
            v.to_numpy()


# ------------------------------------------------------- NaN/Inf residuals

@pytest.mark.parametrize("case", ["nan_iter3", "inf", "nan_rhs",
                                  "psum_corrupt", "psum_drop"])
def test_nan_inf_residuals_match_jax(case):
    """Injected NaN/Inf residuals and genuine blow-ups map to
    DIVERGED_NANORINF in both packages alike; a dropped reduction on 4
    shards does not fake convergence."""
    out = []
    for pkg in PKG:
        P, mod = PKG[pkg][:2]
        ksp, M, x, b, A = _setup(pkg, nsh=4, ksp_type="cg")
        spec = {"nan_iter3": "ksp.result=nan:iter=3", "inf": "ksp.result=inf",
                "psum_corrupt": "comm.psum=corrupt:times=*",
                "psum_drop": "comm.psum=drop:times=*"}.get(case)
        if case == "nan_rhs":
            ksp.set_tolerances(max_it=8)
            arr = b.to_numpy()
            arr[0] = np.nan
            b.set_global(arr)
        if case.startswith("psum"):
            ksp.set_tolerances(max_it=50 if case == "psum_corrupt" else 30)
        with (mod.inject_faults(spec) if spec else _null()):
            res = ksp.solve(b, x)
        out.append((res.iterations, int(res.reason)))
        if case == "psum_corrupt":
            x.zero()
            assert ksp.solve(b, x).converged     # the plan is gone
    if case == "psum_drop":
        # the port keeps one scalar for every shard: a dropped reduction
        # is modelled as the first shard's partial, not JAX's per-shard
        # values, so only the outcome class is held
        assert all(r <= 0 for _, r in out)
        return
    assert out[0] == out[1]
    if case != "psum_corrupt":
        assert out[1][1] == CR.DIVERGED_NANORINF
    if case == "nan_iter3":
        assert out[1][0] == 3


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


# ----------------------------------------------------------- resilient_solve

def _resilient(pkg, spec, tmp_path, policy_kw=None, nsh=2, guard=False,
               rtol=1e-10, n_side=None, many=False):
    # the guarded cases run on poisson2d_csr(10): a replacement every 8
    # iterations restarts CG's direction (the JAX algorithm), and on larger
    # grids the restarted tail makes the iteration count hang on rounding
    n_side = n_side or (10 if guard else 16)
    P, mod, _fb, ret = PKG[pkg]
    ksp, M, x, b, A = _setup(pkg, nsh=nsh, rtol=rtol, n_side=n_side,
                             pc="jacobi" if guard else "none")
    if guard:
        ksp.abft = True
        ksp.residual_replacement = 8
    delays = []
    policy = ret.RetryPolicy(sleep=delays.append, **(policy_kw or {}))
    ckpt = str(tmp_path / f"{pkg}.npz")
    with mod.inject_faults(spec):
        if many:
            B = np.stack([b.to_numpy(), 2.0 * b.to_numpy()], axis=1)
            res = ret.resilient_solve_many(ksp, B, None, policy,
                                           checkpoint_path=ckpt)
            xs = np.asarray(res.X)
        else:
            res = ret.resilient_solve(ksp, b, x, policy,
                                      checkpoint_path=ckpt)
            xs = x.to_numpy()
    return res, xs, delays, ckpt, ksp


@pytest.mark.parametrize("spec,nsh,guard,many", [
    ("ksp.program=unavailable:iter=6", 1, False, False),
    ("ksp.program=unavailable:iter=6", 4, False, False),
    ("ksp.program=unavailable:iter=4", 2, False, True),
    ("ksp.solve=unavailable:at=1:times=2", 2, False, False),
    ("spmv.result=bitflip:at=2:times=1", 2, True, False),
    ("spmv.result=bitflip:at=1:times=1", 4, True, False),
    ("pc.apply=scale:mag=1e-2:at=2:times=1", 1, True, False),
    ("comm.psum=corrupt:times=1:at=3", 2, True, False),
    ("spmv.result=bitflip:at=2:times=1", 2, True, True)])
def test_resilient_solve_matches_jax(tmp_path, spec, nsh, guard, many):
    """Crash at iteration K -> checkpoint -> deterministic backoff ->
    rebuild -> resume; silent corruption -> rollback -> re-entry -> host
    fp64 verification: the same event sequence, delays, attempts,
    iterations and answer in both packages."""
    kw = {"base_delay": 0.125, "max_attempts": 3}
    ra, xa, da, _, _ = _resilient("jax", spec, tmp_path, kw, nsh, guard,
                                  many=many)
    rp, xp, dp, ckpt, ksp = _resilient("torch", spec, tmp_path, kw, nsh,
                                       guard, many=many)
    assert _events(rp) == _events(ra)
    assert (rp.attempts, rp.sdc_detections, dp) == (ra.attempts,
                                                    ra.sdc_detections, da)
    its = (list(rp.iterations), list(ra.iterations)) if many else (
        rp.iterations, ra.iterations)
    assert its[0] == its[1]
    assert rp.converged and ksp._initial_guess_nonzero is False
    _close(xp, xa)
    if guard:
        assert rp.recovery_events[-1].kind == "verify"
    if "ksp.program" in spec:
        assert os.path.exists(ckpt)
        assert rp.recovery_events[1].detail == ckpt


def test_resume_converges_faster_than_cold(tmp_path):
    ksp, M, x, b, _ = _setup("torch", n_side=16, rtol=1e-8)
    cold = ksp.solve(b, x.duplicate()).iterations
    with faults.inject_faults(
            f"ksp.program=unavailable:iter={cold * 3 // 4}"):
        res = retry.resilient_solve(
            ksp, b, x, retry.RetryPolicy(max_attempts=2,
                                         sleep=lambda _d: None),
            checkpoint_path=str(tmp_path / "s.npz"))
    assert res.converged and res.iterations < cold


@pytest.mark.parametrize("spec,kw,exc_cls", [
    ("ksp.solve=oom", {}, "oom"),
    ("ksp.solve=unavailable:times=*", {"base_delay": 1.0}, "unavailable"),
    ("spmv.result=bitflip:times=*", {"max_attempts": 2}, "detected_sdc")])
def test_unrecoverable_failures_reraise_like_jax(tmp_path, spec, kw,
                                                 exc_cls):
    """A non-retriable class raises at once; an exhausted policy re-raises
    after its exponential delays; a corruption that re-arms on every
    attempt defeats recovery."""
    out = []
    for pkg in PKG:
        P, mod, _fb, ret = PKG[pkg]
        ksp, M, x, b, _ = _setup(pkg, pc="jacobi")
        ksp.abft = True
        delays = []
        with mod.inject_faults(spec):
            with pytest.raises(P.DeviceExecutionError) as ei:
                ret.resilient_solve(
                    ksp, b, x, ret.RetryPolicy(sleep=delays.append, **kw),
                    checkpoint_path=str(tmp_path / f"{pkg}.npz"))
        out.append((ei.value.failure_class, delays))
    assert out[0] == out[1] and out[1][0] == exc_cls


def test_backoff_and_policy_match_jax():
    """Exponential, capped, deterministic delays as the JAX package's; the
    jitter draws reproducibly within ``jitter`` of the delay (the JAX
    package's tuple seed raises on Python 3.12: ROADMAP.md Queue C)."""
    kw = {"base_delay": 0.5, "max_delay": 3.0}
    a, p = jretry.RetryPolicy(**kw), retry.RetryPolicy(**kw)
    assert [p.delay(i) for i in range(6)] == [a.delay(i) for i in range(6)]
    p = retry.RetryPolicy(jitter=0.25, jitter_seed=3)
    base = retry.RetryPolicy()
    got = [p.delay(i) for i in range(6)]
    assert got == [p.delay(i) for i in range(6)]
    assert all(b <= g <= 1.25 * b for g, b in
               zip(got, (base.delay(i) for i in range(6))))
    k1 = pt.KSP().create(pt.DeviceComm(device="cpu"))
    k2 = pt.KSP().create(pt.DeviceComm(device="cpu"))
    assert retry.default_checkpoint_path(k1) != \
        retry.default_checkpoint_path(k2)


def test_no_fault_zero_overhead(tmp_path):
    ksp, M, x, b, _ = _setup("torch")
    ckpt = str(tmp_path / "never.npz")
    res = retry.resilient_solve(ksp, b, x, checkpoint_path=ckpt)
    assert res.converged and res.attempts == 1
    assert res.recovery_events == [] and not os.path.exists(ckpt)


# ------------------------------------------------------------ fallback chain

@pytest.mark.parametrize("case", [
    "nan_to_bcgs", "exhaust_to_direct", "oom_precision", "breakdown",
    "custom_no_direct", "kept_escalation", "raising_last_stage",
    "convdiff_nan"])
def test_fallback_chain_matches_jax(case):
    """Method escalation on NaN/breakdown (cg -> bcgs -> gmres -> preonly +
    lu), the oom retry at float32, custom stages, the kept configuration
    and its restoration: the same events, attempts, configuration and
    answer in both packages."""
    out = []
    for pkg in PKG:
        P, mod, fb, _ret = PKG[pkg]
        op = "convdiff" if case == "convdiff_nan" else "poisson"
        rtol = 1e-5 if case == "oom_precision" else 1e-10
        ksp, M, x, b, A = _setup(pkg, op=op, rtol=rtol,
                                 ksp_type="bcgs" if op == "convdiff"
                                 else "cg")
        if case == "breakdown":
            A = sp.diags([1.0, -1.0, 2.0, -2.0, 3.0, -3.0, 4.0, -4.0]).tocsr()
            M = P.Mat.from_scipy(M.comm, A)
            ksp.set_operators(M)
            x, b = M.get_vecs()
            b.set_global(np.ones(8))
        chain = (fb.KSPFallbackChain(ksp, methods=["gmres"], direct=False)
                 if case == "custom_no_direct" else fb.KSPFallbackChain(ksp))
        spec = {"nan_to_bcgs": "ksp.result=nan:at=1:iter=2",
                "exhaust_to_direct": "ksp.result=nan:at=1:times=3",
                "oom_precision": "ksp.solve=oom:at=1",
                "custom_no_direct": "ksp.result=nan:at=1:times=*",
                "kept_escalation": "ksp.result=nan:at=1",
                "raising_last_stage": "ksp.solve=unavailable:times=*",
                "convdiff_nan": "ksp.result=nan:at=1"}.get(case)
        row = []
        with (mod.inject_faults(spec) if spec else _null()):
            try:
                res = chain.solve(b, x)
                row += [int(res.reason), res.attempts, _events(res),
                        [e.detail for e in res.recovery_events]]
            except P.DeviceExecutionError as e:
                row += [e.failure_class]
        if case == "kept_escalation":
            x.zero()
            with mod.inject_faults("ksp.result=nan:at=1"):
                res = chain.solve(b, x)
            row += [res.attempts, [e.detail for e in res.recovery_events]]
        row += [ksp.get_type(), ksp.get_pc().get_type(),
                getattr(chain, "last_config", None)]
        out.append((row, x.to_numpy()))
    assert out[0][0] == out[1][0]
    tol = 1e-6 if case == "oom_precision" else X_TOL
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=0,
                               atol=tol * max(np.abs(out[0][1]).max(), 1.0))


@pytest.mark.parametrize("fault", [
    "ksp.program=unavailable:times=*", "ksp.solve=unavailable:times=*",
    "launch"])
def test_fallback_chain_reraises_device_failures(fault, monkeypatch):
    """A device failure other than oom is the device's, not the method's:
    the chain re-raises it from its first stage and tries no other method
    and no host LU (unlike the JAX chain, which escalates it); the owner's
    configuration stays. ``launch`` is a hand-written kernel's refused
    launch, as ``ops/stencil.py`` reports it."""
    from mpi_petsc4py_example_tpu_torch.solvers import ksp as ksp_mod
    ksp, M, x, b, _ = _setup("torch")
    solves = []
    real_solve = ksp_mod.KSP._solve
    monkeypatch.setattr(ksp_mod.KSP, "_solve", lambda self, *a: (
        solves.append(self.get_type()), real_solve(self, *a))[1])
    monkeypatch.setattr(ksp_mod.KSP, "_solve_hostlu", lambda *a: pytest.fail(
        "the chain reached the host LU"))
    if fault == "launch":
        def refused(*a, **k):
            def prog(*a_, **k_):
                raise RuntimeError("CUDA error: unspecified launch failure")
            return prog
        monkeypatch.setattr(ksp_mod, "build_ksp_program", refused)
    chain = fallback.KSPFallbackChain(ksp)
    with (faults.inject_faults(fault) if "=" in fault else _null()):
        with pytest.raises(pt.DeviceExecutionError) as err:
            chain.solve(b, x)
    assert err.value.failure_class == "unavailable"
    assert solves == ["cg"]
    assert (ksp.get_type(), ksp.get_pc().get_type()) == ("cg", "none")


def test_fallback_chain_refuses_the_host_lu_for_a_card_operator(monkeypatch):
    """Past the dense cap an irreducible operator's lu is the host sparse
    LU. On the CPU the chain ends there as the JAX chain does (same events
    and answer); for an operator on the card it raises
    ``HostStageError`` with the escalations made so far instead of moving
    the solve to the host."""
    from mpi_petsc4py_example_tpu.solvers import pc as jax_pc
    from mpi_petsc4py_example_tpu_torch.solvers import pc as port_pc
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", 512)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", 512)
    A = (sp.random(1000, 1000, density=0.005, random_state=42, format="csr")
         + 10.0 * sp.eye(1000)).tocsr()
    rhs = A @ np.random.default_rng(6).random(1000)
    spec = "ksp.result=nan:at=1:times=3"
    out = []
    for pkg in PKG:
        P, mod, fb, _ret = PKG[pkg]
        comm = (tps.DeviceComm(n_devices=2) if pkg == "jax"
                else pt.DeviceComm(2, device="cpu"))
        M = P.Mat.from_scipy(comm, A)
        ksp = P.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.set_tolerances(rtol=1e-10, max_it=50)
        x, b = M.get_vecs()
        b.set_global(rhs)
        with mod.inject_faults(spec):
            res = fb.KSPFallbackChain(ksp).solve(b, x)
        assert ksp.get_pc().kind == "hostlu"
        out.append(([int(res.reason), res.attempts, _events(res)],
                    x.to_numpy()))
    assert out[0][0] == out[1][0]
    _close(out[1][1], out[0][1])
    ksp.get_pc().set_type("none")
    ksp.set_type("cg")
    x.zero()
    monkeypatch.setattr(fallback, "_on_card", lambda mat: True)
    with faults.inject_faults(spec):
        with pytest.raises(fallback.HostStageError, match="host") as err:
            fallback.KSPFallbackChain(ksp).solve(b, x)
    assert [e.detail for e in err.value.recovery_events] == [
        "cg->bcgs", "bcgs->gmres", "gmres->preonly"]
    assert (ksp.get_type(), ksp.get_pc().get_type()) == ("cg", "none")


def test_reduced_dtype_table():
    assert fallback.reduced_dtype(torch.float64) == torch.float32
    assert fallback.reduced_dtype(np.complex128) == torch.complex64
    assert fallback.reduced_dtype(torch.float32) is None
    assert jfallback.reduced_dtype(np.float64) == np.float32


# ----------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_cross_loads(tmp_path, dtype, direction):
    """Vec, Mat, solve_state and solve_state_many written by one package
    load into the other on another shard count, values and dtype intact
    (bfloat16 as its raw 2-byte words)."""
    import jax.numpy as jnp
    A = convdiff2d(6)
    n = A.shape[0]
    rng = np.random.default_rng(5)
    xh, bh = rng.standard_normal(n), rng.standard_normal(n)
    X, B = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))
    tdt = getattr(torch, dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    pcomm, jcomm = pt.DeviceComm(4, device="cpu"), tps.DeviceComm(
        n_devices=2)
    p = lambda name: str(tmp_path / name)
    if direction == "port_to_jax":
        M = pt.Mat.from_scipy(pcomm, A, dtype=tdt)
        x = pt.Vec.from_global(pcomm, xh, dtype=tdt)
        b = pt.Vec.from_global(pcomm, bh, dtype=tdt)
        checkpoint.save_vec(p("v"), x)
        checkpoint.save_mat(p("m"), M)
        checkpoint.save_solve_state(p("s"), M, x, b, iteration=7)
        checkpoint.save_solve_state_many(p("sm"), M, X, B, iteration=9)
        v2 = jckpt.load_vec(p("v"), jcomm)
        m2 = jckpt.load_mat(p("m"), jcomm)
        mat3, x3, b3, it3 = jckpt.load_solve_state(p("s"), jcomm)
        mat4, X4, B4, it4 = jckpt.load_solve_state_many(p("sm"), jcomm)
        assert np.dtype(m2.dtype) == np.dtype(jdt)
        host = lambda a: np.asarray(a, np.float64)
        ip, ix, dv = m2.host_csr
        dense = sp.csr_matrix((host(dv), ix, ip), shape=A.shape).toarray()
        got = [host(v2.to_numpy()), dense,
               host(x3.to_numpy()), host(b3.to_numpy()), host(X4),
               host(B4)]
    else:
        M = tps.Mat.from_scipy(jcomm, A, dtype=jdt)
        x = tps.Vec.from_global(jcomm, xh.astype(jdt))
        b = tps.Vec.from_global(jcomm, bh.astype(jdt))
        jckpt.save_vec(p("v"), x)
        jckpt.save_mat(p("m"), M)
        jckpt.save_solve_state(p("s"), M, x, b, iteration=7)
        jckpt.save_solve_state_many(p("sm"), M, X.astype(jdt),
                                    B.astype(jdt), iteration=9)
        v2 = checkpoint.load_vec(p("v"), pcomm)
        m2 = checkpoint.load_mat(p("m"), pcomm)
        mat3, x3, b3, it3 = checkpoint.load_solve_state(p("s"), pcomm)
        mat4, X4, B4, it4 = checkpoint.load_solve_state_many(p("sm"), pcomm)
        assert m2.dtype == tdt and x3.dtype == tdt and v2.dtype == tdt
        host = lambda a: np.asarray(a, np.float64)
        got = [host(v2.to_numpy()), m2.to_scipy().toarray(),
               host(x3.to_numpy()), host(b3.to_numpy()), host(X4),
               host(B4)]
    rnd = lambda a: np.asarray(np.asarray(a, dtype=np.float64).astype(jdt),
                               np.float64)
    want = [rnd(xh), rnd(A.toarray()), rnd(xh), rnd(bh), rnd(X), rnd(B)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (it3, it4) == (7, 9)


def test_checkpoint_validation(tmp_path):
    """Atomic saves (no ``.tmp`` left), a missing file is FileNotFoundError,
    anything malformed a ValueError naming the checkpoint."""
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, poisson2d_csr(4))
    x, b = M.get_vecs()
    path = str(tmp_path / "s.npz")
    checkpoint.save_solve_state(path, M, x, b)
    assert os.listdir(tmp_path) == ["s.npz"]
    with pytest.raises(FileNotFoundError):
        checkpoint.load_solve_state(str(tmp_path / "absent.npz"), comm)
    with pytest.raises(ValueError, match="expected 'vec'"):
        checkpoint.load_vec(path, comm)
    with open(str(tmp_path / "junk.npz"), "wb") as f:
        f.write(b"not a zip")
    with pytest.raises(ValueError):
        checkpoint.load_mat(str(tmp_path / "junk.npz"), comm)
    z = dict(np.load(path))
    z["indptr"] = z["indptr"][:-2]
    np.savez(str(tmp_path / "bad.npz"), **z)
    with pytest.raises(ValueError, match="indptr"):
        checkpoint.load_solve_state(str(tmp_path / "bad.npz"), comm)
    with pytest.raises(ValueError, match="matching"):
        checkpoint.save_solve_state_many(path, M, np.zeros((16, 2)),
                                         np.zeros((16, 3)))


# --------------------------------------------------------------- the surface

def test_package_surface_matches_jax():
    assert pt.RetryPolicy is retry.RetryPolicy
    assert pt.resilient_solve is retry.resilient_solve
    assert pt.KSPFallbackChain is fallback.KSPFallbackChain
    assert pt.inject_faults is faults.inject_faults
    assert pt.HealthMonitor is faults.HealthMonitor
    import mpi_petsc4py_example_tpu.resilience as jres
    import mpi_petsc4py_example_tpu_torch.resilience as pres
    assert pres.__all__ == jres.__all__
    for name in pres.__all__:
        assert getattr(pres, name) is not None
    for cls in ("RecoveryEvent", "SolveResult", "BatchedSolveResult"):
        jf = getattr(tps, cls).__dataclass_fields__
        pf = getattr(pt, cls).__dataclass_fields__
        assert set(jf) - {"history"} <= set(pf), cls
