"""The PyTorch port's KSP surface against the JAX package: monitors and the
convergence history, the nonzero initial guess, the natural norm,
``get_tolerances``/``get_operators``/``view``, and ``solve_many`` with the
per-column true-residual gate.

Both packages solve the same seeded numpy problem on 1/2/4/8 shards, fp64
unless stated: iterations, restarts and reasons equal, iterates within
1e-10, each monitor and history entry within 1e-10 relative. Entries below
1e-6 of the initial residual are held to 1e-10 of the initial residual
instead: that far down they are rounding-level, and the JAX package's own
values move between device counts there. The port delivers each entry at
the host read its loop makes anyway; the JAX package records the same
values in its program and replays them after the solve.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    convdiff2d)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson2d_csr)
from mpi_petsc4py_example_tpu_torch.solvers import krylov  # noqa: E402

SHARDS = [1, 2, 4, 8]
X_TOL = 1e-10
CR = pt.ConvergedReason


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def assert_history(h, jh, rel=1e-10):
    """Entries within ``rel`` relative, or within ``rel`` of the initial
    residual where they have fallen below 1e-6 of it."""
    h, jh = np.asarray(h, dtype=float), np.asarray(jh, dtype=float)
    assert h.shape == jh.shape, (len(h), len(jh))
    floor = np.where(jh < 1e-6 * jh[0], jh[0], jh)
    np.testing.assert_array_less(np.abs(h - jh), rel * floor + 1e-300)


def comms(ndev):
    return ((tps, tps.DeviceComm(n_devices=ndev)),
            (pt, pt.DeviceComm(ndev, device="cpu")))


def run_both(ndev, make_op, b, ksp_type, pc_type, rtol=1e-8, max_it=5000,
             configure=None, x0=None):
    """Solve with both packages, each with a recording monitor and the
    convergence history on; returns per package ``(res, x, monitor
    records, history, ksp)``."""
    out = []
    for pkg, comm in comms(ndev):
        op = make_op(pkg, comm)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_type(ksp_type)
        ksp.get_pc().set_type(pc_type)
        ksp.set_tolerances(rtol=rtol, max_it=max_it)
        seen = []
        ksp.set_monitor(lambda k, it, rn: seen.append((it, rn)))
        ksp.set_convergence_history()
        if configure is not None:
            configure(ksp)
        x, bv = op.get_vecs()
        bv.set_global(b)
        if x0 is not None:
            x.set_global(x0)
        res = ksp.solve(bv, x)
        out.append((res, x.to_numpy(), seen,
                    ksp.get_convergence_history(), ksp))
    (jres, jx, jseen, jh, _), (res, x, seen, h, _) = out
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason)), (res, jres)
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=X_TOL * max(np.abs(jx).max(), 1.0))
    assert [i for i, _ in seen] == [i for i, _ in jseen]
    assert_history([r for _, r in seen], [r for _, r in jseen])
    assert_history(h, jh)
    return out


def stencil(pkg, comm, nx=8):
    return (JaxStencil if pkg is tps else pt.StencilPoisson3D)(
        comm, nx, dtype=np.float64 if pkg is tps else torch.float64)


def stencil_rhs(nx=8, seed=1):
    return np.random.default_rng(seed).random(nx ** 3)


def mat(A):
    return lambda pkg, comm: pkg.Mat.from_scipy(comm, A)


# ---- monitors and the history ---------------------------------------------------------

@pytest.mark.parametrize("ndev", SHARDS)
def test_monitored_stencil_cg_keeps_the_fast_path(ndev, monkeypatch):
    """The monitored 8^3 stencil CG + jacobi: the history has iterations +
    1 entries ending at the result's norm, and the port runs it through
    the fused matvec-dot (one call per iteration, and one for the initial
    residual) with as many host reads as without the monitor."""
    calls = []
    orig = pt.StencilPoisson3D.local_matvec_dot

    def counting(self, comm):
        fn = orig(self, comm)

        def wrapped(u):
            calls.append(1)
            return fn(u)
        return wrapped

    monkeypatch.setattr(pt.StencilPoisson3D, "local_matvec_dot", counting)
    b = stencil_rhs()
    (jres, _, _, jh, _), (res, _, seen, h, ksp) = run_both(
        ndev, stencil, b, "cg", "jacobi", rtol=1e-8)
    assert len(h) == len(jh) == res.iterations + 1
    assert h[-1] == res.residual_norm
    assert len(calls) == res.iterations + 1
    # the same host reads without any monitor
    plain = pt.KSP().create(ksp.comm)
    plain.set_operators(ksp.get_operators()[0])
    plain.set_type("cg")
    plain.get_pc().set_type("jacobi")
    plain.set_tolerances(rtol=1e-8)
    x, bv = plain.get_operators()[0].get_vecs()
    bv.set_global(b)
    assert plain.solve(bv, x).host_syncs == res.host_syncs


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("ksp_type,pc_type", [
    ("cg", "jacobi"), ("bcgs", "jacobi"), ("gmres", "jacobi"),
    ("fgmres", "bjacobi"), ("bicg", "jacobi"), ("cgne", "none")])
def test_histories_match_jax(ksp_type, pc_type, ndev):
    A = (poisson2d_csr(10) if ksp_type == "cg"
         else (convdiff2d(10, beta=0.3) + 4 * sp.eye(100)).tocsr())
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    (jres, _, _, jh, _), (res, _, seen, h, _) = run_both(
        ndev, mat(A), b, ksp_type, pc_type, rtol=1e-8)
    cycle = ksp_type in ("gmres", "fgmres")
    assert len(h) == 1 + (res.iterations // 30 if cycle
                          else res.iterations)
    if cycle:   # one entry per restart cycle, numbered by iteration
        assert [i for i, _ in seen] == list(range(0, res.iterations + 1, 30))


def test_ksp_monitor_prints_like_jax():
    A = poisson2d_csr(8)
    b = np.random.default_rng(3).random(A.shape[0])
    printed = []
    for pkg, comm in comms(2):
        pkg.init(["prog", "-ksp_monitor"])
        ksp = pkg.KSP().create(comm)
        M = pkg.Mat.from_scipy(comm, A)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.set_tolerances(rtol=1e-8)
        ksp.set_from_options()
        x, bv = M.get_vecs()
        bv.set_global(b)
        buf = io.StringIO()
        with redirect_stdout(buf):
            res = ksp.solve(bv, x)
        lines = buf.getvalue().splitlines()
        assert len(lines) == res.iterations + 1
        assert lines[0].startswith("     0 KSP Residual norm ")
        printed.append([float(line.split()[-1]) for line in lines])
        pkg.global_options().clear()
    assert_history(printed[1], printed[0])


def test_history_length_cap_and_reset():
    A = poisson2d_csr(8)
    b = np.random.default_rng(4).random(A.shape[0])
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, A)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("cg")
    ksp.set_tolerances(rtol=1e-8)
    x, bv = M.get_vecs()
    bv.set_global(b)
    ksp.set_convergence_history()
    n1 = ksp.solve(bv, x).iterations + 1
    x.zero()
    ksp.solve(bv, x)
    assert len(ksp.get_convergence_history()) == 2 * n1   # accumulates
    ksp.set_convergence_history(reset=True)
    x.zero()
    ksp.solve(bv, x)
    x.zero()
    ksp.solve(bv, x)
    assert len(ksp.get_convergence_history()) == n1
    ksp.set_convergence_history(length=5)
    x.zero()
    ksp.solve(bv, x)
    assert len(ksp.get_convergence_history()) == 5


def test_a_raising_monitor_is_not_swallowed():
    comm = pt.DeviceComm(1, device="cpu")
    op = stencil(pt, comm)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")

    def boom(k, it, rn):
        if it == 3:
            raise RuntimeError("monitor says stop")

    ksp.set_monitor(boom)
    x, bv = op.get_vecs()
    bv.set_global(stencil_rhs())
    with pytest.raises(RuntimeError, match="monitor says stop"):
        ksp.solve(bv, x)


@pytest.mark.parametrize("ndev", [1, 4])
def test_gate_reentry_numbers_monitor_entries_on_like_jax(ndev):
    """fp32 CG + jacobi with the true-residual gate: one re-entry in both
    packages, the monitor numbering its entries on from the iterations
    already spent."""
    A = poisson2d_csr(64)
    b = A @ np.random.default_rng(0).random(A.shape[0])
    seen = []
    for pkg, comm in comms(ndev):
        M = pkg.Mat.from_scipy(comm, A, dtype=np.float32 if pkg is tps
                               else torch.float32)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("cg")
        ksp.get_pc().set_type("jacobi")
        ksp.set_tolerances(rtol=1e-6, atol=0.0, max_it=20000)
        ksp.set_true_residual_check(True)
        rec = []
        ksp.set_monitor(lambda k, it, rn: rec.append((it, rn)))
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        assert ksp._last_reentries == 1
        seen.append((res.iterations, rec))
    (jits, jrec), (its, rec) = seen
    assert its == jits
    assert [i for i, _ in rec] == [i for i, _ in jrec]
    # two solves, each with its iteration-0 entry; the re-entry's entries
    # are numbered on from the iterations the first one spent
    idx = [i for i, _ in rec]
    assert len(idx) == its + 2 and idx == sorted(idx) and idx[-1] == its
    # fp32 norms: rounding-level apart, within 1e-5 of the initial norm
    np.testing.assert_allclose([r for _, r in rec], [r for _, r in jrec],
                               rtol=1e-3, atol=1e-5 * jrec[0][1])


# ---- the nonzero initial guess -------------------------------------------------------

@pytest.mark.parametrize("ndev", SHARDS)
def test_initial_guess_nonzero_like_jax(ndev):
    nx = 8
    b = stencil_rhs(nx, 5)
    A = pt.poisson3d_csr(nx)
    x_star = np.linalg.solve(A.toarray(), b)
    x0 = x_star + 1e-3 * np.random.default_rng(6).standard_normal(nx ** 3)
    cfg = lambda k: k.set_initial_guess_nonzero(True)
    warm = run_both(ndev, stencil, b, "cg", "jacobi", configure=cfg, x0=x0)
    cold = run_both(ndev, stencil, b, "cg", "jacobi", x0=x0)
    assert warm[1][0].iterations < cold[1][0].iterations
    # a Mat and GMRES take the guess the same way
    run_both(ndev, mat(A.tocsr()), b, "gmres", "jacobi", configure=cfg,
             x0=x0)


# ---- the natural norm ------------------------------------------------------------------

@pytest.mark.parametrize("ndev", SHARDS)
def test_natural_norm_cg_like_jax(ndev):
    A = poisson2d_csr(10)
    b = np.random.default_rng(7).random(A.shape[0])
    (jres, *_), (res, _, seen, h, ksp) = run_both(
        ndev, mat(A), b, "cg", "jacobi",
        configure=lambda k: k.set_norm_type("natural"))
    assert ksp.get_norm_type() == "natural" and res.converged
    # the monitored norm is sqrt <r, M r>, relative to its own start
    r0 = b
    assert h[0] == pytest.approx(np.sqrt(r0 @ (r0 / A.diagonal())),
                                 rel=1e-12)
    assert h[-1] <= 1e-8 * h[0]
    # on a stencil the natural norm leaves the fast path
    comm = pt.DeviceComm(ndev, device="cpu")
    op = stencil(pt, comm)
    k = pt.KSP().create(comm)
    k.set_operators(op)
    k.set_type("cg")
    k.get_pc().set_type("jacobi")
    assert not krylov.stencil_cg_eligible("cg", k.get_pc(), op,
                                          natural=True)


# ---- get_tolerances, get_operators, view ------------------------------------------------

def test_tolerances_operators_and_view_like_jax():
    A = poisson2d_csr(4)
    views = []
    for pkg, comm in comms(2):
        ksp = pkg.KSP().create(comm)
        with pytest.raises(RuntimeError, match="no operators"):
            ksp.get_operators()
        M = pkg.Mat.from_scipy(comm, A)
        P = pkg.Mat.from_scipy(comm, A)
        ksp.set_operators(M, P)
        assert ksp.get_operators() == (M, P)
        ksp.set_type("cg")
        ksp.set_tolerances(rtol=1e-7, atol=1e-20, divtol=1e3, max_it=77)
        assert ksp.get_tolerances() == (1e-7, 1e-20, 1e3, 77)
        buf = io.StringIO()
        ksp.view(file=buf)
        views.append(buf.getvalue())
        pc = pkg.PC(comm).set_type("jacobi")
        assert ksp.set_pc(pc).get_pc() is pc
    assert views[0] == views[1]
    # -ksp_view prints it after the solve
    pt.init(["prog", "-ksp_view"])
    comm = pt.DeviceComm(1, device="cpu")
    M = pt.Mat.from_scipy(comm, A)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_from_options()
    x, bv = M.get_vecs()
    bv.set_global(np.ones(16))
    buf = io.StringIO()
    with redirect_stdout(buf):
        ksp.solve(bv, x)
    assert buf.getvalue().startswith("KSP Object: type=gmres")


# ---- solve_many: the batched gate, histories, the initial guess -------------------------

def many_both(ndev, make_op, B, rtol, gate=True, dtype=np.float32,
              monitored=False, X0=None, pc_type="jacobi"):
    out = []
    for pkg, comm in comms(ndev):
        op = make_op(pkg, comm, dtype)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_type("cg")
        ksp.get_pc().set_type(pc_type)
        ksp.set_tolerances(rtol=rtol, atol=0.0, max_it=20000)
        ksp.set_true_residual_check(gate)
        seen = []
        if monitored:
            ksp.set_monitor(lambda k, it, rn: seen.append((it, rn)))
        if X0 is not None:
            ksp.set_initial_guess_nonzero(True)
        X = None if X0 is None else X0.astype(dtype).copy()
        res = ksp.solve_many(B.astype(dtype), X)
        out.append((res, ksp, seen))
    (jres, jksp, jseen), (res, ksp, seen) = out
    assert res.iterations == [int(i) for i in jres.iterations]
    assert res.reasons == [int(r) for r in jres.reasons]
    assert ksp._last_reentries == getattr(jksp, "_last_reentries", 0)
    return out


def stencil_f(pkg, comm, dtype, nx=16):
    return (JaxStencil(comm, nx, dtype=dtype) if pkg is tps
            else pt.StencilPoisson3D(comm, nx, dtype=torch_dtype(dtype)))


def mat_f(A):
    return lambda pkg, comm, dtype: pkg.Mat.from_scipy(
        comm, A, dtype=dtype if pkg is tps else torch_dtype(dtype))


def torch_dtype(dt):
    return {np.float32: torch.float32, np.float64: torch.float64}[dt]


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_gated_solve_many_matches_jax_batched_gate(ndev):
    """fp32 CG + jacobi, k = 3, on the 2D Poisson where the recurrence
    drifts past rtol 1e-6: the columns that miss re-enter as one block, in
    both packages, with the same per-column iterations and reasons."""
    A = poisson2d_csr(64)
    rng = np.random.default_rng(8)
    B = A @ rng.random((A.shape[0], 3))
    (jres, jksp, _), (res, ksp, _) = many_both(ndev, mat_f(A), B, 1e-6)
    assert ksp._last_reentries >= 1
    X = res.X.astype(np.float64)
    for j in range(3):
        assert np.linalg.norm(B[:, j] - A @ X[:, j]) <= 1.05e-6 * \
            np.linalg.norm(B[:, j])


@pytest.mark.parametrize("ndev", [1, 4])
def test_gated_solve_many_on_the_stencil_fast_path(ndev, monkeypatch):
    """The stencil's batched fast path stays on under the gate (the port
    no longer solves the columns one by one): fp32 16^3, k = 4, rtol 5e-6,
    where the fp32 recurrence drifts and the block re-enters once. (Nearer
    fp32's floor, at 2e-6, the re-entered counts are rounding noise in
    both packages.)"""
    monkeypatch.setattr(pt.KSP, "_solve_many_sequential", None)
    B = np.random.default_rng(9).random((16 ** 3, 4))
    (jres, _, _), (res, ksp, _) = many_both(ndev, stencil_f, B, 5e-6)
    assert res.converged and ksp._last_reentries == 1
    # the first pass's reads, its epilogue's, and the re-entry's
    assert res.host_syncs > max(res.iterations) + 2


@pytest.mark.parametrize("ndev", [1, 4])
def test_solve_many_histories_and_guess_like_jax(ndev):
    A = poisson2d_csr(12)
    rng = np.random.default_rng(10)
    B = rng.random((A.shape[0], 3))
    X0 = np.linalg.solve(A.toarray(), B) + 1e-4 * rng.random(B.shape)
    for X in (None, X0):
        (jres, _, jseen), (res, ksp, seen) = many_both(
            ndev, mat_f(A), B, 1e-8, gate=False, dtype=np.float64,
            monitored=True, X0=X)
        for h, jh in zip(res.histories, jres.histories):
            assert_history(h, jh)
        assert [len(h) for h in res.histories] == [i + 1
                                                   for i in res.iterations]
        assert [i for i, _ in seen] == [i for i, _ in jseen]
        np.testing.assert_allclose(res.X, jres.X, rtol=0, atol=1e-10)
