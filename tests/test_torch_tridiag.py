"""The PyTorch port's cyclic-reduction direct solves against the JAX package:
``solvers/tridiag.py`` (PCR and block PCR, host and device set-up, the
applies) and PC lu/cholesky in the ``crtri``/``crband`` modes under KSP
preonly, with RCM and the uneven tail, in fp64 unless stated.

The JAX side runs on the forced 8-device CPU mesh of ``conftest.py``, the
port on its CPU virtual mesh (``-pc_setup_device 1`` forces the device
set-up program there). ``_DENSE_CAP`` is lowered in both packages, as
``tests/test_rcm_direct.py`` lowers it, so that small operators take the
modes past the dense cap.
"""

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.solvers import pc as jax_pc  # noqa: E402
from mpi_petsc4py_example_tpu.solvers import tridiag as jtri  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.models.generators import (  # noqa: E402
    tridiag_family)
from mpi_petsc4py_example_tpu_torch.models.poisson import (  # noqa: E402
    poisson2d_csr)
from mpi_petsc4py_example_tpu_torch.solvers import pc as port_pc  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import tridiag as ptri  # noqa: E402

CPU = pt.DeviceComm(device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dominant(n, seed):
    rng = np.random.default_rng(seed)
    a, c = rng.standard_normal(n), rng.standard_normal(n)
    return a, np.abs(a) + np.abs(c) + 1.0 + rng.random(n), c


def pentadiag(n, seed=0):
    """Diagonally dominant pentadiagonal (``tests/test_bpcr_device.py``)."""
    rng = np.random.default_rng(seed)
    diags = [rng.random(n - abs(o)) * 0.4 for o in (-2, -1, 1, 2)]
    return sp.diags(diags[:2] + [4.0 + rng.random(n)] + diags[2:],
                    [-2, -1, 0, 1, 2]).tocsr()


def _banded(n, bw, seed):
    rng = np.random.default_rng(seed)
    offs = [o for o in range(-bw, bw + 1) if o != 0]
    return (sp.diags([0.1 * (rng.random(n - abs(o)) - 0.5) for o in offs],
                     offs) + 3.0 * sp.eye(n)).tocsr()


# ---- the kernels of the sweeps -------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 5, 100, 1023])
def test_pcr_setup_and_apply_match_jax(n):
    a, b, c = _dominant(n, n)
    host = ptri.pcr_setup(a, b, c)
    jhost = jtri.pcr_setup(a, b, c)
    for p, j in zip(host, jhost):
        np.testing.assert_array_equal(p, j)
    d = np.random.default_rng(1).random(n)
    x = ptri.pcr_apply(_t(d), *map(_t, host)).numpy()
    jx = np.asarray(jtri.pcr_apply(jnp.asarray(d),
                                   *map(jnp.asarray, jhost)))
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)
    np.testing.assert_allclose(x, ptri.pcr_apply_np(d, *host), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("n,bw", [(64, 2), (203, 2), (150, 3), (96, 8)])
def test_bpcr_setup_and_apply_match_jax(n, bw):
    A = _banded(n, bw, n)
    blocks = ptri.banded_to_blocks(A, bw)
    for p, j in zip(blocks, jtri.banded_to_blocks(A, bw)):
        np.testing.assert_array_equal(p, j)
    host = ptri.bpcr_setup(*blocks)
    jhost = jtri.bpcr_setup(*blocks)
    for p, j in zip(host, jhost):
        np.testing.assert_allclose(p, j, rtol=0, atol=1e-14)
    d = np.random.default_rng(2).random(host[2].shape[0] * bw)
    x = ptri.bpcr_apply(_t(d), *map(_t, host)).numpy()
    jx = np.asarray(jtri.bpcr_apply(jnp.asarray(d),
                                    *map(jnp.asarray, jhost)))
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-12)


def test_pcr_apply_launch_count():
    """Per sweep one copy and two slice addcmul_, then one divide."""
    n = 1000
    host = ptri.pcr_setup(*_dominant(n, 0))
    S = host[0].shape[0]
    with torch.profiler.profile() as prof:
        ptri.pcr_apply(_t(np.ones(n)), *map(_t, host))
    ops = {e.key: e.count for e in prof.key_averages()}
    assert S == 10 and ops["aten::addcmul_"] == 2 * S
    assert ops["aten::clone"] == S and ops["aten::div"] == 1


SETUP_ERRORS = {
    "zero diagonal": lambda: ((np.ones(8), np.r_[np.ones(3), 0.0,
                                                 np.ones(4)], np.ones(8)),
                              "zero diagonal"),
    "breakdown": lambda: ((np.array([0.0, 1.0]), np.ones(2),
                           np.array([1.0, 0.0])), "broke down"),
    "probe": lambda: ((np.full(3, np.sqrt(2.0)), np.full(3, 2.0 + 1e-13),
                       np.full(3, np.sqrt(2.0))), "probe"),
}


@pytest.mark.parametrize("case", sorted(SETUP_ERRORS))
def test_pcr_setup_refuses_like_jax(case):
    args, match = SETUP_ERRORS[case]()
    for mod in (ptri, jtri):
        with pytest.raises(ValueError, match=match):
            mod.pcr_setup(*args)


def test_bpcr_setup_refuses_like_jax():
    n = 1024
    lam = 2 * np.cos(np.pi / (n + 1))
    A = sp.diags([np.full(n - 1, -1.0), np.full(n, lam),
                  np.full(n - 1, -1.0)], [-1, 0, 1], format="csr")
    for mod in (ptri, jtri):
        with pytest.raises(ValueError, match="probe|singular|broke"):
            mod.bpcr_setup(*mod.banded_to_blocks(A, 2))


def _jax_cast_probe(host, d1, dtype):
    """The JAX package's cast probe (``tridiag.py:168-182``) computed in its
    own arithmetic: numpy in ``dtype`` (``ml_dtypes`` for bfloat16)."""
    x = jtri.pcr_apply_np(d1.astype(dtype), *(h.astype(dtype) for h in host))
    x = x.astype(np.float64)
    return np.max(np.abs(x - 1.0)) if np.all(np.isfinite(x)) else np.inf


@pytest.mark.parametrize("family", ["dominant", "test2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cast_probe_outcome_like_jax(family, dtype):
    """The probe through the apply dtype builds or raises as the JAX
    package's probe decides; bfloat16 rounds through torch.bfloat16 in the
    port and through ml_dtypes in the JAX package's arithmetic."""
    n = 1000
    if family == "dominant":
        a, b, c = np.full(n, -1.0), np.full(n, 4.0), np.full(n, -1.0)
    else:
        i = np.arange(n, dtype=np.float64)
        a, b, c = 2 * i, 2 * i + 1, 2 * i + 2
    host = jtri.pcr_setup(a, b, c)
    d1 = np.r_[0.0, a[1:]] + b + np.r_[c[:-1], 0.0]
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    jax_builds = _jax_cast_probe(host, d1, np_dt) <= ptri.CAST_PROBE_GATE
    # test2's family is no dominant band: fine in fp32, lost in bfloat16
    assert jax_builds == (family == "dominant" or dtype == "float32")
    if jax_builds:
        ptri.pcr_setup(a, b, c, apply_dtype=getattr(torch, dtype))
    else:
        with pytest.raises(ValueError, match="probe solve in the operator"):
            ptri.pcr_setup(a, b, c, apply_dtype=getattr(torch, dtype))


# ---- block PCR set-up on the device -------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bpcr_setup_device_matches_jax(comm8, dtype):
    """The device factorization (``-pc_setup_device 1`` on the CPU) against
    the JAX package's on its CPU mesh, and against the host set-up."""
    A = sp.csr_matrix(pentadiag(2000), dtype=dtype)
    blocks = ptri.banded_to_blocks(A, 2)
    dev = ptri.bpcr_setup_device(*blocks, CPU, dtype)
    jdev = jtri.bpcr_setup_device(*blocks, comm8, dtype)
    host = ptri.bpcr_setup(*blocks, apply_dtype=dtype)
    tol = 5e-4 if dtype == np.float32 else 1e-9
    for d, j, h in zip(dev, jdev, host):
        assert d.dtype == torch.from_numpy(np.zeros(0, dtype)).dtype
        np.testing.assert_allclose(d.numpy(), np.asarray(j), rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(d.numpy(), h.astype(dtype), rtol=tol,
                                   atol=tol)
    # the CSR route builds the same stacks from triplets
    timings = {}
    csr = ptri.bpcr_setup_device_csr(A, 2, CPU, dtype, timings=timings)
    for d, c in zip(dev, csr):
        np.testing.assert_array_equal(d.numpy(), c.numpy())
    assert set(timings) == {"extract_s", "invert_s"}


def _sign_indefinite(n, b, eps, seed=0):
    rng = np.random.default_rng(seed)
    Bb = np.stack([np.diag([eps * s, -eps * s])
                   for s in np.where(np.arange(n) % 2 == 0, 1.0, -1.0)])
    Ab = rng.standard_normal((n, b, b))
    Cb = rng.standard_normal((n, b, b))
    Ab[0] = 0.0
    Cb[-1] = 0.0
    return Ab, Bb, Cb


UNSTABLE = {
    "zero diagonal blocks": lambda: (
        np.random.default_rng(0).random((64, 2, 2)), np.zeros((64, 2, 2)),
        np.zeros((64, 2, 2))),
    "sign-indefinite 1e-4": lambda: _sign_indefinite(64, 2, 1e-4),
}


@pytest.mark.parametrize("case", sorted(UNSTABLE))
def test_device_probes_reject_like_jax(comm8, case):
    blocks = UNSTABLE[case]()
    for mod, comm in ((ptri, CPU), (jtri, comm8)):
        with pytest.warns(RuntimeWarning, match="probe"):
            assert mod.bpcr_setup_device(*blocks, comm, np.float64) is None


def test_device_stable_indefinite_member_builds(comm8):
    blocks = _sign_indefinite(64, 2, 1e-2)
    host = jtri.bpcr_setup(*blocks, apply_dtype=np.float64)
    dev = ptri.bpcr_setup_device(*blocks, CPU, np.float64)
    assert jtri.bpcr_setup_device(*blocks, comm8, np.float64) is not None
    for d, h in zip(dev, host):
        np.testing.assert_allclose(d.numpy(), h, rtol=1e-8, atol=1e-8)


# ---- PC lu/cholesky in the cyclic-reduction modes, under KSP preonly -------------

def _scrambled(A, seed=5):
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def _laplace1d(n):
    return sp.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                     np.full(n - 1, -1.0)], [-1, 0, 1], format="csr")


def _uneven_tail(n=387):
    d1, d2 = np.full(n - 1, -1.0), np.full(n - 2, -0.4)
    return sp.diags([d2, d1, np.full(n, 3.5), d1, d2], [-2, -1, 0, 1, 2],
                    format="csr")


# (operator, expected mode, PC arrays); the dense cap is lowered to 64
DIRECT = {
    "crtri-test2": (lambda: tridiag_family(100), "crtri", 3),
    "crtri-laplace": (lambda: _laplace1d(211), "crtri", 3),
    "crband-tail": (_uneven_tail, "crband", 3),
    "crband-bw8": (lambda: _banded(300, 8, 13), "crband", 3),
    "crband-rcm": (lambda: _scrambled(poisson2d_csr(12)), "crband", 5),
}


def _refine_steps(apply_np, A, b):
    """Refinement steps KSP preonly takes with the factor ``apply_np``
    (the loop of JAX ``krylov.preonly_kernel``, replayed on the host)."""
    x = apply_np(b)
    rn = np.linalg.norm(b - A @ x)
    k, go = 0, rn > 0
    while go:
        x2 = x + apply_np(b - A @ x)
        rn2 = np.linalg.norm(b - A @ x2)
        go = rn2 < 0.5 * rn and k + 1 < 20
        if rn2 < rn:
            x, rn = x2, rn2
        k += 1
    return k


def _jax_apply_np(jpc, n):
    """The JAX PC's factor as a host fp64 solve (its own arrays)."""
    arrs = [np.asarray(a) for a in jpc.device_arrays()]
    if jpc.kind == "crtri":
        return lambda d: jtri.pcr_apply_np(d, *arrs)
    N, b = arrs[2].shape[:2]

    def solve(d):
        if len(arrs) == 5:
            d = d[arrs[3]]
        x = jtri.bpcr_apply_np(np.r_[d, np.zeros(N * b - n)].reshape(N, b),
                               *arrs[:3]).reshape(-1)[:n]
        return x if len(arrs) == 3 else x[arrs[4]]
    return solve


def _direct(pkg, comm, A, b, pc_type, setup_device="auto",
            dtype=np.float64):
    M = pkg.Mat.from_scipy(comm, A, dtype=dtype)
    ksp = pkg.KSP().create(comm)
    ksp.set_operators(M)
    ksp.set_type("preonly")
    ksp.get_pc().set_type(pc_type)
    ksp.get_pc().set_factor_solver_type("mumps")
    ksp.get_pc().setup_device = setup_device
    x, bv = M.get_vecs()
    bv.set_global(b.astype(dtype))
    res = ksp.solve(bv, x)
    return res, x.to_numpy(), ksp.get_pc()


@pytest.mark.parametrize("ndev,pc_type", [(1, "lu"), (2, "cholesky"),
                                          (4, "lu"), (8, "lu")])
@pytest.mark.parametrize("case", sorted(DIRECT))
def test_preonly_cr_modes_match_jax(case, ndev, pc_type, monkeypatch):
    make, mode, narrays = DIRECT[case]
    A = make().tocsr()
    if pc_type == "cholesky" and (A != A.T).nnz:
        pc_type = "lu"                 # the unsymmetric band takes lu
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", 64)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", 64)
    n = A.shape[0]
    b = A @ np.random.default_rng(7).random(n)
    jres, jx, jpc = _direct(tps, tps.DeviceComm(n_devices=ndev), A, b,
                            pc_type)
    res, x, pc = _direct(pt, pt.DeviceComm(ndev, device="cpu"), A, b,
                         pc_type)
    assert pc.kind == jpc.kind == mode
    assert pc.program_key() == jpc.program_key()
    assert len(pc._arrays) == len(jpc.device_arrays()) == narrays
    assert (res.iterations, res.reason) == (1, jres.reason)
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=1e-10 * np.abs(jx).max())
    assert res.residual_norm == pytest.approx(jres.residual_norm, rel=1e-3,
                                              abs=1e-13 * np.linalg.norm(b))
    # preonly refines these kinds: one host read per step after the first
    assert res.host_syncs - 1 == _refine_steps(_jax_apply_np(jpc, n), A, b)
    assert res.host_syncs >= 2


@pytest.mark.parametrize("case,dtype,tol", [
    ("crband-tail", np.float64, 1e-10), ("crband-rcm", np.float64, 1e-10),
    ("crband-tail", np.float32, 5e-6)])
def test_preonly_crband_device_setup_matches_jax(case, dtype, tol,
                                                 monkeypatch):
    """``-pc_setup_device 1``: the block PCR factor made by the device
    program in both packages, fp32 recovered by preonly's refinement."""
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", 64)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", 64)
    A = sp.csr_matrix(DIRECT[case][0](), dtype=dtype)
    b = (A @ np.random.default_rng(1).random(A.shape[0])).astype(dtype)
    jres, jx, jpc = _direct(tps, tps.DeviceComm(n_devices=4), A, b, "lu",
                            "1", dtype)
    res, x, pc = _direct(pt, pt.DeviceComm(4, device="cpu"), A, b, "lu",
                         "1", dtype)
    assert pc.setup_mode == jpc.setup_mode == "device"
    assert set(pc.setup_breakdown) == {"extract_s", "invert_s"}
    assert pc.program_key() == jpc.program_key()
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    for xx in (x, jx):
        rr = np.linalg.norm(b64 - A64 @ xx.astype(np.float64)) \
            / np.linalg.norm(b64)
        assert rr <= tol, rr
    if dtype == np.float64:
        np.testing.assert_allclose(x, jx, rtol=0,
                                   atol=1e-10 * np.abs(jx).max())


def _block_band(blocks):
    """The CSR of a block-tridiagonal ``(Ab, Bb, Cb)`` (a band of 3 for
    2 x 2 blocks)."""
    Ab, Bb, Cb = blocks
    N = Bb.shape[0]
    rows = [[Bb[i] if j == i else Ab[i] if j == i - 1 else
             Cb[i] if j == i + 1 else None for j in range(N)]
            for i in range(N)]
    return sp.bmat(rows).tocsr()


@pytest.mark.parametrize("eps,host_builds", [(1e-4, True), (1e-6, False)])
def test_device_probe_rejection_takes_host_setup(comm8, eps, host_builds,
                                                 monkeypatch):
    """A band whose device factor fails its probe is set up on the host, in
    both packages: it builds there (``setup_mode`` 'host'), or raises the
    host path's ValueError. No device exception is involved."""
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", 64)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", 64)
    A = _block_band(_sign_indefinite(64, 2, eps))
    for pkg, comm in ((tps, comm8), (pt, pt.DeviceComm(8, device="cpu"))):
        pc = pkg.PC(comm).set_type("lu")
        pc.setup_device = "1"
        m = pkg.Mat.from_scipy(comm, A)
        with pytest.warns(RuntimeWarning, match="probe"):
            if host_builds:
                pc.set_up(m)
                assert pc.kind == "crband" and pc.setup_mode == "host"
            else:
                with pytest.raises(ValueError, match="probe"):
                    pc.set_up(m)


def test_iterative_ksp_applies_cr_factor(monkeypatch):
    """GMRES with PC lu in crtri mode converges in one iteration, as the
    JAX package's does (an exact preconditioner)."""
    monkeypatch.setattr(jax_pc, "_DENSE_CAP", 64)
    monkeypatch.setattr(port_pc, "_DENSE_CAP", 64)
    A = _laplace1d(150)
    b = A @ np.random.default_rng(4).random(150)
    out = []
    for pkg, comm in ((tps, tps.DeviceComm(n_devices=2)),
                      (pt, pt.DeviceComm(2, device="cpu"))):
        M = pkg.Mat.from_scipy(comm, A)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(M)
        ksp.set_type("gmres")
        ksp.get_pc().set_type("lu")
        ksp.set_tolerances(rtol=1e-10)
        x, bv = M.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((res.iterations, int(res.reason), x.to_numpy()))
    assert out[0][:2] == out[1][:2]
    np.testing.assert_allclose(out[1][2], out[0][2], rtol=0, atol=1e-10)
