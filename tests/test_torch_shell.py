"""The PyTorch port's matrix-free ``ShellMat`` and the user PCs ``shell``
and ``composite`` against the JAX package.

The same operator is a jnp callable in the JAX package and a torch callable
in the port (a dense product of the scipy matrix); both solve the same
seeded numpy problem on 1/2/4/8 shards, fp64: iterations and reasons equal,
iterates within 1e-10. The cases follow the JAX package's
``tests/test_shell.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402

SHARDS = [1, 2, 4, 8]
X_TOL = 1e-10


@pytest.fixture(autouse=True)
def clean_port_options():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def poisson2d(nx):
    T = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    return (sp.kron(sp.eye(nx), T) + sp.kron(T, sp.eye(nx))).tocsr()


def unsym(nx=9):
    """A diagonally dominant unsymmetric operator (upwinded convection)."""
    A = poisson2d(nx)
    n = A.shape[0]
    return (A + sp.diags([0.4 * np.ones(n - 1)], [1]) + 2 * sp.eye(n)).tocsr()


def shell(pkg, comm, A, transpose=True, diagonal=True):
    """A shell applying the scipy matrix ``A`` densely: a jnp callable for
    the JAX package, a torch one for the port."""
    if pkg is tps:
        Ad = jnp.asarray(A.toarray())
        mult, mult_t = (lambda x: Ad @ x), (lambda x: Ad.T @ x)
    else:
        Ad = torch.tensor(A.toarray())
        mult, mult_t = (lambda x: Ad @ x), (lambda x: Ad.T @ x)
    return pkg.ShellMat(comm, A.shape, mult,
                        mult_transpose=mult_t if transpose else None,
                        diagonal=np.asarray(A.diagonal()) if diagonal
                        else None)


def comms(ndev):
    return ((tps, tps.DeviceComm(n_devices=ndev)),
            (pt, pt.DeviceComm(ndev, device="cpu")))


def solve_both(ndev, make_op, b, ksp_type="cg", setup_pc=None, rtol=1e-10,
               max_it=5000):
    out = []
    for pkg, comm in comms(ndev):
        op = make_op(pkg, comm)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_type(ksp_type)
        if setup_pc is not None:
            setup_pc(pkg, ksp.get_pc())
        ksp.set_tolerances(rtol=rtol, max_it=max_it)
        x, bv = op.get_vecs()
        bv.set_global(b)
        res = ksp.solve(bv, x)
        out.append((res, x.to_numpy(), ksp))
    (jres, jx, jksp), (res, x, ksp) = out
    assert (res.iterations, res.reason) == (jres.iterations,
                                            int(jres.reason)), (res, jres)
    np.testing.assert_allclose(x, jx, rtol=0,
                               atol=X_TOL * max(np.abs(jx).max(), 1.0))
    return res, x, ksp


def rhs(A, seed=0):
    return A @ np.random.default_rng(seed).random(A.shape[0])


def pc_type(t):
    return lambda pkg, pc: pc.set_type(t)


# ---- ShellMat -----------------------------------------------------------------------

@pytest.mark.parametrize("ndev", SHARDS)
def test_mult_matches_assembled_and_jax(ndev):
    A = unsym()
    x = np.random.default_rng(ndev).random(A.shape[0])
    (_, jc), (_, pc) = comms(ndev)
    jS, S = shell(tps, jc, A), shell(pt, pc, A)
    xv = pt.Vec.from_global(pc, x)
    np.testing.assert_allclose(S.mult(xv).to_numpy(), A @ x, atol=1e-13)
    np.testing.assert_allclose(S.mult_transpose(xv).to_numpy(), A.T @ x,
                               atol=1e-13)
    np.testing.assert_allclose(
        S.mult(xv).to_numpy(),
        jS.mult(tps.Vec.from_global(jc, x)).to_numpy(), atol=1e-13)
    y = pt.Vec(pc, A.shape[0])
    assert S.mult(xv, y) is y and torch.all(y.data[A.shape[0]:] == 0)


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("ksp_type,pc", [("cg", "jacobi"), ("cg", "none"),
                                         ("gmres", "jacobi"),
                                         ("bcgs", "jacobi"),
                                         ("fgmres", "jacobi")])
def test_krylov_on_shell_like_jax(ksp_type, pc, ndev):
    A = poisson2d(8) if ksp_type == "cg" else unsym()
    res, x, _ = solve_both(ndev, lambda pkg, c: shell(pkg, c, A), rhs(A),
                           ksp_type, pc_type(pc))
    assert res.converged


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("ksp_type", ["lsqr", "bicg", "cgne"])
def test_transpose_ksp_on_shell_like_jax(ksp_type, ndev):
    A = unsym()
    res, x, _ = solve_both(ndev, lambda pkg, c: shell(pkg, c, A), rhs(A),
                           ksp_type, rtol=1e-8)
    assert res.converged
    assert np.linalg.norm(A @ x - rhs(A)) <= 1e-6 * np.linalg.norm(rhs(A))


@pytest.mark.parametrize("ndev", [1, 4])
def test_variable_coefficient_shell_like_jax(ndev):
    """``examples/advanced.py``'s scenario 1 at 12^2: the Laplacian plus a
    variable diagonal, never assembled."""
    A = poisson2d(12)
    n = A.shape[0]
    w = 1.0 + np.arange(n) / n

    def make(pkg, comm):
        if pkg is tps:
            Ad, wd = jnp.asarray(A.toarray()), jnp.asarray(w)
        else:
            Ad, wd = torch.tensor(A.toarray()), torch.tensor(w)
        return pkg.ShellMat(comm, n, lambda v: Ad @ v + wd * v,
                            diagonal=A.diagonal() + w)

    x_true = np.random.default_rng(7).random(n)
    res, x, _ = solve_both(ndev, make, (A + sp.diags(w)) @ x_true, "cg",
                           pc_type("jacobi"))
    assert res.converged and np.abs(x - x_true).max() < 1e-8


def test_shell_refusals_like_jax():
    A = poisson2d(4)
    for pkg, comm in comms(2):
        S = shell(pkg, comm, A, transpose=False, diagonal=False)
        with pytest.raises(ValueError, match="no diagonal"):
            S.diagonal()
        with pytest.raises(ValueError, match="no mult_transpose"):
            S.mult_transpose(S.get_vecs()[0])
        with pytest.raises(ValueError, match="no mult_transpose"):
            S.local_spmv_t(comm)
        with pytest.raises(ValueError, match="square"):
            pkg.ShellMat(comm, (4, 5), lambda v: v)
    S1, S2 = shell(pt, comm, A), shell(pt, comm, A)
    assert S1.program_key() != S2.program_key()


def test_shell_takes_the_general_route_and_is_not_batched():
    from mpi_petsc4py_example_tpu_torch.solvers.krylov import (
        stencil_cg_eligible)
    A = poisson2d(4)
    comm = pt.DeviceComm(2, device="cpu")
    S = shell(pt, comm, A)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(S)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.set_tolerances(rtol=1e-10)
    assert not stencil_cg_eligible("cg", ksp.get_pc(), S)
    B = np.stack([rhs(A, s) for s in range(3)], axis=1)
    res = ksp.solve_many(B)
    for j in range(3):
        np.testing.assert_allclose(A @ res.X[:, j], B[:, j], atol=1e-8)


# ---- PC shell -------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", SHARDS)
def test_shell_pc_jacobi_equivalence_like_jax(ndev):
    """A PC shell dividing by the diagonal runs as PC jacobi does."""
    A = poisson2d(8)
    d = A.diagonal()

    def setup(pkg, pc):
        pc.set_type("shell")
        dd = jnp.asarray(d) if pkg is tps else torch.tensor(d)
        pc.set_shell_apply(lambda r: r / dd)

    b = rhs(A)
    res, x, _ = solve_both(ndev, lambda pkg, c: pkg.Mat.from_scipy(c, A), b,
                           "cg", setup)
    ref, xr, _ = solve_both(ndev, lambda pkg, c: pkg.Mat.from_scipy(c, A), b,
                            "cg", pc_type("jacobi"))
    assert res.iterations == ref.iterations
    np.testing.assert_allclose(x, xr, atol=1e-12)


@pytest.mark.parametrize("ndev", [1, 4])
def test_bicg_with_shell_pc_transpose_like_jax(ndev):
    A = unsym()
    d = A.diagonal()

    def setup(pkg, pc):
        pc.set_type("shell")
        dd = jnp.asarray(d) if pkg is tps else torch.tensor(d)
        pc.set_shell_apply(lambda r: r / dd)
        pc.set_shell_apply_transpose(lambda r: r / dd)

    res, _, _ = solve_both(ndev, lambda pkg, c: pkg.Mat.from_scipy(c, A),
                           rhs(A), "bicg", setup, rtol=1e-8)
    assert res.converged


def test_shell_pc_refusals_and_keys():
    A = poisson2d(4)
    comm = pt.DeviceComm(1, device="cpu")
    M = pt.Mat.from_scipy(comm, A)
    pc = pt.PC(comm)
    pc.set_type("shell")
    with pytest.raises(RuntimeError, match="set_shell_apply"):
        pc.set_up(M)
    pc.set_shell_apply(lambda r: r)
    key = pc.set_up(M).program_key()
    other = pt.PC(comm).set_type("shell").set_shell_apply(lambda r: 2 * r)
    assert other.set_up(M).program_key() != key
    # a new apply rebuilds, with a new key
    pc.set_shell_apply(lambda r: 3 * r)
    assert pc.set_up(M).program_key() != key
    z = pc.local_apply(comm, 16)(torch.ones(1, 16, dtype=torch.float64))
    assert torch.all(z == 3)
    # no transpose apply: bicg is refused, as in the JAX package
    assert pc.local_apply_transpose(comm, 16) is None


# ---- PC composite ---------------------------------------------------------------------

def composite(ctype, children=("jacobi", "sor")):
    def setup(pkg, pc):
        pc.set_type("composite")
        pc.set_composite_type(ctype)
        pc.set_composite_pcs(*children)
    return setup


@pytest.mark.parametrize("ndev", SHARDS)
@pytest.mark.parametrize("ctype", ["additive", "multiplicative"])
def test_composite_converges_like_jax(ctype, ndev):
    A = unsym(8)
    res, _, _ = solve_both(ndev, lambda pkg, c: pkg.Mat.from_scipy(c, A),
                           rhs(A), "gmres", composite(ctype), rtol=1e-8)
    assert res.converged


def test_multiplicative_beats_single_child():
    A = poisson2d(10)
    its = {}
    for name, setup in (("jacobi", pc_type("jacobi")),
                        ("mult", composite("multiplicative",
                                           ("jacobi", "jacobi")))):
        res, _, _ = solve_both(2, lambda pkg, c: pkg.Mat.from_scipy(c, A),
                               rhs(A), "fgmres", setup, rtol=1e-8)
        its[name] = res.iterations
    assert its["mult"] <= its["jacobi"]


def test_additive_is_sum_of_children():
    A = unsym(6)
    comm = pt.DeviceComm(2, device="cpu")
    M = pt.Mat.from_scipy(comm, A)
    n = A.shape[0]
    r = torch.tensor(np.random.default_rng(1).random(n)).view(2, -1)
    pc = pt.PC(comm).set_type("composite").set_composite_pcs("jacobi", "sor")
    pc.set_up(M)
    z = pc.local_apply(comm, n)(r)
    parts = [c.local_apply(comm, n)(r) for c in pc._sub_pcs]
    torch.testing.assert_close(z, parts[0] + parts[1], rtol=0, atol=1e-15)
    assert pc.get_composite_pc(1).get_type() == "sor"
    key = pc.program_key()
    assert key[:2] == ("composite", "additive") and len(key) == 5
    # additive of transpose-capable children has a transpose apply;
    # multiplicative has none (JAX pc.py:707-720)
    assert pc.local_apply_transpose(comm, n) is not None
    pc.set_composite_type("multiplicative")
    assert pc.local_apply_transpose(comm, n) is None


def test_composite_options_wiring_like_jax():
    opts = ["prog", "-pc_type", "composite", "-pc_composite_type",
            "multiplicative", "-pc_composite_pcs", "jacobi,sor"]
    A = unsym(6)
    for pkg, comm in comms(1):
        pkg.init(opts)
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(pkg.Mat.from_scipy(comm, A))
        ksp.set_from_options()
        pc = ksp.get_pc()
        assert pc.get_type() == "composite"
        assert pc.composite_type == "multiplicative"
        assert [c.get_type() for c in pc._sub_pcs] == ["jacobi", "sor"]
        pkg.global_options().clear()


def test_composite_refusals_like_jax():
    A = poisson2d(4)
    for pkg, comm in comms(1):
        M = pkg.Mat.from_scipy(comm, A)
        pc = pkg.PC(comm).set_type("composite")
        with pytest.raises(RuntimeError, match="no children"):
            pc.set_up(M)
        with pytest.raises(ValueError, match="composite type"):
            pc.set_composite_type("sideways")
