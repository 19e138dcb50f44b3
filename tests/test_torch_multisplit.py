"""The asynchronous multisplitting tier of the PyTorch port against the JAX
package: the stale exchange (``parallel/exchange.py``), the ``comm.delay``
timing fault, ``MultisplitSolver`` with its degradation under jitter,
partition and device loss, the server's ``multisplit`` schedule class and
the tier's telemetry: every scenario of ``tests/test_multisplit.py``.

The exchange and the fault draws are deterministic, so each scenario runs on
both packages and their observations are equal. The solves are not: block
threads interleave as the scheduler lets them, so outer step counts and
walls differ run to run in either package. A solve is held by what the
contract fixes: the reason, the consistent-cut residual against the target,
the true residual of the returned iterate, version monotonicity, the
counters, and the iterate against the JAX package's (computed once a module)
within the tolerance both meet. Every wait has a timeout and injected
latencies stay in milliseconds.
"""

import io

import numpy as np
import pytest
import scipy.sparse as sp

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.parallel import (  # noqa: E402
    exchange as jexchange)
from mpi_petsc4py_example_tpu.resilience import faults as jfaults  # noqa: E402
from mpi_petsc4py_example_tpu.solvers import multisplit as jms  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.parallel import exchange  # noqa: E402
from mpi_petsc4py_example_tpu_torch.resilience import faults  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import multisplit  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers.multisplit import (  # noqa: E402
    MultisplitSolver)
from mpi_petsc4py_example_tpu_torch.telemetry import (  # noqa: E402
    metrics as _metrics)


@pytest.fixture(autouse=True)
def clean_port_state():
    pt.global_options().clear()
    faults.heal()
    yield
    pt.global_options().clear()
    faults.heal()


def tridiag(n, diag=4.0):
    """Block-diagonally-dominant model operator (the classical
    multisplitting convergence condition): cfg16's operator."""
    return sp.diags([-1.0, diag, -1.0], [-1, 0, 1], shape=(n, n),
                    format="csr")


def manufactured(A, seed=0):
    x = np.random.default_rng(seed).random(A.shape[0])
    return x, np.asarray(A @ x)


def comm_cpu(ndev=8):
    return pt.DeviceComm(ndev, device="cpu")


def relres(A, x, b):
    return np.linalg.norm(b - A @ x) / np.linalg.norm(b)


# ---- the exchange: each scenario on both packages ---------------------------

def _publish_monotonic(ex_mod, inject):
    ex = ex_mod.StaleExchange(2)
    return (ex.publish(0, np.zeros(2)), ex.publish(0, np.ones(2)),
            ex.versions())


def _read_never_blocks(ex_mod, inject):
    ex = ex_mod.StaleExchange(2)
    ex.publish(1, np.full(2, 7.0))
    r = ex.read(1, reader_version=4)
    ex.publish(1, np.zeros(2))
    ex.publish(1, np.zeros(2))
    return (type(r).__name__, r.version, r.age, r.payload.tolist(),
            ex.read(1, reader_version=1).age)


def _unpublished_slot(ex_mod, inject):
    r = ex_mod.StaleExchange(3).read(2, reader_version=5)
    return r.payload, r.version, r.age


def _read_all_excludes_self(ex_mod, inject):
    ex = ex_mod.StaleExchange(3)
    for b in range(3):
        ex.publish(b, np.full(1, float(b)))
    return sorted(ex.read_all(1, 1))


def _staleness_bound(ex_mod, inject):
    reads = {0: ex_mod.ExchangeRead(None, 1, 2),
             2: ex_mod.ExchangeRead(None, 1, 5)}
    out = [ex_mod.check_staleness_bound(reads, 4),
           ex_mod.check_staleness_bound(reads, 5)]
    with pytest.raises(ex_mod.StalenessBoundExceeded) as err:
        ex_mod.check_staleness_bound(reads, 4, strict=True)
    return out + [str(err.value)]


def _cut_matching_versions(ex_mod, inject):
    ex = ex_mod.StaleExchange(2, history=4)
    out = [ex.consistent_cut()]
    ex.publish(0, np.array([1.0]))
    out.append(ex.consistent_cut())
    ex.publish(1, np.array([2.0]))
    ex.publish(0, np.array([3.0]))
    cut, payloads = ex.consistent_cut()
    return out + [cut, payloads[0][0], payloads[1][0]]


def _cut_refuses_pruned(ex_mod, inject):
    ex = ex_mod.StaleExchange(2, history=2)
    ex.publish(1, np.array([0.0]))
    for k in range(5):
        ex.publish(0, np.array([float(k)]))
    return ex.consistent_cut()


def _mark_lost_freezes(ex_mod, inject):
    ex = ex_mod.StaleExchange(2, history=4)
    ex.publish(0, np.array([1.0]))
    ex.publish(1, np.array([5.0]))
    ex.publish(1, np.array([6.0]))
    ex.mark_lost(0)
    with pytest.raises(RuntimeError):
        ex.publish(0, np.array([9.0]))
    cut, payloads = ex.consistent_cut()
    return cut, payloads[0][0], sorted(ex.lost()), repr(ex)


def _republish_never_from_zero(ex_mod, inject):
    ex = ex_mod.StaleExchange(2, history=4)
    for _ in range(3):
        ex.publish(0, np.zeros(1))
    ex.mark_lost(0)
    with pytest.raises(ValueError):
        ex.republish(0, np.zeros(1), version=1)
    ex.republish(0, np.ones(1))
    return ex.version(0), ex.publish(0, np.ones(1)), sorted(ex.lost())


def _wait_for_timeout_and_lost(ex_mod, inject):
    ex = ex_mod.StaleExchange(2)
    first = ex.wait_for(1, 1, timeout=0.01)
    ex.mark_lost(1)
    return first, ex.wait_for(1, 99, timeout=0.01)


def _put_drop_fault(ex_mod, inject):
    ex = ex_mod.StaleExchange(2)
    ex.publish(0, np.array([1.0]))
    with inject("exchange.put=drop:device=0:times=2") as plan:
        got = [ex.publish(0, np.array([v])) for v in (2.0, 3.0, 4.0)]
        hits = [(f.hits, f.fired) for f in plan]
    return got, ex.drops, ex.read(0, 0).version, hits


def _put_partition_fault(ex_mod, inject):
    """A partitioned peer: every publish of block 1 is discarded while the
    clause is armed; block 0's go through."""
    ex = ex_mod.StaleExchange(2)
    with inject("exchange.put=partition:device=1:times=*"):
        got = [ex.publish(b, np.array([1.0])) for b in (0, 1, 1, 0)]
    return got, ex.drops, ex.versions(), ex.publish(1, np.array([2.0]))


EXCHANGE = {f.__name__[1:]: f for f in (
    _publish_monotonic, _read_never_blocks, _unpublished_slot,
    _read_all_excludes_self, _staleness_bound, _cut_matching_versions,
    _cut_refuses_pruned, _mark_lost_freezes, _republish_never_from_zero,
    _wait_for_timeout_and_lost, _put_drop_fault, _put_partition_fault)}


def _plain(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("name", sorted(EXCHANGE))
def test_exchange_scenario_matches_jax(name):
    want = EXCHANGE[name](jexchange, tps.inject_faults)
    got = EXCHANGE[name](exchange, pt.inject_faults)
    assert _plain(got) == _plain(want)


def test_exchange_expectations():
    """The JAX tests' own expectations, on the port's exchange."""
    inj = pt.inject_faults
    assert _publish_monotonic(exchange, inj) == (1, 2, (2, 0))
    assert _read_never_blocks(exchange, inj) == ("ExchangeRead", 1, 3,
                                                 [7.0, 7.0], 0)
    assert _unpublished_slot(exchange, inj) == (None, 0, 5)
    assert _staleness_bound(exchange, inj)[:2] == [(2,), ()]
    assert _cut_matching_versions(exchange, inj) == [None, None, 1, 1.0,
                                                     2.0]
    assert _cut_refuses_pruned(exchange, inj) is None
    assert _mark_lost_freezes(exchange, inj)[:3] == (2, 1.0, [0])
    assert _republish_never_from_zero(exchange, inj) == (3, 4, [])
    assert _wait_for_timeout_and_lost(exchange, inj) == (False, True)
    got, drops, version, _ = _put_drop_fault(exchange, inj)
    assert (got, drops, version) == ([None, None, 2], 2, 2)


def test_exchange_imports_nothing_of_torch():
    import ast
    import inspect
    src = inspect.getsource(exchange)
    mods = {n.module or "" for n in ast.walk(ast.parse(src))
            if isinstance(n, ast.ImportFrom)}
    mods |= {a.name for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Import) for a in n.names}
    assert not any(m.split(".")[0] in ("torch", "jax", "numpy")
                   for m in mods)


# ---- the comm.delay timing fault --------------------------------------------

def test_delay_spec_parses_as_jax():
    spec = "comm.delay=delay:device=1:times=*:mean=0.02:seed=7"
    (f,), (jf,) = faults.parse_spec(spec), jfaults.parse_spec(spec)
    for attr in ("point", "kind", "device", "forever", "mean"):
        assert getattr(f, attr) == getattr(jf, attr)
    assert f.device == 1 and f.forever and f.mean == 0.02


def test_unseeded_delay_is_exact_and_device_filtered():
    spec = "comm.delay=delay:device=1:times=*:mean=0.005"
    for mod, inject in ((faults, pt.inject_faults),
                        (jfaults, tps.inject_faults)):
        with inject(spec):
            assert mod.delay_seconds("comm.delay", device=1) == 0.005
            assert mod.delay_seconds("comm.delay", device=2) == 0.0
        assert mod.delay_seconds("comm.delay", device=1) == 0.0


@pytest.mark.parametrize("spec", [
    "comm.delay=delay:times=*:mean=0.01:seed=3",
    "comm.delay=delay:times=*:mean=0.02:seed=16:prob=0.5",
    "comm.delay=delay:device=0:at=2:times=3:mean=0.004"])
def test_seeded_delays_reproduce_jax_draws(spec):
    """The same spec draws the same delays in either package (one
    ``random.Random(seed)`` stream each), and again on a re-arm."""
    draws = []
    for mod, inject in ((faults, pt.inject_faults),
                        (faults, pt.inject_faults),
                        (jfaults, tps.inject_faults)):
        with inject(spec):
            draws.append([mod.delay_seconds("comm.delay", device=0)
                          for _ in range(6)])
    assert draws[0] == draws[1] == draws[2]
    if "seed" in spec and "prob" not in spec:
        assert all(d > 0 for d in draws[0]) and len(set(draws[0])) > 1


# ---- the solver -------------------------------------------------------------

# (case, n, nblocks, seed, rtol, keywords): tests/test_multisplit.py's solves
SOLVES = {
    "parity": (256, 4, 1, 1e-10, {}),
    "history": (192, 3, 2, 1e-8, {}),
    "forcing": (256, 4, 3, 1e-10, {"inner_rtol": 1e-2}),
    "stale_override": (192, 4, 6, 1e-9, {"max_stale": 6}),
}


@pytest.fixture(scope="module")
def jax_solves():
    out = {}
    comm = tps.DeviceComm()
    for case, (n, nb, seed, rtol, kw) in SOLVES.items():
        A = tridiag(n)
        _, b = manufactured(A, seed)
        ms = jms.MultisplitSolver(comm, nblocks=nb, rtol=rtol, **kw)
        ms.set_operator(A)
        res = ms.solve(b, max_stale=1 if case == "stale_override" else None)
        out[case] = res
    return out


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(SOLVES))
def test_solve_matches_jax(case, ndev, jax_solves):
    n, nb, seed, rtol, kw = SOLVES[case]
    A = tridiag(n)
    x_true, b = manufactured(A, seed)
    ms = MultisplitSolver(comm_cpu(ndev), nblocks=nb, rtol=rtol, **kw)
    ms.set_operator(A)
    res = ms.solve(b, max_stale=1 if case == "stale_override" else None)
    jres = jax_solves[case]
    assert res.converged, res
    assert res.reason == int(jres.reason)
    bn = np.linalg.norm(b)
    assert res.residual_norm <= rtol * bn
    assert relres(A, res.x, b) <= rtol
    # both iterates meet the same target, so they agree to what it fixes:
    # |x - x_jax| <= ||A^-1|| (||r|| + ||r_jax||) <= rtol ||b|| (the
    # smallest eigenvalue of diags([-1, 4, -1]) is above 2)
    np.testing.assert_allclose(res.x, jres.x, rtol=0, atol=rtol * bn)
    np.testing.assert_allclose(res.x, x_true, rtol=0, atol=0.5 * rtol * bn)
    assert res.cut_version > 0 and res.iterations == res.cut_version
    assert len(res.block_steps) == nb and all(s > 0 for s in res.block_steps)
    versions = [v for v, _ in res.history]
    assert versions == sorted(versions)
    assert res.history[-1] == (res.cut_version, res.residual_norm)
    assert res.max_stale_seen >= 0 and res.blocks_lost == 0 == jres.blocks_lost
    assert all(v >= res.cut_version for v in ms._exchange.versions())


def test_warm_start_and_resolve():
    A = tridiag(192)
    _, b = manufactured(A, seed=4)
    ms = MultisplitSolver(comm_cpu(8), nblocks=2, rtol=1e-9)
    ms.set_operator(A)
    cold = ms.solve(b)
    warm = ms.solve(b, x0=cold.x)
    assert warm.converged
    assert warm.cut_version <= cold.cut_version


def test_warm_start_holds_from_the_first_cut():
    """A neighbour that has not published yet is read at its initial guess
    (its version 0), so a solve started from a converged iterate converges
    at the first consistent cut (the JAX package reads it as zero, and each
    block's first step undoes the warm start)."""
    A = tridiag(192)
    _, b = manufactured(A, seed=4)
    ms = MultisplitSolver(comm_cpu(8), nblocks=2, rtol=1e-9)
    ms.set_operator(A)
    cold = ms.solve(b)
    warm = ms.solve(b, x0=cold.x)
    assert warm.converged and warm.cut_version == 1
    assert warm.history[0][1] <= 1e-9 * np.linalg.norm(b)
    with pytest.raises(ValueError, match="x0"):
        ms.solve(b, x0=cold.x[:-1])


@pytest.mark.parametrize("ndev", [2, 8])
def test_operator_can_be_a_port_mat(ndev):
    A = tridiag(128)
    _, b = manufactured(A, seed=5)
    comm = comm_cpu(ndev)
    ms = MultisplitSolver(comm, nblocks=2, rtol=1e-9)
    ms.set_operator(pt.Mat.from_scipy(comm, A))
    res = ms.solve(b)
    assert res.converged
    assert relres(A, res.x, b) <= 1e-9


def test_complex_hermitian_operator():
    """A complex Hermitian, diagonally dominant operator (the JAX tier's
    residual is real-only; the port's sums ``conj(r) r``): the solve meets
    its target against the scipy residual."""
    n = 192
    ph = np.exp(0.4j)
    A = sp.diags([-np.conj(ph) * np.ones(n - 1), 4.0 * np.ones(n),
                  -ph * np.ones(n - 1)], [-1, 0, 1], format="csr")
    rng = np.random.default_rng(7)
    x_true = rng.random(n) + 1j * rng.random(n)
    b = A @ x_true
    ms = MultisplitSolver(comm_cpu(4), nblocks=3, rtol=1e-10)
    ms.set_operator(A)
    res = ms.solve(b)
    assert res.converged and res.x.dtype == np.complex128
    assert relres(A, res.x, b) <= 1e-10
    # the eigenvalues of A lie in [2, 6]: |x - x_true| <= rtol ||b|| / 2
    np.testing.assert_allclose(res.x, x_true, rtol=0,
                               atol=0.5e-10 * np.linalg.norm(b))


def test_bad_inputs_raise():
    ms = MultisplitSolver(comm_cpu(8), nblocks=2)
    with pytest.raises(RuntimeError):
        ms.solve(np.zeros(4))                  # set_operator first
    with pytest.raises(ValueError):
        ms.set_operator(np.zeros((3, 4)))       # non-square
    ms.set_operator(tridiag(64))
    with pytest.raises(ValueError):
        ms.solve(np.zeros(65))                  # rhs length mismatch
    with pytest.raises(ValueError, match="max_stale"):
        ms.solve(np.ones(64), max_stale=-1)


@pytest.mark.parametrize("kw,flag", [({"nblocks": 0}, "blocks"),
                                     ({"max_stale": -1}, "max_stale"),
                                     ({"inner_max_it": 0}, "inner_max_it"),
                                     ({"max_outer": 0}, "max_outer"),
                                     ({"inner_type": "nope"}, "nope")])
def test_values_it_cannot_honour_raise(kw, flag):
    """The JAX package clamps these (``max(1, ...)``); the port raises, from
    a keyword or a flag alike."""
    with pytest.raises(ValueError, match=flag):
        MultisplitSolver(comm_cpu(2), **kw)
    (key, value), = kw.items()
    name = {"nblocks": "blocks"}.get(key, key)
    pt.global_options().set(f"multisplit_{name}", value)
    with pytest.raises(ValueError, match=flag):
        MultisplitSolver(comm_cpu(2))


def test_flags_set_defaults_kwargs_override():
    out = []
    for pkg, ms_mod, comm in ((tps, jms, tps.DeviceComm()),
                              (pt, multisplit, comm_cpu(8))):
        opts = pkg.global_options()
        opts.set("multisplit_blocks", "3")
        opts.set("multisplit_max_stale", "7")
        opts.set("multisplit_inner_type", "pipecg")
        opts.set("multisplit_inner_rtol", "1e-3")
        opts.set("multisplit_inner_max_it", "20")
        opts.set("multisplit_max_outer", "40")
        opts.set("multisplit_resync_timeout", "2.5")
        try:
            ms = ms_mod.MultisplitSolver(comm)
            over = ms_mod.MultisplitSolver(comm, nblocks=2, max_stale=1)
        finally:
            opts.clear()
        out.append([(m.nblocks, m.max_stale, m.inner_type, m.inner_rtol,
                     m.inner_max_it, m.max_outer, m.resync_timeout)
                    for m in (ms, over)])
    assert out[0] == out[1]
    assert out[1][0][:4] == (3, 7, "pipecg", 1e-3)
    assert out[1][1][:2] == (2, 1)


def test_negative_resync_timeout_waits_without_limit():
    """A negative ``-multisplit_resync_timeout`` is honoured as in the JAX
    package (``StaleExchange.wait_for`` then waits without limit)."""
    for mod, comm in ((jms, tps.DeviceComm()), (multisplit, comm_cpu(2))):
        assert mod.MultisplitSolver(comm, resync_timeout=-1).resync_timeout \
            == -1.0
    ex = exchange.StaleExchange(2)
    ex.mark_lost(1)
    assert ex.wait_for(1, 5, timeout=-1) is True


def test_default_blocks_is_the_shard_count():
    for ndev in (1, 3, 8):
        assert MultisplitSolver(comm_cpu(ndev)).nblocks == ndev


def test_program_kind_constants():
    from mpi_petsc4py_example_tpu.contracts import PROGRAM_KINDS
    assert multisplit.BLOCK_PROGRAM_KIND == jms.BLOCK_PROGRAM_KIND
    assert multisplit.RESIDUAL_PROGRAM_KIND == jms.RESIDUAL_PROGRAM_KIND
    assert multisplit.BLOCK_PROGRAM_KIND in PROGRAM_KINDS
    assert multisplit.RESIDUAL_PROGRAM_KIND in PROGRAM_KINDS


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_residual_program_has_exactly_one_psum(ndev):
    """The consistent-cut residual is one program with exactly one psum (the
    JAX ``contracts.py`` pin), counted by ``comm.collectives``; its value is
    the fp64 ``||b - A x||^2``."""
    A = tridiag(100)
    rng = np.random.default_rng(ndev)
    b, x = rng.random(100), rng.random(100)
    comm = comm_cpu(ndev)
    prog = multisplit.build_multisplit_residual_program(
        comm, pt.Mat.from_scipy(comm, A))
    shape = (ndev, comm.local_size(100))
    before = comm.collectives["psum"]
    out = prog(comm.put_rows(b).view(shape), comm.put_rows(x).view(shape))
    assert comm.collectives["psum"] == before + 1
    assert out.dtype == torch.float64
    want = np.linalg.norm(b - A @ x) ** 2
    assert abs(float(out) - want) <= 1e-13 * want


def test_residual_program_refuses_a_live_trace_time_fault():
    comm = comm_cpu(2)
    with pt.inject_faults("comm.psum=corrupt"):
        with pytest.raises(NotImplementedError, match="6.5"):
            multisplit.build_multisplit_residual_program(
                comm, pt.Mat.from_scipy(comm, tridiag(10)))


def test_block_comms_name_the_mesh_ids():
    """Block ``i`` runs on a one-shard comm named by the mesh's id ``i % N``
    on the mesh's device; its inner KSP runs the uncaptured loops."""
    comm = pt.DeviceComm(3, device="cpu", device_ids=(5, 6, 7))
    ms = MultisplitSolver(comm, nblocks=4).set_operator(tridiag(64))
    assert [st.device_id for st in ms._blocks] == [5, 6, 7, 5]
    for st in ms._blocks:
        assert st.comm.size == 1 and st.comm.device_ids == (st.device_id,)
        assert st.comm.device == comm.device
        assert st.ksp.megasolve is False


def test_worker_error_surfaces(monkeypatch):
    """An error a block worker cannot attribute to a lost id ends the solve
    with that error, after every worker has parked (the JAX package's
    thread dies with it and the solve reports DIVERGED_MAX_IT)."""
    ms = MultisplitSolver(comm_cpu(2), nblocks=2, rtol=1e-9)
    ms.set_operator(tridiag(64))

    def boom(st, reads):
        raise RuntimeError(f"block {st.index} failed")
    monkeypatch.setattr(ms, "_inner_step", boom)
    with pytest.raises(RuntimeError, match="failed"):
        ms.solve(np.ones(64))
    assert all(st.steps == 0 for st in ms._blocks)


# ---- degradation ------------------------------------------------------------

# JAX's jitter (an exponential 4 ms draw a step, seed 7) and a sticky
# straggler of exactly 30 ms a step. On the CPU the blocks' steps hold the
# GIL for milliseconds, so the 4 ms draws need not put the slow block past
# the bound (its lag depends on how the threads interleave); 30 ms always
# does, and only there is the resync asserted.
JITTER = [("jax_4ms", ":mean=0.004:seed=7", False),
          ("sticky_30ms", ":mean=0.03", True)]


@pytest.mark.parametrize("ndev", [4, 8])
@pytest.mark.parametrize("label,clause,resyncs", JITTER,
                         ids=[j[0] for j in JITTER])
def test_jitter_absorbed_with_parity(ndev, label, clause, resyncs):
    A = tridiag(256)
    _, b = manufactured(A, seed=7)
    ms = MultisplitSolver(comm_cpu(ndev), nblocks=4, rtol=1e-9, max_stale=2)
    ms.set_operator(A)
    slow = ms._blocks[1].device_id
    with pt.inject_faults(f"comm.delay=delay:device={slow}:times=*"
                          + clause) as plan:
        res = ms.solve(b)
    assert res.converged, res
    assert plan[0].fired > 0
    if resyncs:
        assert res.resyncs > 0      # the sticky straggler tripped the bound
    assert res.max_stale_seen <= 3     # bound + 1: detection, then resync
    assert relres(A, res.x, b) <= 1e-9


@pytest.mark.parametrize("ndev", [4, 8])
def test_device_lost_degrades_and_never_restarts(ndev):
    A = tridiag(256)
    _, b = manufactured(A, seed=8)
    _metrics.registry.reset()
    ms = MultisplitSolver(comm_cpu(ndev), nblocks=4, rtol=1e-9)
    ms.set_operator(A)
    victim = ms._blocks[2].device_id
    with pt.inject_faults(f"device.lost=unavailable:device={victim}:at=4"):
        res = ms.solve(b)
    assert res.converged, res
    assert res.blocks_lost >= 1
    assert _metrics.registry.counter("multisplit.block_lost").total() >= 1
    assert all(s > 0 for s in res.block_steps)
    # the versions stay monotone across the loss: every block's last
    # exchanged version covers the convergence cut
    assert all(v >= res.cut_version for v in ms._exchange.versions())
    assert victim not in [st.device_id for st in ms._blocks]
    assert relres(A, res.x, b) <= 1e-9


def test_device_lost_shrinks_the_residual_check():
    """A loss on a shard no block runs on leaves the blocks alone and moves
    the residual check onto the surviving ids."""
    A = tridiag(192)
    _, b = manufactured(A, seed=12)
    ms = MultisplitSolver(comm_cpu(4), nblocks=2, rtol=1e-9)
    ms.set_operator(A)
    faults.mark_lost(3)
    res = ms.solve(b)
    assert res.converged and res.blocks_lost == 0
    assert ms._residual_comm.device_ids == (0, 1, 2)
    assert relres(A, res.x, b) <= 1e-9


def test_partition_costs_staleness_not_correctness():
    A = tridiag(192)
    _, b = manufactured(A, seed=9)
    ms = MultisplitSolver(comm_cpu(8), nblocks=3, rtol=1e-9)
    ms.set_operator(A)
    with pt.inject_faults("exchange.put=drop:device=1:times=4"):
        res = ms.solve(b)
    assert res.converged
    assert ms._exchange.drops >= 1
    assert relres(A, res.x, b) <= 1e-9


# ---- serving ----------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 8])
def test_schedule_class_and_parity(ndev):
    A = tridiag(192)
    _, b = manufactured(A, seed=10)
    srv = pt.SolveServer(comm_cpu(ndev), max_k=2)
    try:
        sess = srv.register_operator("ms", A, rtol=1e-9, multisplit=True)
        assert sess.schedule == "multisplit"
        assert sess.multisplit.nblocks == ndev
        r = srv.submit("ms", b).result(timeout=120)
        assert r.converged, r
        assert relres(A, r.x, b) <= 1e-9
        assert r.iterations > 0 and r.history
    finally:
        srv.shutdown(wait=True)


def test_urgent_qos_tightens_stale_bound(monkeypatch):
    pt.global_options().set("multisplit_urgent_stale", "1")
    A = tridiag(192)
    _, b = manufactured(A, seed=11)
    srv = pt.SolveServer(comm_cpu(8), max_k=2)
    bounds = []
    try:
        sess = srv.register_operator("ms", A, rtol=1e-9, multisplit=True)
        solve = sess.multisplit.solve

        def spy(*a, **kw):
            bounds.append(kw.get("max_stale"))
            return solve(*a, **kw)
        monkeypatch.setattr(sess.multisplit, "solve", spy)
        r = srv.submit("ms", b, qos="interactive").result(timeout=120)
        assert r.converged
        assert relres(A, r.x, b) <= 1e-9
        r2 = srv.submit("ms", b, qos="bulk").result(timeout=120)
        assert r2.converged
    finally:
        srv.shutdown(wait=True)
    assert bounds == [1, None]


def test_urgent_default_is_half_the_session_bound(monkeypatch):
    pt.global_options().set("multisplit_max_stale", "6")
    srv = pt.SolveServer(comm_cpu(4), max_k=2)
    bounds = []
    try:
        sess = srv.register_operator("ms", tridiag(128), rtol=1e-9,
                                     multisplit=True)
        solve = sess.multisplit.solve
        monkeypatch.setattr(sess.multisplit, "solve", lambda *a, **kw: (
            bounds.append(kw.get("max_stale")) or solve(*a, **kw)))
        srv.submit("ms", np.ones(128), qos="interactive").result(timeout=120)
    finally:
        srv.shutdown(wait=True)
    assert bounds == [3]


def test_inner_flags_take_precedence_over_the_session():
    pt.global_options().set("multisplit_inner_type", "pipecg")
    srv = pt.SolveServer(comm_cpu(2), max_k=2, autostart=False)
    try:
        sess = srv.register_operator("ms", tridiag(64), ksp_type="cg",
                                     pc_type="none", multisplit=True)
        ms = sess.multisplit
        assert ms.inner_type == "pipecg" and ms.pc_type == "none"
        assert all(st.ksp.get_type() == "pipecg" for st in ms._blocks)
        pt.global_options().clear()
        sess2 = srv.register_operator("ms2", tridiag(64), ksp_type="bcgs",
                                      multisplit=True)
        assert sess2.multisplit.inner_type == "bcgs"
    finally:
        srv.shutdown()


def test_default_sessions_stay_synchronous():
    srv = pt.SolveServer(comm_cpu(8), max_k=2, autostart=False)
    try:
        sess = srv.register_operator("sync", tridiag(128), rtol=1e-9)
        assert sess.schedule != "multisplit"
        assert sess.multisplit is None
    finally:
        srv.shutdown()


def test_multisplit_refusals():
    srv = pt.SolveServer(comm_cpu(2), max_k=2, autostart=False)
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            srv.register_operator("a", tridiag(64), multisplit=True,
                                  persistent=True)
        with pytest.raises(ValueError, match="host-reconstructible"):
            srv.register_operator(
                "b", pt.StencilPoisson3D(comm_cpu(2), 8), multisplit=True)
        assert srv.operators() == []
    finally:
        srv.shutdown()


# ---- telemetry --------------------------------------------------------------

def test_flags_registered():
    from mpi_petsc4py_example_tpu.utils.options import KNOWN_FLAGS as JAX
    from mpi_petsc4py_example_tpu_torch.utils.options import KNOWN_FLAGS
    for flag in ("multisplit_blocks", "multisplit_max_stale",
                 "multisplit_inner_type", "multisplit_inner_rtol",
                 "multisplit_inner_max_it", "multisplit_max_outer",
                 "multisplit_resync_timeout", "multisplit_urgent_stale"):
        assert flag in KNOWN_FLAGS and flag in JAX, flag
    assert set(KNOWN_FLAGS) == {k for k in JAX if k.startswith("multisplit")}


def test_metric_names_registered():
    from mpi_petsc4py_example_tpu_torch.telemetry.names import NAMES
    assert NAMES["multisplit.step"][0] == "counter"
    assert NAMES["multisplit.resyncs"][0] == "counter"
    assert NAMES["multisplit.block_lost"][0] == "counter"
    assert NAMES["multisplit.stale_age"][0] == "histogram"
    assert NAMES["multisplit.solve"][0] == "span"


def test_solve_advances_counters_and_log_view_row():
    from mpi_petsc4py_example_tpu_torch.utils.profiling import log_view
    _metrics.registry.reset()
    A = tridiag(192)
    _, b = manufactured(A, seed=12)
    ms = MultisplitSolver(comm_cpu(8), nblocks=3, rtol=1e-8)
    ms.set_operator(A)
    res = ms.solve(b)
    assert res.converged
    # block_steps is read at convergence, before the workers park: steps
    # in flight may still land on the counter after it
    steps = _metrics.registry.counter("multisplit.step").total()
    assert steps == sum(st.steps for st in ms._blocks)
    assert steps >= sum(res.block_steps)
    assert _metrics.registry.histogram("multisplit.stale_age").count > 0
    assert _metrics.registry.counter("dispatch.programs").value(
        multisplit.RESIDUAL_PROGRAM_KIND) == len(res.history)
    out = io.StringIO()
    log_view(file=out)
    text = out.getvalue()
    assert "multisplit staleness histogram" in text
    assert f"{int(steps)} step(s)" in text


def test_solve_span_carries_the_outcome():
    """The ``multisplit.solve`` root span reaches the flight recorder with
    the outcome; each block's inner ``ksp.solve`` spans are roots of their
    own threads, never children of another thread's span."""
    from mpi_petsc4py_example_tpu_torch.telemetry import flight, spans
    flight.recorder.clear()
    spans.enable()
    try:
        A = tridiag(128)
        _, b = manufactured(A, seed=13)
        ms = MultisplitSolver(comm_cpu(2), nblocks=2, rtol=1e-8)
        ms.set_operator(A)
        res = ms.solve(b)
    finally:
        spans.disable()
    roots = flight.recorder.spans()
    mine = [s for s in roots if s["name"] == "multisplit.solve"]
    assert len(mine) == 1
    assert mine[0]["attrs"]["reason"] == "CONVERGED_RTOL"
    assert mine[0]["attrs"]["cut"] == res.cut_version
    assert mine[0]["attrs"]["blocks"] == 2
    assert not any(c["name"] == "ksp.solve" for c in mine[0]["children"])
    inner = [s for s in roots if s["name"] == "ksp.solve"]
    assert inner and {s["thread"] for s in inner}.isdisjoint(
        {mine[0]["thread"]})
