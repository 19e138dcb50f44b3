"""The port's result types and top-level names against the JAX package's.

``SolveResult.history`` and the per-column histories of
``BatchedSolveResult.per_rhs`` (JAX ``utils/convergence.py:87``, :156-162;
``tests/test_batched.py``'s ``test_per_column_histories``) on the mixed
easy/hard batch of the 20^2 Poisson ``Mat`` in fp64 on 8 shards; the served
result's inherited ``history``; the serving names at the top level; and
``backend()``, which names the port's device.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models import poisson2d_csr  # noqa: E402

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.serving import server  # noqa: E402
from mpi_petsc4py_example_tpu_torch.utils import convergence  # noqa: E402

RTOL = 1e-8


@pytest.fixture(autouse=True)
def _clean():
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def _mixed_batch(nx=20):
    # column 0 an eigenvector of the 2D Poisson operator (CG converges at
    # once), column 1 a random right-hand side
    A = poisson2d_csr(nx)
    i = np.arange(1, nx + 1)
    v1 = np.sin(np.pi * i / (nx + 1))
    hard = np.asarray(A @ np.random.default_rng(42).random(nx * nx))
    return A, np.stack([np.kron(v1, v1), hard], axis=1)


def _monitored(P, comm, A, B, pc_type):
    ksp = P.KSP().create(comm)
    ksp.set_operators(P.Mat.from_scipy(comm, A))
    ksp.set_type("cg")
    ksp.get_pc().set_type(pc_type)
    ksp.set_tolerances(rtol=RTOL, atol=0.0, max_it=5000)
    ksp.set_convergence_history()
    return ksp.solve_many(B)


@pytest.mark.parametrize("pc_type", ["none", "jacobi"])
def test_per_rhs_histories_match_jax(pc_type):
    """JAX ``test_batched.py:209``'s contract: ``per[j].history ==
    res.histories[j]``, iterations + 1 entries a column; the port's
    histories equal JAX's within 1e-10 relative."""
    A, B = _mixed_batch()
    rj = _monitored(tps, tps.DeviceComm(n_devices=8), A, B, pc_type)
    rt = _monitored(pt, pt.DeviceComm(8, device="cpu"), A, B, pc_type)
    assert rt.iterations == rj.iterations
    per = rt.per_rhs()
    for j in range(2):
        assert per[j].history == rt.histories[j]
        assert len(per[j].history) == rt.iterations[j] + 1
        assert per[j].iterations == rt.iterations[j]
        np.testing.assert_allclose(per[j].history, rj.per_rhs()[j].history,
                                   rtol=1e-10)
    assert per[1].history is not rt.histories[1]      # a copy


def test_per_rhs_without_histories_gives_empty_lists():
    res = convergence.BatchedSolveResult(iterations=[3, 4],
                                         residual_norms=[1e-9, 2e-9],
                                         reasons=[2, 2], wall_time=0.5)
    per = res.per_rhs()
    assert [p.history for p in per] == [[], []]
    assert [p.wall_time for p in per] == [0.5, 0.5]


def test_solve_result_history_field_like_jax():
    """The field exists with JAX's default; the port keeps ``host_syncs``
    in its positional place and puts ``history`` last."""
    jf = {f.name for f in dataclasses.fields(tps.SolveResult)}
    pf = [f.name for f in dataclasses.fields(pt.SolveResult)]
    assert jf <= set(pf) | {"history"} and "history" in pf
    assert pf[4] == "host_syncs" and pf[-1] == "history"
    assert pt.SolveResult().history == tps.SolveResult().history == []
    a, b = pt.SolveResult(), pt.SolveResult()
    a.history.append(1.0)
    assert b.history == []


def test_served_result_history_is_the_inherited_field():
    own = {f.name for f in dataclasses.fields(server.ServedSolveResult)
           if f.name not in {g.name for g in
                             dataclasses.fields(pt.SolveResult)}}
    assert own == {"x", "op", "batch_width", "queue_wait"}
    assert "history" not in server.ServedSolveResult.__dict__.get(
        "__annotations__", {})
    r = server.ServedSolveResult(iterations=3, history=[1.0, 0.5])
    assert isinstance(r, pt.SolveResult) and r.history == [1.0, 0.5]


def test_served_monitored_block_carries_its_histories():
    """A session whose KSP records a history hands each request its own
    column's, as JAX's server does (``server.py:873``)."""
    A, B = _mixed_batch(12)
    out = {}
    for P, comm in ((tps, tps.DeviceComm(n_devices=8)),
                    (pt, pt.DeviceComm(8, device="cpu"))):
        srv = P.SolveServer(comm, window=0.0, max_k=2, autostart=False)
        try:
            sess = srv.register_operator("p", A, pc_type="none", rtol=RTOL)
            sess.ksp.set_convergence_history()
            futs = [srv.submit("p", B[:, j]) for j in range(2)]
            srv.start()
            out[P] = [f.result(120) for f in futs]
        finally:
            srv.shutdown()
    for rj, rt in zip(out[tps], out[pt]):
        assert rt.iterations == rj.iterations
        assert len(rt.history) == rt.iterations + 1
        np.testing.assert_allclose(rt.history, rj.history, rtol=1e-10)


@pytest.mark.parametrize("name", ["SolveRouter", "QoSClass",
                                  "AutoscalePolicy", "SolveServer",
                                  "ServedSolveResult", "ServerClosedError"])
def test_top_level_serving_names_resolve(name):
    from mpi_petsc4py_example_tpu_torch import serving
    assert name in pt.__all__ and name in tps.__all__
    assert getattr(pt, name) is getattr(serving, name)
    assert getattr(pt, name).__name__ == getattr(tps, name).__name__


def test_unknown_top_level_name_raises():
    with pytest.raises(AttributeError):
        pt.NoSuchName  # noqa: B018


def test_backend_names_the_port_device(monkeypatch):
    """JAX's ``backend()`` names its platform from ``TPU_SOLVE_BACKEND``;
    the port's names the default communicator's device, ``cuda`` unless a
    CPU one is set, and the variable selects nothing."""
    assert "backend" in pt.__all__ and "backend" in tps.__all__
    monkeypatch.setenv("TPU_SOLVE_BACKEND", "cpu")
    pt.set_default_comm(None)
    assert pt.backend() == "cuda"
    pt.set_default_comm(pt.DeviceComm(2, device="cpu"))
    try:
        assert pt.backend() == "cpu"
    finally:
        pt.set_default_comm(None)
    assert tps.backend() == "cpu"          # JAX's reads the variable
    monkeypatch.delenv("TPU_SOLVE_BACKEND")
    assert tps.backend() == "tpu"
    assert pt.backend() == "cuda"
