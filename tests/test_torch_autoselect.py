"""The port's reduction-plan selection (``-ksp_reduction_auto``,
``solvers/autoselect.py``) against the JAX package's.

The model and the margin rule are compared exactly on a grid of
``(psum_us, apply_us)``. The KSP routing is compared with the measuring
functions of both packages replaced by the same latencies (a measurement
on one machine is not a value two packages can share). The probe cache
runs in a temporary directory. Nothing here is timed: the latencies the
port measures on the CPU are only checked to be positive.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import mpi_petsc4py_example_tpu as tps  # noqa: E402
from mpi_petsc4py_example_tpu.models.stencil import (  # noqa: E402
    StencilPoisson3D as JaxStencil)
from mpi_petsc4py_example_tpu.solvers import (  # noqa: E402
    autoselect as jauto)

import mpi_petsc4py_example_tpu_torch as pt  # noqa: E402
from mpi_petsc4py_example_tpu_torch.solvers import autoselect  # noqa: E402

GRID = [(p, a) for p in (0.5, 5.0, 30.0, 120.0, 800.0)
        for a in (2.0, 20.0, 200.0)]


@pytest.fixture(autouse=True)
def _isolated(monkeypatch, tmp_path):
    monkeypatch.setattr(autoselect, "_probe_dir",
                        lambda: str(tmp_path / "probe"))
    pt.global_options().clear()
    yield
    pt.global_options().clear()


def test_plan_model_and_candidates_equal_jax():
    assert autoselect.DEFAULT_CANDIDATES == jauto.DEFAULT_CANDIDATES
    for t, s in jauto.DEFAULT_CANDIDATES:
        assert autoselect._plan_model(t, s) == jauto._plan_model(t, s)
    with pytest.raises(ValueError, match="gmres"):
        autoselect._plan_model("gmres", None)


@pytest.mark.parametrize("psum_us,apply_us", GRID)
def test_ranking_and_margin_rule_equal_jax(monkeypatch, psum_us, apply_us):
    ranking = autoselect.rank_reduction_plans(psum_us, apply_us)
    assert ranking == jauto.rank_reduction_plans(psum_us, apply_us)
    monkeypatch.setattr(jauto, "probe_psum_latency_us",
                        lambda comm, refresh=False: (psum_us, False))
    monkeypatch.setattr(jauto, "measure_apply_latency_us",
                        lambda comm, op, pc: apply_us)
    jrep = jauto.select_reduction_plan(None, None, None)
    best = autoselect.choose(ranking, 0.25)
    assert (best["ksp_type"], int(best.get("s", 0) or 0)) == \
        (jrep.ksp_type, jrep.s)


def _fake_latencies(monkeypatch, psum_us, apply_us, calls=None):
    def apply(comm, op, pc):
        if calls is not None:
            calls.append(1)
        return apply_us
    for mod in (jauto, autoselect):
        monkeypatch.setattr(mod, "probe_psum_latency_us",
                            lambda comm, refresh=False: (psum_us, True))
        monkeypatch.setattr(mod, "measure_apply_latency_us", apply)


@pytest.mark.parametrize("start", ["cg", "pipecg", "sstep", "gmres"])
@pytest.mark.parametrize("psum_us,apply_us", [(0.5, 50.0), (40.0, 30.0),
                                              (800.0, 20.0)])
def test_reduction_auto_picks_what_jax_picks(monkeypatch, start, psum_us,
                                             apply_us):
    _fake_latencies(monkeypatch, psum_us, apply_us)
    got = []
    for pkg in (tps, pt):
        if pkg is tps:
            comm = tps.DeviceComm(n_devices=2)
            op = JaxStencil(comm, 8, 8, 8)
        else:
            comm = pt.DeviceComm(2, device="cpu")
            op = pt.StencilPoisson3D(comm, 8)
        pkg.init(["prog", "-ksp_reduction_auto", "-ksp_type", start,
                  "-pc_type", "jacobi"])
        ksp = pkg.KSP().create(comm)
        ksp.set_operators(op)
        ksp.set_from_options()
        ksp.set_up()
        rep = getattr(ksp, "_reduction_report", None)
        got.append((ksp.get_type(), ksp.sstep_s,
                    None if rep is None else (rep.ksp_type, rep.s,
                                              rep.ranking)))
        tps.global_options().clear()
    assert got[0] == got[1]
    if start == "gmres":
        assert got[1][0] == "gmres" and got[1][2] is None


def test_selection_runs_once_per_operator_and_solves(monkeypatch):
    calls = []
    _fake_latencies(monkeypatch, 800.0, 20.0, calls)
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 8)
    ksp = pt.KSP().create(comm)
    ksp.set_operators(op)
    ksp.set_type("cg")
    ksp.get_pc().set_type("jacobi")
    ksp.reduction_auto = True
    ksp.set_tolerances(rtol=1e-8)
    x, b = op.get_vecs()
    b.set_global(np.ones(512))
    res = ksp.solve(b, x)
    ksp.solve(b, x)
    assert len(calls) == 1
    assert ksp.get_type() == ksp._reduction_report.ksp_type == "sstep"
    assert ksp.sstep_s == ksp._reduction_report.s == 8
    assert res.converged


def test_probe_cache_hit_refresh_and_corrupt_file(monkeypatch):
    values = iter([11.0, 22.0, 33.0, 44.0])
    monkeypatch.setattr(autoselect, "measure_psum_latency_us",
                        lambda comm, chain=256: next(values))
    comm = pt.DeviceComm(2, device="cpu")
    assert autoselect.probe_psum_latency_us(comm) == (11.0, False)
    assert autoselect.probe_psum_latency_us(comm) == (11.0, True)
    assert autoselect.probe_psum_latency_us(comm, refresh=True) == \
        (22.0, False)
    assert autoselect.probe_psum_latency_us(comm) == (22.0, True)
    path = autoselect._probe_path(comm)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write("{not json")
    assert autoselect.probe_psum_latency_us(comm) == (33.0, False)
    with open(path, encoding="utf-8") as fh:
        assert json.load(fh)["psum_us"] == 33.0
    # another chain length misses; another mesh has its own file
    assert autoselect.probe_psum_latency_us(comm, chain=8) == (44.0, False)
    assert autoselect._probe_path(pt.DeviceComm(4, device="cpu")) != path


def test_measurements_run_on_the_real_operands():
    """The measuring functions themselves, on a CPU communicator: positive
    latencies, and the communicator's collective counts left as they
    were."""
    comm = pt.DeviceComm(2, device="cpu")
    op = pt.StencilPoisson3D(comm, 8)
    pc = pt.PC(comm).set_type("jacobi")
    pc.set_operators(op)
    before = dict(comm.collectives)
    assert autoselect.measure_psum_latency_us(comm, chain=16) > 0
    assert autoselect.measure_apply_latency_us(comm, op, pc, chain=4) > 0
    assert comm.collectives == before
    rep = autoselect.select_reduction_plan(comm, op, pc)
    assert rep.ksp_type in ("cg", "pipecg", "sstep")
    assert len(rep.ranking) == len(autoselect.DEFAULT_CANDIDATES)
    assert rep.as_dict()["choice"] == rep.ksp_type
