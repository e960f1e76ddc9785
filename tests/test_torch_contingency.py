"""The port's failure contingencies against the reference's on the CPU.

* ``ScenarioGenerator.failure_sweep``: every array equal.
* ``ContingencyTable`` built by the reference's engine and by the port's
  (the same constants through ``repro_torch.convert``) at the same
  positions: each plan's dead UAV, assignment exact, latency and power
  within rtol 1e-5 (the geometry's ``log2`` differs in the last ulp);
  ``lookup`` agrees on single, multi and unknown failures, and
  ``as_survivor_plan``'s re-indexing with it.  A refresh at moved
  positions agrees again; a shrunk swarm raises in both.
* With a ``PositionSpec`` (the fused P2 stage) the engine test's P2
  tolerance: feasibility, the dead UAVs and the assignments exact,
  latency and power within rtol 1e-3, positions within 1e-2 m.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import RadioChannel, cnn_cost, make_devices  # noqa: E402
from repro.core.positions import hex_init  # noqa: E402
from repro.core.rollout import PositionSpec as JPositionSpec  # noqa: E402
from repro.runtime import scenario_engine as jse  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.rollout import PositionSpec  # noqa: E402
from repro_torch.runtime import scenario_engine as tse  # noqa: E402

MODELS = {"lenet": LENET, "alexnet": ALEXNET}


def engines(model, U, p2=None, order=None):
    ref = jse.ScenarioEngine(RadioChannel(), make_devices(U),
                             cnn_cost(MODELS[model]), device_order=order,
                             plan_cache=jse.PlanFnCache(), position_spec=p2)
    port = convert.engine_from_arrays(
        convert.engine_arrays(ref), dataclasses.asdict(ref.params), "cpu",
        plan_cache=tse.PlanFnCache(),
        position_spec=None if p2 is None
        else PositionSpec(**dataclasses.asdict(p2)))
    return ref, port


@pytest.mark.parametrize("U,source", [(4, 0), (4, 3), (6, 2), (8, 5)])
def test_failure_sweep_matches(U, source):
    base = hex_init(U, 40.0, jitter=1.0, seed=U)
    ref = jse.ScenarioGenerator(base, seed=1).failure_sweep(source=source)
    got = tse.ScenarioGenerator(base, seed=1).failure_sweep(source=source)
    for f in ("positions", "source", "active"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f)
    assert got.gain_scale is None and got.n_scenarios == U + 1
    assert got.source[source] == (source + 1) % U


def assert_plan_close(ref, got, rtol=1e-5, pos_atol=0.0):
    assert (got.dead, got.dead_index) == (ref.dead, ref.dead_index)
    assert np.isfinite(got.latency) == np.isfinite(ref.latency)
    assert got.assign == ref.assign
    if np.isfinite(ref.latency):
        np.testing.assert_allclose(got.latency, ref.latency, rtol=rtol)
    np.testing.assert_allclose(got.power, ref.power, rtol=rtol, atol=0)
    np.testing.assert_allclose(got.positions, ref.positions, rtol=0,
                               atol=pos_atol)


def assert_tables(ref, got, **kw):
    assert list(got.plans) == list(ref.plans)
    for name in ref.plans:
        assert_plan_close(ref.plans[name], got.plans[name], **kw)


def lookups(table, names):
    return [table.lookup([names[2]]), table.lookup([names[0]]),
            table.lookup([names[1], names[2]]), table.lookup(["nope"]),
            table.lookup([])]


@pytest.mark.parametrize("model,U,order", [("lenet", 5, None),
                                           ("alexnet", 6, None),
                                           ("alexnet", 5, (2, 0, 4, 1, 3))])
def test_contingency_table_matches(model, U, order):
    ref_engine, port_engine = engines(model, U, order=order)
    base = hex_init(U, 40.0, jitter=0.5, seed=U)
    ref = jse.ContingencyTable(ref_engine, base, source=1)
    got = tse.ContingencyTable(port_engine, base, source=1)
    assert_tables(ref, got)
    assert np.isfinite(got.plans[None].latency)
    names = [d.name for d in port_engine.devices]
    for r, g in zip(lookups(ref, names), lookups(got, names)):
        assert (r is None) == (g is None)
        if r is not None:
            assert_plan_close(r, g)
            assert g.dead_index == -1 and len(g.power) == U - 1
            assert all(0 <= i < U - 1 for i in g.assign)
    # survivor re-indexing of every single-failure plan
    for k, name in enumerate(names):
        r, g = ref.plans[name], got.plans[name]
        assert g.survivor_assign == r.survivor_assign
        if np.isfinite(g.latency):
            assert k not in g.assign and g.power[k] == 0.0
            survivors = [i for i in range(U) if i != k]
            assert g.survivor_assign == tuple(survivors.index(i)
                                              for i in g.assign)
        sg, sr = g.as_survivor_plan(), r.as_survivor_plan()
        assert sg.assign == sr.assign and sg.dead_index == -1
        np.testing.assert_array_equal(sg.positions, sr.positions)
    nominal = got.plans[None]
    assert nominal.as_survivor_plan() is nominal
    assert nominal.survivor_assign == nominal.assign


def test_refresh_follows_moved_positions_and_refuses_a_shrunk_swarm():
    U = 6
    ref_engine, port_engine = engines("lenet", U)
    base = hex_init(U, 40.0, jitter=0.5, seed=2)
    ref = jse.ContingencyTable(ref_engine, base, source=0)
    got = tse.ContingencyTable(port_engine, base, source=0)
    builds = port_engine.build_count
    rng = np.random.default_rng(4)
    for _ in range(2):
        moved = base + rng.normal(0.0, 4.0, base.shape)
        ref.refresh(moved, source=3)
        got.refresh(moved, source=3)
        assert_tables(ref, got)
    assert port_engine.build_count == builds        # the built plan reused
    for table in (ref, got):
        with pytest.raises(ValueError, match="build a new ScenarioEngine"):
            table.refresh(base[:-1])


def test_contingency_table_with_p2_within_the_engine_tolerance():
    U = 5
    p2 = JPositionSpec(steps=30, repair_iters=10)
    ref_engine, port_engine = engines("alexnet", U, p2=p2)
    base = hex_init(U, 40.0, jitter=0.5, seed=3)
    ref = jse.ContingencyTable(ref_engine, base, source=0)
    got = tse.ContingencyTable(port_engine, base, source=0)
    assert_tables(ref, got, rtol=1e-3, pos_atol=1e-2)
    assert all(np.isfinite(p.latency) for p in got.plans.values())
    g = got.lookup([port_engine.devices[1].name])
    r = ref.lookup([ref_engine.devices[1].name])
    assert g.positions.shape == r.positions.shape == (U - 1, 2)
    np.testing.assert_allclose(g.latency, r.latency, rtol=1e-3)
