"""The port's ScenarioEngine against the reference's, built from the same
constants through ``repro_torch.convert``, on the CPU.

Without P2: assignments and feasibility exact, latency and power within
rtol 1e-5 (the geometry's ``log2`` differs in the last ulp between XLA
and PyTorch on the CPU).  With P2 (``PositionSpec``): feasibility exact,
latency within rtol 1e-3 (ulp differences compound over the gradient
steps).
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
from repro.runtime.scenario_engine import PlanFnCache as JCache  # noqa: E402
from repro.runtime.scenario_engine import ScenarioEngine as JEngine  # noqa: E402
from repro.runtime.scenario_engine import ScenarioGenerator  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.rollout import PositionSpec  # noqa: E402
from repro_torch.runtime.scenario_engine import (PlanFnCache,  # noqa: E402
                                                 ScenarioBatch)

MODELS = {"lenet": LENET, "alexnet": ALEXNET}


def engines(model, U=4, p2=None, order=None):
    ref = JEngine(RadioChannel(), make_devices(U), cnn_cost(MODELS[model]),
                  device_order=order, plan_cache=JCache(),
                  position_spec=p2)
    port = convert.engine_from_arrays(
        convert.engine_arrays(ref), dataclasses.asdict(ref.params), "cpu",
        plan_cache=PlanFnCache(),
        position_spec=None if p2 is None
        else PositionSpec(**dataclasses.asdict(p2)))
    return ref, port


def scenarios(U, B=4, seed=3, failures=0.15, shadow=2.0):
    gen = ScenarioGenerator(hex_init(U, 40.0, jitter=1.0, seed=seed),
                            pos_sigma_m=6.0, failure_prob=failures,
                            shadow_sigma_db=shadow, seed=seed)
    return gen.draw(B)


def assert_plans(ref, got, exact_fields, rtol, rtol_fields):
    for f in exact_fields:
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f)
    np.testing.assert_array_equal(ref.feasible, got.feasible)
    for f in rtol_fields:
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   rtol=rtol, atol=0, err_msg=f)


@pytest.mark.parametrize("model,order", [("lenet", None),
                                         ("alexnet", (2, 0, 3, 1))])
def test_plan_batch_matches(model, order):
    ref, port = engines(model, order=order)
    batch = scenarios(4)
    assert_plans(ref.plan_batch(batch), port.plan_batch(batch),
                 ("assign",), 1e-5,
                 ("latency", "power", "total_power", "positions"))


@pytest.mark.parametrize("model", ["lenet", "alexnet"])
def test_plan_batch_multi_matches(model):
    ref, port = engines(model)
    batch = scenarios(4, seed=8)
    n_req = np.array([[1, 2, 0, 1], [0, 0, 3, 0], [2, 0, 0, 2],
                      [1, 1, 1, 1]])
    r, g = ref.plan_batch_multi(batch, n_req), \
        port.plan_batch_multi(batch, n_req)
    assert_plans(r, g, ("assign", "cap_feasible", "n_requests"), 1e-5,
                 ("latency", "source_latency", "power", "load"))
    assert g.feasible.any()


def test_plan_batch_with_p2_matches():
    p2 = JPositionSpec(steps=30, repair_iters=10)
    ref, port = engines("alexnet", p2=p2)
    batch = scenarios(4, seed=5, failures=0.0, shadow=0.0)
    r, g = ref.plan_batch(batch), port.plan_batch(batch)
    np.testing.assert_array_equal(r.feasible, g.feasible)
    np.testing.assert_allclose(g.latency, r.latency, rtol=1e-3)
    np.testing.assert_allclose(g.positions, r.positions, atol=1e-2)
    r, g = ref.plan_batch_multi(batch, [1, 0, 2, 1]), \
        port.plan_batch_multi(batch, [1, 0, 2, 1])
    np.testing.assert_array_equal(r.feasible, g.feasible)
    np.testing.assert_allclose(g.latency, r.latency, rtol=1e-3)


def test_plan_cache_shares_one_build_per_signature():
    cache = PlanFnCache()
    ref, _ = engines("lenet")
    arrays, radio = convert.engine_arrays(ref), dataclasses.asdict(ref.params)
    e0 = convert.engine_from_arrays(arrays, radio, "cpu", plan_cache=cache)
    e1 = convert.engine_from_arrays(arrays, radio, "cpu", plan_cache=cache)
    assert (cache.misses, cache.hits) == (1, 1)
    assert e0._solve is e1._solve and e0.build_count == 1
    batch = scenarios(4, B=2)
    e0.plan_batch_multi(batch, [1, 1, 0, 0])
    e1.plan_batch_multi(batch, [1, 1, 0, 0])
    assert cache.info()["builds"] == 2 and cache.misses == 2


def test_plan_positions_and_p2_links_contract():
    ref, port = engines("lenet")
    pos = hex_init(4, 40.0)
    r, g = ref.plan_positions(pos, source=2), port.plan_positions(pos, 2)
    np.testing.assert_array_equal(r.assign, g.assign)
    np.testing.assert_allclose(g.latency, r.latency, rtol=1e-5)
    with pytest.raises(ValueError, match="PositionSpec"):
        port.plan_batch(ScenarioBatch(positions=pos[None],
                                      source=np.array([0])),
                        p2_links=np.eye(4, dtype=bool))
    with pytest.raises(ValueError, match="nonnegative"):
        port.plan_batch_multi(ScenarioBatch(positions=pos[None],
                                            source=np.array([0])),
                              [1, -1, 0, 0])
