"""The port's FleetRollout against the reference's on the CPU, same seed,
same constants (``repro_torch.convert``), same host random streams.

Without P2: every ``RolloutTrace`` field, bools and ints exact, floats
within rtol 1e-5.  With P2: ``active``, ``n_requests`` and ``feasible``
exact, floats within rtol 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import RadioChannel, RolloutSpec, cnn_cost  # noqa: E402
from repro.core import make_devices  # noqa: E402
from repro.core.positions import hex_init  # noqa: E402
from repro.core.rollout import PositionSpec  # noqa: E402
from repro.runtime.fleet_rollout import FleetRollout  # noqa: E402
from repro.runtime.scenario_engine import PlanFnCache  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import rollout as trl  # noqa: E402

FIELDS = ("latency", "total_power", "feasible", "cap_feasible",
          "source_latency", "assign", "positions", "active", "charge",
          "n_requests", "energy_tx", "energy_cmp")
EXACT = ("feasible", "cap_feasible", "assign", "active", "n_requests")

# the reference's kernel-parity fixture (tests/test_kernels_planner.py)
SPEC = RolloutSpec(frames=3, requests_per_frame=2, jitter_sigma_m=2.0,
                   failure_prob=0.2, recovery_prob=0.3, battery_j=2e3,
                   hover_watts=0.05, frame_s=1.0)


def fleets(model="lenet", U=4, spec=SPEC, p2=None, seed=13):
    ref = FleetRollout(RadioChannel(), make_devices(U),
                       cnn_cost({"lenet": LENET, "alexnet": ALEXNET}[model]),
                       spec, plan_cache=PlanFnCache(), position_spec=p2,
                       seed=seed)
    port = convert.fleet_from_arrays(
        convert.engine_arrays(ref), dataclasses.asdict(ref.params),
        trl.RolloutSpec(**dataclasses.asdict(spec)), "cpu", seed=seed,
        position_spec=None if p2 is None
        else trl.PositionSpec(**dataclasses.asdict(p2)))
    return ref, port


def assert_traces(r0, r1, exact=EXACT, rtol=1e-5):
    for f in FIELDS:
        a, b = getattr(r0, f), getattr(r1, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f in exact or a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=f)


def test_rollout_matches_reference_fixture():
    ref, port = fleets()
    base = hex_init(4, 40.0, jitter=1.0, seed=5)
    r0, r1 = ref.run(base, n_trajectories=2), port.run(base, n_trajectories=2)
    assert_traces(r0, r1)
    assert r1.feasibility_rate == r0.feasibility_rate
    assert (~r1.active).any()                 # failures did happen
    for a, b in zip(r0.frame_stats(1), r1.frame_stats(1)):
        assert (a.t, a.n_requests, a.feasible, a.replanned) == \
            (b.t, b.n_requests, b.feasible, b.replanned)
        assert b.latency == pytest.approx(a.latency, rel=1e-5)
        assert b.breakdown == pytest.approx(a.breakdown, rel=1e-5)


def test_rollout_alexnet_all_sources_and_battery_death():
    spec = RolloutSpec(frames=3, requests_per_frame=4, jitter_sigma_m=1.0,
                       failure_prob=0.1, recovery_prob=0.5, battery_j=5.0,
                       hover_watts=2.0, frame_s=1.0)
    ref, port = fleets("alexnet", spec=spec, seed=2)
    base = hex_init(4, 40.0, jitter=0.5, seed=0)
    r0, r1 = ref.run(base, n_trajectories=4), port.run(base, n_trajectories=4)
    assert_traces(r0, r1)
    assert (r1.charge[:, -1] == 0).any()      # someone drained


def test_rollout_chaos_streams_match():
    ref, port = fleets(seed=4)
    T, B, U = 3, 3, 4
    rng = np.random.default_rng(0)
    gain = rng.uniform(0.3, 1.2, (T, B, U, U)).astype(np.float32)
    drain = rng.uniform(0.0, 50.0, (T, U)).astype(np.float32)
    forced = np.zeros((T, B, U), dtype=bool)
    forced[1, 0, 2] = True
    base = hex_init(4, 40.0, jitter=1.0, seed=5)
    kw = dict(n_trajectories=B, gain_scale=gain, extra_drain=drain,
              forced=forced, forced_failures=[(2, 3)])
    assert_traces(ref.run(base, **kw), port.run(base, **kw))


def test_rollout_given_arrivals_and_waypoints_match():
    spec = dataclasses.replace(SPEC, drift_m_per_frame=3.0,
                               waypoint_range_m=20.0)
    ref, port = fleets(spec=spec, seed=9)
    base = hex_init(4, 40.0, jitter=1.0, seed=1)
    arrivals = np.zeros((3, 2, 4), np.float32)
    arrivals[:, :, 1] = 2
    r0 = ref.run(base, n_trajectories=2, arrivals=arrivals)
    r1 = port.run(base, n_trajectories=2, arrivals=arrivals)
    assert_traces(r0, r1)
    sources = np.array([[0, 3], [1, 1], [2, 0]])
    assert_traces(ref.run(base, n_trajectories=2, sources=sources),
                  port.run(base, n_trajectories=2, sources=sources))


def test_rollout_with_p2_matches_within_tolerance():
    ref, port = fleets("alexnet", p2=PositionSpec(steps=30, repair_iters=25),
                       seed=0)
    base = hex_init(4, 40.0, jitter=0.5, seed=0)
    r0, r1 = ref.run(base, n_trajectories=2), port.run(base, n_trajectories=2)
    assert_traces(r0, r1, exact=("active", "n_requests", "feasible"),
                  rtol=1e-3)


def test_rollout_validates_host_inputs():
    _, port = fleets()
    base = hex_init(4, 40.0)
    with pytest.raises(ValueError, match="sources must index"):
        port.run(base, n_trajectories=1, sources=np.full((3, 1), 4))
    with pytest.raises(ValueError, match="distinct sources"):
        port.run(base, n_trajectories=1,
                 arrivals=np.ones((3, 1, 4), np.float32))
    with pytest.raises(ValueError, match="positive"):
        port.run(base, n_trajectories=1,
                 gain_scale=np.zeros((4, 4), np.float32))
