"""The port's streaming gateway against the reference's on the CPU:
``tests/test_gateway.py``'s cases run through both packages on the same
inputs.

* ``LoadGenerator`` and ``ArrivalSchedule`` draws are bitwise the
  reference's (every profile, flood factors, weights, jitter), and the
  same invalid knobs raise.
* With the injectable ``solve_fn`` the gateway is host Python in both
  packages: admission, deadline and priority scheduling, source slots,
  the retry ladder (backoff sleeps, exhaustion, degraded admission), the
  fall-through into ``ReplanController`` and clock skew give the
  reference's outcomes, frames, shed counts, staged arrival tensors and
  reports exactly.
* ``ContinuousBatcher(max_pending=)``: ``submit`` reports backpressure
  with ``False`` and counts ``rejected``.
* The soak (``tests/test_gateway.py``'s composed flood, stall, burst,
  crash and skew) against the port's CPU ``FleetRollout``: every request
  ends with exactly one outcome, served requests meet their deadlines,
  two passes replay bitwise on one built rollout, and the outcomes,
  frames, shed counts and staged tensors equal the reference's soak; its
  latencies within rtol 1e-5 (no P2 stage: the geometry's last ulp).
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import gateway as jgw  # noqa: E402
from repro.runtime import serve_loop as jsl  # noqa: E402
from repro_torch.runtime import chaos as tchaos  # noqa: E402
from repro_torch.runtime import gateway as tgw  # noqa: E402
from repro_torch.runtime import serve_loop as tsl  # noqa: E402

REF = SimpleNamespace(name="ref", chaos=jchaos, gw=jgw, sl=jsl)
PORT = SimpleNamespace(name="port", chaos=tchaos, gw=tgw, sl=tsl)


def both(fn):
    return fn(REF), fn(PORT)


def nan_safe(x):
    """``x`` with every float NaN replaced by a marker, so that two
    reports compare equal when their NaNs (no served request) agree."""
    if isinstance(x, dict):
        return {k: nan_safe(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(nan_safe(v) for v in x)
    if isinstance(x, float) and x != x:
        return "nan"
    return x


# ---------------------------------------------------------------------------
# Arrival sources
# ---------------------------------------------------------------------------


GENERATORS = {
    "poisson": dict(n_uavs=4, kind="poisson", rate=2.0, seed=9,
                    deadline_s=5.0, deadline_jitter_s=1.0,
                    priorities=(0, 1)),
    "weighted": dict(n_uavs=3, kind="poisson", rate=1.5, seed=2,
                     priorities=(0, 1, 2), priority_weights=(0.2, 0.3, 0.5),
                     uav_weights=(0.6, 0.0, 0.4)),
    "flood": dict(n_uavs=3, kind="flood", rate=3.0, seed=0),
    "burst": dict(n_uavs=3, kind="burst", rate=1.0, burst_every=8,
                  burst_frames=2, burst_rate=30.0, seed=1),
    "soak": dict(n_uavs=4, kind="burst", rate=1.0, deadline_s=9.0, seed=7,
                 priorities=(0, 1), priority_weights=(0.2, 0.8)),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_load_generator_draws_bitwise(name):
    def run(pkg):
        gen = pkg.gw.LoadGenerator(**GENERATORS[name])
        return [gen.arrivals(f, flood_factor=ff) for f in range(40)
                for ff in (1.0, 3.0)]

    ref, got = both(run)
    assert got == ref and sum(map(len, got)) > 0


def test_arrival_schedule_replays_the_reference():
    def run(pkg):
        ev = (pkg.gw.ArrivalSchedule(frames=8)
              .at(2, uav=1, deadline_s=5.0)
              .at(2, uav=0, deadline_s=3.0, priority=0, count=2)
              .at(7, uav=2, deadline_s=0.5))
        return [ev.arrivals(f, flood_factor=10.0) for f in range(8)]

    ref, got = both(run)
    assert got == ref and got[2] == [(1, 5.0, 1), (0, 3.0, 0), (0, 3.0, 0)]


@pytest.mark.parametrize("k", range(10))
def test_invalid_sources_and_configs_raise_in_both(k):
    def calls(pkg):
        G, A, C = pkg.gw.LoadGenerator, pkg.gw.ArrivalSchedule, \
            pkg.gw.GatewayConfig
        return [lambda: G(3, kind="nope"),
                lambda: G(3, deadline_s=1.0, deadline_jitter_s=2.0),
                lambda: G(3, uav_weights=[1.0, 1.0]),
                lambda: G(3, priorities=(0, 1), priority_weights=[-1.0, 2.0]),
                lambda: A(8).at(9, 0, 1.0), lambda: A(8).at(0, 0, 0.0),
                lambda: A(8).at(0, 0, 1.0, count=0),
                lambda: C(window_frames=0), lambda: C(max_attempts=0),
                lambda: C(degraded_admit_fraction=1.5)]

    for pkg in (REF, PORT):
        with pytest.raises(ValueError):
            calls(pkg)[k]()


# ---------------------------------------------------------------------------
# The gateway over the injectable solve_fn: host Python, exact
# ---------------------------------------------------------------------------


def stub_solver(T, U, latency=0.01, infeasible_frames=(), record=None,
                fail=False):
    """A trace-shaped stand-in: ``feasible [1, T]`` / ``source_latency
    [1, T, U]``, the only fields the gateway reads from a window."""
    infeasible = set(infeasible_frames)

    def solve(w, arr):
        if fail:
            raise RuntimeError("device on fire")
        if record is not None:
            record.append((w, arr.copy()))
        feas = np.ones((1, T), bool)
        for g in infeasible:
            if w * T <= g < (w + 1) * T:
                feas[0, g - w * T] = False
        return SimpleNamespace(
            feasible=feas,
            source_latency=np.full((1, T, U), latency, np.float64))
    return solve


def make_gateway(pkg, T=4, U=3, schedule=None, record=None, controller=None,
                 sleeps=None, solve_kw=None, **cfg):
    cfg.setdefault("window_frames", T)
    cfg.setdefault("frame_s", 1.0)
    cfg.setdefault("queue_capacity", 16)
    cfg.setdefault("frame_capacity", 2)
    cfg.setdefault("retry_base_backoff_s", 0.01)
    solve = stub_solver(T, U, record=record, **(solve_kw or {}))
    sleep = sleeps.append if sleeps is not None else (lambda s: None)
    return pkg.gw.StreamingGateway(solve_fn=solve, n_uavs=U,
                                   schedule=schedule, controller=controller,
                                   sleep=sleep,
                                   config=pkg.gw.GatewayConfig(**cfg))


def state(gw, record=(), sleeps=()):
    """Everything a stub-driven serve decides, for an exact comparison."""
    return dict(
        requests=[(r.rid, r.uav, r.submit_s, r.deadline_s, r.priority,
                   r.outcome, r.admitted, r.frame, r.window, r.latency_s)
                  for r in gw.requests],
        shed=dict(gw.shed_counts), degraded=gw.degraded,
        retries=gw.retries, failures=gw.device_failures,
        tensors=[a.tolist() for a in gw.arrival_tensors],
        record=[(w, a.tolist()) for w, a in record], sleeps=list(sleeps),
        backpressure=gw.backpressure)


def after(gw, report, **kw):
    """The gateway's state once ``report`` (a ``serve``'s) was made."""
    return state(gw, **kw), report


def scenario_queue_full(pkg):
    gw = make_gateway(pkg, queue_capacity=3)
    for _ in range(5):
        gw.submit(0, 100.0)
    return state(gw)


def scenario_expired_and_invalid(pkg):
    gw = make_gateway(pkg)
    gw.submit(0, 0.0)
    with pytest.raises(ValueError):
        gw.submit(3, 1.0)
    return state(gw)


def scenario_degraded_bucket(pkg):
    gw = make_gateway(pkg, degraded_admit_fraction=0.5)
    gw.degraded = True
    for _ in range(8):
        gw.submit(0, 100.0)
    return state(gw)


def scenario_earliest_frame(pkg):
    rec = []
    gw = make_gateway(pkg, record=rec)
    gw.submit(1, 2.5)
    return after(gw, gw.serve(None, n_windows=1), record=rec)


def scenario_expired_before_device(pkg):
    rec = []
    gw = make_gateway(pkg, record=rec, frame_capacity=1)
    for _ in range(3):
        gw.submit(0, 1.0)
    rep = gw.serve(None, n_windows=1)
    return state(gw, rec), rep


def scenario_priority(pkg):
    gw = make_gateway(pkg, frame_capacity=1, T=2)
    gw.submit(0, 2.0, priority=5)
    gw.submit(1, 2.0, priority=0)
    return after(gw, gw.serve(None, n_windows=1))


def scenario_rid_ties(pkg):
    gw = make_gateway(pkg, frame_capacity=1, T=1, queue_capacity=8)
    for u in (2, 0, 1):
        gw.submit(u, 1.0)
    return after(gw, gw.serve(None, n_windows=1))


def scenario_source_slots(pkg):
    rec = []
    gw = make_gateway(pkg, U=4, record=rec, frame_capacity=4, T=1)
    gw.slots = 2
    for u in range(4):
        gw.submit(u, 100.0)
    rep = gw.serve(None, n_windows=2, drain=False)
    return state(gw, rec), rep


def scenario_roll_over(pkg):
    gw = make_gateway(pkg, frame_capacity=1, T=1)
    gw.submit(0, 50.0)
    gw.submit(1, 50.0)
    return after(gw, gw.serve(None, n_windows=2))


def scenario_stall_absorbed(pkg):
    sleeps = []
    sched = pkg.chaos.FaultSchedule(3, 8, seed=0).device_stall(1, attempts=2)
    gw = make_gateway(pkg, schedule=sched, sleeps=sleeps, max_attempts=4,
                      retry_max_backoff_s=0.5)
    gw.submit(0, 100.0)
    rep = gw.serve(None, n_windows=1)
    return state(gw, sleeps=sleeps), rep


def scenario_backoff_capped(pkg):
    sleeps = []
    sched = pkg.chaos.FaultSchedule(3, 8, seed=0).device_stall(0, attempts=4)
    gw = make_gateway(pkg, schedule=sched, sleeps=sleeps, max_attempts=8,
                      retry_max_backoff_s=0.04)
    rep = gw.serve(None, n_windows=1)
    return state(gw, sleeps=sleeps), rep


def scenario_exhaustion(pkg):
    sched = pkg.chaos.FaultSchedule(3, 8, seed=0).device_stall(0, attempts=5)
    gw = make_gateway(pkg, schedule=sched, max_attempts=2,
                      degraded_admit_fraction=0.5)
    gw.submit(0, 100.0)
    first = gw.serve(None, n_windows=1, drain=False)
    for _ in range(6):
        gw.submit(0, 100.0)
    second = gw.serve(None, n_windows=1, drain=False)
    return state(gw), first, second


def scenario_always_failing(pkg):
    gw = make_gateway(pkg, max_attempts=2, solve_kw=dict(fail=True))
    for _ in range(3):
        gw.submit(0, 1000.0)
    return after(gw, gw.serve(None, n_windows=3))


def scenario_infeasible_frames(pkg):
    gw = make_gateway(pkg, frame_capacity=3,
                      solve_kw=dict(infeasible_frames=(0, 5)))
    gen = pkg.gw.LoadGenerator(3, rate=2.0, deadline_s=6.0, seed=4,
                               priorities=(0, 1))
    return after(gw, gw.serve(gen, n_windows=3))


def scenario_controller(pkg):
    class HealthyStub:
        plan = SimpleNamespace(latency=np.array([1.0]), positions=None)
        rollout = None
        horizon = None
        refreshes = 0
        infeasible_refreshes = 0
        nominal_latency = 1.0

    ctl = pkg.sl.ReplanController(HealthyStub())
    sched = pkg.chaos.FaultSchedule(3, 8, seed=0).device_stall(0, attempts=5)
    gw = make_gateway(pkg, schedule=sched, max_attempts=2, controller=ctl)
    rep = gw.serve(None, n_windows=2, drain=False)
    return state(gw), rep, ctl.mode, ctl.shedding, ctl.metrics()


def scenario_clock_skew(pkg):
    sched = pkg.chaos.FaultSchedule(3, 8, seed=0).clock_skew(0, -2.0)
    gw = make_gateway(pkg, schedule=sched)
    gw.submit(0, 2.0)
    return after(gw, gw.serve(None, n_windows=1))


def scenario_flood_stream(pkg):
    sched = (pkg.chaos.FaultSchedule(3, 16, seed=1)
             .arrival_flood(2, 4.0, frames=3).clock_skew(6, -0.5, frames=4)
             .device_stall(9, attempts=1))
    gw = make_gateway(pkg, schedule=sched, queue_capacity=6,
                      frame_capacity=2)
    gen = pkg.gw.LoadGenerator(3, kind="burst", rate=1.0, deadline_s=5.0,
                               deadline_jitter_s=1.5, seed=3,
                               priorities=(0, 1))
    return after(gw, gw.serve(gen, n_windows=4))


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_queue_full, scenario_expired_and_invalid,
    scenario_degraded_bucket, scenario_earliest_frame,
    scenario_expired_before_device, scenario_priority, scenario_rid_ties,
    scenario_source_slots, scenario_roll_over, scenario_stall_absorbed,
    scenario_backoff_capped, scenario_exhaustion, scenario_always_failing,
    scenario_infeasible_frames, scenario_controller, scenario_clock_skew,
    scenario_flood_stream)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stub_gateway_matches_the_reference(name):
    ref, got = both(SCENARIOS[name])
    assert nan_safe(got) == nan_safe(ref)


def test_stub_gateway_paths_exercised():
    """The scenarios above reach the outcomes they are named for."""
    g = {n: SCENARIOS[n](PORT) for n in ("queue_full", "stall_absorbed",
                                          "exhaustion", "controller",
                                          "clock_skew", "flood_stream")}
    assert g["queue_full"]["shed"] == {tgw.SHED_QUEUE_FULL: 2}
    assert g["stall_absorbed"][0]["sleeps"] == [0.01, 0.02]
    assert g["exhaustion"][0]["shed"] == {tgw.SHED_DEVICE_FAILURE: 1,
                                          tgw.SHED_DEGRADED: 3}
    assert g["controller"][2] == "nominal"
    assert g["controller"][4]["events"][0]["rungs"] == ["degraded"]
    assert g["clock_skew"][0]["requests"][0][5] == tgw.SHED_EXPIRED
    assert set(g["flood_stream"][1]["shed"]) >= {tgw.SHED_QUEUE_FULL,
                                                 tgw.SHED_EXPIRED}


# ---------------------------------------------------------------------------
# ContinuousBatcher hardening
# ---------------------------------------------------------------------------


def batcher(**kw):
    model = SimpleNamespace(device=torch.device("cpu"))
    scfg = SimpleNamespace(max_seq=32, temperature=0.0, max_batch=2,
                           eos_id=1)
    return tsl.ContinuousBatcher(model, SimpleNamespace(family="dense"),
                                 scfg, None, **kw)


def test_batcher_submit_reports_backpressure_at_capacity():
    b = batcher(max_pending=2)
    assert b.submit(tsl.Request(0, [2, 3]))
    assert b.submit(tsl.Request(1, [2, 3]))
    assert not b.submit(tsl.Request(2, [2, 3]))
    assert len(b.pending) == 2 and b.rejected == 1


def test_batcher_unbounded_default_and_validation():
    b = batcher(seed=7)
    assert all(b.submit(tsl.Request(i, [2])) for i in range(64))
    assert len(b.pending) == 64 and b.rejected == 0 and b.seed == 7
    with pytest.raises(ValueError):
        batcher(max_pending=0)


# ---------------------------------------------------------------------------
# The soak against each package's rollout
# ---------------------------------------------------------------------------


U, T, WINDOWS = 4, 4, 5


def soak(pkg, cache):
    """``tests/test_gateway.py``'s soak on ``pkg``: LeNet split over 4 UAVs,
    5 windows of 4 frames, a flood, a stall, a burst, a crash and a
    skew."""
    if pkg is REF:
        from repro.configs.lenet import LENET
        from repro.core import (RadioChannel, RadioParams, RolloutSpec,
                                cnn_cost, make_devices)
        from repro.core.positions import hex_init
        from repro.runtime.fleet_rollout import FleetRollout
        kw = {}
    else:
        from repro_torch.configs.lenet import LENET
        from repro_torch.core.channel import RadioChannel, RadioParams
        from repro_torch.core.cost_model import cnn_cost
        from repro_torch.core.positions import hex_init
        from repro_torch.core.rollout import RolloutSpec
        from repro_torch.core.swarm import make_devices
        from repro_torch.runtime.fleet_rollout import FleetRollout
        kw = {"device": "cpu"}
    base = hex_init(U, 40.0, jitter=0.5, seed=1)
    ro = FleetRollout(RadioChannel(RadioParams()),
                      make_devices(U, mem_frac=2e-4), cnn_cost(LENET),
                      RolloutSpec(frames=T, requests_per_frame=3,
                                  recovery_prob=0.5),
                      plan_cache=cache, seed=0, **kw)
    sched = (pkg.chaos.FaultSchedule(U, T * WINDOWS, seed=5)
             .burst(frame=6, size=2, persistence=0.7)
             .crash(frame=10, uav=0, frames=4)
             .arrival_flood(8, 3.0, frames=4)
             .device_stall(4, attempts=1)
             .clock_skew(12, -1.0, frames=4))
    gw = pkg.gw.StreamingGateway(
        ro, base, pkg.gw.GatewayConfig(window_frames=T, frame_s=1.0,
                                       queue_capacity=24, frame_capacity=3,
                                       retry_base_backoff_s=0.001,
                                       max_attempts=3),
        schedule=sched, seed=0)
    gen = pkg.gw.LoadGenerator(U, kind="burst", rate=1.0, deadline_s=9.0,
                               seed=7, priorities=(0, 1),
                               priority_weights=(0.2, 0.8))
    try:
        report = gw.serve(gen, n_windows=WINDOWS)
    finally:
        gw.close()
    return gw, report


def discrete(gw):
    return ([(r.rid, r.uav, r.submit_s, r.deadline_s, r.priority, r.outcome,
              r.frame, r.window) for r in gw.requests],
            dict(gw.shed_counts), [a.tolist() for a in gw.arrival_tensors])


FLOAT_KEYS = ("latency_p50_s", "latency_p99_s", "latency_mean_s")


@pytest.fixture(scope="module")
def soaks():
    from repro.runtime.scenario_engine import PlanFnCache as JCache
    from repro_torch.runtime.scenario_engine import PlanFnCache as TCache
    cache = TCache()
    first = soak(PORT, cache)
    builds = dict(cache.builds)
    second = soak(PORT, cache)
    return dict(ref=soak(REF, JCache()), port=first, replay=second,
                cache=cache, builds=builds)


def test_soak_invariants(soaks):
    gw, report = soaks["port"]
    outcomes = [r.outcome for r in gw.requests]
    assert all(o == tgw.SERVED or o in tgw.SHED_REASONS for o in outcomes)
    assert report["served"] + report["shed_total"] == report["submitted"]
    assert report["served"] == outcomes.count(tgw.SERVED)
    assert report["retries"] >= 1
    assert gw.shed_counts.get(tgw.SHED_QUEUE_FULL, 0) > 0
    assert gw.shed_counts.get(tgw.SHED_EXPIRED, 0) > 0
    assert report["deadline_hit_rate"] == 1.0
    assert report["windows_failed"] == report["device_failures"] == 0
    for r in gw.served:
        assert (r.frame + 1) * 1.0 <= r.deadline_s
        assert np.isfinite(r.latency_s)


def test_soak_replays_bitwise_on_one_build(soaks):
    (gw, report), (gw2, report2) = soaks["port"], soaks["replay"]
    assert report2 == report
    assert discrete(gw2) == discrete(gw)
    assert [r.latency_s for r in gw2.requests] == \
        [r.latency_s for r in gw.requests]
    cache = soaks["cache"]
    rollout_keys = [k for k in cache.builds if k[0] == "rollout"]
    assert len(rollout_keys) == 1 and cache.builds[rollout_keys[0]] == 1
    assert cache.builds == soaks["builds"]          # the replay built none


def test_soak_matches_the_reference(soaks):
    (ref_gw, ref), (gw, got) = soaks["ref"], soaks["port"]
    assert discrete(gw) == discrete(ref_gw)
    assert {k: v for k, v in got.items() if k not in FLOAT_KEYS} == \
        {k: v for k, v in ref.items() if k not in FLOAT_KEYS}
    for k in FLOAT_KEYS:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    np.testing.assert_allclose([r.latency_s for r in gw.requests],
                               [r.latency_s for r in ref_gw.requests],
                               rtol=1e-5)
