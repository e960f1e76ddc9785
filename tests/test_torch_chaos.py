"""The port's chaos harness, fault tolerance and SLO ladder against the
reference's on the CPU: ``tests/test_chaos.py``'s cases run through both
packages on the same inputs.

* ``FaultSchedule`` is host numpy: its three compile targets
  (``rollout_inputs``, ``host_timeline``, ``gateway_timeline``), its burst
  members and its key are bitwise the reference's, for schedules using
  every event kind; invalid events raise in both.
* The injected tensors through each package's ``FleetRollout`` (no P2):
  feasibility, activity, charge exhaustion and assignments exact,
  latency and power within rtol 1e-5 (the geometry's ``log2`` differs in
  the last ulp); a neutral ``gain_scale`` is bitwise the plain run, and
  a seeded chaos run replays bitwise, in the port.
* ``HealthTracker`` and ``FaultTolerantRunner`` (registration timeouts,
  straggler hysteresis) give the reference's scans and events.
* ``PeriodicReplanner``'s adoption guard: the same infeasible flag and
  counts; positions adopted only from a feasible plan.
* ``ReplanController``: on a scripted stub replanner the forced-refresh
  frames, modes, admissions and metrics equal the reference's; on the
  real stack (engine, contingency table, rollout horizon, tracker and
  runner, driven by ``ChaosHostDriver``) a single crash and a 3-UAV
  burst climb the same rungs and leave the same runner events, with no
  build after the first refresh.
"""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.lenet import LENET as J_LENET  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import positions as jpos  # noqa: E402
from repro.core import rollout as jro  # noqa: E402
from repro.core import swarm as jsw  # noqa: E402
from repro.core.placement import Device as JDevice  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.runtime import fleet_rollout as jfr  # noqa: E402
from repro.runtime import scenario_engine as jse  # noqa: E402
from repro.runtime import serve_loop as jsl  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import positions as tpos  # noqa: E402
from repro_torch.core import rollout as tro  # noqa: E402
from repro_torch.core import swarm as tsw  # noqa: E402
from repro_torch.core.placement import Device as TDevice  # noqa: E402
from repro_torch.runtime import chaos as tchaos  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402
from repro_torch.runtime import fleet_rollout as tfr  # noqa: E402
from repro_torch.runtime import scenario_engine as tse  # noqa: E402
from repro_torch.runtime import serve_loop as tsl  # noqa: E402

#: each package's modules, and the keywords its device-side objects take
REF = SimpleNamespace(
    name="ref", chaos=jchaos, ft=jft, fr=jfr, se=jse, sl=jsl, sw=jsw,
    ro=jro, hex_init=jpos.hex_init, Device=JDevice,
    ch=jch.RadioChannel(jch.RadioParams()), mc=jcm.cnn_cost(J_LENET), kw={})
PORT = SimpleNamespace(
    name="port", chaos=tchaos, ft=tft, fr=tfr, se=tse, sl=tsl, sw=tsw,
    ro=tro, hex_init=tpos.hex_init, Device=TDevice,
    ch=tch.RadioChannel(tch.RadioParams()), mc=tcm.cnn_cost(T_LENET),
    kw={"device": "cpu"})
SPLIT = 2e-4          # mem_frac forcing LeNet to span >= 2 UAVs


def line_positions(u, spacing=100.0):
    return np.stack([np.arange(u) * spacing, np.zeros(u)], -1)


# ---------------------------------------------------------------------------
# FaultSchedule: host numpy, bitwise
# ---------------------------------------------------------------------------


def build_schedule(pkg, case):
    """The same event script on ``pkg``'s ``FaultSchedule``."""
    S = pkg.chaos.FaultSchedule
    if case == "crash":
        return S(4, 6, seed=0).crash(1, 2)
    if case == "fade_drop":
        return (S(4, 6, seed=0).crash(1, 2)
                .link_fade(0, db=-10.0, uav=1, frames=2)
                .link_fade(2, db=-3.0, pair=(0, 3), frames=0)
                .battery_drop(2, 3, 50.0))
    if case == "burst":
        return S(6, 10, seed=0).burst(2, 3, center=0)
    if case == "burst_drawn":
        return (S(5, 30, seed=3).burst(0, 2, persistence=0.9)
                .burst(4, 3, center=4, persistence=0.6, frames=5))
    if case == "bernoulli":
        return (S(4, 12, seed=9).bernoulli(0.2, start=2, stop=10)
                .burst(4, 2, persistence=0.5))
    if case == "host":
        return (S(5, 10, seed=1).burst(3, 2, center=4, persistence=0.6)
                .silence(5, 0).straggler(2, 1, factor=3.0)
                .straggler(4, 1, factor=2.0, frames=3)
                .battery_drop(6, 2, 10.0).battery_drop(6, 2, 5.0)
                .link_fade(1, db=-6.0, uav=4, frames=3))
    if case == "gateway":
        return (S(4, 20, seed=5).burst(frame=6, size=2, persistence=0.7)
                .crash(frame=10, uav=0, frames=4)
                .arrival_flood(8, 3.0, frames=4)
                .arrival_flood(9, 2.0, frames=0)
                .device_stall(4, attempts=1).device_stall(5, attempts=2)
                .clock_skew(12, -1.0, frames=4).clock_skew(14, 0.5))
    raise ValueError(case)


SCHEDULES = ("crash", "fade_drop", "burst", "burst_drawn", "bernoulli",
             "host", "gateway")


def frame_events(tl):
    return [(e.frame, tuple(int(u) for u in e.down), e.silent,
             e.straggler_factor, e.battery_drop_j, e.faded) for e in tl]


@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("case", SCHEDULES)
def test_schedule_compiles_bitwise(case, B):
    ref, got = build_schedule(REF, case), build_schedule(PORT, case)
    assert got.key() == ref.key()
    pos = line_positions(ref.n_uavs) + \
        np.random.default_rng(B).normal(0, 3.0, (ref.n_uavs, 2))
    a, b = ref.rollout_inputs(B, pos), got.rollout_inputs(B, pos)
    assert set(b) == set(a)
    for k in a:
        assert b[k].dtype == a[k].dtype and b[k].shape == a[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert got.burst_members(pos) == ref.burst_members(pos)
    for traj in {0, B - 1}:
        assert frame_events(got.host_timeline(pos, traj, B)) == \
            frame_events(ref.host_timeline(pos, traj, B))
    assert [vars(e) for e in got.gateway_timeline()] == \
        [vars(e) for e in ref.gateway_timeline()]


def bad_calls(pkg):
    S = pkg.chaos.FaultSchedule
    s = S(4, 8)
    return [lambda: s.crash(8, 0), lambda: s.crash(0, 4),
            lambda: s.burst(0, 5), lambda: s.burst(0, 2, persistence=1.0),
            lambda: s.link_fade(0, db=-3.0),
            lambda: s.link_fade(0, db=-3.0, uav=1, pair=(0, 1)),
            lambda: s.battery_drop(0, 1, -5.0),
            lambda: s.straggler(0, 1, factor=0.5),
            lambda: s.bernoulli(1.5), lambda: s.arrival_flood(0, 0.0),
            lambda: s.device_stall(0, attempts=0), lambda: S(0, 4)]


@pytest.mark.parametrize("k", range(12))
def test_invalid_events_raise_in_both(k):
    for pkg in (REF, PORT):
        with pytest.raises(ValueError):
            bad_calls(pkg)[k]()


def test_host_driver_feeds_the_same_heartbeats():
    """``ChaosHostDriver`` into each package's ``HealthTracker``: the same
    charges, scans and dead/straggler lists frame by frame."""
    out = {}
    for pkg in (REF, PORT):
        sched = build_schedule(pkg, "host")
        names = [f"uav{i}" for i in range(5)]
        tracker = pkg.ft.HealthTracker(names, timeout_s=2.5, now=0.0,
                                       battery_floor_j=0.0)
        drv = pkg.chaos.ChaosHostDriver(sched, tracker, line_positions(5),
                                        battery_j=12.0)
        out[pkg.name] = [(drv.play_frame(t), tracker.scan(drv.now(t)),
                          dict(drv.charge)) for t in range(10)]
    assert out["port"] == out["ref"]
    assert any(dead for _, (dead, _), _ in out["ref"])


# ---------------------------------------------------------------------------
# The injected tensors through each package's rollout
# ---------------------------------------------------------------------------


def rollout(pkg, u, frames, cache, battery_j=float("inf"), seed=0):
    spec = pkg.ro.RolloutSpec(frames=frames, battery_j=battery_j)
    return pkg.fr.FleetRollout(pkg.ch, pkg.sw.make_devices(u, mem_frac=SPLIT),
                               pkg.mc, spec, plan_cache=cache, seed=seed,
                               **pkg.kw)


def assert_traces_close(ref, got, rtol=1e-5):
    for f in ("feasible", "cap_feasible", "active", "assign", "n_requests"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(got, f),
                                      err_msg=f)
    for f in ("latency", "total_power", "source_latency", "charge",
              "energy_tx", "energy_cmp"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=f)
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, err_msg=f)


def both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn(REF), fn(PORT)


def test_neutral_gain_matches_no_gain_bitwise():
    pos = tpos.hex_init(4, 40.0, jitter=0.5, seed=1)
    T, B = 3, 2
    src = np.zeros((T, B), np.int64)
    cache = tse.PlanFnCache()
    plain = rollout(PORT, 4, T, cache).run(pos, n_trajectories=B,
                                           sources=src)
    neutral = rollout(PORT, 4, T, cache).run(
        pos, n_trajectories=B, sources=src,
        gain_scale=np.ones((T, B, 4, 4), np.float32))
    for f in ("latency", "total_power", "assign", "charge"):
        np.testing.assert_array_equal(getattr(plain, f),
                                      getattr(neutral, f), err_msg=f)


def test_blackout_fade_breaks_the_split_chain():
    """A -200 dB fade of every link of the pinned source (gain 1e-20):
    exactly the faded frames go infeasible, in both packages."""
    T, B = 4, 2

    def run(pkg):
        pos = pkg.hex_init(4, 40.0, jitter=0.5, seed=1)
        sched = pkg.chaos.FaultSchedule(4, T, seed=0).link_fade(
            1, db=-200.0, uav=0, frames=2)
        return rollout(pkg, 4, T, pkg.se.PlanFnCache()).run(
            pos, n_trajectories=B, sources=np.zeros((T, B), np.int64),
            **sched.rollout_inputs(B, pos))

    ref, got = both(run)
    assert_traces_close(ref, got)
    assert np.isfinite(got.latency[:, 0]).all()
    assert np.isinf(got.latency[:, 1:3]).all()
    assert np.isfinite(got.latency[:, 3]).all()


def test_battery_drop_excludes_uav_next_frame():
    T, B = 4, 2

    def run(pkg):
        pos = pkg.hex_init(4, 40.0, jitter=0.5, seed=1)
        sched = pkg.chaos.FaultSchedule(4, T, seed=0).battery_drop(1, 2, 1e9)
        return rollout(pkg, 4, T, pkg.se.PlanFnCache(), battery_j=5e3).run(
            pos, n_trajectories=B, **sched.rollout_inputs(B, pos))

    ref, got = both(run)
    assert_traces_close(ref, got)
    assert got.active[:, 1, 2].all() and got.charge[:, 1, 2].max() == 0.0
    assert not got.active[:, 2:, 2].any()


def test_seeded_chaos_run_replays_bitwise_and_matches():
    """A burst and a fade from one schedule seed and one rollout seed:
    two fresh port rollouts bitwise equal, and the reference's trace."""
    T, B = 6, 4

    def run(pkg, cache):
        pos = pkg.hex_init(5, 40.0, jitter=0.5, seed=1)
        sched = (pkg.chaos.FaultSchedule(5, T, seed=5)
                 .burst(2, 3, center=1, persistence=0.6)
                 .link_fade(1, db=-6.0, uav=4, frames=3))
        return rollout(pkg, 5, T, cache, seed=11).run(
            pos, n_trajectories=B, **sched.rollout_inputs(B, pos))

    cache = tse.PlanFnCache()
    a, b = run(PORT, cache), run(PORT, cache)
    for f in ("latency", "total_power", "active", "charge", "assign"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert_traces_close(run(REF, jse.PlanFnCache()), a)


# ---------------------------------------------------------------------------
# Tracker registration, straggler hysteresis, the adoption guard
# ---------------------------------------------------------------------------


def test_tracker_registration_scans_match():
    def run(pkg):
        ht = pkg.ft.HealthTracker(["a", "b"], timeout_s=10.0, now=100.0)
        early = ht.scan(now=105.0)
        ht.heartbeat("a", 0.1, now=105.0)
        late = ht.scan(now=112.0)
        return early, late, {n: (d.alive, d.last_heartbeat)
                             for n, d in ht.devices.items()}

    ref, got = both(run)
    assert got == ref and got[1][0] == ["b"]


def straggler_runner(pkg, **kw):
    devs = [pkg.Device(f"d{i}", 1e9, 1e12, 5e8) for i in range(4)]
    calls = []
    runner = pkg.ft.FaultTolerantRunner(
        devs, lambda d: calls.append(len(d)) or {"n": len(d)}, ".", **kw)
    return runner, calls


def runner_state(runner, calls):
    return (runner.events, calls, runner.state.generation,
            [(d.name, d.throughput) for d in runner.state.devices])


def test_repeated_scans_demote_once():
    def run(pkg):
        runner, calls = straggler_runner(pkg, straggler_cooldown_s=30.0)
        for t in range(10):
            for d in runner.health.devices.values():
                runner.health.heartbeat(
                    d.name, 2.0 if d.name == "d1" else 0.1, now=float(t))
            runner.tick(now=float(t))
        return runner_state(runner, calls)

    ref, got = both(run)
    assert got == ref
    assert [e["kind"] for e in got[0]] == ["straggler"]


@pytest.mark.parametrize("cooldown,floor,times",
                         [(5.0, 0.1, (0.0, 1.0, 6.0)),
                          (0.0, 0.2, tuple(float(k) for k in range(20))
                           + (99.0,))])
def test_straggler_cooldown_and_floor(cooldown, floor, times):
    def run(pkg):
        runner, calls = straggler_runner(pkg, straggler_cooldown_s=cooldown,
                                         demote_floor=floor)
        hits = [runner.on_straggler(["d1"], now=t) is not None
                for t in times]
        return runner_state(runner, calls), hits

    ref, got = both(run)
    assert got == ref


def test_runner_battery_failure_and_restore_step(tmp_path):
    """``on_battery`` kills a drained UAV through the same delegation
    path; ``restore_step`` reads the checkpoint directory."""
    def run(pkg):
        runner, calls = straggler_runner(pkg)
        runner.ckpt_dir = str(tmp_path)
        plan = runner.on_battery({"d2": 0.0, "d0": 5.0, "zz": 1.0})
        return runner_state(runner, calls), plan, runner.restore_step()

    ref, got = both(run)
    assert got == ref and got[1] == {"n": 3} and got[2] is None


@pytest.mark.parametrize("mem_frac,steps", [(4e-7, 20), (1.0, 30)])
def test_refresh_adoption_guard(mem_frac, steps):
    """A fused-P2 refresh adopts the solved positions only when its
    scenario-0 plan is feasible; an infeasible one keeps the measured
    positions and is counted, in both packages."""
    def run(pkg):
        engine = pkg.se.ScenarioEngine(
            pkg.ch, pkg.sw.make_devices(4, mem_frac=mem_frac), pkg.mc,
            plan_cache=pkg.se.PlanFnCache(),
            position_spec=pkg.ro.PositionSpec(steps=steps), **pkg.kw)
        base = pkg.hex_init(4, 40.0, jitter=0.5, seed=1)
        gen = pkg.se.ScenarioGenerator(base, pos_sigma_m=1.0, seed=0)
        rp = pkg.sl.PeriodicReplanner(engine, gen, period=2, n_scenarios=2)
        assert rp.tick(0)
        return (base, gen.base_positions, rp.nominal_latency,
                rp.infeasible_refreshes, rp.assignment)

    ref, got = both(run)
    assert np.isfinite(got[2]) == np.isfinite(ref[2])
    assert got[3] == ref[3] == (0 if mem_frac == 1.0 else 1)
    np.testing.assert_array_equal(got[4], ref[4])
    if got[3]:
        np.testing.assert_array_equal(got[1], got[0])
    else:
        assert not np.array_equal(got[1], got[0])
        np.testing.assert_allclose(got[1], ref[1], atol=1e-2)
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-3)


# ---------------------------------------------------------------------------
# ReplanController
# ---------------------------------------------------------------------------


class StubReplanner:
    """Duck-typed ``PeriodicReplanner`` with scriptable health (the
    reference test's stub)."""

    def __init__(self):
        self.healthy = True
        self.plan = SimpleNamespace(latency=np.array([1.0]), positions=None)
        self.rollout = object()
        self.horizon = object()
        self.refreshes = 0
        self.infeasible_refreshes = 0
        self.forced_at = []

    @property
    def nominal_latency(self):
        return 1.0

    @property
    def horizon_feasibility(self):
        return 1.0 if self.healthy else 0.0

    def horizon_latency(self, q):
        return 0.5

    def tick(self, frame, positions=None, force=False):
        if force:
            self.forced_at.append(frame)
        self.refreshes += 1
        return True


#: health per frame (True healthy) and the controller's knobs
LADDERS = {
    "backoff_then_degraded": ([False] * 8, dict(
        max_refresh_retries=3, base_backoff_frames=1, max_backoff_frames=8,
        shed_fraction=0.5)),
    "cap_1": ([False] * 40, dict(max_refresh_retries=1,
                                 base_backoff_frames=1,
                                 max_backoff_frames=4)),
    "cap_4": ([False] * 40, dict(max_refresh_retries=4,
                                 base_backoff_frames=1,
                                 max_backoff_frames=4)),
    "recovery": ([False] * 5 + [True] + [False] * 3, dict(
        max_refresh_retries=2, base_backoff_frames=4)),
    "healthy": ([True] * 10, {}),
    "flapping": ([True, False, False, True, False, True, True, False] * 3,
                 dict(max_refresh_retries=2, shed_fraction=0.25)),
}


@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_ladder_matches_the_reference(ladder):
    health, kw = LADDERS[ladder]

    def run(pkg):
        rp = StubReplanner()
        ctl = pkg.sl.ReplanController(rp, **kw)
        modes, admits = [], []
        for frame, ok in enumerate(health):
            rp.healthy = ok
            modes.append(ctl.step(frame))
            admits.append([ctl.admit() for _ in range(3)])
        return rp.forced_at, modes, admits, ctl.metrics(), ctl.shedding

    ref, got = both(run)
    assert got == ref


def test_degraded_serves_last_known_good():
    for pkg in (REF, PORT):
        rp = StubReplanner()
        ctl = pkg.sl.ReplanController(rp, max_refresh_retries=0)
        ctl.step(0)
        good = rp.plan
        rp.healthy = False
        rp.plan = SimpleNamespace(latency=np.array([np.inf]), positions=None)
        ctl.step(1)
        assert ctl.serving_plan is good


def test_device_exhausted_falls_to_degraded_and_recovers():
    def run(pkg):
        rp = StubReplanner()
        rp.rollout = rp.horizon = None
        ctl = pkg.sl.ReplanController(rp)
        ctl.on_device_exhausted(4)
        mid = (ctl.mode, ctl.shedding, [ctl.admit() for _ in range(4)])
        ctl.on_device_recovered(8)
        return mid, ctl.mode, ctl.metrics()

    ref, got = both(run)
    assert got == ref and got[1] == "nominal"


def stack(pkg, uavs, replan_fn=None):
    """The reference test's live stack: engine, contingency table,
    tracker, runner, a rollout horizon and the controller."""
    cache = pkg.se.PlanFnCache()
    devs = pkg.sw.make_devices(uavs, mem_frac=SPLIT)
    base = pkg.hex_init(uavs, 40.0, jitter=0.5, seed=1)
    engine = pkg.se.ScenarioEngine(pkg.ch, devs, pkg.mc, plan_cache=cache,
                                   **pkg.kw)
    table = pkg.se.ContingencyTable(engine, base, source=0)
    tracker = pkg.ft.HealthTracker([d.name for d in devs], timeout_s=2.5,
                                   now=0.0)
    runner = pkg.ft.FaultTolerantRunner(
        devs, replan_fn or (lambda d: {"n": len(d)}), ".",
        contingency=table, health=tracker)
    ro = pkg.fr.FleetRollout(pkg.ch, devs, pkg.mc, pkg.ro.RolloutSpec(
        frames=3), plan_cache=cache, seed=0, **pkg.kw)
    rp = pkg.sl.PeriodicReplanner(
        engine, pkg.se.ScenarioGenerator(base, pos_sigma_m=1.0, seed=0),
        period=4, n_scenarios=2, rollout=ro, rollout_horizon=3,
        rollout_trajectories=2)
    ctl = pkg.sl.ReplanController(
        rp, pkg.sl.ServiceLevelObjective(min_horizon_feasibility=0.25),
        runner=runner)
    return base, tracker, runner, rp, ctl


def drive(pkg, uavs, frames, schedule, replan_fn=None):
    """Play ``schedule(pkg)`` frame by frame through the live stack;
    returns what the ladder and the runner did."""
    base, tracker, runner, rp, ctl = stack(pkg, uavs, replan_fn)
    drv = pkg.chaos.ChaosHostDriver(schedule(pkg), tracker, base,
                                    frame_s=1.0)
    modes = [ctl.step(t, now=drv.play_frame(t)) for t in range(frames)]
    return dict(modes=modes, events=runner.events, metrics=ctl.metrics(),
                plan=runner.state.plan, survivors=len(runner.state.devices),
                retraces=rp.retraces)


def test_single_crash_recovers_from_contingency():
    def run(pkg):
        return drive(pkg, 4, 10, lambda p: p.chaos.FaultSchedule(
            4, 10, seed=0).crash(3, 2))

    ref, got = both(run)
    for k in ("modes", "events", "metrics"):
        assert got[k] == ref[k], k
    fails = [e for e in got["events"] if e["kind"] == "failure"]
    assert fails[0]["dead"] == ["uav2"] and fails[0]["precomputed"]
    assert got["plan"].assign == ref["plan"].assign
    assert max(got["plan"].assign) < got["survivors"]
    assert got["modes"][-1] == "nominal" and got["retraces"] == 0
    assert got["metrics"]["n_unrecovered"] == 0


def test_burst_falls_through_to_live_replan():
    def replan(survivors):
        return {"devices": [d.name for d in survivors]}

    def run(pkg):
        return drive(pkg, 5, 10, lambda p: p.chaos.FaultSchedule(
            5, 10, seed=2).burst(3, 3, center=1, persistence=0.95),
            replan_fn=replan)

    ref, got = both(run)
    for k in ("modes", "events", "metrics", "plan"):
        assert got[k] == ref[k], k
    fails = [e for e in got["events"] if e["kind"] == "failure"]
    assert len(fails[0]["dead"]) == 3 and not fails[0]["precomputed"]
    assert set(got["plan"]["devices"]).isdisjoint(fails[0]["dead"])
    assert got["metrics"]["n_unrecovered"] == 0 and got["retraces"] == 0


def test_same_seed_identical_runner_events():
    def run(pkg):
        return drive(pkg, 4, 10, lambda p: p.chaos.FaultSchedule(
            4, 10, seed=4).burst(2, 2, center=0, persistence=0.9))

    first, second = run(PORT), run(PORT)
    assert first["events"] == second["events"]
    assert first["events"] == run(REF)["events"]
