"""The port's swarm simulator and the paper's two baselines against the
reference on the CPU.

* The baselines never run P2: their placement, P1 and positions are host
  numpy in both packages, so every ``SwarmSim`` row (latency, power,
  feasibility, breakdown) and every frame's plan (positions, assignment,
  ``Plan.solver``) is identical; ``static_tour_positions`` and
  ``random_positions`` too.
* LLHR with the chain DP at few P2 steps (20 and 30), on the rollout and
  on the legacy loop, with a failure injected, at U 4, 5, 6 and 8:
  feasibility, ``replanned`` and the request counts exact, latency
  within rtol 1e-3 (the tolerance of ``test_torch_rollout.py``'s P2
  case), power within 1e-3 at U 4 and 5 and within ``P2_POWER_RTOL`` at
  U 6 and 8, where the reference's own power moves by more than 1e-3
  when its initial positions move by one float32 ulp (shown below;
  ROADMAP section 3).  At the example's 80 steps and 6 UAVs: the
  discrete fields exact, latency within rtol 1e-3, power within
  ``P2_POWER_RTOL``, and LLHR <= both baselines in both packages.
* The port's own backends: the rollout close to its legacy loop (as the
  reference's ``test_swarmsim_rollout_close_to_legacy_backend`` holds
  it), failure injection sets ``replanned``, ``auto`` takes the rollout
  only for a chain-DP ``LLHRPlanner`` (counted ``FleetRollout.run``
  calls), and ``backend="rollout"`` with a baseline raises.
* ``latency_summary``, ``average_latency``, ``feasibility_rate`` and
  ``average_power`` equal the reference's on the same frames.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import swarm as jsw  # noqa: E402
from repro.core import baselines as jbl  # noqa: E402
from repro.core.channel import RadioChannel as JChannel  # noqa: E402
from repro.core.cost_model import cnn_cost as j_cnn_cost  # noqa: E402
from repro.core.placement import solve_chain_dp as j_chain_dp  # noqa: E402
from repro.core.planner import LLHRPlanner as JPlanner  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET as T_ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import baselines as tbl  # noqa: E402
from repro_torch.core import swarm as tsw  # noqa: E402
from repro_torch.core.channel import RadioChannel as TChannel  # noqa: E402
from repro_torch.core.cost_model import cnn_cost as t_cnn_cost  # noqa: E402
from repro_torch.core.placement import solve_chain_dp as t_chain_dp  # noqa: E402
from repro_torch.core.planner import LLHRPlanner as TPlanner  # noqa: E402
from repro_torch.runtime.fleet_rollout import FleetRollout  # noqa: E402

MODELS = {"lenet": (LENET, T_LENET), "alexnet": (ALEXNET, T_ALEXNET)}
BASELINES = {"heuristic": (jbl.HeuristicPlanner, tbl.HeuristicPlanner),
             "random": (jbl.RandomPlanner, tbl.RandomPlanner)}
#: model, U, mem_frac: AlexNet at mem_frac 0.2 on 8 UAVs makes the random
#: baseline spread requests over two UAVs and leaves frames infeasible
BASELINE_CASES = [("lenet", 6, 1.0), ("alexnet", 6, 1.0),
                  ("alexnet", 8, 0.2)]
#: power where P2 is chaotic (U 6 and 8, and 80 steps): the tightened
#: power is a max over USED links, whose lengths the chain objective does
#: not pin; one float32 ulp on the reference's initial positions moves its
#: own power by up to 1.99e-2 (``test_llhr_power_rtol_is_the_reference_own
#: _one_ulp_spread``)
P2_POWER_RTOL = 2e-2
DISCRETE = ("t", "n_requests", "feasible", "replanned")


def sims(model, U, jplanner, tplanner, mem_frac=1.0, **kw):
    jcfg, tcfg = MODELS[model]
    return (jsw.SwarmSim(j_cnn_cost(jcfg), jsw.make_devices(U, mem_frac),
                         jplanner, **kw),
            tsw.SwarmSim(t_cnn_cost(tcfg), tsw.make_devices(U, mem_frac),
                         tplanner, device="cpu", **kw))


def assert_rows(ref, got, rtol=None, power_rtol=None):
    """Frame by frame: discrete fields exact; latency, power and the
    breakdown exact when ``rtol`` is None, else within it."""
    assert len(ref) == len(got)
    for r, g in zip(ref, got):
        assert tuple(getattr(g, f) for f in DISCRETE) == \
            tuple(getattr(r, f) for f in DISCRETE)
        if rtol is None:
            assert (g.latency, g.power, g.breakdown) == \
                (r.latency, r.power, r.breakdown)
            continue
        assert np.isfinite(g.latency) == np.isfinite(r.latency)
        if np.isfinite(r.latency):
            np.testing.assert_allclose(g.latency, r.latency, rtol=rtol)
        np.testing.assert_allclose(g.power, r.power,
                                   rtol=power_rtol or rtol, atol=1e-12)


@pytest.mark.parametrize("name", ["heuristic", "random"])
@pytest.mark.parametrize("model,U,mem_frac", BASELINE_CASES)
def test_baseline_rows_and_plans_are_exact(model, U, mem_frac, name):
    jcls, tcls = BASELINES[name]
    jp, tp = jcls(JChannel()), tcls(TChannel(), device="cpu")
    ref, got = sims(model, U, jp, tp, mem_frac, requests_per_frame=4,
                    seed=2, failure_frame=1, failure_uav=2)
    rows = got.run(frames=4)
    assert_rows(ref.run(frames=4), rows)
    assert not any(s.replanned for s in rows)      # baselines never replan
    jcfg, tcfg = MODELS[model]
    rng = np.random.default_rng(5)
    for t in range(3):
        src = [int(x) for x in rng.integers(0, U, 4)]
        jplan, jprobs = jp.plan(j_cnn_cost(jcfg),
                                jsw.make_devices(U, mem_frac), src, t=t)
        tplan, tprobs = tp.plan(t_cnn_cost(tcfg),
                                tsw.make_devices(U, mem_frac), src, t=t)
        np.testing.assert_array_equal(jplan.positions, tplan.positions)
        np.testing.assert_array_equal(jplan.rate, tplan.rate)
        assert [s.assign for s in jplan.placements] == \
            [s.assign for s in tplan.placements]
        assert [s.latency for s in jplan.placements] == \
            [s.latency for s in tplan.placements]
        assert (jplan.total_power, jplan.feasible, jplan.solver) == \
            (tplan.total_power, tplan.feasible, tplan.solver)
        assert tplan.solver == {"heuristic": "solve_greedy",
                                "random": "_rand"}[name]
        assert jplan.latency_breakdown(jprobs) == \
            tplan.latency_breakdown(tprobs)


def test_the_random_baseline_case_spreads_and_fails_frames():
    """The AlexNet mem_frac 0.2 case above is not all-local: the random
    baseline hosts some request on two UAVs and leaves a frame
    infeasible."""
    tp = tbl.RandomPlanner(TChannel(), device="cpu")
    plan, _ = tp.plan(t_cnn_cost(T_ALEXNET), tsw.make_devices(8, 0.2),
                      [1, 6, 3, 2], t=2)
    assert any(len(set(s.assign)) == 2 for s in plan.placements)
    assert not plan.feasible and plan.total_power > 0


@pytest.mark.parametrize("t", [0, 3, 17])
@pytest.mark.parametrize("U", [1, 6, 8])
def test_baseline_positions_match(U, t):
    np.testing.assert_array_equal(jbl.static_tour_positions(U, t),
                                  tbl.static_tour_positions(U, t))
    for sep in (0.0, 40.0):
        np.testing.assert_array_equal(
            jbl.random_positions(U, np.random.default_rng(t), 220.0, sep),
            tbl.random_positions(U, np.random.default_rng(t), 220.0, sep))


def llhr(steps, seed=0):
    return (JPlanner(JChannel(), placement_solver=j_chain_dp,
                     position_steps=steps, seed=seed),
            TPlanner(TChannel(), placement_solver=t_chain_dp,
                     position_steps=steps, seed=seed, device="cpu"))


@pytest.mark.parametrize("backend", ["rollout", "legacy"])
@pytest.mark.parametrize("steps", [20, 30])
@pytest.mark.parametrize("model,U", [("lenet", 4), ("alexnet", 4),
                                     ("lenet", 5), ("alexnet", 5),
                                     ("lenet", 6), ("alexnet", 6),
                                     ("lenet", 8), ("alexnet", 8)])
def test_llhr_rows_within_the_p2_tolerance(model, U, steps, backend):
    ref, got = sims(model, U, *llhr(steps), requests_per_frame=4,
                    failure_frame=1, failure_uav=2, backend=backend)
    rows = got.run(frames=3)
    assert_rows(ref.run(frames=3), rows, rtol=1e-3,
                power_rtol=P2_POWER_RTOL if U >= 6 else None)
    assert rows[1].replanned and all(s.feasible for s in rows)


def one_ulp_up_hex_init(hex_init):
    def nudged(*a, **k):
        pos = np.asarray(hex_init(*a, **k), np.float32)
        return np.nextafter(pos, np.float32(np.inf)).astype(np.float64)
    return nudged


@pytest.mark.parametrize("model,U,seed", [("alexnet", 6, 0),
                                          ("lenet", 6, 1),
                                          ("lenet", 8, 1)])
def test_llhr_power_rtol_is_the_reference_own_one_ulp_spread(
        model, U, seed, monkeypatch):
    """Why power is held at ``P2_POWER_RTOL`` at U 6 and 8: one float32
    ulp up on every initial coordinate of the reference's P2 (its
    ``hex_init``, read by both backends) moves the reference's own power
    by more than 1e-3 (1.66e-2, 1.99e-2 and 6.6e-3 in these cases) while
    latency stays within 1e-3 and every discrete field is exact; the
    port lies within the same bounds at the same inputs."""
    import repro.core.positions as jpos
    kw = dict(requests_per_frame=4, failure_frame=1, failure_uav=2,
              backend="rollout")
    ref, got = sims(model, U, *llhr(20, seed), **kw)
    rows, port = ref.run(frames=3), got.run(frames=3)
    monkeypatch.setattr(jpos, "hex_init", one_ulp_up_hex_init(jpos.hex_init))
    nudged = sims(model, U, *llhr(20, seed), **kw)[0].run(frames=3)
    spread = max(abs(n.power - r.power) / max(r.power, 1e-30)
                 for r, n in zip(rows, nudged))
    assert 1e-3 < spread < P2_POWER_RTOL
    assert_rows(rows, nudged, rtol=1e-3, power_rtol=P2_POWER_RTOL)
    assert_rows(rows, port, rtol=1e-3, power_rtol=P2_POWER_RTOL)


@pytest.fixture
def rollout_runs(monkeypatch):
    """Counts ``FleetRollout.run`` calls: which backend ran."""
    calls = []
    run = FleetRollout.run

    def counting(self, *a, **k):
        calls.append(self.device)
        return run(self, *a, **k)

    monkeypatch.setattr(FleetRollout, "run", counting)
    return calls


@pytest.mark.parametrize("model", ["lenet", "alexnet"])
def test_example_configuration_at_80_steps(model, rollout_runs):
    """The example's rows: 6 UAVs, 4 requests a frame, LLHR at 80 P2
    steps on the rollout (with and without the failure at frame 1, UAV
    2) against both baselines, in both packages."""
    for fail in (-1, 1):
        ref, got = sims(model, 6, *llhr(80), requests_per_frame=4,
                        failure_frame=fail, failure_uav=2)
        rows = got.run(frames=3)
        assert_rows(ref.run(frames=3), rows, rtol=1e-3,
                    power_rtol=P2_POWER_RTOL)
        assert rows[1].replanned == (fail == 1)
    assert len(rollout_runs) == 2
    (jllhr, tllhr), jcfg = llhr(80), MODELS[model][0]
    jrows = [jsw.latency_summary(jsw.SwarmSim(
        j_cnn_cost(jcfg), jsw.make_devices(6), p, requests_per_frame=4)
        .run(frames=3)) for p in (jllhr, jbl.HeuristicPlanner(JChannel()),
                                  jbl.RandomPlanner(JChannel()))]
    trows = [tsw.latency_summary(tsw.SwarmSim(
        t_cnn_cost(MODELS[model][1]), tsw.make_devices(6), p,
        requests_per_frame=4, device="cpu").run(frames=3))
        for p in (tllhr, tbl.HeuristicPlanner(TChannel(), device="cpu"),
                  tbl.RandomPlanner(TChannel(), device="cpu"))]
    for llhr_row, *baseline_rows in (jrows, trows):
        for row in baseline_rows:
            assert llhr_row.mean_latency <= row.mean_latency + 1e-9
            assert llhr_row.feasibility_rate >= row.feasibility_rate
    assert len(rollout_runs) == 3


def test_rollout_close_to_legacy_backend():
    """The port's two backends in the matched configuration (one request
    a frame, the same source stream, P2 on), held as the reference holds
    its own: feasibility and request counts equal, mean latency within
    rtol 0.3 (the two P2 paths differ in the coverage-circle centre)."""
    _, planner = llhr(300)
    kw = dict(model=t_cnn_cost(T_LENET), devices=tsw.make_devices(5),
              seed=3, device="cpu")
    for rq in (1, 4):
        fast = tsw.SwarmSim(planner=planner, backend="rollout",
                            requests_per_frame=rq, **kw).run(3)
        slow = tsw.SwarmSim(planner=planner, backend="legacy",
                            requests_per_frame=rq, **kw).run(3)
        assert [s.feasible for s in fast] == [s.feasible for s in slow]
        assert [s.n_requests for s in fast] == [s.n_requests for s in slow]
        f, s = tsw.latency_summary(fast), tsw.latency_summary(slow)
        assert f.feasibility_rate == s.feasibility_rate == 1.0
        np.testing.assert_allclose(f.mean_latency, s.mean_latency, rtol=0.3)


def test_failure_injection_replans_on_the_rollout(rollout_runs):
    sim = tsw.SwarmSim(t_cnn_cost(T_LENET), tsw.make_devices(5),
                       llhr(60)[1], requests_per_frame=2, failure_frame=1,
                       failure_uav=2, device="cpu")
    stats = sim.run(frames=3)
    assert sim.backend == "auto" and rollout_runs == [sim.device]
    assert len(stats) == 3
    assert not stats[0].replanned and stats[1].replanned
    assert all(s.feasible for s in stats)
    assert np.isfinite(tsw.average_latency(stats))


def test_auto_backend_keeps_bnb_on_the_legacy_loop(rollout_runs):
    """A planner with the default branch-and-bound keeps its solver: one
    ``plan`` call a frame, no rollout."""
    calls = []
    planner = TPlanner(TChannel(), position_steps=50, device="cpu")
    orig = planner.plan

    def spying_plan(*a, **k):
        calls.append(k["t"])
        return orig(*a, **k)

    planner.plan = spying_plan
    stats = tsw.SwarmSim(t_cnn_cost(T_LENET), tsw.make_devices(4), planner,
                         requests_per_frame=1, device="cpu").run(frames=2)
    assert calls == [0, 1] and rollout_runs == []
    assert all(s.feasible for s in stats)


def test_reference_solver_identity_takes_the_legacy_loop(rollout_runs):
    """``auto`` keys on the port's own ``solve_chain_dp``: a planner
    handed the reference's function is not rerouted onto the rollout."""
    planner = TPlanner(TChannel(), placement_solver=j_chain_dp,
                       position_steps=20, device="cpu")
    tsw.SwarmSim(t_cnn_cost(T_LENET), tsw.make_devices(4), planner,
                 requests_per_frame=1, device="cpu").run(frames=1)
    assert rollout_runs == []


def test_baselines_take_the_legacy_loop_and_refuse_the_rollout(rollout_runs):
    for cls in (tbl.HeuristicPlanner, tbl.RandomPlanner):
        planner = cls(TChannel(), device="cpu")
        assert isinstance(planner, tsw.SwarmPlanner)
        stats = tsw.SwarmSim(t_cnn_cost(T_LENET), tsw.make_devices(6),
                             planner, requests_per_frame=2,
                             device="cpu").run(frames=2)
        assert len(stats) == 2
        with pytest.raises(ValueError, match="backend='legacy'"):
            tsw.SwarmSim(t_cnn_cost(T_LENET), tsw.make_devices(6), planner,
                         backend="rollout", device="cpu").run(frames=1)
    assert rollout_runs == []
    assert isinstance(llhr(10)[1], tsw.SwarmPlanner)


def test_llhr_dominates_both_baselines_on_lenet():
    """Fig. 5's ordering on LeNet, 6 UAVs, 4 requests a frame."""
    mc, devs = t_cnn_cost(T_LENET), tsw.make_devices(6)
    rows = {name: tsw.SwarmSim(mc, devs, p, requests_per_frame=4,
                               device="cpu").run(frames=4)
            for name, p in (("llhr", llhr(80)[1]),
                            ("heuristic", tbl.HeuristicPlanner(
                                TChannel(), device="cpu")),
                            ("random", tbl.RandomPlanner(
                                TChannel(), device="cpu")))}
    s = {k: tsw.latency_summary(v) for k, v in rows.items()}
    assert s["llhr"].feasibility_rate == 1.0
    for name in ("heuristic", "random"):
        assert s["llhr"].mean_latency <= s[name].mean_latency + 1e-9
        assert s["llhr"].feasibility_rate >= s[name].feasibility_rate
    assert tsw.average_power(rows["llhr"]) >= 0.0


def frames_with_outages():
    mk = tsw.FrameStats
    return [mk(0, 0.5, 0.1, {}, 4, True), mk(1, float("inf"), 0.3, {}, 4,
                                               False),
            mk(2, 0.25, 0.2, {}, 3, True), mk(3, 0.75, 0.9, {}, 4, False),
            mk(4, 1.5, 0.05, {}, 4, True, True)]


@pytest.mark.parametrize("frames", [frames_with_outages(),
                                    frames_with_outages()[1:2],
                                    frames_with_outages()[2:3]])
def test_summaries_match(frames):
    r, g = jsw.latency_summary(frames), tsw.latency_summary(frames)
    assert (g.mean_latency, g.feasibility_rate, g.n_frames, g.n_feasible) \
        == (r.mean_latency, r.feasibility_rate, r.n_frames, r.n_feasible)
    assert str(g) == str(r)
    for fn in ("average_latency", "feasibility_rate", "average_power"):
        assert getattr(tsw, fn)(frames) == getattr(jsw, fn)(frames), fn
