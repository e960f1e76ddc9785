"""The port's host planner (P1, P3, ``LLHRPlanner``) and its P2 entry
points against the reference on the CPU.

* P1 (``solve_power``, ``exhaustive_refine``, ``min_power_for_placement``)
  and P3 (``solve_bnb``, ``solve_greedy``, ``solve_chain_dp``,
  ``solve_brute``, ``solve_random``, ``place_requests``) are numpy copies:
  every array, assignment and latency must be identical.
* The solver options the baselines and the batched wrappers use:
  ``solve_chain_dp(device_order=)``, ``solve_random(seed=, tries=)`` and
  ``place_requests(solver=)``, identical to the reference's.
* ``LLHRPlanner.plan`` and ``replan_on_failure`` given the SAME positions:
  every ``Plan`` field identical, with the default branch-and-bound and
  with a ``placement_solver`` (``Plan.solver`` names it); ``t`` is
  ignored, and ``optimize_positions=False`` without positions raises.  P2 is left out of that comparison: its
  float32 gradient steps compound ulp differences between XLA and
  PyTorch, so a near tie in P3 could flip on positions that differ in the
  last bits.
* P2 (``solve_positions``, ``solve_positions_batched``) on the CPU: the 2R
  separation and the coverage circle hold, and after 20-30 steps the
  objective is within rtol 1e-4 of the reference's (1e-3 at U = 6, where
  the reference's own 1-ulp spread is 6.9e-4; see ``P2_RTOL``).  Longer
  runs are chaotic in float32 (see the 200-step test), so they keep the
  invariants only.
* ``solve_positions_legacy`` (a gradient loop on the device, then the
  reference's host repair): at 20-30 steps the objective within rtol
  1e-4 at U 4 and 8; at its default 800 steps the invariants, and the
  objective within ``P2_LEGACY_RTOL``, the width of the band the
  reference's own last iterates sweep (the legacy solver keeps its last
  iterate, and a normalized step of lr = 0.5 m never shrinks).
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core import power as jpw  # noqa: E402
from repro.core.batch import solve_positions_batched as j_spb  # noqa: E402
from repro.core.channel import RadioChannel as JChannel  # noqa: E402
from repro.core.cost_model import cnn_cost as j_cnn_cost  # noqa: E402
from repro.core.planner import LLHRPlanner as JPlanner  # noqa: E402
from repro.core.positions import chain_oracle as j_chain_oracle  # noqa: E402
from repro.core.positions import hex_init  # noqa: E402
from repro.core.positions import solve_positions as j_solve_pos  # noqa: E402
from repro.core.positions import \
    solve_positions_legacy as j_legacy  # noqa: E402
from repro.core.swarm import make_devices as j_make_devices  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET as T_ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core import power as tpw  # noqa: E402
from repro_torch.core.batch import \
    solve_positions_batched as t_spb  # noqa: E402
from repro_torch.core.channel import RadioChannel as TChannel  # noqa: E402
from repro_torch.core.cost_model import cnn_cost as t_cnn_cost  # noqa: E402
from repro_torch.core.planner import LLHRPlanner as TPlanner  # noqa: E402
from repro_torch.core.positions import \
    chain_oracle as t_chain_oracle  # noqa: E402
from repro_torch.core.positions import \
    solve_positions as t_solve_pos  # noqa: E402
from repro_torch.core.positions import \
    solve_positions_legacy as t_legacy  # noqa: E402
from repro_torch.core.swarm import make_devices as t_make_devices  # noqa: E402

MODELS = {"lenet": (LENET, T_LENET), "alexnet": (ALEXNET, T_ALEXNET)}
#: model, U, mem_frac, requests: AlexNet at mem_frac 0.2 cannot fit fc1
#: and fc2 on one UAV, so every request there is distributed
CASES = [("lenet", 4, 1.0, [0, 1]), ("lenet", 6, 0.001, [0, 2, 5]),
         ("alexnet", 8, 0.2, [0, 1, 2, 3]), ("alexnet", 5, 0.5, [4, 4])]
CASE_IDS = [f"{m}-U{u}-mem{f}" for m, u, f, _ in CASES]


def positions(seed, U, spread=60.0):
    return np.random.default_rng(seed).uniform(0.0, spread, (U, 2))


def dist_of(pos):
    return np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1))


def assert_power_equal(a, b):
    for f in ("power", "threshold", "feasible", "link_feasible"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.total_power == b.total_power


@pytest.mark.parametrize("seed,U,spread", [(0, 4, 40.0), (1, 8, 120.0),
                                           (2, 6, 300.0)])
def test_p1_matches(seed, U, spread):
    pos = positions(seed, U, spread)
    d = dist_of(pos)
    jc, tc = JChannel(), TChannel()
    js, ts = jpw.solve_power(d, jc), tpw.solve_power(d, tc)
    assert_power_equal(js, ts)
    np.testing.assert_array_equal(js.rate_matrix(jc, d),
                                  ts.rate_matrix(tc, d))
    np.testing.assert_array_equal(jpw.exhaustive_refine(js, d, jc),
                                  tpw.exhaustive_refine(ts, d, tc))
    links = [(i, (i + 1) % U) for i in range(U)] + [(0, 0)]
    assert_power_equal(jpw.min_power_for_placement(d, jc, links),
                       tpw.min_power_for_placement(d, tc, links))


def problems(pkg, model, U, mem_frac, sources, seed=0):
    cfg = MODELS[model][0 if pkg is jpl else 1]
    mc = (j_cnn_cost if pkg is jpl else t_cnn_cost)(cfg)
    devs = (j_make_devices if pkg is jpl else t_make_devices)(U, mem_frac)
    pw = (jpw if pkg is jpl else tpw).solve_power(
        dist_of(positions(seed, U)), JChannel() if pkg is jpl else TChannel())
    rate = pw.rate_matrix(JChannel() if pkg is jpl else TChannel(),
                          dist_of(positions(seed, U)))
    return [pkg.PlacementProblem(
        np.array([l.flops for l in mc.layers]),
        np.array([l.weight_bytes for l in mc.layers]),
        np.array([l.act_bits for l in mc.layers]), list(devs), rate,
        source=s, input_bits=mc.input_bits) for s in sources]


def assert_solutions_equal(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert tuple(a.assign) == tuple(b.assign)
        assert a.latency == b.latency
        assert a.solver == b.solver
        assert a.links == b.links


@pytest.mark.parametrize("solver", ["solve_bnb", "solve_greedy",
                                    "solve_chain_dp", "solve_random"])
@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_p3_solvers_match(solver, model, U, mem_frac, sources):
    jp = problems(jpl, model, U, mem_frac, sources)
    tp = problems(tpl, model, U, mem_frac, sources)
    js = [getattr(jpl, solver)(p) for p in jp]
    ts = [getattr(tpl, solver)(p) for p in tp]
    assert_solutions_equal(js, ts)


@pytest.mark.parametrize("order", [(3, 1, 0, 2), (2, 0, 1, 3)])
@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_chain_dp_in_a_device_order_matches(model, U, mem_frac, sources,
                                            order):
    """The order is a permutation of the first four UAVs (U >= 4): the
    other UAVs take no layer."""
    jp = problems(jpl, model, U, mem_frac, sources)
    tp = problems(tpl, model, U, mem_frac, sources)
    js = [jpl.solve_chain_dp(p, device_order=order) for p in jp]
    ts = [tpl.solve_chain_dp(p, device_order=order) for p in tp]
    assert_solutions_equal(js, ts)
    assert all(set(s.assign) <= set(order) for s in ts)


@pytest.mark.parametrize("seed,tries", [(0, 64), (3, 1), (11, 8), (7, 200)])
@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_solve_random_seed_and_tries_match(model, U, mem_frac, sources,
                                           seed, tries):
    jp = problems(jpl, model, U, mem_frac, sources)
    tp = problems(tpl, model, U, mem_frac, sources)
    assert_solutions_equal(
        [jpl.solve_random(p, seed=seed, tries=tries) for p in jp],
        [tpl.solve_random(p, seed=seed, tries=tries) for p in tp])


@pytest.mark.parametrize("solver", ["solve_greedy", "solve_chain_dp",
                                    "solve_random"])
@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_place_requests_with_a_solver_matches(model, U, mem_frac, sources,
                                              solver):
    jp = problems(jpl, model, U, mem_frac, sources)
    tp = problems(tpl, model, U, mem_frac, sources)
    for plist in (jp, tp):
        mem, cmp_ = np.zeros(U), np.zeros(U)
        for p in plist:
            p.mem_used, p.compute_used = mem, cmp_
    assert_solutions_equal(jpl.place_requests(jp, getattr(jpl, solver)),
                           tpl.place_requests(tp, getattr(tpl, solver)))
    np.testing.assert_array_equal(jp[0].compute_used, tp[0].compute_used)


def test_p3_brute_force_matches_on_a_small_instance():
    jp = problems(jpl, "lenet", 3, 1.0, [1])[0]
    tp = problems(tpl, "lenet", 3, 1.0, [1])[0]
    assert_solutions_equal([jpl.solve_brute(jp)], [tpl.solve_brute(tp)])
    assert tpl.solve_brute(tp).latency == tpl.solve_bnb(tp).latency


@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_place_requests_shares_residual_caps_as_the_reference(
        model, U, mem_frac, sources):
    jp = problems(jpl, model, U, mem_frac, sources)
    tp = problems(tpl, model, U, mem_frac, sources)
    for plist in (jp, tp):
        mem, cmp_ = np.zeros(U), np.zeros(U)
        for p in plist:
            p.mem_used, p.compute_used = mem, cmp_
    assert_solutions_equal(jpl.place_requests(jp), tpl.place_requests(tp))
    np.testing.assert_array_equal(jp[0].mem_used, tp[0].mem_used)
    np.testing.assert_array_equal(jp[0].compute_used, tp[0].compute_used)


def assert_plans_equal(jplan, jprobs, tplan, tprobs):
    np.testing.assert_array_equal(jplan.positions, tplan.positions)
    assert_power_equal(jplan.power, tplan.power)
    assert_solutions_equal(jplan.placements, tplan.placements)
    np.testing.assert_array_equal(jplan.rate, tplan.rate)
    assert jplan.total_latency == tplan.total_latency
    assert jplan.total_power == tplan.total_power
    assert jplan.solver == tplan.solver
    assert jplan.feasible == tplan.feasible
    assert jplan.latency_breakdown(jprobs) == tplan.latency_breakdown(tprobs)


def planners(model, U, mem_frac):
    jcfg, tcfg = MODELS[model]
    return ((JPlanner(JChannel()), j_cnn_cost(jcfg),
             j_make_devices(U, mem_frac)),
            (TPlanner(TChannel(), device="cpu"), t_cnn_cost(tcfg),
             t_make_devices(U, mem_frac)))


@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_planner_matches_given_positions(model, U, mem_frac, sources):
    pos = hex_init(U, 40.0, jitter=0.5, seed=U)
    (jpl_, jmc, jdev), (tpl_, tmc, tdev) = planners(model, U, mem_frac)
    jplan, jprobs = jpl_.plan(jmc, jdev, sources, positions=pos)
    tplan, tprobs = tpl_.plan(tmc, tdev, sources, positions=pos)
    assert_plans_equal(jplan, jprobs, tplan, tprobs)
    dead = tplan.placements[0].assign[0] if tplan.placements[0].assign \
        else 0
    jre = jpl_.replan_on_failure(jplan, jprobs, dead)
    tre = tpl_.replan_on_failure(tplan, tprobs, dead)
    assert_plans_equal(*jre, *tre)


@pytest.mark.parametrize("solver", ["solve_greedy", "solve_chain_dp",
                                    "solve_random"])
@pytest.mark.parametrize("model,U,mem_frac,sources", CASES, ids=CASE_IDS)
def test_planner_with_a_placement_solver_matches(model, U, mem_frac,
                                                 sources, solver):
    """``placement_solver`` and ``optimize_positions=False`` as the
    baselines set them, at the same positions: every ``Plan`` field of
    the plan and of the replan identical, ``Plan.solver`` the solver's
    name, and the frame index ``t`` changes nothing."""
    pos = hex_init(U, 40.0, jitter=0.5, seed=U + 1)
    jcfg, tcfg = MODELS[model]
    jp = JPlanner(JChannel(), placement_solver=getattr(jpl, solver),
                  optimize_positions=False)
    tp = TPlanner(TChannel(), placement_solver=getattr(tpl, solver),
                  optimize_positions=False, device="cpu")
    jmc, tmc = j_cnn_cost(jcfg), t_cnn_cost(tcfg)
    jdev, tdev = j_make_devices(U, mem_frac), t_make_devices(U, mem_frac)
    jplan, jprobs = jp.plan(jmc, jdev, sources, positions=pos, t=3)
    tplan, tprobs = tp.plan(tmc, tdev, sources, positions=pos, t=3)
    assert_plans_equal(jplan, jprobs, tplan, tprobs)
    assert tplan.solver == solver
    again, _ = tp.plan(tmc, tdev, sources, positions=pos)
    assert_plans_equal(tplan, tprobs, again, tprobs)
    dead = tplan.placements[0].assign[0] if tplan.placements[0].assign \
        else 0
    jre = jp.replan_on_failure(jplan, jprobs, dead)
    tre = tp.replan_on_failure(tplan, tprobs, dead)
    assert_plans_equal(*jre, *tre)
    assert tre[0].solver == solver + "+replan"


def test_planner_without_positions_and_p2_off_raises():
    planner = TPlanner(TChannel(), optimize_positions=False, device="cpu")
    with pytest.raises(ValueError, match="positions required"):
        planner.plan(t_cnn_cost(T_LENET), t_make_devices(4), [0])


def test_planner_runs_p2_on_the_cpu_and_plans_alexnet_distributed():
    """The smoke script's CNN-path plan, with P2 on the CPU: every request
    feasible and spread over at least two UAVs (fc1 and fc2 never fit
    one UAV at mem_frac 0.2), and so is the replan without the first
    UAV of request 0."""
    planner = TPlanner(TChannel(), position_steps=40, device="cpu")
    plan, probs = planner.plan(t_cnn_cost(T_ALEXNET),
                               t_make_devices(8, mem_frac=0.2),
                               requests=[0, 1, 2, 3])
    assert plan.feasible
    assert all(len(set(s.assign)) >= 2 for s in plan.placements)
    d = dist_of(plan.positions)
    d[np.eye(8, dtype=bool)] = np.inf
    assert d.min() >= 40.0 - 1e-3
    re, _ = planner.replan_on_failure(plan, probs, plan.placements[0].assign[0])
    assert re.feasible and re.positions.shape == (7, 2)


def check_p2(pos, center, U, radius=20.0):
    d = dist_of(pos)
    d[np.eye(U, dtype=bool)] = np.inf
    assert d.min() >= 2 * radius - 1e-3
    cover = max(radius, 2 * radius * (np.sqrt(U) + 1.0))
    assert np.linalg.norm(pos - np.asarray(center), axis=-1).max() \
        <= cover + 1e-3


#: objective rtol per swarm size at 30 steps.  U = 6 seed 0 is a near tie:
#: moving the reference's own initial positions by one float32 ulp moves
#: its objective by 6.9e-4 relative there (the test below), and the port
#: lands 6.4e-4 away, so 1e-4 would test the noise, not the port
P2_RTOL = {4: 1e-4, 6: 1e-3, 8: 1e-4}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("U", [4, 6, 8])
def test_solve_positions_invariants_and_objective(U, seed):
    steps = 30
    js = j_solve_pos(U, JChannel(), steps=steps, seed=seed)
    ts = t_solve_pos(U, TChannel(), steps=steps, seed=seed, device="cpu")
    check_p2(ts.positions, (0.0, 0.0), U)
    assert ts.positions.shape == (U, 2) and ts.iterations == steps
    assert ts.max_violation < 1e-3
    np.testing.assert_allclose(ts.objective, js.objective, rtol=P2_RTOL[U])


def test_p2_rtol_at_u6_is_the_reference_own_one_ulp_spread():
    """Why ``P2_RTOL[6]`` is 1e-3: one float32 ulp up on every initial
    coordinate moves the reference's 30-step objective by more than 1e-4
    (6.9e-4), and the port lies within twice that spread."""
    U, seed, steps = 6, 0, 30
    pos0 = hex_init(U, 40.0, jitter=0.5, seed=seed).astype(np.float32)
    ref = j_solve_pos(U, JChannel(), steps=steps, seed=seed).objective
    nudged = j_spb(np.nextafter(pos0, np.float32(np.inf))[None],
                   JChannel().params, steps=steps,
                   center=(0.0, 0.0)).objective[0]
    spread = abs(nudged - ref) / ref
    port = t_solve_pos(U, TChannel(), steps=steps, seed=seed,
                       device="cpu").objective
    assert 1e-4 < spread < P2_RTOL[U]
    assert abs(port - ref) / ref <= 2 * spread


def test_solve_positions_at_the_smoke_steps_keeps_the_invariants():
    """At 200 steps float32 trajectories have diverged: the reference's own
    objective moves by up to 5.7e-3 relative when its initial positions
    move by one ulp (ROADMAP, faults section), so only the invariants and
    that scale are held here."""
    js = j_solve_pos(8, JChannel(), steps=200, seed=0)
    ts = t_solve_pos(8, TChannel(), steps=200, seed=0, device="cpu")
    check_p2(ts.positions, (0.0, 0.0), 8)
    np.testing.assert_allclose(ts.objective, js.objective, rtol=1e-2)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_positions_batched_invariants_and_objective(seed):
    rng = np.random.default_rng(seed)
    init = hex_init(8, 40.0)[None] + rng.normal(0, 3.0, (4, 8, 2))
    js = j_spb(init, JChannel(), steps=20, repair_iters=25)
    ts = t_spb(init, TChannel().params, steps=20, repair_iters=25, device="cpu")
    assert ts.positions.shape == (4, 8, 2) and ts.iterations == 20
    for b in range(4):
        check_p2(ts.positions[b], init[b].mean(0), 8)
    assert (np.diff(ts.objective_trace, axis=1) <= 0).all()
    np.testing.assert_allclose(ts.objective, js.objective, rtol=1e-4)
    np.testing.assert_allclose(ts.objective_trace[:, -1],
                               js.objective_trace[:, -1], rtol=1e-4)


@pytest.mark.parametrize("steps", [20, 30])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("U", [4, 8])
def test_solve_positions_legacy_objective(U, seed, steps):
    js = j_legacy(U, JChannel(), steps=steps, seed=seed)
    ts = t_legacy(U, TChannel(), steps=steps, seed=seed, device="cpu")
    assert ts.positions.dtype == js.positions.dtype == np.float32
    assert ts.positions.shape == (U, 2) and ts.iterations == steps
    check_p2(ts.positions, (0.0, 0.0), U)
    assert ts.max_violation == js.max_violation == 0.0
    np.testing.assert_allclose(ts.objective, js.objective, rtol=1e-4)


#: objective rtol at the legacy solver's 800 steps: its last iterate
#: moves by up to lr = 0.5 m a step forever, and the reference's own
#: objective sweeps a band 1.1-2.1 % wide over steps 790-810 (U 4 and 8,
#: seeds 0-2); the test below shows the band at the cases held here
P2_LEGACY_RTOL = 2e-2


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("U", [4, 8])
def test_solve_positions_legacy_at_800_steps_keeps_the_invariants(U, seed):
    js = j_legacy(U, JChannel(), seed=seed)
    ts = t_legacy(U, TChannel(), seed=seed, device="cpu")
    assert ts.iterations == 800
    check_p2(ts.positions, (0.0, 0.0), U)
    assert ts.max_violation == 0.0
    np.testing.assert_allclose(ts.objective, js.objective,
                               rtol=P2_LEGACY_RTOL)


@pytest.mark.parametrize("U", [4, 8])
def test_legacy_800_step_rtol_is_the_reference_own_band(U):
    """Why ``P2_LEGACY_RTOL`` is 2e-2: the reference's objective over
    steps 795-805 spans more than 1e-2 of its 800-step value, and the
    port lies within 2e-2 of it."""
    objs = [j_legacy(U, JChannel(), steps=n, seed=0).objective
            for n in range(795, 806)]
    band = (max(objs) - min(objs)) / objs[5]
    port = t_legacy(U, TChannel(), seed=0, device="cpu").objective
    assert 1e-2 < band <= P2_LEGACY_RTOL
    assert abs(port - objs[5]) / objs[5] <= P2_LEGACY_RTOL


@pytest.mark.parametrize("n,radius,center", [(1, 20.0, (0.0, 0.0)),
                                             (6, 15.0, (3.0, -2.0))])
def test_chain_oracle_matches(n, radius, center):
    np.testing.assert_array_equal(j_chain_oracle(n, radius, center),
                                  t_chain_oracle(n, radius, center))
