"""The port's serving loop against the reference's on the CPU.

* ``PeriodicReplanner`` over each package's ``ScenarioEngine`` with the
  same ``ScenarioGenerator`` seed (host numpy draws, equal in both):
  refreshes on the same ticks (period boundaries, forced ticks, measured
  positions), the served assignment exact, nominal and robust latency
  within rtol 1e-5 without P2; with a rollout horizon the horizon
  feasibility exact and its latency percentile within rtol 1e-5; with
  the fused P2 stage (20 steps, U 4) the assignment exact, latency within
  rtol 1e-3 and the adopted positions within 1e-2 m (ROADMAP section 3's
  P2 notes).  No plan function is built after the first refresh.
* ``checkpoint.latest_step`` reads a directory the reference's
  ``checkpoint.save`` wrote: the newest committed step, never a torn
  ``.tmp`` or an uncommitted one.
* The two ported examples on the CPU: ``torch_quickstart`` plans the
  reference's placements and runs LeNet sliced == monolithic;
  ``torch_scenario_planning`` refreshes on the reference's ticks with no
  build after the first and keeps P2's 2R separation.
"""
import contextlib
import io
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.lenet import LENET as J_LENET  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import rollout as jro  # noqa: E402
from repro.core import swarm as jsw  # noqa: E402
from repro.core.positions import hex_init  # noqa: E402
from repro.runtime import checkpoint as jckpt  # noqa: E402
from repro.runtime import fleet_rollout as jfr  # noqa: E402
from repro.runtime import scenario_engine as jse  # noqa: E402
from repro.runtime import serve_loop as jsl  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import rollout as tro  # noqa: E402
from repro_torch.core import swarm as tsw  # noqa: E402
from repro_torch.runtime import checkpoint as tckpt  # noqa: E402
from repro_torch.runtime import fleet_rollout as tfr  # noqa: E402
from repro_torch.runtime import scenario_engine as tse  # noqa: E402
from repro_torch.runtime import serve_loop as tsl  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = SimpleNamespace(name="ref", fr=jfr, se=jse, sl=jsl, sw=jsw, ro=jro,
                      ch=jch.RadioChannel(), mc=jcm.cnn_cost(J_LENET), kw={})
PORT = SimpleNamespace(name="port", fr=tfr, se=tse, sl=tsl, sw=tsw, ro=tro,
                       ch=tch.RadioChannel(), mc=tcm.cnn_cost(T_LENET),
                       kw={"device": "cpu"})

#: (U, mem_frac, P2 steps or None, rollout horizon, generator knobs)
REPLANNERS = {
    "plain": (6, 1.0, None, 0, dict(pos_sigma_m=3.0, failure_prob=0.1,
                                    shadow_sigma_db=2.0)),
    "split": (5, 2e-4, None, 0, dict(pos_sigma_m=2.0, failure_prob=0.2)),
    "horizon": (4, 2e-4, None, 3, dict(pos_sigma_m=1.0)),
    "p2": (4, 1.0, 20, 0, dict(pos_sigma_m=1.0)),
}
#: (frame, measured positions moved?, forced?) ticks of every case
TICKS = [(0, False, False), (1, False, False), (2, True, False),
         (3, False, False), (4, False, True), (5, False, False),
         (6, True, False), (7, False, False), (9, False, False)]


def replanner_run(pkg, case):
    U, mem_frac, steps, horizon, gen_kw = REPLANNERS[case]
    cache = pkg.se.PlanFnCache()
    devs = pkg.sw.make_devices(U, mem_frac=mem_frac)
    p2 = None if steps is None else pkg.ro.PositionSpec(steps=steps)
    engine = pkg.se.ScenarioEngine(pkg.ch, devs, pkg.mc, plan_cache=cache,
                                   position_spec=p2, **pkg.kw)
    rollout = None if not horizon else pkg.fr.FleetRollout(
        pkg.ch, devs, pkg.mc, pkg.ro.RolloutSpec(frames=horizon,
                                                 failure_prob=0.1),
        plan_cache=cache, seed=3, **pkg.kw)
    base = hex_init(U, 40.0, jitter=0.5, seed=U)
    gen = pkg.se.ScenarioGenerator(base, seed=7, **gen_kw)
    rp = pkg.sl.PeriodicReplanner(engine, gen, period=3, n_scenarios=16,
                                  source=1, rollout=rollout,
                                  rollout_horizon=horizon,
                                  rollout_trajectories=8)
    rng = np.random.default_rng(U)
    rows = []
    for frame, moved, force in TICKS:
        pos = base + rng.normal(0, 2.0, base.shape) if moved else None
        hit = rp.tick(frame, positions=pos, force=force)
        rows.append(dict(
            hit=hit, assign=rp.assignment.tolist(),
            nominal=rp.nominal_latency, robust=rp.robust_latency(95),
            horizon_feas=rp.horizon_feasibility,
            horizon_lat=rp.horizon_latency(95),
            planned=rp.planned_positions,
            base=np.array(gen.base_positions)))
    return rp, rows


@pytest.mark.parametrize("case", sorted(REPLANNERS))
def test_replanner_matches_the_reference(case):
    p2 = REPLANNERS[case][2] is not None
    rtol = 1e-3 if p2 else 1e-5
    (jrp, ref), (trp, got) = replanner_run(REF, case), \
        replanner_run(PORT, case)
    assert [g["hit"] for g in got] == [r["hit"] for r in ref] == \
        [True, False, False, True, True, False, True, False, True]
    for r, g in zip(ref, got):
        assert g["assign"] == r["assign"]
        assert g["horizon_feas"] == r["horizon_feas"]
        for k in ("nominal", "robust", "horizon_lat"):
            assert np.isinf(g[k]) == np.isinf(r[k]), k
            if np.isfinite(r[k]):
                assert g[k] == pytest.approx(r[k], rel=rtol), k
        np.testing.assert_allclose(g["planned"], r["planned"],
                                   atol=1e-2 if p2 else 1e-4)
        np.testing.assert_allclose(g["base"], r["base"],
                                   atol=1e-2 if p2 else 0.0)
    assert (trp.refreshes, trp.infeasible_refreshes) == \
        (jrp.refreshes, jrp.infeasible_refreshes) == (5, 0)
    assert trp.retraces == jrp.retraces == 0
    assert trp.last_refresh_s > 0.0
    if REPLANNERS[case][3]:
        assert 0.0 < trp.horizon_feasibility <= 1.0
    else:
        assert trp.horizon is None and trp.horizon_feasibility == 0.0


def test_replanner_counts_builds_of_a_new_signature():
    """``retraces`` counts plan-function builds paid inside refreshes
    after the first: a lookahead that starts passing link fades builds
    the rollout's ``gain_scale`` entry once and is counted once; an
    engine of another signature built on the shared cache between
    refreshes is not."""
    cache = tse.PlanFnCache()
    devs = tsw.make_devices(4)
    engine = tse.ScenarioEngine(PORT.ch, devs, PORT.mc, plan_cache=cache,
                                device="cpu")
    rollout = tfr.FleetRollout(PORT.ch, devs, PORT.mc,
                               tro.RolloutSpec(frames=2), plan_cache=cache,
                               device="cpu")
    fades = []
    run = rollout.run
    rollout.run = lambda *a, **k: run(*a, **k, **(
        {"gain_scale": np.full((4, 4), 0.5, np.float32)} if fades else {}))
    rp = tsl.PeriodicReplanner(engine, tse.ScenarioGenerator(
        hex_init(4, 40.0, jitter=0.5, seed=1)), period=1, n_scenarios=2,
        rollout=rollout, rollout_horizon=2, rollout_trajectories=2)
    rp.tick(0)
    tse.ScenarioEngine(PORT.ch, tsw.make_devices(5), PORT.mc,
                       plan_cache=cache, device="cpu")   # another signature
    rp.tick(1)
    assert rp.retraces == 0
    fades.append(True)
    rp.tick(2)
    rp.tick(3)
    assert rp.retraces == 1 and rp.refreshes == 4


def test_latest_step_reads_the_reference_checkpoints(tmp_path):
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None
    tree = {"w": np.arange(6.0).reshape(2, 3), "step": np.int32(3)}
    for step in (3, 12, 7):
        jckpt.save(d, step, tree)
    os.makedirs(os.path.join(d, "step_00000020.tmp"))
    torn = os.path.join(d, "step_00000030")
    shutil.copytree(os.path.join(d, "step_00000012"), torn)
    os.remove(os.path.join(torn, "COMMIT"))
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 12
    with open(os.path.join(torn, "COMMIT"), "w") as fh:
        fh.write("ok")
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 30


def run_example(path, argv, capture=True):
    """Run an example's ``main`` with ``argv`` (the reference's examples
    read ``sys.argv``); returns its result and stdout."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out, old = io.StringIO(), sys.argv
    sys.argv = [path] + argv
    try:
        with contextlib.redirect_stdout(out):
            result = mod.main(argv) if "torch_" in path else mod.main()
    finally:
        sys.argv = old
    return result, out.getvalue()


def placement_lines(text):
    return [line.split("latency")[0] for line in text.splitlines()
            if line.startswith("request ")]


def test_torch_quickstart_on_the_cpu():
    got, text = run_example(os.path.join(ROOT, "examples",
                                         "torch_quickstart.py"),
                            ["--device", "cpu"])
    _, ref_text = run_example(os.path.join(ROOT, "examples",
                                           "quickstart.py"), [])
    assert got["sliced_equals_monolithic"] and got["replan_feasible"]
    assert got["hops"] >= 1
    assert placement_lines(text) == placement_lines(ref_text)
    assert len(placement_lines(text)) == 2


def test_torch_scenario_planning_on_the_cpu():
    argv = ["--scenarios", "16", "--uavs", "5"]
    got, text = run_example(os.path.join(ROOT, "examples",
                                         "torch_scenario_planning.py"),
                            argv + ["--device", "cpu"])
    _, ref_text = run_example(os.path.join(ROOT, "examples",
                                           "scenario_planning.py"), argv)
    assert got["feasible"] == 16 and got["refreshed_at"] == [0, 5]
    assert got["retraces"] == 0 and got["p2_min_separation_m"] >= 40.0 - 1e-3
    assert got["delegated"]

    def fails(t):
        return [line.split("latency")[0] for line in t.splitlines()
                if " fails -> " in line]
    assert fails(text) == fails(ref_text)
