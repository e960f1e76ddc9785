"""The port's trajectory-sharded fleet rollout on the CPU: the port's
``tests/test_rollout_sharded.py``.

The trajectory axis B of the (B, T) rollout is embarrassingly parallel,
so splitting it over a mesh (``FleetRollout.run(mesh=|devices=)``) must
be invisible: on the CPU the sharded run equals the port's unsharded run
bitwise on every ``RolloutTrace`` field of the valid rows, and matches
the reference's unsharded run within ``tests/test_torch_rollout.py``'s
tolerances (discrete fields exact, floats rtol 1e-5, 1e-3 with P2).  A
mesh may name one device more than once, so meshes of 1-4 ``cpu``
entries exercise the split, the padding of a ragged B and the
``RolloutTrace.valid`` mask here; the card's cases are in
``tests/test_torch_cuda.py``.  Repeated sharded runs build nothing new,
and single-device and mesh keys never collide.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET as J_ALEXNET  # noqa: E402
from repro.configs.lenet import LENET as J_LENET  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import rollout as jro  # noqa: E402
from repro.core import swarm as jsw  # noqa: E402
from repro.core.positions import hex_init  # noqa: E402
from repro.runtime import fleet_rollout as jfr  # noqa: E402
from repro.runtime import scenario_engine as jse  # noqa: E402
from repro.runtime import serve_loop as jsl  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET as T_ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import rollout as tro  # noqa: E402
from repro_torch.core import swarm as tsw  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import (FLEET_AXIS, fleet_mesh,  # noqa: E402
                                           mesh_signature, pad_to_multiple)
from repro_torch.runtime import fleet_rollout as tfr  # noqa: E402
from repro_torch.runtime import scenario_engine as tse  # noqa: E402
from repro_torch.runtime import serve_loop as tsl  # noqa: E402

CPU = torch.device("cpu")
U = 5
BASE = hex_init(U, 40.0, jitter=0.5, seed=1)
# mobility + failures + recovery + battery drain + a 2-request
# multi-source stream: every branch of the frame body
SPEC = dict(frames=4, requests_per_frame=2, jitter_sigma_m=2.0,
            failure_prob=0.15, recovery_prob=0.25, battery_j=5e3,
            hover_watts=0.5, frame_s=1.0)
FIELDS = ("latency", "total_power", "feasible", "cap_feasible",
          "source_latency", "assign", "positions", "active", "charge",
          "n_requests", "energy_tx", "energy_cmp")
EXACT = ("feasible", "cap_feasible", "assign", "active", "n_requests")
#: ``tests/test_torch_rollout.py``'s P2 case, where its rtol 1e-3 holds:
#: its dynamics, AlexNet at U 4, 30 P2 steps, seed 0, two trajectories
P2_SPEC = dict(frames=3, requests_per_frame=2, jitter_sigma_m=2.0,
               failure_prob=0.2, recovery_prob=0.3, battery_j=2e3,
               hover_watts=0.05, frame_s=1.0)


def cpus(n):
    return fleet_mesh([CPU] * n)


def port_rollout(cache, seed=3, p2=None, u=U, cnn=T_LENET, spec=SPEC, **kw):
    return tfr.FleetRollout(tch.RadioChannel(), tsw.make_devices(u),
                            tcm.cnn_cost(cnn), tro.RolloutSpec(**spec),
                            plan_cache=cache, seed=seed, device="cpu",
                            position_spec=None if p2 is None
                            else tro.PositionSpec(**p2), **kw)


def ref_rollout(seed=3, p2=None, u=U, cnn=J_LENET, spec=SPEC):
    return jfr.FleetRollout(jch.RadioChannel(), jsw.make_devices(u),
                            jcm.cnn_cost(cnn), jro.RolloutSpec(**spec),
                            plan_cache=jse.PlanFnCache(), seed=seed,
                            position_spec=None if p2 is None
                            else jro.PositionSpec(**p2))


def assert_bitwise(ref, got):
    """``got``'s valid rows equal the unsharded ``ref`` bitwise, and so do
    the aggregates."""
    sel = np.flatnonzero(got._valid())
    assert len(sel) == ref.latency.shape[0] == got.n_trajectories
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(got, f)[sel]
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    for stat in ("feasibility_rate", "mean_latency", "mean_power"):
        assert getattr(got, stat) == getattr(ref, stat), stat
    for q in (50.0, 95.0):
        assert got.latency_percentile(q) == ref.latency_percentile(q)


def assert_matches_reference(ref, got, p2=False):
    """``got``'s valid rows against the reference's unsharded trace, with
    ``tests/test_torch_rollout.py``'s tolerances."""
    sel = np.flatnonzero(got._valid())
    exact = ("active", "n_requests", "feasible") if p2 else EXACT
    rtol = 1e-3 if p2 else 1e-5
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(got, f)[sel]
        if f in exact or a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=f)
    assert got.feasibility_rate == ref.feasibility_rate


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sharded_equals_unsharded_and_the_reference(n):
    cache = tse.PlanFnCache()
    one = port_rollout(cache).run(BASE, n_trajectories=12)
    got = port_rollout(cache).run(BASE, n_trajectories=12, mesh=cpus(n))
    assert got.valid is None                  # 12 divides 1-4: no padding
    assert_bitwise(one, got)
    assert_matches_reference(ref_rollout().run(BASE, n_trajectories=12), got)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_with_fused_p2(n):
    """Every shard runs the same fused P2 warm start: bitwise the
    unsharded run at this file's dynamics (U 5, LeNet, 20 steps), and
    against the reference at ``P2_SPEC`` (2 trajectories on 2 shards, and
    padded to 4) with ``test_torch_rollout.py``'s P2 tolerances.  At this
    file's dynamics P2's float32 steps carry the reference's own
    one-ulp spread (positions 0.4 m apart; ROADMAP section 3), so the
    reference comparison takes that test's case."""
    p2 = dict(steps=20, repair_iters=25)
    cache = tse.PlanFnCache()
    one = port_rollout(cache, p2=p2).run(BASE, n_trajectories=4)
    got = port_rollout(cache, p2=p2).run(BASE, n_trajectories=4,
                                         mesh=cpus(n))
    assert_bitwise(one, got)
    kw = dict(p2=dict(steps=30, repair_iters=25), u=4, seed=0, spec=P2_SPEC)
    base = hex_init(4, 40.0, jitter=0.5, seed=0)
    ref = ref_rollout(cnn=J_ALEXNET, **kw).run(base, n_trajectories=2)
    got = port_rollout(cache, cnn=T_ALEXNET, **kw).run(
        base, n_trajectories=2, mesh=cpus(n))
    assert_matches_reference(ref, got, p2=True)
    assert got.n_trajectories == 2


@pytest.mark.parametrize("B,n", [(5, 2), (7, 4), (1, 3)])
def test_ragged_batch_padding_mask(B, n):
    """A ragged B is padded with edge rows to a multiple of the mesh size
    and masked back out of every statistic; a padding row's frame stats
    raise."""
    cache = tse.PlanFnCache()
    one = port_rollout(cache).run(BASE, n_trajectories=B)
    got = port_rollout(cache).run(BASE, n_trajectories=B, mesh=cpus(n))
    Bpad = pad_to_multiple(B, n)
    assert got.latency.shape[0] == Bpad > B
    assert got.valid is not None and got.valid.sum() == B
    assert got.valid[:B].all() and not got.valid[B:].any()
    assert got.n_trajectories == B
    assert_bitwise(one, got)
    assert_matches_reference(ref_rollout().run(BASE, n_trajectories=B), got)
    # the filler rows are edge copies of the last requested row's inputs
    np.testing.assert_array_equal(got.positions[Bpad - 1],
                                  got.positions[B - 1])
    with pytest.raises(IndexError, match="padding"):
        got.frame_stats(trajectory=B)
    assert [s.t for s in got.frame_stats(trajectory=B - 1)] == \
        list(range(SPEC["frames"]))


def test_host_streams_identical_before_padding():
    """Every host draw is made for the requested B before padding: a
    ragged sharded run and the unsharded run consume the same streams
    (the served counts show it), and the generator ends in one state."""
    B = 3
    cache = tse.PlanFnCache()
    a, b = port_rollout(cache, seed=11), port_rollout(cache, seed=11)
    ref = a.run(BASE, n_trajectories=B)
    got = b.run(BASE, n_trajectories=B, mesh=cpus(2))
    np.testing.assert_array_equal(got.n_requests[got._valid()],
                                  ref.n_requests)
    assert a._rng.random() == b._rng.random()


def test_no_build_across_repeated_sharded_runs():
    cache = tse.PlanFnCache()
    ro = port_rollout(cache)
    ro.run(BASE, n_trajectories=4, mesh=cpus(2))
    builds = ro.build_count
    assert builds >= 2
    for _ in range(3):
        ro.run(BASE, n_trajectories=4, mesh=cpus(2))
    assert ro.build_count == builds
    # a rebuilt rollout on the same mesh shares the built shard rollout
    ro2 = port_rollout(cache, seed=9)
    ro2.run(BASE, n_trajectories=4, mesh=cpus(2))
    assert cache.build_count() == builds


def test_mesh_keys_never_collide():
    """The unsharded rollout and each mesh get their own entries (a mesh
    naming one device twice has one shard key); re-running either adds
    hits, never builds."""
    cache = tse.PlanFnCache()
    ro = port_rollout(cache)
    misses0 = cache.misses
    ro.run(BASE, n_trajectories=8)
    ro.run(BASE, n_trajectories=8, mesh=cpus(2))
    ro.run(BASE, n_trajectories=8, mesh=cpus(4))
    assert cache.misses - misses0 == 2
    keys = [k for k in ro._cache_keys_used if k[0] == "rollout"]
    assert len(keys) == 3
    assert keys[0][1] is None and keys[0][2] == "cpu"
    assert [k[1] for k in keys[1:]] == [mesh_signature(cpus(2)),
                                        mesh_signature(cpus(4))]
    assert all(k[1][0] == "mesh" for k in keys[1:])
    assert cache.build_count(keys) == 3
    hits0 = cache.hits
    ro.run(BASE, n_trajectories=8)
    ro.run(BASE, n_trajectories=8, mesh=cpus(2))
    assert cache.build_count(keys) == 3 and cache.hits > hits0


def test_mesh_and_devices_are_mutually_exclusive():
    ro = port_rollout(tse.PlanFnCache())
    with pytest.raises(ValueError, match="not both"):
        ro.run(BASE, mesh=cpus(1), devices=1)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        ro.run(BASE, devices=n + 2)
    # devices=1 is the engine's own device, unsharded
    trace = ro.run(BASE, n_trajectories=2, devices=1)
    assert trace.valid is None and trace.latency.shape[0] == 2


def test_fleet_mesh_forms_and_signature():
    mesh = cpus(3)
    assert fleet_mesh(mesh) == mesh == (CPU,) * 3
    assert FLEET_AXIS == "traj"
    assert mesh_signature(mesh) == ("mesh", "traj", 3, "cpu", (-1, -1, -1))
    assert mesh_signature(None) is None
    assert fleet_mesh(["cpu", "cpu"]) == cpus(2)
    assert hash(mesh_signature(fleet_mesh(("cpu",)))) is not None
    with pytest.raises(ValueError, match="at least one"):
        fleet_mesh([])
    with pytest.raises(ValueError, match="available"):
        fleet_mesh(0)
    assert pad_to_multiple(5, 2) == 6 and pad_to_multiple(8, 4) == 8
    assert pad_to_multiple(7, 1) == 7 and pad_to_multiple(1, 3) == 3


def test_default_mesh_needs_a_card(monkeypatch):
    """``fleet_mesh()`` is every visible CUDA device: without one it
    raises; an int asks for that many CUDA devices; a ``cuda`` entry
    raises without CUDA (no fallback to the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="0 CUDA device"):
        fleet_mesh()
    with pytest.raises(ValueError, match="requested a 2-device mesh"):
        fleet_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_mesh([torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="one device type"):
        sharding.fleet_mesh([CPU, torch.device("meta")])


def test_constructor_default_mesh():
    """A FleetRollout built with ``mesh_devices=`` shards every run by
    default, and a per-run ``devices=1`` falls back to the unsharded
    rollout."""
    cache = tse.PlanFnCache()

    def sharded_by_default():
        return port_rollout(cache, mesh_devices=[CPU] * 2)

    got = sharded_by_default().run(BASE, n_trajectories=3)
    assert got.valid is not None and got.latency.shape[0] == 4
    ref = port_rollout(cache).run(BASE, n_trajectories=3)
    assert_bitwise(ref, got)
    over = sharded_by_default().run(BASE, n_trajectories=3, devices=1)
    assert over.valid is None
    assert_bitwise(ref, over)
    with pytest.raises(ValueError, match="not both"):
        port_rollout(cache, mesh=cpus(2), mesh_devices=2)


def test_chaos_inputs_shard_with_the_rows():
    """The chaos tensors (link fades, battery drops, forced deaths) are
    split along B with the other inputs, through their own entries."""
    T, B = SPEC["frames"], 5
    rng = np.random.default_rng(0)
    kw = dict(n_trajectories=B,
              gain_scale=rng.uniform(0.3, 1.2, (T, B, U, U)).astype(
                  np.float32),
              extra_drain=rng.uniform(0.0, 50.0, (T, U)).astype(np.float32),
              forced_failures=[(2, 3)])
    cache = tse.PlanFnCache()
    one = port_rollout(cache).run(BASE, **kw)
    got = port_rollout(cache).run(BASE, mesh=cpus(3), **kw)
    assert_bitwise(one, got)


def replanner(pkg, cache, **mesh_kw):
    engine = pkg.se.ScenarioEngine(pkg.ch, pkg.sw.make_devices(U), pkg.mc,
                                   plan_cache=cache, **pkg.kw)
    ro = pkg.fr.FleetRollout(pkg.ch, pkg.sw.make_devices(U), pkg.mc,
                             pkg.ro.RolloutSpec(**SPEC), plan_cache=cache,
                             seed=3, **pkg.kw)
    return pkg.sl.PeriodicReplanner(
        engine, pkg.se.ScenarioGenerator(BASE, seed=0), period=2,
        n_scenarios=4, rollout=ro, rollout_horizon=3,
        rollout_trajectories=3, **mesh_kw)


class _Pkg:
    def __init__(self, **kw):
        self.__dict__.update(kw)


REF = _Pkg(se=jse, sw=jsw, fr=jfr, ro=jro, sl=jsl, ch=jch.RadioChannel(),
           mc=jcm.cnn_cost(J_LENET), kw={})
PORT = _Pkg(se=tse, sw=tsw, fr=tfr, ro=tro, sl=tsl, ch=tch.RadioChannel(),
            mc=tcm.cnn_cost(T_LENET), kw={"device": "cpu"})


@pytest.mark.parametrize("mesh_kw", [{"rollout_mesh": "cpus2"},
                                     {"rollout_devices": "cpus2"}])
def test_replanner_lookahead_over_a_mesh(mesh_kw):
    """The ``PeriodicReplanner``'s lookahead rides the mesh: 3
    trajectories on 2 shards (one padding row, masked), the reference's
    unsharded horizon feasibility and latency, no build after the first
    refresh."""
    mesh_kw = {k: cpus(2) if k == "rollout_mesh" else [CPU] * 2
               for k in mesh_kw}
    jrp = replanner(REF, jse.PlanFnCache())
    trp = replanner(PORT, tse.PlanFnCache(), **mesh_kw)
    for f in range(4):
        assert jrp.tick(f) == trp.tick(f)
        assert trp.assignment.tolist() == jrp.assignment.tolist()
        assert trp.horizon_feasibility == jrp.horizon_feasibility
        a, b = jrp.horizon_latency(50.0), trp.horizon_latency(50.0)
        assert np.isinf(a) == np.isinf(b)
        if np.isfinite(a):
            assert b == pytest.approx(a, rel=1e-5)
    assert trp.refreshes == jrp.refreshes == 2
    assert trp.retraces == 0
    assert trp.horizon.n_trajectories == 3
    assert trp.horizon.latency.shape[0] == 4
    assert trp.horizon.valid.tolist() == [True, True, True, False]
