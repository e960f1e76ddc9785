"""The last names the JAX package had and the port lacked, each against
the reference on the same inputs, on the CPU:

* ``LLHRPlanner.plan(act_scale=)``, ``PlacementProblem.fits`` and
  ``solve_bnb(node_limit=)``: bitwise on every discrete output and every
  float (numpy copies); ``exhaustive_refine`` and
  ``min_power_for_placement`` bitwise against the reference's at any
  ``bits=`` / ``bits_per_link=``, which the reference takes and does not
  read (the port takes neither);
* ``SwarmSim(jitter_sigma_m=, battery_j=)`` on the rollout backend at U
  4 and 5, under ``tests/test_torch_swarm.py``'s tolerances (discrete
  fields exact, latency and power within rtol 1e-3);
* the sequential mLSTM oracles ``kernels/mlstm_chunk/ref.py::mlstm_ref``
  and ``models/recurrent.py::mlstm_seq_ref`` within 1e-5 in float32;
* ``dp_wavefront_step`` bitwise (the plain version on the CPU);
* ``link_geometry_fused`` under the geometry's rtol (1e-6, ``rate``
  1e-5, ``tests/test_torch_kernels.py``);
* ``CNN_ARCHS`` / ``ALL_ARCHS``, ``ServeConfig``'s fields (but
  ``kv_block`` and ``decode_steps``, which no reference code reads) and
  ``ScenarioEngine.plan_cache_info``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core import power as jpw  # noqa: E402
from repro.core import swarm as jsw  # noqa: E402
from repro.core.channel import RadioChannel as JChannel  # noqa: E402
from repro.core.channel import RadioParams as JParams  # noqa: E402
from repro.core.cost_model import cnn_cost as j_cnn_cost  # noqa: E402
from repro.core.planner import LLHRPlanner as JPlanner  # noqa: E402
from repro.core.positions import hex_init  # noqa: E402
from repro.kernels.link_geometry.link_geometry import \
    link_geometry_fused as j_geo_fused  # noqa: E402
from repro.kernels.mlstm_chunk.ref import mlstm_ref as j_mlstm_ref  # noqa
from repro.kernels.tropical_dp.ops import \
    dp_wavefront_step as j_dp_step  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.runtime.scenario_engine import \
    ScenarioEngine as JEngine  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET as T_ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core import power as tpw  # noqa: E402
from repro_torch.core import swarm as tsw  # noqa: E402
from repro_torch.core.channel import RadioChannel as TChannel  # noqa: E402
from repro_torch.core.channel import RadioParams as TParams  # noqa: E402
from repro_torch.core.cost_model import cnn_cost as t_cnn_cost  # noqa: E402
from repro_torch.core.planner import LLHRPlanner as TPlanner  # noqa: E402
from repro_torch.kernels.link_geometry.link_geometry import \
    link_geometry_fused as t_geo_fused  # noqa: E402
from repro_torch.kernels.mlstm_chunk.ref import \
    mlstm_ref as t_mlstm_ref  # noqa: E402
from repro_torch.kernels.tropical_dp.ops import \
    dp_wavefront_step as t_dp_step  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.runtime.scenario_engine import \
    ScenarioEngine as TEngine  # noqa: E402

MODELS = {"lenet": (LENET, T_LENET), "alexnet": (ALEXNET, T_ALEXNET)}
PLAN_CASES = [("lenet", 4, 1.0, [0, 1]), ("alexnet", 8, 0.2, [0, 1, 2, 3]),
              ("alexnet", 5, 0.5, [4, 4])]
DISCRETE = ("t", "n_requests", "feasible", "replanned")


def _problems(pkg, power, model, U, mem_frac, sources, seed=0):
    cfg = MODELS[model][0 if pkg is jpl else 1]
    mc = (j_cnn_cost if pkg is jpl else t_cnn_cost)(cfg)
    devs = (jsw if pkg is jpl else tsw).make_devices(U, mem_frac)
    ch = JChannel() if pkg is jpl else TChannel()
    pos = np.random.default_rng(seed).uniform(0.0, 60.0, (U, 2))
    dist = np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1))
    rate = power.solve_power(dist, ch).rate_matrix(ch, dist)
    return [pkg.PlacementProblem(
        np.array([l.flops for l in mc.layers]),
        np.array([l.weight_bytes for l in mc.layers]),
        np.array([l.act_bits for l in mc.layers]), list(devs), rate,
        source=s, input_bits=mc.input_bits) for s in sources]


def _assert_power_equal(a, b):
    for f in ("power", "threshold", "feasible", "link_feasible"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.total_power == b.total_power


@pytest.mark.parametrize("act_scale", [0.25, 1.0, 3.0])
@pytest.mark.parametrize("model,U,mem_frac,sources", PLAN_CASES)
def test_plan_act_scale_matches(model, U, mem_frac, sources, act_scale):
    jcfg, tcfg = MODELS[model]
    pos = hex_init(U, 40.0, jitter=0.5, seed=U)
    jplan, jprobs = JPlanner(JChannel()).plan(
        j_cnn_cost(jcfg), jsw.make_devices(U, mem_frac), sources,
        positions=pos, act_scale=act_scale)
    tplan, tprobs = TPlanner(TChannel(), device="cpu").plan(
        t_cnn_cost(tcfg), tsw.make_devices(U, mem_frac), sources,
        positions=pos, act_scale=act_scale)
    for jp, tp in zip(jprobs, tprobs):
        np.testing.assert_array_equal(jp.act_bits, tp.act_bits)
    assert [tuple(s.assign) for s in jplan.placements] == \
        [tuple(s.assign) for s in tplan.placements]
    assert [s.latency for s in jplan.placements] == \
        [s.latency for s in tplan.placements]
    assert jplan.total_latency == tplan.total_latency
    _assert_power_equal(jplan.power, tplan.power)


@pytest.mark.parametrize("model,U,mem_frac,sources", PLAN_CASES)
def test_fits_matches(model, U, mem_frac, sources):
    jp = _problems(jpl, jpw, model, U, mem_frac, sources)[0]
    tp = _problems(tpl, tpw, model, U, mem_frac, sources)[0]
    # UAV 1 near full: its largest layers no longer fit, its smallest do
    jp.mem_used[1] = tp.mem_used[1] = \
        jp.devices[1].mem_cap - 0.5 * jp.memory.max()
    got = [[tp.fits(i, j) for j in range(tp.L)] for i in range(tp.U)]
    assert got == [[jp.fits(i, j) for j in range(jp.L)]
                   for i in range(jp.U)]
    assert any(map(any, got)) and not all(map(all, got))


@pytest.mark.parametrize("node_limit", [1, 40, 2_000_000])
@pytest.mark.parametrize("model,U,mem_frac,sources", PLAN_CASES)
def test_solve_bnb_node_limit_matches(model, U, mem_frac, sources,
                                      node_limit):
    for jp, tp in zip(_problems(jpl, jpw, model, U, mem_frac, sources),
                      _problems(tpl, tpw, model, U, mem_frac, sources)):
        a = jpl.solve_bnb(jp, node_limit=node_limit)
        b = tpl.solve_bnb(tp, node_limit=node_limit)
        assert (tuple(a.assign), a.latency, a.solver) == \
            (tuple(b.assign), b.latency, b.solver)


@pytest.mark.parametrize("bits", [None, 1e4, 8e6])
def test_power_bits_parameters_match(bits):
    """The reference's ``bits`` and ``bits_per_link`` change nothing it
    returns: the port, which takes neither, matches it at each."""
    pos = np.random.default_rng(3).uniform(0.0, 90.0, (6, 2))
    dist = np.sqrt(((pos[:, None] - pos[None, :]) ** 2).sum(-1))
    js, ts = jpw.solve_power(dist, JChannel()), tpw.solve_power(
        dist, TChannel())
    np.testing.assert_array_equal(
        jpw.exhaustive_refine(js, dist, JChannel(), bits=bits),
        tpw.exhaustive_refine(ts, dist, TChannel()))
    links = [(0, 1), (1, 3), (3, 5), (2, 2)]
    per = None if bits is None else {l: bits for l in links}
    _assert_power_equal(
        jpw.min_power_for_placement(dist, JChannel(), links,
                                    bits_per_link=per),
        tpw.min_power_for_placement(dist, TChannel(), links))


#: (model, U, jitter_sigma_m, battery_j, whether the rows move): LeNet's
#: frames draw too little energy for any battery here to run out.  With
#: jitter, P2 re-solves jittered positions every frame: power is held at
#: ``tests/test_torch_swarm.py``'s ``P2_POWER_RTOL`` (a max over used
#: links that the chain objective does not pin), latency at 1e-3;
#: ``test_jittered_power_spread_is_the_references_own`` is the witness
SWARM_CASES = [("lenet", 4, 2.5, np.inf, True), ("lenet", 4, 0.0, 1.0, False),
               ("alexnet", 5, 0.0, 1.0, True), ("alexnet", 5, 1.5, 1.0, True),
               ("alexnet", 5, 2.5, np.inf, True)]
P2_POWER_RTOL = 2e-2


@pytest.mark.parametrize("model,U,jitter,battery,moves", SWARM_CASES)
def test_swarm_mobility_and_battery_axes_match(model, U, jitter, battery,
                                               moves):
    jcfg, tcfg = MODELS[model]
    kw = dict(requests_per_frame=4, backend="rollout", jitter_sigma_m=jitter,
              battery_j=battery)
    ref = _jsim(model, U, **kw)
    got = tsw.SwarmSim(t_cnn_cost(tcfg), tsw.make_devices(U, 1.0),
                       TPlanner(TChannel(), placement_solver=tpl.
                                solve_chain_dp, position_steps=20,
                                device="cpu"), device="cpu", **kw)
    rows, want = got.run(frames=4), ref.run(frames=4)
    assert len(rows) == len(want)
    for r, g in zip(want, rows):
        assert tuple(getattr(g, f) for f in DISCRETE) == \
            tuple(getattr(r, f) for f in DISCRETE)
        assert np.isfinite(g.latency) == np.isfinite(r.latency)
        if np.isfinite(r.latency):
            np.testing.assert_allclose(g.latency, r.latency, rtol=1e-3)
        np.testing.assert_allclose(g.power, r.power, atol=1e-12,
                                   rtol=P2_POWER_RTOL if jitter else 1e-3)
    plain = tsw.SwarmSim(t_cnn_cost(tcfg), tsw.make_devices(U, 1.0),
                         TPlanner(TChannel(), placement_solver=tpl.
                                  solve_chain_dp, position_steps=20,
                                  device="cpu"), device="cpu",
                         requests_per_frame=4, backend="rollout")
    moved = [(r.latency, r.feasible) for r in plain.run(frames=4)] != \
        [(r.latency, r.feasible) for r in rows]
    assert moved == moves


def _jsim(model, U, **kw):
    return jsw.SwarmSim(j_cnn_cost(MODELS[model][0]),
                        jsw.make_devices(U, 1.0),
                        JPlanner(JChannel(),
                                 placement_solver=jpl.solve_chain_dp,
                                 position_steps=20), **kw)


def test_jittered_power_spread_is_the_references_own(monkeypatch):
    """One float32 ulp up on the reference's own initial positions moves
    its power by more than 1e-3 (3.96e-3 in frame 2) with jitter 1.5 m
    at U 5 while latency and every discrete field stay exact: power under
    jitter is held at ``P2_POWER_RTOL``."""
    import repro.core.positions as jpos
    kw = dict(requests_per_frame=4, backend="rollout", jitter_sigma_m=1.5,
              battery_j=1.0)
    rows = _jsim("alexnet", 5, **kw).run(frames=4)
    hex_init_ = jpos.hex_init

    def nudged(*a, **k):
        pos = np.asarray(hex_init_(*a, **k), np.float32)
        return np.nextafter(pos, np.float32(np.inf)).astype(np.float64)
    monkeypatch.setattr(jpos, "hex_init", nudged)
    moved = _jsim("alexnet", 5, **kw).run(frames=4)
    spread = max(abs(n.power - r.power) / max(r.power, 1e-30)
                 for r, n in zip(rows, moved))
    assert 1e-3 < spread < P2_POWER_RTOL
    assert [(r.latency, r.feasible) for r in rows] == \
        [(n.latency, n.feasible) for n in moved]


def _mlstm_inputs(seed, b=2, h=2, s=37, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    q = q / np.sqrt(d)
    i_pre = rng.normal(size=(b, h, s)).astype(np.float32)
    f_pre = (rng.normal(size=(b, h, s)) + 2.0).astype(np.float32)
    return q, k, v, i_pre, f_pre


@pytest.mark.parametrize("seed,s", [(0, 1), (1, 37), (2, 64)])
def test_mlstm_ref_matches(seed, s):
    args = _mlstm_inputs(seed, s=s)
    want = np.asarray(j_mlstm_ref(*map(jnp.asarray, args)))
    got = t_mlstm_ref(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [1, 19, 40])
def test_mlstm_seq_ref_matches(s):
    d, h, hd, b = 32, 2, 16, 2
    rng = np.random.default_rng(s)
    jp = jrec.mlstm_init(jax.random.PRNGKey(s), d, h, hd)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    state = {"C": rng.normal(size=(b, h, hd, hd)).astype(np.float32) * 0.1,
             "n": rng.normal(size=(b, h, hd)).astype(np.float32) * 0.1,
             "m": rng.normal(size=(b, h)).astype(np.float32)}
    wy, ws = jrec.mlstm_seq_ref({k: jnp.asarray(v) for k, v in jp.items()},
                                jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in state.items()})
    ty, ts = trec.mlstm_seq_ref({k: torch.as_tensor(v) for k, v in
                                 jp.items()}, torch.as_tensor(x),
                                {k: torch.as_tensor(v) for k, v in
                                 state.items()})
    np.testing.assert_allclose(ty.numpy(), np.asarray(wy), atol=1e-5,
                               rtol=1e-5)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(ws[k]),
                                   atol=1e-5, rtol=1e-5, err_msg=k)


def _dp_inputs(seed, B=3, M=2, L=5, S=4):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.integers(0, 3, shape).astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
        return x
    ct = rng.integers(0, 2, (L, S)).astype(np.float32)
    ok = (rng.random((L, S)) < 0.8).astype(np.float32)
    return (draw((B, M, L, S + 1)), draw((B, L, S, S + 1)), draw((B, M, S)),
            ct, ok)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_wavefront_step_is_bitwise(seed):
    args = _dp_inputs(seed)
    want = j_dp_step(*map(jnp.asarray, args), use_kernel=False)
    got = t_dp_step(*map(torch.as_tensor, args))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    meta = t_dp_step(*(torch.as_tensor(a).to("meta") for a in args))
    assert [(m.shape, m.dtype) for m in meta] == \
        [(g.shape, g.dtype) for g in got]


@pytest.mark.parametrize("gain", [False, True])
def test_link_geometry_fused_matches(gain):
    rng = np.random.default_rng(5)
    pos = rng.uniform(0.0, 120.0, (3, 6, 2)).astype(np.float32)
    active = (rng.random((3, 6)) > 0.2).astype(np.float32)
    gs = (10.0 ** (rng.normal(0, 3.0, (3, 6, 6)) / 10.0)).astype(
        np.float32) if gain else None
    want = j_geo_fused(jnp.asarray(pos), jnp.asarray(active),
                       None if gs is None else jnp.asarray(gs),
                       params=JParams())
    got = t_geo_fused(torch.as_tensor(pos), torch.as_tensor(active),
                      None if gs is None else torch.as_tensor(gs),
                      params=TParams())
    for name, a, b in zip(("dist", "threshold", "rate"), want, got):
        a, b = np.asarray(a), b.numpy()
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        np.testing.assert_array_equal(a == 0, b == 0, err_msg=name)
        fin = np.isfinite(a)
        np.testing.assert_allclose(b[fin], a[fin], atol=0, err_msg=name,
                                   rtol=1e-5 if name == "rate" else 1e-6)


def test_arch_tuples_and_serve_config_match():
    assert treg.CNN_ARCHS == jreg.CNN_ARCHS
    assert treg.ALL_ARCHS == jreg.ALL_ARCHS
    unread = ("kv_block", "decode_steps")     # no reference code reads them
    assert [(f.name, f.default) for f in
            dataclasses.fields(tbase.ServeConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(jbase.ServeConfig)
         if f.name not in unread]


def test_plan_cache_info_matches():
    from repro.runtime.scenario_engine import PlanFnCache as JCache
    from repro_torch.runtime.scenario_engine import PlanFnCache as TCache
    mc_j, mc_t = j_cnn_cost(LENET), t_cnn_cost(T_LENET)
    je = JEngine(JParams(), jsw.make_devices(4, 1.0), mc_j,
                 plan_cache=JCache())
    te = TEngine(TParams(), tsw.make_devices(4, 1.0), mc_t,
                 plan_cache=TCache(), device="cpu")
    # the port counts builds (at construction) where the reference counts
    # XLA traces (at the first call); the other entries are alike
    want, got = dict(je.plan_cache_info()), dict(te.plan_cache_info())
    assert want.pop("traces") == 0 and got.pop("builds") == \
        te.build_count == 1
    assert got == want and want["entries"] == want["misses"] == 1
