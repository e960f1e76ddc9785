"""The port's pipeline-stage planner against the reference on the CPU.

The planner is host NumPy in float64 in both packages, so parity is
exact: every float ``==`` and every tuple equal.  The port has no chip or
interconnect default; these tests build the reference's own constants
(``repro.core.pipeline_opt.V5E_MACS`` / ``V5E_HBM_BYTES`` and
``repro.core.channel.ICIParams()``) and pass the same values to both
sides.

* Each LM config's planner fields (``param_dtype``, ``supported_shapes``,
  ``n_params``, ``supports``) and every field the port carries, against
  the reference's; the four shapes and ``get_shape``.
* ``arch_cost`` layer by layer, ``n_params`` and ``model_flops`` for every
  LM config at the four shapes.
* ``solve_chain_dp_minmax`` on random problems (seeds 0-19, loose and
  tight caps, a permuted device order, and caps no partition fits).
* ``assign_stages_to_torus`` on the reference's own cases
  (``tests/test_positions_fused.py``) and on random traffic at 3 x 3,
  4 x 4 and 16 x 16, with ``exact_cutoff`` 0 and 8 and a node budget of
  5,000.
* ``pipeline_efficiency`` and ``scale_elastic`` at 8, 7 and 5 stages;
  the planner raises without ``chip`` or ``ici``.

``plan_pipeline`` over the whole grid is ``test_torch_pipeline_plans.py``.
"""
import dataclasses
import itertools

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core import channel as jch  # noqa: E402
from repro.core import cost_model as jcm  # noqa: E402
from repro.core import pipeline_opt as jpo  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core import positions as jpos  # noqa: E402
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import channel as tch  # noqa: E402
from repro_torch.core import cost_model as tcm  # noqa: E402
from repro_torch.core import pipeline_opt as tpo  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core import positions as tpos  # noqa: E402
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402

LM_ARCHS = sorted(jreg.LM_ARCHS)
SHAPES = [s.name for s in jbase.ALL_SHAPES]
#: the reference's chip and interconnect, given to both sides
CHIP = tpo.ChipParams("reference chip", jpo.V5E_MACS, jpo.V5E_HBM_BYTES)
J_ICI = jch.ICIChannel()
T_ICI = tch.ICIChannel(tch.ICIParams(**dataclasses.asdict(J_ICI.params)))


def test_port_lists_the_reference_archs_and_shapes():
    assert sorted(treg.LM_ARCHS) == LM_ARCHS
    assert [dataclasses.astuple(s) for s in tbase.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jbase.ALL_SHAPES]
    for name in SHAPES:
        t, j = treg.get_shape(name), jreg.get_shape(name)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert t.tokens == j.tokens
        assert tbase.SHAPES_BY_NAME[name] == t
    for name in ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K"):
        assert dataclasses.astuple(getattr(tbase, name)) == \
            dataclasses.astuple(getattr(jbase, name))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_config_fields_match_the_reference(arch):
    """Every field the port's config carries equals the reference's (the
    nested attention and MoE configs field by field), and the planner's
    fields and properties with them."""
    t, j = treg.get_arch(arch), jreg.get_arch(arch)
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(got):
            for g in dataclasses.fields(got):
                assert getattr(got, g.name) == getattr(want, g.name), \
                    (f.name, g.name)
        else:
            assert got == want, f.name
    assert (t.param_dtype, t.supported_shapes) == \
        (j.param_dtype, j.supported_shapes)
    assert t.n_params == j.n_params
    for shape in jbase.ALL_SHAPES:
        assert t.supports(treg.get_shape(shape.name)) == j.supports(shape)


@pytest.mark.parametrize("arch,shape", list(itertools.product(LM_ARCHS,
                                                              SHAPES)))
def test_arch_cost_matches_the_reference(arch, shape):
    t_cfg, j_cfg = treg.get_arch(arch), jreg.get_arch(arch)
    t_sh, j_sh = treg.get_shape(shape), jreg.get_shape(shape)
    got, want = tcm.arch_cost(t_cfg, t_sh), jcm.arch_cost(j_cfg, j_sh)
    assert got.name == want.name and got.input_bits == want.input_bits
    assert len(got.layers) == len(want.layers)
    for g, w in zip(got.layers, want.layers):
        assert (g.name, g.flops, g.weight_bytes, g.act_bits, g.kind,
                g.state_bytes) == (w.name, w.flops, w.weight_bytes,
                                   w.act_bits, w.kind, w.state_bytes)
    assert got.total_flops == want.total_flops
    assert got.total_weight_bytes == want.total_weight_bytes
    assert tcm.arch_param_count(t_cfg) == jcm.arch_param_count(j_cfg)
    assert tcm.model_flops(t_cfg, t_sh) == jcm.model_flops(j_cfg, j_sh)


def random_problem(pkg, seed, tight, dead_caps=False):
    """A random chain problem built as ``tests/test_property.py``'s
    ``placement_problems`` builds one, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    L, U = int(rng.integers(2, 7)), int(rng.integers(2, 4))
    compute = rng.uniform(1e4, 1e6, L)
    memory = rng.uniform(1e3, 1e5, L)
    act = rng.uniform(1e3, 1e5, L)
    devices = [pkg.Device(f"d{i}",
                          mem_cap=rng.uniform(5e4, 2e5) if tight else 1e9,
                          compute_cap=rng.uniform(5e5, 2e6) if tight else 1e12,
                          throughput=rng.uniform(1e8, 6e8)) for i in range(U)]
    if dead_caps:       # no device holds the largest layer
        devices = [dataclasses.replace(d, mem_cap=float(memory.max()) / 2)
                   for d in devices]
    rate = rng.uniform(1e7, 1e9, (U, U))
    rate = (rate + rate.T) / 2
    np.fill_diagonal(rate, np.inf)
    return pkg.PlacementProblem(compute, memory, act, devices, rate,
                                source=int(rng.integers(0, U)),
                                input_bits=rng.uniform(1e3, 1e5))


@pytest.mark.parametrize("seed", range(20))
def test_minmax_matches_the_reference(seed):
    for tight, dead in ((False, False), (True, False), (False, True)):
        jp = random_problem(jpl, seed, tight, dead)
        tp = random_problem(tpl, seed, tight, dead)
        orders = [None, list(range(tp.U))[::-1]]
        for n_stages, order in itertools.product(range(1, tp.L + 2), orders):
            want = jpl.solve_chain_dp_minmax(jp, n_stages, device_order=order)
            got = tpl.solve_chain_dp_minmax(tp, n_stages, device_order=order)
            assert (got.assign, got.latency, got.solver) == \
                (want.assign, want.latency, want.solver)
            if dead:
                assert got.assign == () and got.solver == "infeasible"


def chain_traffic(n, rng):
    t = np.zeros((n, n))
    for i in range(n - 1):
        t[i, i + 1] = rng.uniform(1e6, 1e8)
    return t


def torus_pair(torus):
    j = jch.ICIChannel(jch.ICIParams(torus=torus))
    t = tch.ICIChannel(tch.ICIParams(**dataclasses.asdict(j.params)))
    return j, t


#: the reference's torus cases (``tests/test_positions_fused.py``):
#: (torus, stages, traffic maker, keyword arguments)
TORUS_CASES = [
    *[((3, 3), 4, ("chain", s), {}) for s in range(3)],
    ((4, 4), 6, ("normal", 5), {}),
    ((4, 4), 6, ("normal", 5), {"exact_cutoff": 0}),
    ((16, 16), 8, ("chain", 2), {"node_budget": 5_000}),
    ((4, 4), 10, ("chain", 7), {"exact_cutoff": 8}),
]
#: random traffic at three tori, with and without the exact search
TORUS_CASES += [
    (torus, n, ("dense", 100 * n + torus[0]), dict(
        exact_cutoff=cut, node_budget=5_000))
    for torus, n in (((3, 3), 5), ((4, 4), 7), ((16, 16), 8))
    for cut in (0, 8)]


def traffic_of(kind, seed, n):
    rng = np.random.default_rng(seed)
    if kind == "chain":
        return chain_traffic(n, rng)
    if kind == "normal":
        return np.abs(rng.normal(0, 1e7, (n, n)))
    t = np.abs(rng.normal(0, 1e7, (n, n))) * (rng.random((n, n)) < 0.6)
    np.fill_diagonal(t, 0.0)
    return t


@pytest.mark.parametrize("torus,n,traffic,kw", TORUS_CASES)
def test_torus_placement_matches_the_reference(torus, n, traffic, kw):
    j, t = torus_pair(torus)
    tr = traffic_of(*traffic, n)
    want = jpos.assign_stages_to_torus(n, tr, j, **kw)
    got = tpos.assign_stages_to_torus(n, tr, t, **kw)
    assert got == want
    assert len(set(got)) == n
    for a, b in itertools.combinations(((0, 0), (1, 2), (2, 0)), 2):
        assert t.hops(a, b) == j.hops(a, b)
    assert (t.rate(0), t.rate(3), t.transfer_time(1e6, 2),
            t.transfer_time(1e6, 0)) == (j.rate(0), j.rate(3),
                                         j.transfer_time(1e6, 2),
                                         j.transfer_time(1e6, 0))


@pytest.mark.parametrize("arch,shape,cps", [
    ("qwen2-vl-2b", "train_4k", 32), ("gemma2-9b", "decode_32k", 8),
    ("xlstm-350m", "long_500k", 1)])
def test_scale_elastic_and_efficiency_match_the_reference(arch, shape, cps):
    t_cfg, j_cfg = treg.get_arch(arch), jreg.get_arch(arch)
    t_sh, j_sh = treg.get_shape(shape), jreg.get_shape(shape)
    for n in (8, 7, 5):
        want = jft.scale_elastic(n, j_cfg, j_sh, chips_per_stage=cps)
        got = tft.scale_elastic(n, t_cfg, t_sh, chips_per_stage=cps,
                                chip=CHIP, ici=T_ICI)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)
        assert got.n_stages <= n
        assert got.blocks_per_stage == want.blocks_per_stage
        for mb in (1, 8, 32):
            assert tpo.pipeline_efficiency(got, mb) == \
                jpo.pipeline_efficiency(want, mb)
    state = tft.ElasticPlanState([], plan=got)
    assert state.plan is got


def test_stage_devices_match_the_reference():
    for n, cps, frac in ((2, 1, 0.85), (8, 32, 0.5)):
        got = tpo.stage_devices(n, cps, CHIP, hbm_frac=frac)
        want = jpo.stage_devices(n, cps, hbm_frac=frac)
        assert [dataclasses.astuple(d) for d in got] == \
            [dataclasses.astuple(d) for d in want]


def test_planner_has_no_chip_or_interconnect_default():
    cfg, shape = treg.get_arch("gemma2-9b"), tbase.DECODE_32K
    with pytest.raises(TypeError, match="chip"):
        tpo.plan_pipeline(cfg, shape, 2, ici=T_ICI)
    with pytest.raises(TypeError, match="ici"):
        tpo.plan_pipeline(cfg, shape, 2, chip=CHIP)
    with pytest.raises(TypeError):
        tpo.stage_devices(2, 1)
    with pytest.raises(TypeError):
        tft.scale_elastic(4, cfg, shape)
    with pytest.raises(TypeError):
        tch.ICIParams()
    with pytest.raises(TypeError):
        tch.ICIChannel()
    with pytest.raises(TypeError):
        tpo.ChipParams("chip")
    # the package exports what the reference's ``repro.core`` exports
    for name in ("ICIChannel", "ICIParams", "arch_cost", "model_flops",
                 "StagePlan", "pipeline_efficiency", "plan_pipeline",
                 "stage_devices", "solve_chain_dp_minmax",
                 "assign_stages_to_torus"):
        assert getattr(tcore, name) is not None and name in tcore.__all__


def test_h100_helpers_read_the_card(monkeypatch):
    """``card_chip`` takes the name and memory from the card and half the
    H100 SXM's dense bf16 FLOP/s; another card raises.  The NVLink rate
    is the data sheet's 900 GB/s, one way."""
    import torch
    props = {"name": "NVIDIA H100 80GB HBM3", "total_memory": 85_000_000_000}
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: type("P", (), props))
    chip = tpo.card_chip(0)
    assert chip == tpo.ChipParams("NVIDIA H100 80GB HBM3", 494.5e12, 85e9)
    for other in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        props["name"] = other
        with pytest.raises(ValueError, match="not an H100 SXM"):
            tpo.card_chip(0)
    assert tpo.H100_SXM_NVLINK_BYTES_ONE_WAY == 450e9
