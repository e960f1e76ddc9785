"""The port's host-side modules against the reference: exact equality.

Channel, cost model (LeNet and AlexNet), ``Device``, ``make_devices``,
``hex_init``, ``chain_links``, ``position_coeff``, ``coverage_radius`` and
``percentile_with_inf`` are pure Python/numpy copies, so every value must
be identical.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import batch as jbatch  # noqa: E402
from repro.core import channel as jchannel  # noqa: E402
from repro.core.cost_model import cnn_cost as j_cnn_cost  # noqa: E402
from repro.core.positions import hex_init as j_hex_init  # noqa: E402
from repro.core.rollout import percentile_with_inf as j_pct  # noqa: E402
from repro.core.swarm import make_devices as j_make_devices  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET as T_ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET as T_LENET  # noqa: E402
from repro_torch.core import batch as tbatch  # noqa: E402
from repro_torch.core import channel as tchannel  # noqa: E402
from repro_torch.core.cost_model import cnn_cost as t_cnn_cost  # noqa: E402
from repro_torch.core.positions import hex_init as t_hex_init  # noqa: E402
from repro_torch.core.rollout import percentile_with_inf as t_pct  # noqa: E402
from repro_torch.core.swarm import make_devices as t_make_devices  # noqa: E402


@pytest.mark.parametrize("name", ["lenet", "alexnet"])
def test_cnn_configs_and_costs_match(name):
    jcfg, tcfg = {"lenet": (LENET, T_LENET),
                  "alexnet": (ALEXNET, T_ALEXNET)}[name]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jm, tm = j_cnn_cost(jcfg), t_cnn_cost(tcfg)
    assert (jm.name, jm.input_bits) == (tm.name, tm.input_bits)
    assert [dataclasses.asdict(l) for l in jm.layers] == \
        [dataclasses.asdict(l) for l in tm.layers]
    assert jm.total_flops == tm.total_flops
    assert jm.total_weight_bytes == tm.total_weight_bytes


@pytest.mark.parametrize("bw", [10e6, 20e6])
def test_channel_matches(bw):
    jp = jchannel.RadioParams(bandwidth_hz=bw)
    tp = tchannel.RadioParams(bandwidth_hz=bw)
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    assert jp.noise_watts == tp.noise_watts
    assert jchannel.dbm_to_watts(-170.0) == tchannel.dbm_to_watts(-170.0)
    d = np.array([0.2, 1.0, 17.5, 40.0, 123.4])
    jc, tc = jchannel.RadioChannel(jp), tchannel.RadioChannel(tp)
    for fn in ("gain", "power_threshold", "feasible"):
        np.testing.assert_array_equal(getattr(jc, fn)(d), getattr(tc, fn)(d))
    np.testing.assert_array_equal(jc.rate(d, 0.05), tc.rate(d, 0.05))
    np.testing.assert_array_equal(jc.transfer_time(1e5, d, 0.05),
                                  tc.transfer_time(1e5, d, 0.05))


@pytest.mark.parametrize("n,mem_frac", [(4, 1.0), (8, 0.5)])
def test_devices_match(n, mem_frac):
    jd, td = j_make_devices(n, mem_frac), t_make_devices(n, mem_frac)
    assert [dataclasses.asdict(d) for d in jd] == \
        [dataclasses.asdict(d) for d in td]


@pytest.mark.parametrize("n,jitter,seed", [(4, 0.0, 0), (8, 0.5, 0),
                                           (7, 1.0, 5)])
def test_hex_init_matches(n, jitter, seed):
    np.testing.assert_array_equal(j_hex_init(n, 40.0, jitter=jitter,
                                             seed=seed),
                                  t_hex_init(n, 40.0, jitter=jitter,
                                             seed=seed))


def test_p2_constants_and_chain_links_match():
    for p in (jchannel.RadioParams(), jchannel.RadioParams(tau=2e-4)):
        tp = tchannel.RadioParams(**dataclasses.asdict(p))
        assert jbatch.position_coeff(p) == tbatch.position_coeff(tp)
    for n in (1, 4, 8, 9):
        assert jbatch.coverage_radius(n, 20.0) == \
            tbatch.coverage_radius(n, 20.0)
    for order in (None, (3, 1, 0, 2)):
        np.testing.assert_array_equal(jbatch.chain_links(4, order),
                                      tbatch.chain_links(4, order))


def test_percentile_with_inf_matches():
    lat = np.array([0.5, 2.0, np.inf, 1.0, 3.0, np.inf])
    for q in (0, 25, 50, 60, 95, 100):
        assert j_pct(lat, q) == t_pct(lat, q)
    assert t_pct(np.array([]), 50) == float("inf")
