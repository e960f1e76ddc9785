"""The port on a CUDA card: each kernel against its plain version, a
small planning run on the card against the CPU plain path, the sliced
LeNet forward against the monolithic one, the attention kernels
(prefill, also with a key length of its own, and decode, G up to 16;
whisper's cross cache) and the MoE, RG-LRU and mLSTM kernels
against their plain versions; the kernels with more than one route
(expert GEMM, prefill attention, RG-LRU scan, mLSTM chunk, chain DP) also
by the route each launch took.  The fused chain DP is bitwise with its
plain version at one launch a call.  The paper's evaluation path: the
batched chain-DP wrappers (one fused launch a call, bitwise the CPU's),
a contingency-table refresh (one link-geometry and one chain-DP launch,
the CPU's table), ``SwarmSim``'s LLHR rollout (one of each a frame, the
baselines none) and ``solve_positions_legacy``'s separation.  The
trajectory-sharded rollout over meshes of this card (two entries, and a
ragged B over four): bitwise the unsharded run on every valid row, T
link-geometry and T fused chain-DP launches a shard.  Training: the
flash forward with its log-sum-exp and the backward kernel against their
plain versions (causal, window, softcap, GQA, Sk != Sq, ragged S; two
launches bitwise), ``mha`` under grad through both kernels against the
CPU, the bare forward wrappers refusing grad, and the reduced
minicpm-2b's loss and gradients on the card against the CPU; the expert
GEMM's backward kernels (dX, dW) against their plain versions and the
RG-LRU reverse scan bitwise against its, both Functions' gradients card
against CPU, and the reduced granite-moe's and recurrentgemma's loss and
gradients on the card against the CPU with exact launch counts; the
mLSTM chunk backward kernel against its plain version (zero and random
states, the final state's gradients or none, both normaliser branches,
S 1 to 1,000; two launches bitwise), the mLSTM Function card against
CPU, and the reduced xlstm-350m's loss and gradients.  The expert-parallel
MoE over meshes of entries of this card: three expert-GEMM launches a
mesh position on the route the dtype gives, the CPU's result, and the
same output bit for bit from call to call; the int8 all-reduce over
entries of this card bitwise the CPU's.

Imports no JAX (the card's machine has none).  Without a CUDA device
every test skips, decided by a fixture when the test runs; on the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET  # noqa: E402
from repro_torch.core.channel import RadioChannel, RadioParams  # noqa: E402
from repro_torch.core.cost_model import cnn_cost  # noqa: E402
from repro_torch.core.positions import hex_init  # noqa: E402
from repro_torch.core.swarm import make_devices  # noqa: E402
from repro_torch.kernels.conv2d.conv2d import matmul_bias_act  # noqa: E402
from repro_torch.kernels.conv2d.ref import matmul_ref  # noqa: E402
from repro_torch.kernels.decode_attention.decode_attention import \
    decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_ref  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402
from repro_torch.kernels.link_geometry.ops import \
    fused_link_geometry  # noqa: E402
from repro_torch.kernels.link_geometry.ref import \
    link_geometry_ref  # noqa: E402
from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (  # noqa: E402
    mlstm_chunk, mlstm_route)
from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref  # noqa: E402
from repro_torch.kernels.moe_matmul.moe_matmul import moe_matmul  # noqa
from repro_torch.kernels.moe_matmul.ref import moe_matmul_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.rglru_scan import (  # noqa: E402
    rglru_route, rglru_scan)
from repro_torch.kernels.tropical_dp.ref import dp_step_ref  # noqa: E402
from repro_torch.kernels.tropical_dp.tropical_dp import \
    tropical_dp_step  # noqa: E402
from repro_torch.models.cnn import (distributed_forward,  # noqa: E402
                                   forward, init_cnn)
from repro_torch.runtime.scenario_engine import (PlanFnCache,  # noqa: E402
                                                 ScenarioEngine,
                                                 ScenarioGenerator)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("gain", [False, True])
def test_link_geometry_kernel_matches_plain(cuda, gain):
    rng = np.random.default_rng(11)
    B, U = 64, 8
    pos = torch.as_tensor(rng.uniform(0, 120, (B, U, 2)),
                          dtype=torch.float32, device=cuda)
    active = torch.as_tensor(rng.random((B, U)) > 0.2, device=cuda)
    gs = torch.as_tensor(10.0 ** (rng.normal(0, 3, (B, U, U)) / 10.0),
                         dtype=torch.float32, device=cuda) if gain else None
    kernels.reset_launch_counts()
    got = fused_link_geometry(pos, RadioParams(), active=active,
                              gain_scale=gs)
    ref = link_geometry_ref(pos, active, gs, params=RadioParams())
    torch.cuda.synchronize()
    assert kernels.launch_counts()["link_geometry"] == 1
    for a, b in zip(ref[:2], got[:2]):          # dist, threshold
        assert torch.equal(a, b)
    assert torch.equal(ref[2] == 0, got[2] == 0)
    assert torch.equal(torch.isinf(ref[2]), torch.isinf(got[2]))
    fin = torch.isfinite(ref[2])
    torch.testing.assert_close(got[2][fin], ref[2][fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("ties", [False, True])
def test_dp_step_kernel_matches_plain_on_a_table_slice(cuda, ties):
    rng = np.random.default_rng(4)
    B, M, L, S = 256, 4, 11, 8

    def draw(shape):
        x = (rng.integers(0, 3, shape) if ties
             else rng.uniform(0, 5, shape)).astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
        return torch.as_tensor(x, device=cuda)

    table = torch.full((B, M, L + 1, S + 1), float("inf"), device=cuda)
    table[:, :, :L] = draw((B, M, L, S + 1))
    ok = torch.as_tensor(rng.random((L, S)) < 0.8, dtype=torch.float32,
                         device=cuda)
    ok[:, 0] = 0.0
    args = (table[:, :, :L], draw((B, L, S, S + 1)), draw((B, M, S)),
            torch.as_tensor(rng.integers(0, 2, (L, S)), dtype=torch.float32,
                            device=cuda), ok)
    kernels.reset_launch_counts()
    got = tropical_dp_step(*args)
    ref = dp_step_ref(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["tropical_dp_step"] == 1
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def chain_case(device, model, U, M, B, rates, seed):
    """Chain-DP operands at a planner shape: the model's tables for U
    devices in a shuffled order; rates from positions (``geometry``, with
    dead UAVs) or integer multiples of 1e6 (``ties``); one scenario with
    every UAV down, so some slots are infeasible."""
    from repro_torch.core.batch import chain_dp_tables
    rng = np.random.default_rng(seed)
    mc, devs = cnn_cost(model), make_devices(U)
    t = chain_dp_tables(
        [x.flops for x in mc.layers], [x.weight_bytes for x in mc.layers],
        [x.act_bits for x in mc.layers], mc.input_bits,
        [d.mem_cap for d in devs], [d.compute_cap for d in devs],
        [d.throughput for d in devs],
        order=tuple(int(o) for o in rng.permutation(U)), device=device)
    active = torch.as_tensor(rng.random((B, U)) >= 0.2, device=device)
    active[0] = False
    if rates == "ties":
        rate = torch.as_tensor(rng.integers(0, 3, (B, U, U)) * 1e6,
                               dtype=torch.float32, device=device)
        rate[:, torch.arange(U), torch.arange(U)] = float("inf")
    else:
        pos = torch.as_tensor(rng.uniform(0, 90, (B, U, 2)),
                              dtype=torch.float32, device=device)
        rate = link_geometry_ref(pos, active, None, params=RadioParams())[2]
    sources = torch.as_tensor(rng.integers(0, U, (B, M)), device=device)
    return (rate, sources, active, t.order_arr, t.prev_dev, t.bits_in,
            t.input_bits, t.ct, t.ok)


@pytest.mark.parametrize("L,S,U,slots", [(11, 8, 8, 4), (11, 8, 8, 8),
                                         (7, 8, 8, 4), (11, 32, 32, 8),
                                         (40, 6, 6, 3), (11, 58, 58, 1)])
def test_chain_smem_bytes_are_the_launchers(cuda, L, S, U, slots):
    """The wrapper's shared-memory total, which picks the route and the
    slots a block, is the one the kernel's launcher lays out."""
    from repro_torch.kernels.tropical_dp import tropical_dp as tdp
    assert tdp.kernel_smem_bytes(L, S, U, slots) == \
        tdp.chain_smem_bytes(L, S, U, slots)


@pytest.mark.parametrize("model,U,M,B,rates,route", [
    (ALEXNET, 8, 4, 256, "geometry", "fused"),
    (ALEXNET, 8, 8, 256, "geometry", "fused"),
    (ALEXNET, 8, 4, 4096, "ties", "fused"),
    (LENET, 8, 4, 64, "ties", "fused"),
    (ALEXNET, 32, 32, 16, "geometry", "fused"),
    (ALEXNET, 80, 2, 4, "geometry", "step")])
def test_chain_dp_kernel_is_bitwise_the_plain_version(cuda, model, U, M, B,
                                                      rates, route):
    from repro_torch.kernels.tropical_dp.ops import chain_dp
    from repro_torch.kernels.tropical_dp.ref import chain_dp_ref
    args = chain_case(cuda, model, U, M, B, rates, seed=U + M)
    kernels.reset_launch_counts()
    got = chain_dp(*args)
    torch.cuda.synchronize()
    L = len(model.layers)
    counts = kernels.launch_counts()
    fused = route == "fused"
    assert counts["tropical_dp"] == (1 if fused else 0)
    assert counts["tropical_dp_step"] == (0 if fused else L)
    assert kernels.route_counts()["tropical_dp"] == (
        {"fused": 1, "step": 0} if fused else {"fused": 0, "step": L})
    ref = chain_dp_ref(*args)
    assert got[0].dtype == torch.int32 and got[0].shape == (B, M, L)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)
    assert torch.isinf(got[1][0]).all() and (got[0][0] == -1).all()
    assert torch.isfinite(got[1]).any()


def test_plan_batch_multi_on_the_card_equals_the_cpu(cuda):
    ch, devs, mc = RadioChannel(), make_devices(8), cnn_cost(ALEXNET)
    batch = ScenarioGenerator(hex_init(8, 40.0, jitter=0.5), pos_sigma_m=4.0,
                              failure_prob=0.1, shadow_sigma_db=2.0,
                              seed=2).draw(32)
    n_req = np.random.default_rng(0).multinomial(4, np.full(8, 0.125), 32)
    plans = [ScenarioEngine(ch, devs, mc, plan_cache=PlanFnCache(),
                            device=d).plan_batch_multi(batch, n_req)
             for d in (cuda, "cpu")]
    for f in ("assign", "cap_feasible", "feasible"):
        np.testing.assert_array_equal(getattr(plans[0], f),
                                      getattr(plans[1], f))
    for f in ("latency", "source_latency", "power", "load"):
        np.testing.assert_allclose(getattr(plans[0], f),
                                   getattr(plans[1], f), rtol=1e-5)
    assert plans[0].n_feasible > 0


def wrapper_args(model, U, B, seed):
    """Host operands of ``solve_chain_dp_batched`` at these shapes: rates
    from jittered positions, a tenth of the UAVs dead."""
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    rng = np.random.default_rng(seed)
    mc, devs = cnn_cost(model), make_devices(U)
    pos = hex_init(U, 40.0, jitter=0.5)[None] + rng.normal(0, 8.0, (B, U, 2))
    active = rng.random((B, U)) >= 0.1
    rate = link_geometry_ref(torch.as_tensor(pos, dtype=torch.float32),
                             torch.as_tensor(active), None,
                             params=RadioParams())[2].numpy()
    return ([x.flops for x in mc.layers], [x.weight_bytes for x in mc.layers],
            [x.act_bits for x in mc.layers], mc.input_bits,
            [d.mem_cap for d in devs], [d.compute_cap for d in devs],
            [d.throughput for d in devs], rate), active, rng


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("model,U,B", [(ALEXNET, 8, 4096), (LENET, 5, 64),
                                       (ALEXNET, 8, 16)])
def test_batched_chain_dp_wrappers_on_the_card_equal_the_cpu(cuda, model, U,
                                                             B, multi):
    from repro_torch.core.batch import (solve_chain_dp_batched,
                                        solve_chain_dp_multisource)
    args, active, rng = wrapper_args(model, U, B, seed=U + B)
    order = tuple(int(o) for o in rng.permutation(U))
    fn = solve_chain_dp_multisource if multi else solve_chain_dp_batched
    src = rng.integers(0, U, (B, 4) if multi else B)
    kernels.reset_launch_counts()
    got = fn(*args, src, active, order, device=cuda)
    assert kernels.launch_counts()["tropical_dp"] == 1
    assert kernels.route_counts()["tropical_dp"] == {"fused": 1, "step": 0}
    ref = fn(*args, src, active, order, device="cpu")
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(got[1]).any()


def test_contingency_refresh_on_the_card_equals_the_cpu(cuda):
    from repro_torch.runtime.scenario_engine import ContingencyTable
    ch, devs, mc = RadioChannel(), make_devices(8), cnn_cost(ALEXNET)
    base = hex_init(8, 40.0, jitter=0.5, seed=1)
    tables = [ContingencyTable(ScenarioEngine(ch, devs, mc,
                                              plan_cache=PlanFnCache(),
                                              device=d), base, source=2)
              for d in (cuda, "cpu")]
    moved = base + np.random.default_rng(3).normal(0.0, 4.0, base.shape)
    kernels.reset_launch_counts()
    tables[0].refresh(moved, source=2)
    assert kernels.launch_counts()["link_geometry"] == 1
    assert kernels.launch_counts()["tropical_dp"] == 1
    tables[1].refresh(moved, source=2)
    for name, g in tables[0].plans.items():
        r = tables[1].plans[name]
        assert g.assign == r.assign and g.dead_index == r.dead_index
        np.testing.assert_allclose(g.latency, r.latency, rtol=1e-5)
        np.testing.assert_allclose(g.power, r.power, rtol=1e-5)
    assert np.isfinite(tables[0].plans[None].latency)


def test_swarm_sim_launches_per_frame(cuda):
    """LLHR on the rollout: one link-geometry and one fused chain-DP
    launch a frame; a baseline on the legacy loop: none."""
    from repro_torch.core.baselines import HeuristicPlanner
    from repro_torch.core.placement import solve_chain_dp
    from repro_torch.core.planner import LLHRPlanner
    from repro_torch.core.swarm import SwarmSim
    T, ch = 4, RadioChannel()
    llhr = LLHRPlanner(ch, placement_solver=solve_chain_dp,
                       position_steps=20, device=cuda)
    kernels.reset_launch_counts()
    stats = SwarmSim(cnn_cost(LENET), make_devices(6), llhr,
                     requests_per_frame=4, failure_frame=1, failure_uav=2,
                     device=cuda).run(frames=T)
    counts = kernels.launch_counts()
    assert counts["link_geometry"] == T and counts["tropical_dp"] == T
    assert stats[1].replanned and all(s.feasible for s in stats)
    kernels.reset_launch_counts()
    SwarmSim(cnn_cost(LENET), make_devices(6), HeuristicPlanner(ch, device=cuda),
             requests_per_frame=4, device=cuda).run(frames=T)
    assert sum(kernels.launch_counts().values()) == 0


def test_solve_positions_legacy_on_the_card_keeps_2r(cuda):
    from repro_torch.core.positions import solve_positions_legacy
    sol = solve_positions_legacy(8, RadioChannel(), steps=200, device=cuda)
    d = np.sqrt(((sol.positions[:, None] - sol.positions[None]) ** 2)
                .sum(-1))
    d[np.eye(8, dtype=bool)] = np.inf
    assert d.min() >= 40.0 - 1e-3 and sol.max_violation == 0.0


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("m,k,n", [(5408, 2304, 384), (67, 363, 33),
                                   (23328, 2400, 256), (1000, 364, 96),
                                   (67, 2400, 33), (130, 4, 257),
                                   (67, 2401, 33)])
def test_matmul_bias_act_kernel_matches_plain(cuda, m, k, n, relu):
    """AlexNet conv3 and conv2 at a batch of 32, conv1's padded K 364, and
    ragged shapes; atol 5e-4, rtol 1e-3 (float32 sums in another order;
    3xTF32 products on the wgmma route).  K a multiple of 4 takes the
    wgmma route, other K the SIMT route.  Two launches on the same inputs
    are bitwise equal, and each adds one to the counter."""
    rng = np.random.default_rng(m + n)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32,
                        device=cuda)
    w = torch.as_tensor(rng.normal(size=(k, n)) / np.sqrt(k),
                        dtype=torch.float32, device=cuda)
    b = torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=cuda)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    kernels.reset_launch_counts()
    got = matmul_bias_act(x, w, b, relu=relu)
    again = matmul_bias_act(x, w, b, relu=relu)
    ref = matmul_ref(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["conv2d"] == 2
    route = "wgmma" if k % 4 == 0 else "simt"
    assert kernels.route_counts()["conv2d"] == \
        {"simt": 0, "wgmma": 0, route: 2}
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)


def test_lenet_sliced_forward_is_bitwise_on_the_card(cuda):
    params = init_cnn(LENET, torch.Generator().manual_seed(0), device=cuda)
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 32, 32, 3)),
                        dtype=torch.float32, device=cuda)
    kernels.reset_launch_counts()
    y0 = forward(LENET, params, x)
    assert kernels.launch_counts()["conv2d"] == 2
    for n_dev in (2, 3, 5):
        assign = [j % n_dev for j in range(len(LENET.layers))]
        y1, transfers = distributed_forward(LENET, params, x, assign)
        assert torch.equal(y0, y1) and transfers > 0


#: the reference's kernel-test tolerance (tests/test_kernels.py TOL, rtol
#: ten times atol): float32 sums in another order; bfloat16 outputs may
#: round one ulp apart
ATTN_TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=2e-1)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window,cap", [
    (1, 2, 2, 128, 32, True, 0, 0.0), (2, 4, 2, 256, 64, True, 0, 50.0),
    (1, 2, 1, 256, 32, True, 64, 0.0), (1, 2, 2, 128, 64, False, 0, 0.0),
    (1, 8, 4, 384, 128, True, 128, 30.0), (1, 2, 1, 1, 256, True, 0, 50.0),
    (1, 4, 2, 1000, 256, True, 300, 50.0), (1, 2, 2, 77, 128, False, 16, 0.0),
    (2, 4, 2, 40, 16, True, 32, 50.0), (1, 4, 2, 63, 64, True, 0, 0.0),
    (1, 4, 2, 65, 128, True, 0, 50.0), (1, 4, 2, 129, 256, True, 0, 50.0),
    (1, 2, 2, 129, 16, True, 16, 0.0), (1, 16, 1, 300, 256, True, 2048, 0.0),
    (2, 16, 1, 129, 128, False, 40, 0.0)])
def test_flash_attention_kernel_matches_plain(cuda, b, h, kv, s, d, causal,
                                              window, cap, dtype):
    """The reference's kernel grid plus ragged S (1, 63, 65, 77, 129,
    1000) at D 16 to 256, a window smaller than a kv tile and 16 query
    heads over one kv head; q/k/v are transposed views of [B, S, heads,
    D] tensors, as the model passes them.  bfloat16 takes the wgmma
    route, float32 the SIMT route.  Two launches are bitwise equal."""
    rng = np.random.default_rng(s + d)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, s, n, d)),
                               dtype=torch.float32, device=cuda)
               .to(dtype).transpose(1, 2) for n in (h, kv, kv))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    again = flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    ref = attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 2
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert kernels.route_counts()["flash_attention"] == \
        {"simt": 0, "wgmma": 0, route: 2}
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,d", [
    (2, 6, 6, 1500, 1500, 64), (2, 6, 6, 16, 1500, 64),
    (1, 6, 6, 448, 1500, 64), (2, 6, 6, 1, 1, 64), (2, 6, 6, 63, 1000, 64),
    (2, 6, 6, 65, 1, 64), (1, 4, 2, 100, 37, 128), (1, 4, 4, 129, 300, 256),
    (1, 2, 1, 7, 200, 16)])
def test_flash_attention_kernel_with_its_own_key_length(cuda, b, h, kv, sq,
                                                        sk, d, dtype):
    """Non-causal attention whose keys have a length of their own (Sk !=
    Sq: whisper's cross-attention over its 1,500 frames) and at S 1,500
    (23 kv tiles of 64 and a ragged 28: the mask, not the zero rows TMA
    reads past Sk, removes the keys past the end), each route against the
    plain version; two launches bitwise equal."""
    rng = np.random.default_rng(sq * 7 + sk)
    q, k, v = (torch.as_tensor(rng.normal(size=(b, s, n, d)),
                               dtype=torch.float32, device=cuda)
               .to(dtype).transpose(1, 2)
               for s, n in ((sq, h), (sk, kv), (sk, kv)))
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=False)
    again = flash_attention(q, k, v, causal=False)
    ref = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert kernels.route_counts()["flash_attention"] == \
        {"simt": 0, "wgmma": 0, route: 2}
    assert got.shape == (b, h, sq, d) and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_attention_over_a_cross_cache(cuda, dtype):
    """Whisper's cross-attention at decode: one query a kv head (G 1, D
    64) over 1,500 kept slots, every one valid (pos 1,499)."""
    b, kv, s, d = 4, 6, 1500, 64
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.normal(size=(b, kv, 1, d)), dtype=torch.float32,
                        device=cuda).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, kv, d)),
                            dtype=torch.float32, device=cuda)
            .to(dtype).transpose(1, 2) for _ in range(2))
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, pos)
    again = decode_attention(q, k, v, pos)
    ref = decode_ref(q, k, v, pos)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,kv,g,s,d,cap", [
    (2, 2, 4, 512, 64, 0.0), (1, 4, 1, 1024, 32, 50.0),
    (3, 1, 8, 256, 128, 0.0), (8, 8, 2, 4096, 256, 50.0),
    (2, 2, 3, 37, 256, 0.0), (2, 2, 2, 48, 16, 50.0),
    (8, 1, 16, 2048, 256, 0.0), (2, 2, 12, 300, 64, 50.0),
    (2, 1, 16, 48, 16, 0.0)])
def test_decode_attention_kernel_matches_plain(cuda, b, kv, g, s, d, cap,
                                               dtype):
    """The reference's decode grid plus gemma2-9b's decode shape, a
    ragged cache and D = 16, and groups above 8 (recurrentgemma-9b's 16
    query heads over one kv head at its 2048-slot window, G = 12, and
    D = 16 at G = 16); pos holds 0 and S - 1 and random slots between; the
    cache is a transposed view of [B, S, KV, D], as the model keeps it."""
    rng = np.random.default_rng(s + g)
    q = torch.as_tensor(rng.normal(size=(b, kv, g, d)), dtype=torch.float32,
                        device=cuda).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, kv, d)),
                            dtype=torch.float32, device=cuda)
            .to(dtype).transpose(1, 2) for _ in range(2))
    pos = rng.integers(0, s, size=b)
    pos[0] = 0
    pos[-1] = s - 1
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    got = decode_attention(q, k, v, pos, cap=cap)
    again = decode_attention(q, k, v, pos, cap=cap)
    ref = decode_ref(q, k, v, pos, cap=cap)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 2
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,kv,g,s,d,cap", [
    (8, 1, 16, 2048, 256, 0.0), (4, 2, 16, 1000, 128, 50.0),
    (8, 8, 2, 4001, 256, 50.0), (2, 4, 4, 777, 64, 0.0)])
def test_decode_attention_at_split_edges(cuda, b, kv, g, s, d, cap, dtype):
    """pos at a split's last slot (L - 1), the next split's first (L), the
    cache's last (S - 1) and 0, with S not a multiple of the split length
    L that ``decode_splits`` gives on this card; B KV = 8 at G 16
    (recurrentgemma-9b's decode) among them.  Within the reference's
    tolerance and, in bfloat16, one output rounding; two launches
    bitwise equal."""
    from repro_torch.device import sm_count
    from repro_torch.kernels.decode_attention.decode_attention import \
        decode_splits
    n_split, length = decode_splits(b, kv, s, sm_count(cuda))
    assert n_split > 1 and s % length
    rng = np.random.default_rng(s + g + 1)
    q = torch.as_tensor(rng.normal(size=(b, kv, g, d)), dtype=torch.float32,
                        device=cuda).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, kv, d)),
                            dtype=torch.float32, device=cuda)
            .to(dtype).transpose(1, 2) for _ in range(2))
    pos = [length - 1, length, s - 1, 0] * b
    pos = torch.as_tensor(pos[:b], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, pos, cap=cap)
    again = decode_attention(q, k, v, pos, cap=cap)
    ref = decode_ref(q, k, v, pos, cap=cap)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3,
                                   rtol=1e-2)


#: (b, h, kv, sq, sk, q_offset, d, causal, window, cap): row blocks of a
#: sequence split over a mesh's ``model`` axis (query row i at position
#: q_offset + i over the first sk >= q_offset + sq keys): minicpm-2b's last
#: block of 8 (rows 256, keys 2,048, offset 1,792), offsets that are not a
#: multiple of a kv tile (a tile straddles the shifted diagonal), windows
#: shorter than a tile, a softcap, a window without the causal mask, and
#: more keys than the block's last position reads
OFFSET_CASES = [(1, 4, 4, 256, 2048, 1792, 64, True, 0, 0.0),
                (2, 4, 2, 100, 300, 200, 32, True, 16, 5.0),
                (1, 4, 2, 130, 450, 300, 128, True, 0, 50.0),
                (1, 2, 1, 64, 1000, 900, 256, True, 64, 50.0),
                (2, 6, 6, 33, 130, 67, 16, True, 0, 0.0),
                (1, 2, 2, 50, 230, 150, 64, False, 40, 0.0),
                (1, 4, 2, 70, 300, 129, 64, True, 0, 0.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,off,d,causal,window,cap",
                         OFFSET_CASES)
def test_flash_attention_at_a_query_offset_matches_plain(
        cuda, b, h, kv, sq, sk, off, d, causal, window, cap, dtype):
    """The forward (with and without its log-sum-exp) and the backward at
    a query offset against their plain versions, on each dtype's route;
    two launches bitwise equal; the bfloat16 ones also within one output
    rounding of plain; keys past the block's last position get dK = dV =
    0."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_route, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    rng = np.random.default_rng(sq * 5 + sk + off)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(b, s, n, d)),
                                   dtype=torch.float32, device=cuda)
                   .to(dtype).transpose(1, 2)
                   for s, n in ((sq, h), (sk, kv), (sk, kv), (sq, h)))
    kw = dict(causal=causal, window=window, cap=cap, q_offset=off)
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, **kw)
    again = flash_attention(q, k, v, **kw)
    o, lse = flash_attention(q, k, v, with_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    grads2 = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    ref, ref_lse = attention_fwd_ref(q, k, v, **kw)
    ref_grads = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert kernels.route_counts()["flash_attention"] == \
        {"simt": 0, "wgmma": 0, route: 3}
    assert kernels.route_counts()["flash_attention_bwd"] == dict(
        {"simt": 0, "wgmma": 0}, **{bwd_route(dtype): 2})
    assert torch.equal(got, again) and torch.equal(got, o)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])
    torch.testing.assert_close(lse, ref_lse, **ATTN_TOL[torch.float32])
    for name, g, a, r in zip("qkv", grads, grads2, ref_grads):
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), r.float(), **ATTN_TOL[dtype])
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), r.float(), atol=1e-3,
                                       rtol=1e-2)
    if causal and sk > off + sq:
        assert not grads[1][:, :, off + sq:].any()
        assert not grads[2][:, :, off + sq:].any()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-3,
                                   rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_at_offset_zero_is_the_launch_without_one(cuda,
                                                                   dtype):
    """``q_offset=0`` gives the call without it bit for bit, forward and
    backward."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_bwd
    rng = np.random.default_rng(34)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(2, 300, 4, 64)),
                                   dtype=torch.float32, device=cuda)
                   .to(dtype).transpose(1, 2) for _ in range(4))
    kw = dict(causal=True, window=100, cap=50.0)
    o, lse = flash_attention(q, k, v, with_lse=True, **kw)
    o0, lse0 = flash_attention(q, k, v, with_lse=True, q_offset=0, **kw)
    g = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    g0 = flash_attention_bwd(q, k, v, o, lse, do, q_offset=0, **kw)
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,kv,g,s,d,cap", [
    (4, 8, 2, 512, 256, 50.0), (4, 1, 16, 512, 256, 0.0),
    (3, 2, 16, 300, 64, 50.0), (4, 4, 2, 100, 64, 0.0)])
def test_decode_attention_returns_its_lse(cuda, b, kv, g, s, d, cap, dtype):
    """``return_lse``: the output, float32, rounded to the dtype bitwise
    the call without it, each query
    head's log-sum-exp within float32's tolerance of the plain version's;
    a row whose pos is negative (a cache block wholly past the position)
    gives 0 and -inf, never NaN; two launches bitwise equal.  G 2
    (gemma2-9b) and G 16 (recurrentgemma-9b, the tensor-core kernel in
    bfloat16)."""
    rng = np.random.default_rng(s + g + 7)
    q = torch.as_tensor(rng.normal(size=(b, kv, g, d)), dtype=torch.float32,
                        device=cuda).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, kv, d)),
                            dtype=torch.float32, device=cuda)
            .to(dtype).transpose(1, 2) for _ in range(2))
    pos = torch.as_tensor(([-1, s - 1, 0, -s, s // 2] * b)[:b],
                          dtype=torch.int32, device=cuda)
    kernels.reset_launch_counts()
    out, lse = decode_attention(q, k, v, pos, cap=cap, return_lse=True)
    out2, lse2 = decode_attention(q, k, v, pos, cap=cap, return_lse=True)
    plain = decode_attention(q, k, v, pos, cap=cap)
    ref, ref_lse = decode_ref(q, k, v, pos, cap=cap, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 3
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.dtype == torch.float32 and torch.equal(out.to(dtype), plain)
    assert lse.shape == (b, kv, g) and lse.dtype == torch.float32
    empty = pos < 0
    assert bool(torch.isneginf(lse[empty]).all())
    assert not out[empty].any() and not ref[empty].any()
    assert not torch.isnan(ref).any() and not torch.isnan(ref_lse).any()
    torch.testing.assert_close(out, ref, **ATTN_TOL[dtype])
    if dtype == torch.bfloat16:
        torch.testing.assert_close(out, ref, atol=1e-3, rtol=1e-2)
    torch.testing.assert_close(lse, ref_lse, **ATTN_TOL[torch.float32])


#: tolerances of the expert GEMM: float32 sums in another order grow
#: with sqrt(D); bfloat16 outputs one rounding apart
MOE_TOL = {torch.float32: lambda d: dict(atol=1e-5 * d ** 0.5, rtol=1e-4),
           torch.bfloat16: lambda d: dict(atol=1e-3, rtol=1e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("e,c,d,f", [
    (4, 64, 96, 160), (8, 32, 128, 64), (2, 128, 64, 256),
    (64, 8, 2048, 1024), (64, 8, 1024, 2048), (8, 16, 64, 32),
    (8, 17, 64, 32), (3, 5, 7, 9), (4, 63, 64, 64), (4, 65, 64, 64),
    (4, 127, 128, 64), (4, 129, 200, 72), (64, 1144, 2048, 1024),
    (4, 33, 100, 36)])
def test_moe_matmul_kernel_matches_plain(cuda, e, c, d, f, dtype):
    """The reference's kernel grid, olmoe-1b-7b's decode GEMMs (C = 8 rows:
    the decode tile) and a served prefill GEMM (C 1144), both sides of the
    tile choice (C 16 and 17), C at 64k +- 1, D and F not multiples of 64,
    and ragged shapes with D, F not multiples of 8.  bfloat16 takes the
    wgmma route where TMA takes the shape (D and F multiples of 8), else
    the SIMT route, as float32 does.  Two launches are bitwise equal."""
    rng = np.random.default_rng(e * c + f)
    x = torch.as_tensor(rng.normal(size=(e, c, d)), dtype=torch.float32,
                        device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(e, d, f)) / np.sqrt(d),
                        dtype=torch.float32, device=cuda).to(dtype)
    kernels.reset_launch_counts()
    got = moe_matmul(x, w)
    again = moe_matmul(x, w)
    ref = moe_matmul_ref(x, w)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_matmul"] == 2
    route = "wgmma" if dtype == torch.bfloat16 and d % 8 == 0 and \
        f % 8 == 0 else "simt"
    assert kernels.route_counts()["moe_matmul"] == \
        {"simt": 0, "wgmma": 0, route: 2}
    assert got.dtype == dtype and torch.equal(got, again)
    torch.testing.assert_close(got.float(), ref.float(),
                               **MOE_TOL[dtype](d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,t,w", [(2, 64, 256), (1, 128, 128), (3, 32, 384),
                                   (2, 37, 100), (8, 300, 4096),
                                   (2, 37, 102), (1, 5, 8)])
def test_rglru_scan_kernel_is_bitwise_the_plain_version(cuda, b, t, w,
                                                        dtype):
    """The reference's kernel grid, ragged shapes and recurrentgemma's
    width; h0 nonzero.  Each launch on the route its dtype and W give
    (``tma`` for rows a multiple of 16 bytes: W 100 in float32, not in
    bfloat16; W 102 ``simt`` in both).  Bitwise, launch to launch too."""
    rng = np.random.default_rng(b * t + w)
    a = torch.as_tensor(1.0 / (1.0 + np.exp(-rng.normal(size=(b, t, w)))),
                        dtype=torch.float32, device=cuda).to(dtype)
    bb = torch.as_tensor(rng.normal(size=(b, t, w)) * 0.1,
                         dtype=torch.float32, device=cuda).to(dtype)
    h0 = torch.as_tensor(rng.normal(size=(b, w)), dtype=torch.float32,
                         device=cuda).to(dtype)
    kernels.reset_launch_counts()
    h, hT = rglru_scan(a, bb, h0)
    h2, hT2 = rglru_scan(a, bb, h0)
    rh, rhT = rglru_ref(a, bb, h0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rglru_scan"] == 2
    route = rglru_route(dtype, t, w)
    assert kernels.route_counts()["rglru_scan"] == \
        {"simt": 0, "tma": 0, route: 2}
    assert h.dtype == hT.dtype == dtype
    assert torch.equal(h, h2) and torch.equal(hT, hT2)
    assert torch.equal(h, rh) and torch.equal(hT, rhT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,s,d", [(2, 3, 128, 32), (1, 2, 64, 64),
                                     (2, 1, 256, 32), (2, 2, 37, 16),
                                     (1, 4, 1000, 256), (8, 4, 1, 256),
                                     (2, 2, 70, 128), (2, 4, 63, 256),
                                     (2, 4, 64, 256), (2, 4, 65, 256),
                                     (2, 4, 129, 256)])
def test_mlstm_chunk_kernel_matches_plain(cuda, b, h, s, d, dtype):
    """The reference's kernel grid, ragged S, xlstm-350m's head width in
    prefill and decode (S 1), S at the wgmma route's chunk edges, from a
    nonzero state; each launch on the route its dtype and S give
    (bfloat16 S > 1 ``wgmma``, chunks of 64; float32 S > 1 ``simt``,
    chunks of 32; S 1 ``decode``).  Against the plain version's chunks
    of 256 (or S): h within the reference's kernel-test atol 5e-4, rtol
    1e-3 (bf16: one output rounding more), the state within the same;
    launch to launch bitwise."""
    rng = np.random.default_rng(b * s + d)

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x, np.float32), device=cuda).to(dt)

    q, k, v = (t(rng.normal(0, 0.5, (b, s, h, d)), dtype) for _ in range(3))
    ip = t(rng.normal(size=(b, s, h)))
    fp = t(rng.normal(size=(b, s, h)) + 3.0)
    state = (t(rng.normal(0, 0.1, (b, h, d, d))),
             t(rng.normal(0, 0.1, (b, h, d))), t(rng.normal(size=(b, h))))
    scale = 1.0 / d ** 0.5
    kernels.reset_launch_counts()
    got = mlstm_chunk(q, k, v, ip, fp, *state, scale)
    again = mlstm_chunk(q, k, v, ip, fp, *state, scale)
    ref = mlstm_chunk_ref(q, k, v, ip, fp, *state, scale)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mlstm_chunk"] == 2
    route = mlstm_route(dtype, s)
    assert kernels.route_counts()["mlstm_chunk"] == \
        {"simt": 0, "wgmma": 0, "decode": 0, route: 2}
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    for a, a2, r in zip(got, again, ref):
        assert torch.equal(a, a2)
    tol = dict(atol=5e-4, rtol=1e-3) if dtype == torch.float32 \
        else dict(atol=1e-3, rtol=1e-2)
    torch.testing.assert_close(got[0].float(), ref[0].float(), **tol)
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, atol=5e-4, rtol=1e-3)


def _sharded_pair(cuda, B, n, seed):
    """The same LeNet rollout on the card unsharded and over a mesh of
    ``n`` entries of this card, with one generator seed; the sharded
    run's launch counts."""
    from repro_torch.core.rollout import RolloutSpec
    from repro_torch.parallel.sharding import fleet_mesh
    from repro_torch.runtime.fleet_rollout import FleetRollout
    T, U = 4, 5
    ro = FleetRollout(RadioChannel(), make_devices(U), cnn_cost(LENET),
                      RolloutSpec(frames=T, requests_per_frame=2,
                                  jitter_sigma_m=2.0, failure_prob=0.15,
                                  recovery_prob=0.25, battery_j=5e3),
                      plan_cache=PlanFnCache(), device=cuda)
    base = hex_init(U, 40.0, jitter=0.5, seed=1)
    ref = ro.run(base, n_trajectories=B, rng=np.random.default_rng(seed))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = ro.run(base, n_trajectories=B, mesh=fleet_mesh([cuda] * n),
                 rng=np.random.default_rng(seed))
    torch.cuda.synchronize()
    return ref, got, kernels.launch_counts(), T


def _assert_valid_rows_bitwise(ref, got):
    sel = np.flatnonzero(got._valid())
    assert len(sel) == ref.latency.shape[0] == got.n_trajectories
    for f in ("latency", "total_power", "feasible", "cap_feasible",
              "source_latency", "assign", "positions", "active", "charge",
              "n_requests", "energy_tx", "energy_cmp"):
        np.testing.assert_array_equal(getattr(got, f)[sel], getattr(ref, f),
                                      err_msg=f)


def test_sharded_rollout_over_two_entries_of_the_card(cuda):
    ref, got, counts, T = _sharded_pair(cuda, 16, 2, 5)
    assert got.valid is None
    _assert_valid_rows_bitwise(ref, got)
    assert counts["link_geometry"] == 2 * T and counts["tropical_dp"] == 2 * T


def test_sharded_rollout_ragged_on_the_card(cuda):
    ref, got, counts, T = _sharded_pair(cuda, 7, 4, 6)
    assert got.latency.shape[0] == 8 and got.valid.tolist() == \
        [True] * 7 + [False]
    _assert_valid_rows_bitwise(ref, got)
    assert got.feasibility_rate == ref.feasibility_rate
    assert counts["link_geometry"] == 4 * T and counts["tropical_dp"] == 4 * T


# ---------------------------------------------------------------------------
# training: the flash-attention backward kernel, the autograd Function
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kv,sq,sk,d,causal,window,cap", [
    (1, 4, 4, 256, 256, 64, True, 0, 0.0), (1, 4, 2, 65, 65, 16, True, 0,
                                            0.0),
    (2, 4, 2, 100, 100, 32, True, 16, 5.0),
    (1, 4, 2, 300, 300, 256, True, 64, 50.0),
    (1, 2, 1, 1000, 1000, 128, True, 0, 0.0),
    (2, 6, 6, 37, 150, 64, False, 0, 0.0), (1, 2, 2, 1, 1, 64, True, 0, 0.0),
    (1, 4, 4, 1, 65, 64, False, 0, 0.0),
    (1, 8, 2, 513, 513, 128, True, 200, 0.0),
    (2, 4, 4, 129, 129, 16, False, 0, 0.0),
    (1, 4, 2, 257, 257, 64, True, 0, 50.0)])
def test_flash_attention_backward_matches_plain(cuda, b, h, kv, sq, sk, d,
                                                causal, window, cap, dtype):
    """The forward with ``with_lse`` (the same output, the plain
    version's log-sum-exp) and the backward kernel against
    ``attention_bwd_ref`` on the same o and lse, dO a transposed view as
    autograd hands it; two backward launches bitwise equal, each counted
    once on its dtype's route (bfloat16 ``wgmma``, float32 ``simt``), and
    the bfloat16 ones also within one output rounding of plain."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        bwd_route, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    rng = np.random.default_rng(sq * 3 + sk + d)
    q, k, v, do = (torch.as_tensor(rng.normal(size=(b, s, n, d)),
                                   dtype=torch.float32, device=cuda)
                   .to(dtype).transpose(1, 2)
                   for s, n in ((sq, h), (sk, kv), (sk, kv), (sq, h)))
    kw = dict(causal=causal, window=window, cap=cap)
    kernels.reset_launch_counts()
    plain_o = flash_attention(q, k, v, **kw)
    o, lse = flash_attention(q, k, v, with_lse=True, **kw)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    _, ref_lse = attention_fwd_ref(q, k, v, **kw)
    ref = attention_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, plain_o)
    torch.testing.assert_close(lse, ref_lse, **ATTN_TOL[torch.float32])
    assert kernels.launch_counts()["flash_attention_bwd"] == 2
    route = bwd_route(dtype)
    assert kernels.route_counts()["flash_attention_bwd"] == dict(
        {"simt": 0, "wgmma": 0}, **{route: 2})
    for name, g, a, r, shape in zip("qkv", got, again, ref,
                                    ((b, h, sq, d), (b, kv, sk, d),
                                     (b, kv, sk, d))):
        assert g.shape == shape and g.dtype == dtype, name
        assert torch.equal(g, a), name
        torch.testing.assert_close(g.float(), r.float(), **ATTN_TOL[dtype])
        if dtype == torch.bfloat16:
            torch.testing.assert_close(g.float(), r.float(),
                                       atol=1e-3, rtol=1e-2)


def test_flash_attention_backward_refuses_misaligned_bf16(cuda):
    """On the card the bfloat16 backward refuses, before launching, a q 8
    bytes off 16 (TMA reads it) and a broadcast dO (stride 0)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention_bwd
    q, k, v, do = (torch.zeros((1, 4, 64, 64), dtype=torch.bfloat16,
                               device=cuda) for _ in range(4))
    lse = torch.zeros((1, 4, 64), device=cuda)
    off = torch.zeros(q.numel() + 4, dtype=torch.bfloat16,
                      device=cuda)[4:].view(q.shape)
    kernels.reset_launch_counts()
    for args in ((off, k, v, q, lse, do),
                 (q, k, v, q, lse, torch.zeros(
                     (), dtype=torch.bfloat16, device=cuda).expand(q.shape))):
        with pytest.raises(ValueError, match="TMA"):
            flash_attention_bwd(*args)
    assert kernels.launch_counts()["flash_attention_bwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mha_under_grad_runs_both_kernels(cuda, dtype):
    """``mha`` under grad on the card: one forward launch with the
    log-sum-exp, one backward launch; the gradients the CPU plain path's
    (float32 inputs, then cast)."""
    from repro_torch.kernels.flash_attention.ops import mha
    rng = np.random.default_rng(5)
    base = [rng.normal(size=(2, 96, n, 64)).astype(np.float32)
            for n in (8, 4, 4)]
    do = rng.normal(size=(2, 96, 8, 64)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        q, k, v = (torch.as_tensor(x, device=dev).to(dtype).requires_grad_()
                   for x in base)
        kernels.reset_launch_counts()
        out = mha(q, k, v, causal=True, window=40, cap=30.0)
        grads[str(dev)] = torch.autograd.grad(
            out, (q, k, v), torch.as_tensor(do, device=dev).to(dtype))
    assert kernels.launch_counts()["flash_attention"] == 1
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    route = "wgmma" if dtype == torch.bfloat16 else "simt"
    assert kernels.route_counts()["flash_attention"][route] == 1
    assert kernels.route_counts()["flash_attention_bwd"][route] == 1
    for g, r in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g.float().cpu(), r.float(),
                                   **ATTN_TOL[dtype])


def test_mha_takes_a_broadcast_output_gradient(cuda):
    """``out.sum()`` hands the backward a dO with every stride 0: the
    Function copies it contiguous, the bfloat16 backward runs on
    ``wgmma``, and the gradients equal a dO of ones with strides."""
    from repro_torch.kernels.flash_attention.ops import mha
    rng = np.random.default_rng(6)
    base = [rng.normal(size=(1, 130, n, 64)).astype(np.float32)
            for n in (8, 2, 2)]
    grads = []
    for loss in (lambda o: o.sum(), lambda o: (o * torch.ones_like(o)).sum()):
        q, k, v = (torch.as_tensor(x, device=cuda).to(torch.bfloat16)
                   .requires_grad_() for x in base)
        kernels.reset_launch_counts()
        grads.append(torch.autograd.grad(loss(mha(q, k, v)), (q, k, v)))
        assert kernels.route_counts()["flash_attention_bwd"]["wgmma"] == 1
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_kernel_wrappers_refuse_grad_on_the_card(cuda):
    """On a CUDA tensor that requires grad each wrapper without a
    backward raises before launching (no silent gradient-free output)."""
    from repro_torch.kernels.flash_attention.flash_attention import \
        flash_attention as bare_flash
    x = torch.zeros((1, 2, 8, 64), device=cuda, requires_grad=True)
    s = torch.zeros((1, 8, 2), device=cuda)
    calls = [
        lambda: bare_flash(x, x, x),
        lambda: decode_attention(x, x, x, torch.zeros(
            1, dtype=torch.int32, device=cuda)),
        lambda: moe_matmul(x[0], x[0].transpose(1, 2)),
        lambda: rglru_scan(x[0], x[0], x[0, :, 0]),
        lambda: mlstm_chunk(x.transpose(1, 2), x.transpose(1, 2),
                            x.transpose(1, 2), s, s,
                            torch.zeros((1, 2, 64, 64), device=cuda),
                            torch.zeros((1, 2, 64), device=cuda),
                            torch.zeros((1, 2), device=cuda), 0.125)]
    kernels.reset_launch_counts()
    for call in calls:
        with pytest.raises(RuntimeError, match="ROADMAP queue 1 item 14"):
            call()
    assert not any(kernels.launch_counts().values())


def test_reduced_training_card_against_cpu(cuda):
    """The reduced minicpm-2b in float32: loss and every gradient on the
    card (flash forward and backward kernels, 4 + 4 launches) against
    the CPU plain path."""
    import dataclasses
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = get_arch("minicpm-2b").reduced()
    cpu_model = build_model(cfg, "cpu")
    params = cpu_model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 65)))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(dataclasses.replace(cfg), dev)
        p = tree_map(lambda t: t.detach().to(dev, copy=True)
                     .requires_grad_(), params)
        kernels.reset_launch_counts()
        loss = model.train_loss(p, toks[:, :-1].to(dev), toks[:, 1:].to(dev))
        loss.backward()
        out[str(dev)] = (loss.item(), [t.grad.cpu() for t in leaves(p)],
                         kernels.launch_counts())
    assert out["cuda"][2]["flash_attention"] == cfg.n_layers
    assert out["cuda"][2]["flash_attention_bwd"] == cfg.n_layers
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,c,d,f", [(4, 64, 96, 160), (32, 320, 256, 128),
                                     (8, 97, 200, 72), (3, 40, 100, 36),
                                     (2, 1, 16, 8), (4, 0, 64, 32),
                                     (5, 333, 136, 264)])
def test_moe_matmul_backward_kernels_match_plain(cuda, e, c, d, f, dtype):
    """``moe_matmul_dx`` (dy w^T) and ``moe_matmul_dw`` (x^T dy) against
    their plain versions: the reference's grid, a granite-like shape,
    ragged C 97, D and F not multiples of 8, C 1 and C 0 (dX empty, no
    launch; dW zeros, one launch), D != F and ragged C on both routes.
    One launch each, on ``bwd_route``'s route (``wgmma`` for bfloat16
    with D and F multiples of 8, ``simt`` otherwise); two launches
    bitwise equal; float32 within atol 1e-5 sqrt(K), bfloat16 within one
    output rounding (atol 1e-3 + rtol 1e-2 of the value's scale)."""
    from repro_torch.kernels.moe_matmul.moe_matmul import (bwd_route,
                                                           moe_matmul_dw,
                                                           moe_matmul_dx)
    from repro_torch.kernels.moe_matmul.ref import (moe_matmul_dw_ref,
                                                    moe_matmul_dx_ref)
    rng = np.random.default_rng(e * c + d)
    x = torch.as_tensor(rng.normal(size=(e, c, d)), dtype=torch.float32,
                        device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(e, d, f)) / np.sqrt(d),
                        dtype=torch.float32, device=cuda).to(dtype)
    dy = torch.as_tensor(rng.normal(size=(e, c, f)), dtype=torch.float32,
                         device=cuda).to(dtype)
    kernels.reset_launch_counts()
    dx, dw = moe_matmul_dx(dy, w), moe_matmul_dw(x, dy)
    routes = kernels.route_counts()
    route = bwd_route(dtype, d, f)
    assert routes["moe_matmul_dx"] == dict({"simt": 0, "wgmma": 0},
                                           **{route: int(c > 0)})
    assert routes["moe_matmul_dw"] == dict({"simt": 0, "wgmma": 0},
                                           **{route: 1})
    assert torch.equal(dx, moe_matmul_dx(dy, w))
    assert torch.equal(dw, moe_matmul_dw(x, dy))
    for got, want, k in ((dx, moe_matmul_dx_ref(dy, w), f),
                         (dw, moe_matmul_dw_ref(x, dy), c)):
        assert got.dtype == dtype
        tol = dict(atol=1e-5 * max(k, 1) ** 0.5, rtol=1e-4) \
            if dtype == torch.float32 else \
            dict(atol=1e-3 * max(k, 1) ** 0.5, rtol=1e-2)
        torch.testing.assert_close(got.float(), want.float(), **tol)
    if c == 0:
        assert dx.numel() == 0 and not dw.any()


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,w", [(2, 64, 256), (1, 1345, 4096),
                                   (3, 37, 100), (2, 1, 8), (1, 0, 32),
                                   (2, 5, 256), (8, 100, 512),
                                   (1, 130, 4100)])
def test_rglru_scan_bwd_kernel_is_bitwise_the_plain_version(cuda, b, t, w,
                                                            dtype, last):
    """The reverse scan against ``rglru_bwd_ref`` bitwise (one FMA rounded
    once a step, in its order), with and without dhT, h0 nonzero, at T 1
    and T 0 (dh0 = dhT), a ragged W; one launch on ``rglru_route``'s
    route; two launches bitwise equal.  On ``tma`` the ring's edges: a
    partial strip (W 100 and 4,100 in float32), T below one box (T 5),
    T not a multiple of the box (1,345, 130), B 8."""
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
    from repro_torch.kernels.rglru_scan.rglru_scan import (rglru_route,
                                                          rglru_scan_bwd)
    rng = np.random.default_rng(b * t + w)

    def draw(*shape, f=lambda v: v):
        return torch.as_tensor(f(rng.normal(size=shape)),
                               dtype=torch.float32, device=cuda).to(dtype)
    a = draw(b, t, w, f=lambda v: 1.0 / (1.0 + np.exp(-v)))
    h, dh, h0 = draw(b, t, w), draw(b, t, w), draw(b, w)
    dhT = draw(b, w) if last else None
    kernels.reset_launch_counts()
    got = rglru_scan_bwd(a, h, h0, dh, dhT)
    route = rglru_route(dtype, t, w)
    assert kernels.route_counts()["rglru_scan_bwd"] == dict(
        {"simt": 0, "tma": 0}, **{route: 1})
    again = rglru_scan_bwd(a, h, h0, dh, dhT)
    want = rglru_bwd_ref(a, h, h0, dh, dhT)
    for g, r, s in zip(got, again, want):
        assert g.dtype == dtype
        assert torch.equal(g, r) and torch.equal(g, s)


def test_linear_recurrence_with_a_gradient_off_16_bytes_on_the_card(cuda):
    """h's gradient as a view 4 bytes into a larger gradient: the Function
    hands the reverse scan an aligned copy, which takes ``tma`` and gives
    the plain reverse scan's gradients bitwise."""
    from repro_torch.kernels.rglru_scan.ops import linear_recurrence
    from repro_torch.kernels.rglru_scan.ref import rglru_bwd_ref
    rng = np.random.default_rng(5)
    a = torch.as_tensor(1.0 / (1.0 + np.exp(-rng.normal(size=(2, 70, 64)))),
                        dtype=torch.float32, device=cuda).requires_grad_()
    b, h0 = (torch.as_tensor(rng.normal(size=s), dtype=torch.float32,
                             device=cuda) for s in ((2, 70, 64), (2, 64)))
    b.requires_grad_()
    weight = torch.as_tensor(rng.normal(size=2 * 70 * 64 + 1),
                             dtype=torch.float32, device=cuda)
    kernels.reset_launch_counts()
    h, _ = linear_recurrence(a, b, h0)
    flat = torch.cat([torch.zeros(1, device=cuda), h.reshape(-1)])
    (flat * weight).sum().backward()
    assert kernels.route_counts()["rglru_scan_bwd"] == {"simt": 0, "tma": 1}
    da, db, _ = rglru_bwd_ref(a.detach(), h.detach(), h0,
                              weight[1:].reshape(2, 70, 64))
    assert torch.equal(a.grad, da) and torch.equal(b.grad, db)


def test_expert_gemm_and_linear_recurrence_functions_on_the_card(cuda):
    """Under grad ``expert_gemm`` and ``linear_recurrence`` launch their
    forward and backward kernels (one each, and dX only where x needs a
    gradient); the gradients match the same Functions on the CPU."""
    from repro_torch.kernels.moe_matmul.ops import expert_gemm
    from repro_torch.kernels.rglru_scan.ops import linear_recurrence
    rng = np.random.default_rng(4)
    x, w, dy = (rng.normal(size=s).astype(np.float32)
                for s in ((4, 33, 48), (4, 48, 40), (4, 33, 40)))
    a = (1.0 / (1.0 + np.exp(-rng.normal(size=(2, 50, 64))))).astype(
        np.float32)
    b, h0, dh = (rng.normal(size=s).astype(np.float32)
                 for s in ((2, 50, 64), (2, 64), (2, 50, 64)))
    grads = {}
    for dev in ("cpu", cuda):
        tx = torch.as_tensor(x, device=dev).requires_grad_()
        tw = torch.as_tensor(w, device=dev).requires_grad_()
        ta, tb, th0 = (torch.as_tensor(v, device=dev).requires_grad_()
                       for v in (a, b, h0))
        kernels.reset_launch_counts()
        expert_gemm(tx, tw).backward(torch.as_tensor(dy, device=dev))
        h, hT = linear_recurrence(ta, tb, th0)
        ((h * torch.as_tensor(dh, device=dev)).sum() + hT.sum()).backward()
        grads[str(dev)] = [t.grad.cpu() for t in (tx, tw, ta, tb, th0)]
        counts = kernels.launch_counts()
        n = int(dev == cuda)
        assert (counts["moe_matmul"], counts["moe_matmul_dx"],
                counts["moe_matmul_dw"], counts["rglru_scan"],
                counts["rglru_scan_bwd"]) == (n,) * 5
    for g, r in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_reduced_moe_and_griffin_training_card_against_cpu(cuda, arch):
    """The reduced granite-moe (3 expert GEMMs a layer, forward and
    backward, the aux loss) and recurrentgemma (RG-LRU scan and its
    backward, local attention) in float32: loss and every gradient on the
    card against the CPU plain path, with exact launch counts."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = get_arch(arch).reduced()
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        p = tree_map(lambda t: t.detach().to(dev, copy=True)
                     .requires_grad_(), params)
        kernels.reset_launch_counts()
        loss = model.train_loss(p, toks[:, :-1].to(dev), toks[:, 1:].to(dev))
        loss.backward()
        out[str(dev)] = (loss.item(), [t.grad.cpu() for t in leaves(p)],
                         kernels.launch_counts())
    counts = out["cuda"][2]
    if cfg.family == "moe":
        want = dict(moe_matmul=3 * cfg.n_layers, moe_matmul_dx=3 *
                    cfg.n_layers, moe_matmul_dw=3 * cfg.n_layers,
                    flash_attention=cfg.n_layers,
                    flash_attention_bwd=cfg.n_layers)
    else:
        n_rec = sum(k == "rglru" for k in model.kinds)
        want = dict(rglru_scan=n_rec, rglru_scan_bwd=n_rec,
                    flash_attention=cfg.n_layers - n_rec,
                    flash_attention_bwd=cfg.n_layers - n_rec)
    assert counts == dict(dict.fromkeys(counts, 0), **want)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, r, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_apply_gradients_are_bitwise_launch_to_launch(cuda, cf):
    """A bfloat16 MoE layer at granite-moe's expert width (E 32, top 8,
    d 1,024, d_expert 512, S 1,024): two backward passes on the same
    inputs give bitwise the same gradients, with and without capacity
    drops.  The dispatch's gradient is a gather at the slots and a sum
    over a token's k copies (no atomic bf16 index_add, whose order moved
    a trained model's gradients from run to run)."""
    from repro_torch.models.moe import moe_apply, moe_init
    gen = torch.Generator().manual_seed(5)
    p = {k: v.to(cuda).requires_grad_() for k, v in
         moe_init(1024, 32, 512, True, gen, torch.float32).items()}
    x = torch.randn((1, 1024, 1024), generator=gen).to(cuda, torch.bfloat16)
    x.requires_grad_()
    dy = torch.randn((1, 1024, 1024), generator=gen).to(cuda, torch.bfloat16)
    grads = []
    for _ in range(2):
        pb = {k: v.to(torch.bfloat16) for k, v in p.items()}
        y, aux = moe_apply(pb, x, top_k=8, act="silu", glu=True,
                           capacity_factor=cf)
        gs = torch.autograd.grad((y.float() * dy.float()).sum() + aux,
                                 [x, *p.values()])
        grads.append(gs)
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _mlstm_bwd_operands(cuda, b, s, h, d, dtype, state, final, seed,
                        ibias=0.0, mbias=0.0):
    """q, k, v ~ 0.5 N(0, 1), i ~ N(ibias, 1), f ~ N(3, 1), a zero or
    random state (m0 ~ N(mbias, 1)), dh ~ N(0, 1) and, with ``final``,
    the final state's gradients dC1, dn1, dm1 ~ N(0, 1), each drawn on
    its own (so mx_L's residual dm1 - <dC1, C1> - <dn1, n1> is not 0)."""
    rng = np.random.default_rng(seed)

    def t(x, dt=torch.float32):
        return torch.as_tensor(np.asarray(x, np.float32), device=cuda).to(dt)

    q, k, v = (t(rng.normal(0, 0.5, (b, s, h, d)), dtype) for _ in range(3))
    ip = t(rng.normal(size=(b, s, h)) + ibias)
    fp = t(rng.normal(size=(b, s, h)) + 3.0)
    if state == "zero":
        st = (t(np.zeros((b, h, d, d))), t(np.zeros((b, h, d))),
              t(np.full((b, h), -1e30)))
    else:
        st = (t(rng.normal(0, 0.1, (b, h, d, d))),
              t(rng.normal(0, 0.1, (b, h, d))),
              t(rng.normal(size=(b, h)) + mbias))
    scale = 1.0 / d ** 0.5
    dh = t(rng.normal(size=(b, s, h, d)), dtype)
    seeds = (None, None, None)
    if final:
        seeds = (t(rng.normal(size=(b, h, d, d))),
                 t(rng.normal(size=(b, h, d))), t(rng.normal(size=(b, h))))
    return (q, k, v, ip, fp, *st), scale, dh, seeds


def _held_scaled(got, want, dtype, what):
    """Each gradient within 1e-4 of its largest magnitude (float32 sums
    in another order); rtol 1e-4, or one bf16 rounding (1e-2) for a
    bfloat16 dq, dk, dv."""
    for name, g, w in zip(("dq", "dk", "dv", "di", "df", "dC0", "dn0",
                           "dm0"), got, want):
        rtol = 1e-2 if g.dtype == torch.bfloat16 else 1e-4
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), atol=1e-4 * top,
                                   rtol=rtol, msg=lambda m: f"{what} {name}: "
                                   f"{m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,d,state,final", [
    (2, 37, 2, 16, "zero", False), (1, 100, 2, 32, "random", True),
    (2, 64, 1, 64, "random", True), (1, 130, 2, 128, "random", False),
    (1, 1, 4, 256, "random", True), (2, 300, 4, 256, "zero", True),
    (1, 1000, 4, 256, "random", False)])
def test_mlstm_chunk_bwd_kernel_matches_plain(cuda, b, s, h, d, state, final,
                                              dtype):
    """The backward kernel against ``mlstm_chunk_bwd_ref`` at its chunk
    length (``BWD_CHUNK``), zero and random initial states, with and
    without the final state's gradients, S 1 and ragged; two launches
    bitwise equal, both on the rule's route (``wgmma`` in bfloat16,
    ``simt`` in float32)."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        BWD_CHUNK, mlstm_bwd_route, mlstm_chunk_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref
    fwd, scale, dh, seeds = _mlstm_bwd_operands(cuda, b, s, h, d, dtype,
                                                state, final, b * s + d)
    kernels.reset_launch_counts()
    got = mlstm_chunk_bwd(*fwd, scale, dh, *seeds)
    again = mlstm_chunk_bwd(*fwd, scale, dh, *seeds)
    want = mlstm_chunk_bwd_ref(*fwd, scale, dh, *seeds, chunk=BWD_CHUNK)
    torch.cuda.synchronize()
    assert kernels.route_counts()["mlstm_chunk_bwd"] == dict(
        {"simt": 0, "wgmma": 0}, **{mlstm_bwd_route(dtype, s, d): 2})
    assert [g.dtype for g in got[:3]] == [dtype] * 3
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    _held_scaled(got, want, dtype, f"{b, s, h, d}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ibias", [-3.0, 4.0], ids=["exp_branch",
                                                    "raw_branch"])
def test_mlstm_chunk_bwd_kernel_on_each_normaliser_branch(cuda, ibias,
                                                          dtype):
    """Input gates drawn low (exp(-m_t) is the normaliser for most t) and
    high (|n^T q| is): the kernel against the plain version on each, on
    the rule's route."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        BWD_CHUNK, mlstm_bwd_route, mlstm_chunk_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref
    fwd, scale, dh, seeds = _mlstm_bwd_operands(
        cuda, 2, 200, 2, 64, dtype, "random", True, 9, ibias)
    kernels.reset_launch_counts()
    got = mlstm_chunk_bwd(*fwd, scale, dh, *seeds)
    want = mlstm_chunk_bwd_ref(*fwd, scale, dh, *seeds, chunk=BWD_CHUNK)
    torch.cuda.synchronize()
    assert kernels.route_counts()["mlstm_chunk_bwd"][
        mlstm_bwd_route(dtype, 200, 64)] == 1
    _held_scaled(got, want, dtype, f"i + {ibias}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mbias", [12.0, 6.0], ids=["all_held",
                                                    "some_held"])
def test_mlstm_chunk_bwd_kernel_routes_the_stabiliser_gradient(cuda, mbias,
                                                              dtype):
    """Free final-state seeds, input gates 3 low and m0 raised: m0 holds
    the max over a_s in every chunk of 64 (S 130: the residual of mx_L's
    gradient reaches dm0) or in some (S 200: it stops at a chunk's da).
    The kernel against its plain version, on the rule's route."""
    from repro_torch.kernels.mlstm_chunk.mlstm_chunk import (
        BWD_CHUNK, mlstm_bwd_route, mlstm_chunk_bwd)
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_bwd_ref
    from repro_torch.kernels.mlstm_chunk.ref import m0_holds_max
    s = 130 if mbias > 8 else 200
    fwd, scale, dh, seeds = _mlstm_bwd_operands(
        cuda, 2, s, 2, 64, dtype, "random", True, 21, -3.0, mbias)
    held = m0_holds_max(*fwd, scale, chunk=BWD_CHUNK)
    assert bool(held.all()) if mbias > 8 else bool(held[-1].any() and
                                                   not held.all())
    kernels.reset_launch_counts()
    got = mlstm_chunk_bwd(*fwd, scale, dh, *seeds)
    want = mlstm_chunk_bwd_ref(*fwd, scale, dh, *seeds, chunk=BWD_CHUNK)
    torch.cuda.synchronize()
    assert kernels.route_counts()["mlstm_chunk_bwd"][
        mlstm_bwd_route(dtype, s, 64)] == 1
    _held_scaled(got, want, dtype, f"m0 + {mbias}")


def test_mlstm_chunk_bwd_wgmma_matches_the_simt_kernel(cuda):
    """At xlstm-350m's training call (B 1, S 4,096, H 4, D 256, bfloat16,
    the zero state, no final-state gradients) the ``wgmma`` route against
    the ``simt`` kernel on the same inputs (through its launcher), each
    gradient within 1e-4 of its largest magnitude (bf16 dq, dk, dv one
    rounding more); two ``wgmma`` launches bitwise equal."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.mlstm_chunk import mlstm_chunk as mc
    fwd, scale, dh, _ = _mlstm_bwd_operands(cuda, 1, 4096, 4, 256,
                                            torch.bfloat16, "zero", False, 8)
    kernels.reset_launch_counts()
    got = mc.mlstm_chunk_bwd(*fwd, scale, dh)
    again = mc.mlstm_chunk_bwd(*fwd, scale, dh)
    assert kernels.route_counts()["mlstm_chunk_bwd"] == {"simt": 0,
                                                         "wgmma": 2}
    code = mc.BWD_ROUTES.index("simt")
    size = _build.launcher("mlstm_chunk_bwd",
                           "repro_mlstm_chunk_bwd_workspace",
                           [ctypes.c_int] * 5, ctypes.c_longlong)
    nbytes = size(1, 4096, 4, 256, code)
    work = torch.empty((nbytes + 3) // 4, device=cuda)
    simt = [torch.empty_like(t) for t in got]
    fn = _build.launcher("mlstm_chunk_bwd", "repro_mlstm_chunk_bwd",
                         mc._BWD_ARGTYPES)
    err = fn(*(t.data_ptr() for t in (*fwd, dh)), None, None, None,
             *(t.data_ptr() for t in (*simt, work)), nbytes, 1, 4096, 4, 256,
             mc._DTYPES[torch.bfloat16], code, float(scale),
             torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    for a, a2 in zip(got, again):
        assert torch.equal(a, a2)
    _held_scaled(got, simt, torch.bfloat16, "wgmma against simt")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_mlstm_function_on_the_card(cuda, dtype):
    """Under grad ``ops.mlstm`` launches the forward kernel once and, on
    ``backward``, the backward kernel once; the gradients of q, k, v, the
    gates and the state (h and the final state C1, n1, m1 in the loss,
    each with a seed of its own) match the same Function on the CPU (its
    plain versions, at other chunks) within 1e-4 of each leaf's largest
    value (bf16 q, k, v's gradients one bf16 rounding more)."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm
    fwd, scale, dh, seeds = _mlstm_bwd_operands(cuda, 2, 150, 2, 64, dtype,
                                                "random", True, 5)
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [t.detach().to(dev).requires_grad_() for t in fwd]
        kernels.reset_launch_counts()
        h, *final = mlstm(*leaves, scale)
        loss = (h.float() * dh.to(dev).float()).sum()
        for x, g in zip(final, seeds):
            loss = loss + (x * g.to(dev)).sum()
        loss.backward()
        counts = kernels.launch_counts()
        n = int(dev == cuda)
        assert (counts["mlstm_chunk"], counts["mlstm_chunk_bwd"]) == (n, n)
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    _held_scaled(grads["cuda"], grads["cpu"], dtype, "mlstm Function")


def test_reduced_xlstm_training_card_against_cpu(cuda):
    """The reduced xlstm-350m in float32: loss and every gradient on the
    card against the CPU plain path, a forward and a backward mLSTM launch
    a mLSTM layer (the sLSTM through torch's autograd of its loop)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    from repro_torch.tree import leaves, tree_map
    cfg = get_arch("xlstm-350m").reduced()
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, dev)
        p = tree_map(lambda t: t.detach().to(dev, copy=True)
                     .requires_grad_(), params)
        kernels.reset_launch_counts()
        loss = model.train_loss(p, toks[:, :-1].to(dev), toks[:, 1:].to(dev))
        loss.backward()
        out[str(dev)] = (loss.item(), [t.grad.cpu() for t in leaves(p)],
                         kernels.launch_counts())
    n = sum(k == "mlstm" for k in model.kinds)
    counts = out["cuda"][2]
    assert counts == dict(dict.fromkeys(counts, 0), mlstm_chunk=n,
                          mlstm_chunk_bwd=n)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for g, r in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(g, r, atol=1e-4 * float(r.abs().max()),
                                   rtol=2e-4)


def _ep_inputs(dtype, dev, glu=True):
    """An expert-parallel MoE layer's weights and tokens (E 8, d 128, F 64,
    multiples of 8 so bfloat16 takes the ``wgmma`` route) from a seed."""
    rng = np.random.default_rng(17)
    shapes = {"router": (128, 8), "w_in": (8, 128, 64), "w_out": (8, 64, 128)}
    if glu:
        shapes["w_gate"] = (8, 128, 64)
    p = {n: torch.as_tensor(rng.normal(size=s) / np.sqrt(s[-2]),
                            dtype=torch.float32).to(dev, dtype)
         for n, s in shapes.items()}
    x = torch.as_tensor(rng.normal(size=(4, 32, 128)),
                        dtype=torch.float32).to(dev, dtype)
    return p, x


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_expert_parallel_moe_launches_by_route(cuda, dtype, route, shape):
    """The expert-parallel MoE over a mesh of entries of this card: three
    expert-GEMM launches a mesh position, every one on the route the
    dtype gives, and (float32) the CPU's result over a CPU mesh."""
    from repro_torch.models.moe import moe_apply_expert_parallel
    from repro_torch.parallel.sharding import make_mesh
    n = shape[0] * shape[1]
    out = {}
    for dev in ("cpu", cuda):
        p, x = _ep_inputs(dtype, dev)
        mesh = make_mesh(shape, ("data", "model"), [dev] * n)
        kernels.reset_launch_counts()
        with torch.no_grad():
            y, aux = moe_apply_expert_parallel(p, x, top_k=2, act="silu",
                                               glu=True, mesh=mesh,
                                               capacity_factor=1.0)
        torch.cuda.synchronize()
        out[str(dev)] = (y.float().cpu(), aux.item())
        counts, routes = kernels.launch_counts(), kernels.route_counts()
    assert counts == dict(dict.fromkeys(counts, 0), moe_matmul=3 * n)
    assert routes["moe_matmul"] == dict(
        dict.fromkeys(routes["moe_matmul"], 0), **{route: 3 * n})
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(out[str(cuda)][0], out["cpu"][0], **tol)
    np.testing.assert_allclose(out[str(cuda)][1], out["cpu"][1], rtol=1e-5)


def test_expert_parallel_moe_is_bitwise_repeatable(cuda):
    """Two calls of the expert-parallel MoE in bfloat16 over a (2, 2) mesh
    of this card give the same y and aux bit for bit (the dispatch is a
    scatter of one pick a slot, the shards summed in a fixed order)."""
    from repro_torch.models.moe import moe_apply_expert_parallel
    from repro_torch.parallel.sharding import make_mesh
    p, x = _ep_inputs(torch.bfloat16, cuda)
    mesh = make_mesh((2, 2), ("data", "model"), [cuda] * 4)
    runs = []
    for _ in range(2):
        with torch.no_grad():
            runs.append(moe_apply_expert_parallel(
                p, x, top_k=2, act="silu", glu=True, mesh=mesh,
                capacity_factor=0.5))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_psum_compressed_on_the_card_is_bitwise_the_cpu(cuda):
    """The int8 all-reduce over 4 entries of this card, two steps of
    error feedback, equals the CPU's bit for bit: every operation is
    exact or correctly rounded (the scale's division by 127 too)."""
    from repro_torch.optim.grad_compress import psum_compressed
    rng = np.random.default_rng(48)
    shapes = [(3, 5, 6), (7,), (64, 64)]
    errs = {d: [[torch.zeros(s, device=d) for s in shapes]
                for _ in range(4)] for d in ("cpu", cuda)}
    for step in range(2):
        grads = [[torch.as_tensor(rng.normal(size=s) * 10 ** (k - 2),
                                  dtype=torch.float32) for s in shapes]
                 for k in range(4)]
        out = {}
        for d in ("cpu", cuda):
            out[d] = psum_compressed([[g.to(d) for g in gs] for gs in grads],
                                     errs[d], [[0, 1], [2]])
            errs[d] = out[d][1]
        for got, want in zip(out[cuda], out["cpu"]):
            for a, b in zip(got, want):
                assert all(torch.equal(x.cpu(), y) for x, y in zip(a, b))
