"""The fused chain-DP kernel's design, emulated on the CPU.

``csrc/tropical_dp.cu``'s fused route runs only on the card.  This file
replays its algorithm in numpy, phase for phase, and holds it bitwise
against the plain version ``chain_dp_ref``:

* the transfer tensor without its dead a = 0 row, one division an entry,
  and the block start a = 0 from the per-slot source row;
* each block start's min over the predecessor state taken once, when its
  dp row is final (``mn[a][s]`` with its first-argmin ``s0b``), where the
  plain version takes it again at every later step;
* step j scanning only a < j (``ok`` masks the rest);
* each scan split over the output's four lanes (lane q the indices q,
  q + 4, ...), each lane's first argmin (first strict improvement, NaN
  first) merged by a shuffle-xor tree that keeps the smaller index on
  ties (``takes``);
* 8-bit parent tables and the reference's backtrack on them.

Cases: LeNet and AlexNet at U 8, tie-heavy rates, dead and unreachable
sources, U 32 with 32 slots, and a synthetic 40-layer chain.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.alexnet import ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET  # noqa: E402
from repro_torch.core.batch import chain_dp_tables  # noqa: E402
from repro_torch.core.cost_model import cnn_cost  # noqa: E402
from repro_torch.core.swarm import make_devices  # noqa: E402
from repro_torch.kernels.tropical_dp.ref import chain_dp_ref  # noqa: E402
from repro_torch.kernels.tropical_dp.tropical_dp import (  # noqa: E402
    LANES, chain_route)

INF = np.float32(np.inf)


def before(v, best):
    """First-argmin order, elementwise: strictly smaller, or the first
    NaN."""
    return (v < best) | (np.isnan(v) & ~np.isnan(best))


def takes(v, i, best, i_best):
    return before(v, best) | (~before(best, v) & (i < i_best))


def lanes_argmin(values, n):
    """The kernel's split scan over ``n`` candidates ``values(i)`` (arrays
    of one shape): lane q keeps the first argmin of i = q, q + Q, ...,
    then the xor tree merges the lanes."""
    shape = values(0).shape
    best = np.full((LANES,) + shape, INF, np.float32)
    idx = np.full((LANES,) + shape, n, np.int64)      # no candidate yet
    for i in range(n):
        q, v = i % LANES, values(i)
        t = takes(v, i, best[q], idx[q])
        best[q], idx[q] = np.where(t, v, best[q]), np.where(t, i, idx[q])
    o = LANES // 2
    while o:
        partner = np.arange(LANES) ^ o
        v, i = best[partner], idx[partner]
        t = takes(v, i, best, idx)
        best, idx = np.where(t, v, best), np.where(t, i, idx)
        o //= 2
    return best[0], idx[0]


def fused_emulation(rate, sources, active, order, prev_dev, bits_in,
                    input_bits, ct, ok):
    """The fused kernel's arithmetic and scan order, vectorized over
    (scenario, slot, state)."""
    B, U, _ = rate.shape
    M = sources.shape[1]
    L, _, S = ct.shape
    S1 = S + 1
    with np.errstate(divide="ignore"):
        # tr[b, s, a, s0]: rate into state s from state s0 <= s
        r = rate[:, prev_dev[None, :], order[:, None]]          # [B, S, S1]
        keep = (np.arange(S1)[None, :] <= np.arange(S)[:, None])[None] \
            & active[:, order][:, :, None] & (r > 0)
        tr = np.where(keep[:, :, None, :],
                      bits_in[None, None, :, None] / r[:, :, None, :], INF)
        r0 = rate[np.arange(B)[:, None, None], sources[:, :, None],
                  order[None, None, :]]                          # [B, M, S]
        tr0 = np.where((r0 > 0) & active[:, order][:, None, :],
                       input_bits / r0, INF).astype(np.float32)
    tr = tr.astype(np.float32)
    dp = np.full((B, M, L + 1, S1), INF, np.float32)
    dp[:, :, 0, 0] = 0.0
    mn = np.zeros((B, M, L, S), np.float32)
    s0b = np.zeros((B, M, L, S), np.uint8)
    pa = np.zeros((B, M, L, S1), np.uint8)
    ps = np.zeros((B, M, L, S1), np.uint8)
    mn[:, :, 0] = dp[:, :, 0, 0][..., None] + tr0
    for j in range(1, L + 1):
        def cand(a):
            c = (mn[:, :, a] + ct[j - 1, a]).astype(np.float32)
            return np.where(ok[j - 1, a] > 0, c, INF)
        best, a_best = lanes_argmin(cand, j)
        dp[:, :, j, 1:] = best
        pa[:, :, j - 1, 1:] = a_best
        ps[:, :, j - 1, 1:] = np.take_along_axis(
            s0b, a_best[:, :, None, :], 2)[:, :, 0]
        if j == L:
            break
        v = dp[:, :, j, None, :] + tr[:, None, :, j, :]          # [B,M,S,S1]
        mn[:, :, j], s0b[:, :, j] = lanes_argmin(lambda s0: v[..., s0], S1)
    # backtrack, one slot at a time, as one thread runs it
    assign = np.zeros((B, M, L), np.int32)
    latency = np.zeros((B, M), np.float32)
    for b in range(B):
        for m in range(M):
            fin = dp[b, m, L]
            s = 0
            for k in range(1, S1):
                if before(fin[k], fin[s]):
                    s = k
            lat, feasible, bcur = fin[s], np.isfinite(fin[s]), L
            for j in range(L - 1, -1, -1):
                assign[b, m, j] = order[max(s - 1, 0)] if feasible else -1
                bi = min(max(bcur - 1, 0), L - 1)
                a, s0 = int(pa[b, m, bi, s]), int(ps[b, m, bi, s])
                if a == j:
                    bcur, s = a, s0
            latency[b, m] = lat
    return assign, latency


def case(model, U, M, B, rates, seed):
    rng = np.random.default_rng(seed)
    if model == "chain40":
        L = 40
        compute = rng.uniform(1e6, 3e7, L)
        memory = rng.uniform(1e4, 4e5, L)
        act_bits = rng.uniform(1e4, 1e6, L)
        input_bits = 1e6
    else:
        mc = cnn_cost({"lenet": LENET, "alexnet": ALEXNET}[model])
        compute = [x.flops for x in mc.layers]
        memory = [x.weight_bytes for x in mc.layers]
        act_bits = [x.act_bits for x in mc.layers]
        input_bits = mc.input_bits
    devs = make_devices(U)
    t = chain_dp_tables(compute, memory, act_bits, input_bits,
                        [d.mem_cap for d in devs],
                        [d.compute_cap for d in devs],
                        [d.throughput for d in devs],
                        order=tuple(int(o) for o in rng.permutation(U)),
                        device=torch.device("cpu"))
    if rates == "ties":
        rate = (rng.integers(0, 3, (B, U, U)) * 1e6).astype(np.float32)
    else:
        rate = rng.uniform(1e5, 5e7, (B, U, U)).astype(np.float32)
        rate[rng.random((B, U, U)) < 0.3] = 0.0
    active = rng.random((B, U)) >= 0.2
    sources = rng.integers(0, U, (B, M))
    active[0, sources[0, 0]] = False          # a dead source: infeasible
    rate[0, sources[0, 0]] = 0.0
    rate[:, np.arange(U), np.arange(U)] = np.inf
    return (rate, sources, active, t.order_arr.numpy(), t.prev_dev.numpy(),
            t.bits_in.numpy(), t.input_bits.numpy(), t.ct.numpy(),
            t.ok.numpy())


@pytest.mark.parametrize("model,U,M,B,rates", [
    ("lenet", 8, 4, 4, "random"), ("alexnet", 8, 4, 4, "random"),
    ("alexnet", 8, 8, 3, "ties"), ("lenet", 5, 3, 4, "ties"),
    ("alexnet", 32, 32, 1, "random"), ("chain40", 6, 2, 3, "random")])
def test_fused_route_emulation_equals_the_plain_version(model, U, M, B,
                                                        rates):
    args = case(model, U, M, B, rates, seed=U * M + B)
    L, S = args[7].shape[0], args[7].shape[2]
    assert chain_route(L, S, U) == "fused"
    got = fused_emulation(*args)
    ref = chain_dp_ref(*(torch.as_tensor(a) for a in args))
    np.testing.assert_array_equal(ref[0].numpy(), got[0])
    np.testing.assert_array_equal(ref[1].numpy(), got[1])
    lat = got[1]
    assert np.isinf(lat[0, 0]) and (got[0][0, 0] == -1).all()
    assert np.isfinite(lat).any()
