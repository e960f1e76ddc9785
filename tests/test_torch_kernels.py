"""The port's two kernels: plain PyTorch versions against the reference's
jnp oracles and its Pallas kernels in interpret mode, on the CPU.  The
CUDA kernels against the plain versions are in ``test_torch_cuda.py``,
which imports no JAX so that it runs on the card's machine.

Tolerances: the tropical-DP step is adds, mins and argmins, so it must
be bitwise (``row``, ``pa``, ``ps``), engineered ties and all-inf rows
included; so must the step cut to block starts a below the step, the
fused chain-DP kernel's shortcut.  Link geometry: ``dist`` and
``threshold`` are correctly rounded sub/mul/add/sqrt/div in the
reference's order, held to rtol 1e-6 (bitwise in practice); ``rate``
goes through ``log2``, whose last ulp differs between XLA's and
PyTorch's CPU math, so rtol 1e-5.  The zero (infeasible) and inf
(diagonal) masks must be identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.channel import RadioParams as JParams  # noqa: E402
from repro.kernels.link_geometry.link_geometry import \
    link_geometry as j_link_geometry  # noqa: E402
from repro.kernels.link_geometry.ref import \
    link_geometry_ref as j_geo_ref  # noqa: E402
from repro.kernels.tropical_dp.ref import dp_step_ref as j_dp_ref  # noqa: E402
from repro.kernels.tropical_dp.tropical_dp import \
    tropical_dp_step as j_dp_kernel  # noqa: E402
from repro_torch.configs.alexnet import ALEXNET  # noqa: E402
from repro_torch.configs.lenet import LENET  # noqa: E402
from repro_torch.core.batch import chain_dp_tables  # noqa: E402
from repro_torch.core.channel import RadioParams as TParams  # noqa: E402
from repro_torch.core.cost_model import cnn_cost  # noqa: E402
from repro_torch.core.swarm import make_devices  # noqa: E402
from repro_torch.kernels.link_geometry.ops import \
    fused_link_geometry  # noqa: E402
from repro_torch.kernels.link_geometry.ref import \
    link_geometry_ref as t_geo_ref  # noqa: E402
from repro_torch.kernels.tropical_dp.ref import \
    dp_step_ref as t_dp_ref  # noqa: E402


# ---------------------------------------------------------------------------
# link geometry
# ---------------------------------------------------------------------------


def geometry_inputs(seed, B=4, U=5, gain=False, dead=True, spread=120.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, spread, (B, U, 2)).astype(np.float32)
    pos[0, 1] = pos[0, 0] + 0.3          # under the 1 m clamp
    active = np.ones((B, U), dtype=bool)
    if dead:
        active[rng.random((B, U)) < 0.25] = False
        active[1, :] = True
    gs = None
    if gain:
        gs = (10.0 ** (rng.normal(0, 3.0, (B, U, U)) / 10.0)).astype(
            np.float32)
    return pos, active, gs


def assert_geometry_close(ref, got):
    for name, a, b in zip(("dist", "threshold", "rate"), ref, got):
        a, b = np.asarray(a), np.asarray(b)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        np.testing.assert_array_equal(a == 0, b == 0, err_msg=name)
        fin = np.isfinite(a)
        rtol = 1e-5 if name == "rate" else 1e-6
        np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize("gain", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_link_geometry_plain_matches_jnp_oracle(seed, gain):
    pos, active, gs = geometry_inputs(seed, gain=gain)
    ref = j_geo_ref(jnp.asarray(pos), jnp.asarray(active),
                    None if gs is None else jnp.asarray(gs),
                    params=JParams())
    got = t_geo_ref(torch.as_tensor(pos), torch.as_tensor(active),
                    None if gs is None else torch.as_tensor(gs),
                    params=TParams())
    assert_geometry_close(ref, got)
    rate = np.asarray(ref[2])
    off = ~np.eye(pos.shape[1], dtype=bool)
    assert (rate[:, off] == 0).any() and (rate[:, off] > 0).any()


@pytest.mark.parametrize("gain", [False, True])
def test_link_geometry_plain_matches_interpret_kernel(gain):
    pos, active, gs = geometry_inputs(7, B=3, U=8, gain=gain)
    ref = j_link_geometry(jnp.asarray(pos),
                          jnp.asarray(active, jnp.float32),
                          None if gs is None else jnp.asarray(gs),
                          params=JParams(), interpret=True)
    got = fused_link_geometry(torch.as_tensor(pos), TParams(),
                              active=torch.as_tensor(active),
                              gain_scale=None if gs is None
                              else torch.as_tensor(gs))
    assert_geometry_close(ref, got)


def test_link_geometry_dead_uav_rows_and_columns_are_unlinked():
    pos, active, _ = geometry_inputs(3, B=2, U=6)
    active[0, 2] = False
    _, _, rate = t_geo_ref(torch.as_tensor(pos), torch.as_tensor(active),
                           None, params=TParams())
    rate = rate.numpy()
    off = ~np.eye(6, dtype=bool)
    assert (rate[0, 2][off[2]] == 0).all()
    assert (rate[0, :, 2][off[:, 2]] == 0).all()
    assert np.isinf(np.diagonal(rate, axis1=1, axis2=2)).all()


# ---------------------------------------------------------------------------
# tropical DP step
# ---------------------------------------------------------------------------


def dp_inputs(seed, B=3, M=2, L=5, S=4, ties=False):
    """Random step operands with inf holes; ``ties`` draws small integers so
    equal candidates across a and s0 are common, and plants all-inf rows
    (an ok column of zeros, and a (b, m) slab whose dp is all inf)."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.integers(0, 3, shape) if ties else rng.uniform(0, 5, shape)
        x = x.astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
        return x

    dp, tr, tr0 = draw((B, M, L, S + 1)), draw((B, L, S, S + 1)), \
        draw((B, M, S))
    ct = (rng.integers(0, 2, (L, S)) if ties
          else rng.uniform(0, 1, (L, S))).astype(np.float32)
    ok = (rng.random((L, S)) < 0.8).astype(np.float32)
    ok[:, 0] = 0.0                       # state 1: no feasible block start
    dp[0, 0] = np.inf                    # (b, m) = (0, 0): no finite parent
    tr0[0, 0] = np.inf
    return dp, tr, tr0, ct, ok


def assert_step_equal(ref, got):
    for name, a, b in zip(("row", "pa", "ps"), ref, got):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dp_step_plain_matches_jnp_oracle(seed, ties):
    args = dp_inputs(seed, ties=ties)
    ref = j_dp_ref(*(jnp.asarray(a) for a in args))
    got = t_dp_ref(*(torch.as_tensor(a) for a in args))
    assert_step_equal(ref, [g.numpy() for g in got])


@pytest.mark.parametrize("ties", [False, True])
def test_dp_step_plain_matches_interpret_kernel(ties):
    args = dp_inputs(5, B=2, M=3, L=6, S=5, ties=ties)
    ref = j_dp_kernel(*(jnp.asarray(a) for a in args), interpret=True)
    got = t_dp_ref(*(torch.as_tensor(a) for a in args))
    assert_step_equal(ref, [g.numpy() for g in got])


def test_dp_step_all_inf_rows_point_at_first_parent():
    args = dp_inputs(9, ties=True)
    row, pa, ps = t_dp_ref(*(torch.as_tensor(a) for a in args))
    dead = torch.isinf(row)
    assert dead[:, :, 0].all()           # ok column 0 is all zero
    assert (pa[dead] == 0).all() and (ps[dead] == 0).all()


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("model", [LENET, ALEXNET], ids=["lenet", "alexnet"])
def test_dp_step_cut_to_a_below_the_step_is_bitwise(model, ties):
    """The fused kernel's shortcut: at step b it scans block starts a < b
    only.  ``chain_dp_tables``' ok is 0 for every a >= b, a masked
    candidate (inf) never replaces an earlier one, and an all-inf row
    keeps a = 0, s0 = 0; so the step over the first b rows of dp, tr, ct
    and ok equals the full step bit for bit at every b, with finite
    junk in the cut rows, ties and all-inf rows."""
    mc, U = cnn_cost(model), 6
    devs = make_devices(U)
    t = chain_dp_tables(
        [x.flops for x in mc.layers], [x.weight_bytes for x in mc.layers],
        [x.act_bits for x in mc.layers], mc.input_bits,
        [d.mem_cap for d in devs], [d.compute_cap for d in devs],
        [d.throughput for d in devs], order=tuple(range(U)),
        device=torch.device("cpu"))
    L = t.n_layers
    dp, tr, tr0, _, _ = (torch.as_tensor(a) for a in dp_inputs(
        11, B=3, M=2, L=L, S=U, ties=ties))
    a_ix = torch.arange(L)[:, None]
    for b in range(1, L + 1):
        ct, ok = t.ct[b - 1], t.ok[b - 1]
        assert (ok[a_ix.expand(L, U) >= b] == 0).all()
        full = t_dp_ref(dp, tr, tr0, ct, ok)
        cut = t_dp_ref(dp[:, :, :b], tr[:, :b], tr0, ct[:b], ok[:b])
        assert_step_equal([f.numpy() for f in full],
                          [c.numpy() for c in cut])
