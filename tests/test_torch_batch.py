"""The port's batched planner pieces against the reference on the CPU.

* Prefix sums (``pre_c``/``pre_m``) of the LeNet and AlexNet costs, and
  of random float32 costs at L 2-64 and a few L up to 1,000, equal
  ``jnp.cumsum``'s bit for bit: they feed the DP's discrete ``ok``
  mask.  The chain DP on a scaled AlexNet (another 11-layer CNN) is
  bitwise with the reference's.
* The chain DP (``_chain_dp_solve_kernelized`` and its single-source
  slice) fed the SAME rate tensor as the reference's
  ``_chain_dp_solve_multi`` / ``_chain_dp_solve``: bitwise assignments and
  latencies, with dead UAVs, a permuted device order and tie-heavy rates.
* The fused chain-DP kernel's plain version (``chain_dp_ref``, moved out
  of ``core/batch.py``) against the reference's
  ``_chain_dp_solve_kernelized``, bitwise: M 1, 4 and 8 source slots,
  LeNet (L 7) and AlexNet (L 11), U 8 and 32, with dead UAVs, tie-heavy
  integer rates and all-infeasible rows (assign -1, latency inf).
* The host-facing wrappers ``solve_chain_dp_batched`` and
  ``solve_chain_dp_multisource`` against the reference's, with
  ``use_kernel`` off (the scan DP) and on (Pallas in interpret mode):
  LeNet and AlexNet, U 5 and 8, geometry, tie-heavy and infeasible
  rates, dead UAVs, index and permuted device orders; int64 assignments
  and float64 latencies bitwise.  With a permuted order each placement
  equals the port's scalar ``solve_chain_dp(p, device_order=)``.  At
  U = L = 32 both wrappers are bitwise the reference's, and each
  feasible placement is also held as the reference's own test holds it:
  cap-feasible, its latency the scalar ``latency`` within rtol 1e-5.
* The used-links mask, the aggregate load and the shared-cap check.
* P2 (``_positions_pgd``): elementwise within 1e-4 m after 3 steps; after
  30 steps + repair the invariants (2R separation, coverage, monotone
  trace) and the objective within rtol 1e-4 — ulp differences compound
  over the gradient steps, so elementwise parity is not expected there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.alexnet import ALEXNET  # noqa: E402
from repro.configs.lenet import LENET  # noqa: E402
from repro.core import batch as jb  # noqa: E402
from repro.core.channel import RadioParams as JParams  # noqa: E402
from repro.core.cost_model import cnn_cost  # noqa: E402
from repro.core.swarm import make_devices  # noqa: E402
from repro.kernels.link_geometry.ref import link_geometry_ref  # noqa: E402
from repro_torch.core import batch as tb  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core.swarm import make_devices as t_make_devices  # noqa: E402
from repro_torch.kernels.tropical_dp.ref import chain_dp_ref  # noqa: E402

MODELS = {"lenet": LENET, "alexnet": ALEXNET}


def problem(name, U):
    mc, devs = cnn_cost(MODELS[name]), make_devices(U)
    return dict(
        compute=np.array([l.flops for l in mc.layers]),
        memory=np.array([l.weight_bytes for l in mc.layers]),
        act_bits=np.array([l.act_bits for l in mc.layers]),
        input_bits=float(mc.input_bits),
        mem_cap=np.array([d.mem_cap for d in devs]),
        compute_cap=np.array([d.compute_cap for d in devs]),
        throughput=np.array([d.throughput for d in devs]))


def jax_args(p):
    return (jnp.asarray(p["compute"], jnp.float32),
            jnp.asarray(p["memory"], jnp.float32),
            jnp.asarray(p["act_bits"], jnp.float32),
            jnp.float32(p["input_bits"]),
            jnp.asarray(p["mem_cap"], jnp.float32),
            jnp.asarray(p["compute_cap"], jnp.float32),
            jnp.asarray(p["throughput"], jnp.float32))


def reference_rate(seed, B, U, spread=90.0, dead=0.2):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, spread, (B, U, 2)).astype(np.float32)
    active = rng.random((B, U)) >= dead
    active[:, 0] = True
    _, _, rate = link_geometry_ref(jnp.asarray(pos), jnp.asarray(active),
                                   None, params=JParams())
    return np.array(rate), active


@pytest.mark.parametrize("name", ["lenet", "alexnet"])
def test_prefix_sums_match_jnp_cumsum(name):
    p = problem(name, 4)
    pre_c, pre_m = tb.prefix_sums(torch.as_tensor(p["compute"],
                                                  dtype=torch.float32),
                                  torch.as_tensor(p["memory"],
                                                  dtype=torch.float32))
    for got, key in ((pre_c, "compute"), (pre_m, "memory")):
        x = jnp.asarray(p[key], jnp.float32)
        ref = jnp.concatenate([jnp.zeros(1), jnp.cumsum(x)])
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("L", [*range(2, 65), 100, 255, 256, 257, 511,
                               1000])
def test_prefix_sums_match_jnp_cumsum_on_random_costs(L):
    """Random float32 costs at L 2-64 and a few L up to 1,000, eight seeds
    each: bitwise equal to ``jnp.cumsum``.  From L 18 XLA's blocked scan
    departs from a sequential sum, so this pins its order for the
    installed jaxlib."""
    for seed in range(8):
        rng = np.random.default_rng(100 * L + seed)
        c, m = (rng.uniform(0.1, 10.0, L).astype(np.float32)
                for _ in range(2))
        got = tb.prefix_sums(torch.as_tensor(c), torch.as_tensor(m))
        for x, g in zip((c, m), got):
            ref = jnp.concatenate([jnp.zeros(1), jnp.cumsum(jnp.asarray(x))])
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(np.asarray(ref), g.numpy())


@pytest.mark.parametrize("seed", range(6))
def test_chain_dp_bitwise_on_a_scaled_alexnet(seed):
    """Another 11-layer CNN: AlexNet's compute and memory each scaled by
    ``uniform(0.5, 1.5, 11)``, U 5, B 4, all five sources.  The prefix
    sums, latencies and assignments equal the reference's
    ``_chain_dp_solve_kernelized`` bit for bit."""
    U, B, order = 5, 4, (0, 1, 2, 3, 4)
    p = problem("alexnet", U)
    rng = np.random.default_rng(seed)
    for key in ("compute", "memory"):
        p[key] = (p[key] * rng.uniform(0.5, 1.5, 11)).astype(np.float32)
    rate, active = reference_rate(1, B, U)
    sources = np.tile(np.arange(U, dtype=np.int32), (B, 1))
    ref_assign, ref_lat = jb._chain_dp_solve_kernelized(
        *jax_args(p), jnp.asarray(rate), jnp.asarray(sources),
        jnp.asarray(active), order)
    tables = tb.chain_dp_tables(**p, order=order, device=torch.device("cpu"))
    for got, key in zip(tb.prefix_sums(torch.as_tensor(p["compute"]),
                                       torch.as_tensor(p["memory"])),
                        ("compute", "memory")):
        x = jnp.asarray(p[key], jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(jnp.concatenate([jnp.zeros(1), jnp.cumsum(x)])),
            got.numpy())
    assign, lat = tb._chain_dp_solve_kernelized(
        tables, torch.as_tensor(rate), torch.as_tensor(sources),
        torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(ref_assign), assign.numpy())
    np.testing.assert_array_equal(np.asarray(ref_lat), lat.numpy())
    assert np.isfinite(lat.numpy()).any()


@pytest.mark.parametrize("order", [(0, 1, 2, 3, 4), (3, 0, 4, 1, 2)])
@pytest.mark.parametrize("name", ["lenet", "alexnet"])
def test_chain_dp_multi_source_bitwise(name, order):
    U, B = 5, 4
    p = problem(name, U)
    rate, active = reference_rate(1, B, U)
    sources = np.tile(np.arange(U, dtype=np.int32), (B, 1))
    ref_assign, ref_lat = jb._chain_dp_solve_multi(
        *jax_args(p), jnp.asarray(rate), jnp.asarray(sources),
        jnp.asarray(active), order)
    tables = tb.chain_dp_tables(**p, order=order, device=torch.device("cpu"))
    assign, lat = tb._chain_dp_solve_kernelized(
        tables, torch.as_tensor(rate), torch.as_tensor(sources),
        torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(ref_assign), assign.numpy())
    np.testing.assert_array_equal(np.asarray(ref_lat), lat.numpy())
    assert np.isfinite(lat.numpy()).any()


def test_chain_dp_single_source_bitwise_with_ties():
    """Rates drawn from three values make equal-latency placements
    common; the first-improvement tie-break must pick the same one."""
    U, B = 4, 6
    p = problem("lenet", U)
    rng = np.random.default_rng(4)
    rate = rng.choice(np.array([0.0, 1e6, 2e6], np.float32), (B, U, U))
    rate[:, np.arange(U), np.arange(U)] = np.inf
    active = np.ones((B, U), dtype=bool)
    active[2, 1] = False
    source = rng.integers(0, U, B).astype(np.int32)
    ref_assign, ref_lat = jb._chain_dp_solve(
        *jax_args(p), jnp.asarray(rate), jnp.asarray(source),
        jnp.asarray(active), (0, 1, 2, 3))
    tables = tb.chain_dp_tables(**p, order=(0, 1, 2, 3),
                                device=torch.device("cpu"))
    assign, lat = tb._chain_dp_solve(tables, torch.as_tensor(rate),
                                     torch.as_tensor(source),
                                     torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(ref_assign), assign.numpy())
    np.testing.assert_array_equal(np.asarray(ref_lat), lat.numpy())


def test_chain_dp_all_dead_or_unreachable_is_infeasible():
    U, B = 4, 2
    p = problem("alexnet", U)
    rate = np.zeros((B, U, U), np.float32)          # no link at all
    rate[:, np.arange(U), np.arange(U)] = np.inf
    active = np.ones((B, U), dtype=bool)
    active[1] = False
    tables = tb.chain_dp_tables(**p, order=(0, 1, 2, 3),
                                device=torch.device("cpu"))
    assign, lat = tb._chain_dp_solve(tables, torch.as_tensor(rate),
                                     torch.tensor([0, 0]),
                                     torch.as_tensor(active))
    ref_assign, ref_lat = jb._chain_dp_solve(
        *jax_args(p), jnp.asarray(rate), jnp.asarray([0, 0], jnp.int32),
        jnp.asarray(active), (0, 1, 2, 3))
    np.testing.assert_array_equal(np.asarray(ref_assign), assign.numpy())
    np.testing.assert_array_equal(np.asarray(ref_lat), lat.numpy())
    assert np.isinf(lat[1].item()) and (assign[1] == -1).all()


def chain_rates(mode, seed, B, U, sources):
    """[B, U, U] rates with an inf diagonal and [B, U] active flags:
    ``geometry`` from random positions (a fifth of the UAVs dead);
    ``ties`` integer multiples of 1e6 (0 = no link), so equal-latency
    placements are common, with dead UAVs; ``infeasible`` as ``ties``,
    with every UAV of scenario 0 down, and scenario 1 without a link and
    its slots' source UAVs down."""
    if mode == "geometry":
        return reference_rate(seed, B, U)
    rng = np.random.default_rng(seed)
    rate = (rng.integers(0, 3, (B, U, U)) * 1e6).astype(np.float32)
    active = rng.random((B, U)) >= 0.2
    if mode == "infeasible":
        active[0] = False
        rate[1] = 0.0
        active[1, sources[1]] = False
    rate[:, np.arange(U), np.arange(U)] = np.inf
    return rate, active


CHAIN_SHAPES = [(name, U, M) for name in ("lenet", "alexnet")
                for U in (8, 32) for M in (1, 4, 8)]


@pytest.mark.parametrize("mode", ["geometry", "ties", "infeasible"])
@pytest.mark.parametrize("name,U,M", CHAIN_SHAPES)
def test_chain_dp_ref_bitwise_against_the_reference(name, U, M, mode):
    """``chain_dp_ref`` (the fused kernel's plain version) fed the same
    rates, sources, flags and device order as the reference's
    ``_chain_dp_solve_kernelized``: assignments and latencies bitwise."""
    B = 3
    p = problem(name, U)
    rng = np.random.default_rng(U + M)
    order = tuple(int(o) for o in rng.permutation(U))
    sources = rng.integers(0, U, (B, M)).astype(np.int32)
    rate, active = chain_rates(mode, 10 * U + M, B, U, sources)
    ref_assign, ref_lat = jb._chain_dp_solve_kernelized(
        *jax_args(p), jnp.asarray(rate), jnp.asarray(sources),
        jnp.asarray(active), order)
    t = tb.chain_dp_tables(**p, order=order, device=torch.device("cpu"))
    assign, lat = chain_dp_ref(torch.as_tensor(rate),
                               torch.as_tensor(sources),
                               torch.as_tensor(active), t.order_arr,
                               t.prev_dev, t.bits_in, t.input_bits, t.ct,
                               t.ok)
    assert assign.dtype == torch.int32 and assign.shape == (B, M, len(
        MODELS[name].layers))
    np.testing.assert_array_equal(np.asarray(ref_assign), assign.numpy())
    np.testing.assert_array_equal(np.asarray(ref_lat), lat.numpy())
    dead = ~np.isfinite(lat.numpy())
    assert (assign.numpy()[dead] == -1).all()
    if mode == "infeasible":
        assert dead[:2].all()
    else:
        assert np.isfinite(lat.numpy()).any()


def wrapper_case(name, U, mode, order, B=4, M=3):
    """Problem, device order (None or a permutation), rates, flags and
    [B, M] sources of a wrapper call."""
    rng = np.random.default_rng(7 * U + len(name))
    perm = tuple(int(o) for o in rng.permutation(U))
    sources = rng.integers(0, U, (B, M))
    rate, active = chain_rates(mode, U, B, U, sources)
    return (problem(name, U), None if order == "index" else perm, rate,
            active, sources)


def wrapper_args(p, rate):
    return (p["compute"], p["memory"], p["act_bits"], p["input_bits"],
            p["mem_cap"], p["compute_cap"], p["throughput"], rate)


WRAPPER_CASES = [(name, U) for name in ("lenet", "alexnet") for U in (5, 8)]


def assert_bitwise(ref, got):
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(r, g)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("order", ["index", "permuted"])
@pytest.mark.parametrize("mode", ["geometry", "ties", "infeasible"])
@pytest.mark.parametrize("name,U", WRAPPER_CASES)
def test_solve_chain_dp_batched_bitwise(name, U, mode, order, use_kernel):
    p, dorder, rate, active, sources = wrapper_case(name, U, mode, order)
    args = wrapper_args(p, rate)
    ref = jb.solve_chain_dp_batched(*args, sources[:, 0], active, dorder,
                                    use_kernel=use_kernel)
    got = tb.solve_chain_dp_batched(*args, sources[:, 0], active, dorder,
                                    device="cpu")
    assert_bitwise(ref, got)
    assert got[0].dtype == np.int64 and got[1].dtype == np.float64
    dead = ~np.isfinite(got[1])
    assert (got[0][dead] == -1).all()
    assert dead[:2].all() if mode == "infeasible" else not dead.all()


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("order", ["index", "permuted"])
@pytest.mark.parametrize("mode", ["geometry", "ties", "infeasible"])
@pytest.mark.parametrize("name,U", WRAPPER_CASES)
def test_solve_chain_dp_multisource_bitwise(name, U, mode, order,
                                            use_kernel):
    p, dorder, rate, active, sources = wrapper_case(name, U, mode, order)
    args = wrapper_args(p, rate)
    ref = jb.solve_chain_dp_multisource(*args, sources, active, dorder,
                                        use_kernel=use_kernel)
    got = tb.solve_chain_dp_multisource(*args, sources, active, dorder,
                                        device="cpu")
    assert_bitwise(ref, got)
    assert got[0].shape == sources.shape + (len(p["compute"]),)
    # each slot is the single-source solve of its source
    for m in range(sources.shape[1]):
        assert_bitwise(tb.solve_chain_dp_batched(
            *args, sources[:, m], active, dorder, device="cpu"),
            (got[0][:, m], got[1][:, m]))


def t_problem(p, rate, source, devs):
    return tpl.PlacementProblem(p["compute"], p["memory"], p["act_bits"],
                                devs, rate, source=int(source),
                                input_bits=p["input_bits"])


@pytest.mark.parametrize("name", ["lenet", "alexnet"])
def test_batched_equals_the_scalar_solver_in_a_permuted_order(name):
    """The scalar ``solve_chain_dp(p, device_order=)`` as the oracle of
    the batched wrapper with the same order and every UAV alive: the same
    assignment, the latency within float32 rounding."""
    U, B = 6, 8
    p = problem(name, U)
    rate, _ = reference_rate(5, B, U, dead=0.0)
    order = (4, 1, 5, 0, 3, 2)
    src = np.random.default_rng(5).integers(0, U, B)
    assign, lat = tb.solve_chain_dp_batched(*wrapper_args(p, rate), src,
                                            device_order=order,
                                            device="cpu")
    devs = t_make_devices(U)
    for n in range(B):
        sol = tpl.solve_chain_dp(t_problem(p, rate[n], src[n], devs),
                                 device_order=order)
        assert np.isfinite(lat[n]) == np.isfinite(sol.latency)
        if np.isfinite(sol.latency):
            assert tuple(assign[n]) == sol.assign
            np.testing.assert_allclose(lat[n], sol.latency, rtol=1e-5)
    assert np.isfinite(lat).any()


def test_large_instance_solves_and_prices_consistently():
    """U = L = 32 (the reference's ``test_large_instance_traces_and_solves``
    inputs): past L = 17 the prefix sums are not bitwise ``jnp.cumsum``'s,
    so each feasible placement is held as the reference holds its own:
    cap-feasible, and its latency the port's scalar
    ``PlacementProblem.latency`` within rtol 1e-5."""
    from repro.core.batch import rate_matrix_batched, solve_power_batched
    from repro.core.channel import RadioParams
    rng = np.random.default_rng(3)
    L, U, B = 32, 32, 4
    compute = np.abs(rng.normal(7e7, 3e7, L)) + 1e6
    memory = np.abs(rng.normal(2e6, 1e6, L)) + 1e4
    act = np.abs(rng.normal(6e5, 3e5, L)) + 1e4
    devs = t_make_devices(U)
    prng = np.random.default_rng(3)
    pos = prng.uniform(0, 250.0, (B, U, 2))
    dist = np.sqrt(((pos[:, :, None] - pos[:, None, :]) ** 2).sum(-1))
    sol = solve_power_batched(dist, RadioParams())
    rate = np.asarray(rate_matrix_batched(dist, sol.power, RadioParams(),
                                          sol.link_feasible))
    src = rng.integers(0, U, B)
    p = dict(compute=compute, memory=memory, act_bits=act, input_bits=1e6,
             mem_cap=np.array([d.mem_cap for d in devs]),
             compute_cap=np.array([d.compute_cap for d in devs]),
             throughput=np.array([d.throughput for d in devs]))
    assign, lat = tb.solve_chain_dp_batched(*wrapper_args(p, rate), src,
                                            device="cpu")
    assert assign.shape == (B, L) and lat.shape == (B,)
    assert np.isfinite(lat).any()
    for n in range(B):
        if not np.isfinite(lat[n]):
            assert (assign[n] == -1).all()
            continue
        prob = t_problem(p, rate[n], src[n], devs)
        assert prob.feasible(assign[n])
        np.testing.assert_allclose(prob.latency(assign[n]), lat[n],
                                   rtol=1e-5)


def large_instance(seed, L, U=32, B=16):
    """``test_large_instance_solves_and_prices_consistently``'s generator
    at any seed and chain length: the wrapper arguments and [B, 2]
    sources."""
    from repro.core.batch import rate_matrix_batched, solve_power_batched
    from repro.core.channel import RadioParams
    rng = np.random.default_rng(seed)
    p = dict(compute=np.abs(rng.normal(7e7, 3e7, L)) + 1e6,
             memory=np.abs(rng.normal(2e6, 1e6, L)) + 1e4,
             act_bits=np.abs(rng.normal(6e5, 3e5, L)) + 1e4, input_bits=1e6)
    devs = t_make_devices(U)
    p.update(mem_cap=np.array([d.mem_cap for d in devs]),
             compute_cap=np.array([d.compute_cap for d in devs]),
             throughput=np.array([d.throughput for d in devs]))
    pos = np.random.default_rng(seed).uniform(0, 250.0, (B, U, 2))
    dist = np.sqrt(((pos[:, :, None] - pos[:, None, :]) ** 2).sum(-1))
    sol = solve_power_batched(dist, RadioParams())
    rate = np.asarray(rate_matrix_batched(dist, sol.power, RadioParams(),
                                          sol.link_feasible))
    return wrapper_args(p, rate), rng.integers(0, U, (B, 2))


@pytest.mark.parametrize("L", [18, 24, 32, 48])
@pytest.mark.parametrize("wrapper", ["solve_chain_dp_batched",
                                     "solve_chain_dp_multisource"])
def test_long_chain_wrappers_bitwise(wrapper, L):
    """U 32, B 16, seeds 0-9, chains of 18-48 layers: both wrappers'
    assignments and float64 latencies equal the reference's bit for bit
    (a sequential float32 prefix sum differs from ``jnp.cumsum`` here and
    moves the latencies of up to 127 of the 160 rows)."""
    for seed in range(10):
        args, src = large_instance(seed, L)
        src = src[:, 0] if wrapper == "solve_chain_dp_batched" else src
        ref = getattr(jb, wrapper)(*args, src)
        got = getattr(tb, wrapper)(*args, src, device="cpu")
        assert_bitwise(ref, got)
        assert np.isfinite(got[1]).any()


def test_links_load_and_cap_match():
    rng = np.random.default_rng(2)
    B, S, L, U = 3, 4, 7, 4
    assign = rng.integers(-1, U, (B, S, L)).astype(np.int32)
    src = rng.integers(0, U, (B, S)).astype(np.int32)
    weights = rng.integers(0, 3, (B, S)).astype(np.float32)
    compute = rng.uniform(1e6, 5e8, L).astype(np.float32)
    cap = rng.uniform(1e8, 1e9, U).astype(np.float32)
    for s in range(S):
        ref = jb.links_from_assignment_batched(jnp.asarray(assign[:, s]),
                                               jnp.asarray(src[:, s]), U)
        got = tb.links_from_assignment_batched(torch.as_tensor(assign[:, s]),
                                               torch.as_tensor(src[:, s]), U)
        np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    ref_load = jb.placement_compute_load(jnp.asarray(assign),
                                         jnp.asarray(weights),
                                         jnp.asarray(compute), U)
    load = tb.placement_compute_load(torch.as_tensor(assign),
                                     torch.as_tensor(weights),
                                     torch.as_tensor(compute), U)
    np.testing.assert_allclose(load.numpy(), np.asarray(ref_load), rtol=1e-6)
    ref_ok = jb.shared_cap_feasible(ref_load, jnp.asarray(cap))
    ok = tb.shared_cap_feasible(load, torch.as_tensor(cap))
    np.testing.assert_array_equal(np.asarray(ref_ok), ok.numpy())


# ---------------------------------------------------------------------------
# P2
# ---------------------------------------------------------------------------


def p2_case(seed, B=4, U=5, radius=20.0):
    rng = np.random.default_rng(seed)
    pos0 = rng.uniform(-60, 60, (B, U, 2)).astype(np.float32)
    links = np.broadcast_to(jb.chain_links(U), (B, U, U)).copy()
    consts = dict(coeff=jb.position_coeff(JParams()), lr=0.5,
                  two_r=2.0 * radius,
                  cover_r=jb.coverage_radius(U, radius))
    return pos0, links, consts


def run_both(pos0, links, consts, steps, repair):
    center = pos0.mean(1)
    ref = jb._positions_pgd(
        jnp.asarray(pos0), jnp.asarray(links),
        *(jnp.float32(consts[k]) for k in ("coeff", "lr", "two_r",
                                            "cover_r")),
        jnp.asarray(center), steps, repair)
    f = {k: torch.tensor(np.float32(v)) for k, v in consts.items()}
    got = tb._positions_pgd(torch.as_tensor(pos0), torch.as_tensor(links),
                            f["coeff"], f["lr"], f["two_r"], f["cover_r"],
                            torch.as_tensor(center), steps, repair)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("seed", [0, 1])
def test_p2_three_steps_elementwise(seed):
    pos0, links, consts = p2_case(seed)
    ref, got = run_both(pos0, links, consts, steps=3, repair=3)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-5)


def test_p2_thirty_steps_invariants_and_objective():
    pos0, links, consts = p2_case(3, B=6, U=6)
    ref, got = run_both(pos0, links, consts, steps=30, repair=25)
    pos, obj, viol, trace = got
    d = np.sqrt(((pos[:, :, None] - pos[:, None]) ** 2).sum(-1))
    d[:, np.eye(6, dtype=bool)] = np.inf
    assert d.min() >= consts["two_r"] - 0.5
    assert viol.max() < 0.5
    assert (np.diff(trace, axis=1) <= 0.0).all()
    r = np.linalg.norm(pos - pos0.mean(1)[:, None], axis=-1)
    assert r.max() <= consts["cover_r"] + 1e-3
    np.testing.assert_allclose(obj, ref[1], rtol=1e-4)
    np.testing.assert_allclose(trace[:, -1], ref[3][:, -1], rtol=1e-4)
