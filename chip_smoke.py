#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    PYTHONPATH=src python3 chip_smoke.py

Phases, each raising on failure (the script then exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel from ``src/repro_torch/csrc`` with ``nvcc``
   (``sm_90a``), print the build time and ``ptxas`` resource lines;
3. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at B = 4096: link geometry (with and without
   ``gain_scale``, with dead UAVs; ``dist`` and ``threshold`` bitwise,
   ``rate`` within rtol 1e-6) and the tropical-DP step (random, tie-heavy
   and all-inf inputs; bitwise);
4. a small rollout on the card against the same rollout on the CPU (the
   plain path): discrete fields exact, floats within rtol 1e-5;
5. the main path: ``FleetRollout(...).run`` at AlexNet, U = 8, B = 256,
   T = 32 with the fused P2 stage, launch counters set to 0 just before
   and read just after (32 link-geometry and 32 x 11 tropical-DP
   launches), then ``ScenarioEngine.plan_batch_multi`` at B = 256
   (1 and 11 launches); feasibility, latency percentiles, wall time; the
   warm-up rollout runs its frame loop under PyTorch's sync debug mode
   "error", so a host synchronisation inside the loop fails the phase;
6. each kernel's time (CUDA events over a CUDA graph of many launches,
   and eager back-to-back launches) beside its plain version's and its
   bound at the published H100 SXM peaks;
7. the conv2d GEMM kernel against its plain version at AlexNet's five
   conv GEMMs (batch 32 and 1) and ragged shapes, relu on and off, atol
   5e-4 rtol 1e-3, two launches bitwise equal; the conv2d op against a
   direct float32 convolution at the five conv layers;
8. the CNN path: ``LLHRPlanner.plan`` (P2 200 steps on the card) for four
   AlexNet requests on U = 8 UAVs with a fifth of the memory each, so
   every request spans >= 2 UAVs; each request's 32 images through
   ``distributed_forward`` sliced by its placement, launch counters set
   to 0 just before and read just after (4 x 5 conv2d launches); sliced
   equals monolithic bitwise; then the four requests served again and
   again over a window of at least 1.5 s (images/s over the window, the
   spread per serve and per request); the replan without request 0's
   first UAV; the same path at 2 images against the CPU plain path;
9. the conv2d kernel's time at the five conv GEMMs (batch 32) beside its
   plain version, ``torch.addmm`` and its bound.

The last lines are the CNN path's serving numbers, the per-layer conv2d
times, the kernels line, the ``nvidia-smi`` line and the result object.
Without CUDA it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM fp32 outside the tensor cores
U, L_ALEXNET = 8, 11
MAIN_B, MAIN_T, REQUESTS = 256, 32, 4
MAIN_N_IMG = 32                  # images per request on the CNN path
CONV_ITERS = 20                  # timed conv GEMM launches per measurement
CNN_WINDOW_S = 1.5               # least timed serving window of the CNN path


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def geometry_inputs(np, torch, seed, B, gain, device):
    from repro_torch.core.positions import hex_init
    rng = np.random.default_rng(seed)
    base = hex_init(U, 40.0, jitter=0.5, seed=seed)
    pos = (base[None] + rng.normal(0, 15.0, (B, U, 2))).astype(np.float32)
    pos[0, 1] = pos[0, 0] + 0.3                   # under the 1 m clamp
    active = rng.random((B, U)) >= 0.15
    gs = (10.0 ** (rng.normal(0, 3.0, (B, U, U)) / 10.0)).astype(
        np.float32) if gain else None
    return [None if x is None else torch.as_tensor(x, device=device)
            for x in (pos, active, gs)]


def dp_inputs(np, torch, seed, B, M, L, S, ties, device):
    """Step operands with inf holes; ``ties`` draws small integers so equal
    candidates across a and s0 are common, and plants all-inf rows."""
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.integers(0, 3, shape) if ties else rng.uniform(0, 5, shape)
        x = x.astype(np.float32)
        x[rng.random(shape) < 0.2] = np.inf
        return x

    table = np.full((B, M, L + 1, S + 1), np.inf, np.float32)
    table[:, :, :L] = draw((B, M, L, S + 1))
    tr, tr0 = draw((B, L, S, S + 1)), draw((B, M, S))
    ct = (rng.integers(0, 2, (L, S)) if ties
          else rng.uniform(0, 1, (L, S))).astype(np.float32)
    ok = (rng.random((L, S)) < 0.8).astype(np.float32)
    ok[:, 0] = 0.0                       # state 1: no feasible block start
    table[0, 0] = np.inf                 # a (b, m) slab with no parent
    tr0[0, 0] = np.inf
    t = torch.as_tensor(table, device=device)
    # the solver passes a row slice of its [B, M, L+1, S+1] table
    return [t[:, :, :L]] + [torch.as_tensor(x, device=device)
                            for x in (tr, tr0, ct, ok)]


def max_abs_err(torch, ref, got):
    worst = 0.0
    for a, b in zip(ref, got):
        if not torch.equal(torch.isinf(a), torch.isinf(b)):
            raise AssertionError("inf masks differ")
        fin = torch.isfinite(a)
        if fin.any():
            worst = max(worst, float((a[fin].double() - b[fin].double())
                                     .abs().max()))
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_kernels(np, torch, params, device):
    from repro_torch.kernels.link_geometry.link_geometry import link_geometry
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    from repro_torch.kernels.tropical_dp.ref import dp_step_ref
    from repro_torch.kernels.tropical_dp.tropical_dp import tropical_dp_step
    errs = {}
    for B in (MAIN_B, 4096):
        for gain in (False, True):
            pos, active, gs = geometry_inputs(np, torch, 1, B, gain, device)
            got = link_geometry(pos, active.float(), gs, params=params)
            ref = link_geometry_ref(pos, active, gs, params=params)
            torch.cuda.synchronize()
            for name, a, b in zip(("dist", "threshold"), ref, got):
                if not torch.equal(a, b):
                    raise AssertionError(f"link_geometry {name} differs "
                                         f"(B={B}, gain={gain})")
            a, b = ref[2], got[2]
            if not torch.equal(a == 0, b == 0):
                raise AssertionError("link_geometry rate zero masks differ")
            fin = torch.isfinite(a)
            rel = ((a[fin] - b[fin]).abs() / a[fin].abs().clamp_min(1e-30))
            if float(rel.max()) > 1e-6:
                raise AssertionError(f"link_geometry rate rtol "
                                     f"{float(rel.max())} > 1e-6")
            err = max_abs_err(torch, ref, got)
            if B == MAIN_B and not gain:
                errs["link_geometry"] = err
            log(f"  link_geometry B={B} gain={gain}: dist/threshold bitwise,"
                f" rate max rel {float(rel.max()):.3g}, max abs err {err}")
    for B in (MAIN_B, 4096):
        for ties in (False, True):
            args = dp_inputs(np, torch, 2, B, REQUESTS, L_ALEXNET, U, ties,
                             device)
            got = tropical_dp_step(*args)
            ref = dp_step_ref(*args)
            torch.cuda.synchronize()
            for name, a, b in zip(("row", "pa", "ps"), ref, got):
                if not torch.equal(a, b):
                    raise AssertionError(f"tropical_dp {name} differs "
                                         f"(B={B}, ties={ties})")
            n_dead = int(torch.isinf(got[0]).sum())
            err = max_abs_err(torch, ref[:1], got[:1])
            if B == MAIN_B and not ties:
                errs["tropical_dp"] = err
            log(f"  tropical_dp B={B} ties={ties}: row/pa/ps bitwise "
                f"({n_dead} all-inf outputs)")
    return errs


def alexnet_fleet(torch, device, p2, seed, frames):
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.rollout import PositionSpec, RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import PlanFnCache
    spec = RolloutSpec(frames=frames, requests_per_frame=REQUESTS,
                       jitter_sigma_m=2.0, failure_prob=0.05,
                       recovery_prob=0.3, battery_j=5e3)
    return FleetRollout(RadioChannel(), make_devices(U), cnn_cost(ALEXNET),
                        spec, plan_cache=PlanFnCache(),
                        position_spec=PositionSpec(steps=30, repair_iters=25)
                        if p2 else None, seed=seed, device=device)


def check_small_rollout(np, torch, device):
    """The card's rollout against the CPU's plain path, same seed."""
    from repro_torch.core.positions import hex_init
    base = hex_init(U, 40.0, jitter=0.5, seed=1)
    r_gpu = alexnet_fleet(torch, device, p2=False, seed=3, frames=4).run(
        base, n_trajectories=16)
    r_cpu = alexnet_fleet(torch, "cpu", p2=False, seed=3, frames=4).run(
        base, n_trajectories=16)
    for f in ("feasible", "cap_feasible", "assign", "active", "n_requests"):
        if not np.array_equal(getattr(r_gpu, f), getattr(r_cpu, f)):
            raise AssertionError(f"small rollout: {f} differs GPU vs CPU")
    for f in ("latency", "total_power", "source_latency", "positions",
              "charge", "energy_tx", "energy_cmp"):
        np.testing.assert_allclose(getattr(r_gpu, f), getattr(r_cpu, f),
                                   rtol=1e-5, atol=0, err_msg=f)
    log(f"  small rollout (B=16, T=4): GPU == CPU plain path; "
        f"feasibility {r_gpu.feasibility_rate}")


def without_sync(torch, fn, args):
    """``fn(*args)`` with PyTorch's sync debug mode set to raise."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def run_main_path(np, torch, device):
    from repro_torch import kernels
    from repro_torch.core.positions import hex_init
    from repro_torch.runtime.scenario_engine import ScenarioGenerator
    fleet = alexnet_fleet(torch, device, p2=True, seed=0, frames=MAIN_T)
    base = hex_init(U, 40.0, jitter=0.5, seed=0)
    # warm-up; it also proves the frame loop never makes the host wait for
    # the card: any synchronising call inside it raises
    built = fleet._rollout
    fleet._rollout = lambda *inputs: without_sync(torch, built, inputs)
    t0 = time.perf_counter()
    fleet.run(base, n_trajectories=MAIN_B)
    warm_s = time.perf_counter() - t0
    fleet._rollout = built
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    trace = fleet.run(base, n_trajectories=MAIN_B)         # ends on host
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {"link_geometry": MAIN_T, "tropical_dp": MAIN_T * L_ALEXNET,
            "conv2d": 0}
    if launches != want:
        raise AssertionError(f"rollout launches {launches} != {want}")
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    lat = trace.latency
    if lat.shape != (MAIN_B, MAIN_T) or \
            trace.assign.shape != (MAIN_B, MAIN_T, U, L_ALEXNET):
        raise AssertionError("rollout trace shapes")
    if not trace.feasibility_rate > 0:
        raise AssertionError("no feasible frame in the main rollout")
    feas = trace.feasible
    if not (np.isfinite(lat[feas]).all() and
            np.isfinite(trace.total_power).all() and
            np.isfinite(trace.positions).all() and
            (trace.total_power[feas] >= 0).all()):
        raise AssertionError("non-finite values in the main rollout")
    used = trace.assign[feas]
    if not ((used >= -1) & (used < U)).all():
        raise AssertionError("assignments out of range")
    d = np.sqrt(((trace.positions[..., :, None, :] -
                  trace.positions[..., None, :, :]) ** 2).sum(-1))
    d[..., np.eye(U, dtype=bool)] = np.inf
    min_sep = float(d.min())
    if min_sep < 40.0 - 0.5:          # eq. (8d) after P2's repair: d >= 2R
        raise AssertionError(f"UAVs {min_sep} m apart, under 2R = 40 m")
    spread = sorted({int(x) for x in np.unique(used) if x >= 0})
    p50, p95 = trace.latency_percentile(50), trace.latency_percentile(95)
    log(f"  rollout AlexNet U={U} B={MAIN_B} T={MAIN_T} RQ={REQUESTS} "
        f"P2(30 steps, 25 repairs): launches {launches}")
    log(f"  feasibility {trace.feasibility_rate:.6f}  latency p50 {p50:.6f}"
        f" s  p95 {p95:.6f} s  mean {trace.mean_latency:.6f} s")
    log(f"  UAVs hosting layers: {spread}; min pairwise distance "
        f"{min_sep:.3f} m (2R = 40 m)")
    log("  frame loop: no host synchronisation (sync debug mode 'error')")
    log(f"  rollout wall: first run {warm_s:.3f} s, steady {wall_s:.3f} s "
        f"({MAIN_B * MAIN_T / wall_s:.1f} trajectory-frames/s); "
        f"peak device memory {peak_mb:.1f} MiB")

    gen = ScenarioGenerator(base, pos_sigma_m=2.0, failure_prob=0.05,
                            seed=0)
    batch = gen.draw(MAIN_B)
    n_req = np.random.default_rng(0).multinomial(
        REQUESTS, np.full(U, 1.0 / U), size=MAIN_B)
    fleet.plan_batch_multi(batch, n_req)                    # builds + warms
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    plan = fleet.plan_batch_multi(batch, n_req)
    plan_s = time.perf_counter() - t0
    plan_launches = kernels.launch_counts()
    want = {"link_geometry": 1, "tropical_dp": L_ALEXNET, "conv2d": 0}
    if plan_launches != want:
        raise AssertionError(f"plan_batch_multi launches {plan_launches} "
                             f"!= {want}")
    if not plan.n_feasible > 0 or not np.isfinite(
            plan.latency[plan.feasible]).all():
        raise AssertionError("plan_batch_multi: no feasible plan")
    log(f"  plan_batch_multi B={MAIN_B}: launches {plan_launches}, "
        f"feasible {plan.n_feasible}/{MAIN_B}, p50 "
        f"{plan.latency_percentile(50):.6f} s, wall {plan_s:.4f} s")
    return launches


def time_ms(torch, fn, iters, graph):
    """Per-call time on the card from CUDA events: over a CUDA graph of
    ``iters`` calls replayed (device time, no host dispatch), or over
    ``iters`` eager back-to-back calls (what a Python caller sees)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
    else:
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(np, torch, params, device, launches, errs):
    from repro_torch.kernels.link_geometry.link_geometry import link_geometry
    from repro_torch.kernels.link_geometry.ref import link_geometry_ref
    from repro_torch.kernels.tropical_dp.ref import dp_step_ref
    from repro_torch.kernels.tropical_dp.tropical_dp import tropical_dp_step
    B, M, L, S = MAIN_B, REQUESTS, L_ALEXNET, U
    pos, active, _ = geometry_inputs(np, torch, 5, B, False, device)
    act_f = active.float()
    geo_bytes = 4 * (B * U * 2 + B * U + 3 * B * U * U)
    geo_ops = 18 * B * U * U     # per link: dist 6, gain 3, threshold 2,
    #                              row max 2, rate 5
    dp_args = dp_inputs(np, torch, 6, B, M, L, S, False, device)
    dp_bytes = 4 * (B * M * L * (S + 1) + B * L * S * (S + 1) + B * M * S
                    + 2 * L * S + 3 * B * M * S)
    dp_ops = B * M * S * (L * (S + 1) * 2 + 3 * L)   # add+compare per s0,
    #                                                   add, mask, compare per a
    rows = []
    cases = [
        ("link_geometry", "src/repro_torch/csrc/link_geometry.cu",
         "src/repro/kernels/link_geometry/link_geometry.py:119",
         lambda: link_geometry(pos, act_f, None, params=params),
         lambda: link_geometry_ref(pos, active, None, params=params),
         geo_bytes, geo_ops),
        ("tropical_dp", "src/repro_torch/csrc/tropical_dp.cu",
         "src/repro/kernels/tropical_dp/tropical_dp.py:86",
         lambda: tropical_dp_step(*dp_args),
         lambda: dp_step_ref(*dp_args), dp_bytes, dp_ops),
    ]
    for name, source, replaces, kern, plain, nbytes, nops in cases:
        ms = time_ms(torch, kern, 200, graph=True)
        plain_ms = time_ms(torch, plain, 50, graph=True)
        eager_ms = time_ms(torch, kern, 200, graph=False)
        plain_eager_ms = time_ms(torch, plain, 50, graph=False)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "eager_ms": eager_ms,
            "plain_eager_ms": plain_eager_ms, "bytes": nbytes,
            "operations": nops})
        log(f"  {name}: {ms * 1e3:.2f} us/launch in a graph, "
            f"{eager_ms * 1e3:.2f} us eager; plain {plain_ms * 1e3:.2f} us "
            f"(graph), {plain_eager_ms * 1e3:.2f} us eager; bound "
            f"{max(t_bytes, t_ops) * 1e3:.4f} us ({nbytes} B, {nops} ops)")
    return rows


# ---------------------------------------------------------------------------
# the CNN path: conv2d kernel, LLHR planner, placement-sliced AlexNet
# ---------------------------------------------------------------------------


def conv_layers(batch):
    """AlexNet's conv layers at ``batch``: (name, spec, input NHWC shape,
    GEMM (M, K, N))."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.models.cnn import layer_shapes
    return [(spec.name, spec, x_shape,
             (y_shape[0] * y_shape[1] * y_shape[2],
              spec.kernel ** 2 * x_shape[3], y_shape[3]))
            for spec, (x_shape, y_shape) in zip(
                ALEXNET.layers, layer_shapes(ALEXNET, batch))
            if spec.kind == "conv"]


def gemm_inputs(np, torch, seed, m, k, n, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n, dtype=np.float32)
    return [torch.as_tensor(a, device=device) for a in (x, w, b)]


def check_fp32(torch):
    """Every comparison below is in full float32: no TF32 anywhere."""
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32 is not False:
        raise AssertionError("float32 matmul precision is not 'highest'")


def check_conv2d_kernel(np, torch, device):
    """``matmul_bias_act`` against ``matmul_ref`` at AlexNet's five conv
    GEMMs (batch 32 and 1) and ragged shapes, relu on and off, atol 5e-4
    rtol 1e-3; two launches bitwise equal; ``conv2d`` against
    ``conv2d_ref`` at the five conv layers.  Returns the max abs error at
    conv2, batch 32."""
    from repro_torch.kernels.conv2d.conv2d import matmul_bias_act
    from repro_torch.kernels.conv2d.ops import conv2d
    from repro_torch.kernels.conv2d.ref import conv2d_ref, matmul_ref
    check_fp32(torch)
    cases = [(f"{name} N={bs}", mkn, True) for bs in (MAIN_N_IMG, 1)
             for name, _, _, mkn in conv_layers(bs)]
    cases += [(f"ragged {m}x{k}x{n}", (m, k, n), relu)
              for m, k, n in ((1, 363, 96), (1, 17, 5), (67, 2401, 33),
                              (130, 1, 257)) for relu in (True, False)]
    conv2_err = None
    for i, (label, (m, k, n), relu) in enumerate(cases):
        x, w, b = gemm_inputs(np, torch, 10 + i, m, k, n, device)
        got = matmul_bias_act(x, w, b, relu=relu)
        again = matmul_bias_act(x, w, b, relu=relu)
        ref = matmul_ref(x, w, b, relu=relu)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"matmul_bias_act {label}: two launches "
                                 f"differ")
        torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)
        err = float((got.double() - ref.double()).abs().max())
        if label == f"conv2 N={MAIN_N_IMG}":
            conv2_err = err
        log(f"  matmul_bias_act {label} (M={m} K={k} N={n}, relu={relu}): "
            f"max abs err {err:.3g}, two launches bitwise equal")
    rng = np.random.default_rng(20)
    for name, spec, shape, _ in conv_layers(MAIN_N_IMG):
        x = torch.as_tensor(rng.standard_normal(shape, dtype=np.float32),
                            device=device)
        fan_in = spec.kernel ** 2 * shape[-1]
        w = torch.as_tensor((rng.standard_normal(
            (spec.kernel, spec.kernel, shape[-1], spec.out_channels))
            / np.sqrt(fan_in)).astype(np.float32), device=device)
        b = torch.as_tensor(rng.standard_normal(spec.out_channels,
                                                dtype=np.float32),
                            device=device)
        got = conv2d(x, w, b, stride=spec.stride, padding=spec.padding)
        ref = conv2d_ref(x, w, b, stride=spec.stride, padding=spec.padding)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref, atol=5e-4, rtol=1e-3)
        log(f"  conv2d {name} {tuple(shape)} -> {tuple(got.shape)}: max abs "
            f"err {float((got - ref).abs().max()):.3g} against conv2d_ref")
    return conv2_err


def plan_cnn_path(np, torch, device, images):
    """``LLHRPlanner.plan`` (P2 200 steps on ``device``, P1/P3 on the
    host) for four AlexNet requests on eight UAVs with a fifth of the
    memory each; seeded parameters and ``images`` seeded 227 x 227 x 3
    images per request.  Returns (planner, plan, problems, params, xs,
    planning wall in s)."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.core.channel import RadioChannel
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.planner import LLHRPlanner
    from repro_torch.core.swarm import make_devices
    from repro_torch.models.cnn import init_cnn
    planner = LLHRPlanner(RadioChannel(), position_steps=200, device=device)
    t0 = time.perf_counter()
    plan, problems = planner.plan(cnn_cost(ALEXNET),
                                  make_devices(U, mem_frac=0.2),
                                  requests=list(range(REQUESTS)))
    plan_s = time.perf_counter() - t0
    params = init_cnn(ALEXNET, torch.Generator().manual_seed(0),
                      device=device)
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.standard_normal(
        (images, 227, 227, 3), dtype=np.float32), device=device)
        for _ in plan.placements]
    return planner, plan, problems, params, xs, plan_s


def serve(torch, params, xs, assigns, walls=None):
    """Each request's images through ``distributed_forward`` sliced by its
    placement, one request after another, each ending in a device
    synchronise; appends each request's wall (s) to ``walls``.  Returns
    [(logits, hand-offs)]."""
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.models.cnn import distributed_forward
    outs = []
    for x, a in zip(xs, assigns):
        t0 = time.perf_counter()
        outs.append(distributed_forward(ALEXNET, params, x, a))
        torch.cuda.synchronize()
        if walls is not None:
            walls.append(time.perf_counter() - t0)
    return outs


def serve_window(torch, params, xs, assigns, min_s):
    """Serve the requests again and again for at least ``min_s`` seconds.
    Returns images/s over the whole window, the number of serves, the
    images/s of each serve and every request's wall (s)."""
    walls, per_serve = [], []
    images = sum(x.shape[0] for x in xs)
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < min_s:
        t0 = time.perf_counter()
        serve(torch, params, xs, assigns, walls)
        per_serve.append(images / (time.perf_counter() - t0))
    window_s = time.perf_counter() - t_start
    return images * len(per_serve) / window_s, len(per_serve), per_serve, \
        walls


def run_cnn_path(np, torch, device):
    """The paper's distributed inference on the card: the LLHR plan, then
    each request's batch of 32 images through ``distributed_forward``
    sliced by its placement, counted once and then timed over a window of
    at least ``CNN_WINDOW_S``."""
    from repro_torch import kernels
    from repro_torch.configs.alexnet import ALEXNET
    from repro_torch.models.cnn import distributed_forward, forward
    check_fp32(torch)
    t0 = time.perf_counter()
    planner, plan, problems, params, xs, plan_s = plan_cnn_path(
        np, torch, device, MAIN_N_IMG)
    if not plan.feasible:
        raise AssertionError("CNN path: a request is infeasible")
    assigns = [s.assign for s in plan.placements]
    for r, a in enumerate(assigns):
        log(f"  request {r} (source UAV {r}): placement {a}, latency "
            f"{plan.placements[r].latency:.6f} s")
        if len(set(a)) < 2:
            raise AssertionError(f"request {r} runs on one UAV")
    parts = {k: float(v) for k, v in plan.latency_breakdown(problems).items()}
    log(f"  plan: total latency {plan.total_latency:.6f} s, power "
        f"{plan.total_power:.6f} W, breakdown {parts}, wall {plan_s:.3f} s "
        f"(P2 200 steps on the card); with parameters and inputs "
        f"{time.perf_counter() - t0:.2f} s")
    distributed_forward(ALEXNET, params, xs[0], assigns[0])      # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    outs = serve(torch, params, xs, assigns)
    launches = kernels.launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    n_conv = sum(s.kind == "conv" for s in ALEXNET.layers)
    want = {"link_geometry": 0, "tropical_dp": 0,
            "conv2d": n_conv * len(assigns)}
    if launches != want:
        raise AssertionError(f"CNN path launches {launches} != {want}")
    for r, ((y, hand), x, a) in enumerate(zip(outs, xs, assigns)):
        changes = sum(p != q for p, q in zip(a[:-1], a[1:]))
        if hand != changes:
            raise AssertionError(f"request {r}: {hand} hand-offs, placement "
                                 f"has {changes} device changes")
        if y.shape != (MAIN_N_IMG, 1000) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"request {r}: bad logits {tuple(y.shape)}")
        if not torch.equal(y, forward(ALEXNET, params, x)):
            raise AssertionError(f"request {r}: sliced forward != monolithic")
    log(f"  served {len(assigns)} requests x {MAIN_N_IMG} images: launches "
        f"{launches}; sliced == monolithic bitwise; hand-offs "
        f"{[h for _, h in outs]}; peak device memory {peak_mb:.1f} MiB")
    rate, n_serves, per_serve, walls = serve_window(torch, params, xs,
                                                    assigns, CNN_WINDOW_S)
    walls_ms = sorted(w * 1e3 for w in walls)
    cnn = {"images_per_s": rate, "serves": n_serves,
           "images_per_serve": len(assigns) * MAIN_N_IMG,
           "serve_images_per_s_min": min(per_serve),
           "serve_images_per_s_max": max(per_serve),
           "request_ms_min": walls_ms[0],
           "request_ms_median": walls_ms[len(walls_ms) // 2],
           "request_ms_max": walls_ms[-1], "peak_mib": peak_mb,
           "plan_s": plan_s}
    log(f"  timed window: {n_serves} serves of {len(assigns)} requests x "
        f"{MAIN_N_IMG} images, {rate:.1f} images/s over the window (per "
        f"serve {min(per_serve):.1f} to {max(per_serve):.1f}); wall per "
        f"request min {walls_ms[0]:.4f} median "
        f"{walls_ms[len(walls_ms) // 2]:.4f} max {walls_ms[-1]:.4f} ms")

    dead = assigns[0][0]
    re_plan, _ = planner.replan_on_failure(plan, problems, dead)
    if not re_plan.feasible:
        raise AssertionError(f"replan without UAV {dead} is infeasible")
    re_assign = re_plan.placements[0].assign
    y_re, _ = distributed_forward(ALEXNET, params, xs[0], re_assign)
    if not torch.equal(y_re, outs[0][0]):
        raise AssertionError("replanned sliced forward != monolithic")
    log(f"  replan without UAV {dead}: feasible, request 0 now "
        f"{re_assign} (survivor indices), latency "
        f"{re_plan.placements[0].latency:.6f} s; its sliced forward equals "
        f"the monolithic one")

    # the same path small, card against the CPU plain path
    params_cpu = [{k: v.cpu() for k, v in p.items()} for p in params]
    x2 = xs[0][:2]
    y_gpu, _ = distributed_forward(ALEXNET, params, x2, assigns[0])
    y_cpu, _ = distributed_forward(ALEXNET, params_cpu, x2.cpu(), assigns[0])
    torch.testing.assert_close(y_gpu.cpu(), y_cpu, atol=5e-4, rtol=1e-3)
    log(f"  N=2 logits, card against the CPU plain path: max abs err "
        f"{float((y_gpu.cpu() - y_cpu).abs().max()):.3g}")
    return launches, cnn


def time_conv2d(np, torch, device, launches, conv2_err):
    """``matmul_bias_act`` at AlexNet's five conv GEMMs, batch 32, beside
    its plain version, ``torch.addmm`` and the bound.  Returns the
    per-layer rows and the ``kernels`` row at conv2."""
    from repro_torch.kernels.conv2d.conv2d import matmul_bias_act
    from repro_torch.kernels.conv2d.ref import matmul_ref
    layers = []
    for i, (name, _, _, (m, k, n)) in enumerate(conv_layers(MAIN_N_IMG)):
        x, w, b = gemm_inputs(np, torch, 30 + i, m, k, n, device)
        nbytes = 4 * (m * k + k * n + n + m * n)
        nops = 2 * m * n * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        row = {"layer": name, "M": m, "K": k, "N": n,
               "ms": time_ms(torch, lambda: matmul_bias_act(x, w, b),
                             CONV_ITERS, graph=True),
               "eager_ms": time_ms(torch, lambda: matmul_bias_act(x, w, b),
                                   CONV_ITERS, graph=False),
               "plain_ms": time_ms(torch, lambda: matmul_ref(x, w, b),
                                   CONV_ITERS, graph=True),
               "plain_eager_ms": time_ms(torch, lambda: matmul_ref(x, w, b),
                                         CONV_ITERS, graph=False),
               "library_ms": time_ms(torch, lambda: torch.addmm(b, x, w),
                                     CONV_ITERS, graph=True),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes, "operations": nops}
        row["tflops"] = nops / row["ms"] / 1e9
        layers.append(row)
        log(f"  {name} M={m} K={k} N={n}: kernel {row['ms']:.4f} ms (graph),"
            f" {row['eager_ms']:.4f} ms eager, {row['tflops']:.2f} TFLOP/s; "
            f"plain {row['plain_ms']:.4f} ms ({row['plain_eager_ms']:.4f} "
            f"eager); torch.addmm (GEMM + bias, no "
            f"ReLU) {row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} "
            f"ms ({row['bound_by']})")
    c2 = next(r for r in layers if r["layer"] == "conv2")
    kernel_row = {
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d/conv2d.py:50",
        "launches": launches["conv2d"], "max_abs_err": conv2_err,
        "ms": c2["ms"], "plain_ms": c2["plain_ms"],
        "bound_ms": c2["bound_ms"], "bound_by": c2["bound_by"],
        "library_ms": c2["library_ms"], "eager_ms": c2["eager_ms"],
        "plain_eager_ms": c2["plain_eager_ms"],
        "shape": [c2["M"], c2["K"], c2["N"]], "bytes": c2["bytes"],
        "operations": c2["operations"]}
    return layers, kernel_row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.channel import RadioParams
    from repro_torch.kernels import _build

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build(_build.sources())
    log(f"[2] kernels built in {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in built.items())})")
    for name in _build.sources():
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    params = RadioParams()
    log("[3] kernels against their plain versions on the card")
    errs = check_kernels(np, torch, params, device)
    log("[4] small rollout: card against the CPU plain path")
    check_small_rollout(np, torch, device)
    log("[5] main path")
    launches = run_main_path(np, torch, device)
    log("[6] kernel times (CUDA events)")
    rows = time_kernels(np, torch, params, device, launches, errs)
    log("[7] conv2d kernel against its plain version on the card")
    conv2_err = check_conv2d_kernel(np, torch, device)
    log("[8] CNN path: LLHR plan, then placement-sliced AlexNet")
    cnn_launches, cnn = run_cnn_path(np, torch, device)
    log("[9] conv2d kernel times (CUDA events), batch 32")
    layers, conv_row = time_conv2d(np, torch, device, cnn_launches,
                                   conv2_err)
    rows.append(conv_row)

    print(json.dumps({"cnn_path": cnn}))
    print(json.dumps({"conv2d_layers": layers}))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
