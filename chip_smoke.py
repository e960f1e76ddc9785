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
   bound at the published H100 SXM peaks.

The last two lines are the ``nvidia-smi`` line and the result object.
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
    want = {"link_geometry": MAIN_T, "tropical_dp": MAIN_T * L_ALEXNET}
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
    want = {"link_geometry": 1, "tropical_dp": L_ALEXNET}
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

    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
