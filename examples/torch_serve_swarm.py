"""Serving demo through the PyTorch port (the counterpart of
``examples/serve_swarm.py``): continuous batching over a small LM on the
card, with the LLHR planner choosing the pipeline-stage placement the way
the paper places CNN layers on UAVs (here: transformer blocks on
pipeline stage groups of H100s).

    PYTHONPATH=src python3 examples/torch_serve_swarm.py [--device cpu]

The LM is ``serve-lm`` (float32, 4 layers, d 256, GQA 4 / 2 heads of
64), served through ``ContinuousBatcher`` on the flash- and
decode-attention kernels.  Its decode stack is planned onto 2 stages of
8 chips each.  The chip is the card: its name and memory read from it,
its MAC rate half the H100 SXM's dense bf16 peak (NVIDIA's data sheet).
Stages are joined by NVLink at the data sheet's rate.  The hop latency,
the topology and the cross-host rate have no data-sheet figure: they are
this script's assumptions (the first two also ``--hop-latency-s`` and
``--torus``), printed as such.  ``--chip-macs`` / ``--chip-hbm-bytes``
/ ``--link-bytes`` replace the card's figures; on the CPU, which has no
card, the chip's two are required.

``--chaos`` drives the live recovery path: a one-crash ``FaultSchedule``
feeds heartbeats into the health tracker while a ``ReplanController``
watches the SLO; the crashed UAV must time out, the armed contingency
table must answer, and the loop must end recovered.

    PYTHONPATH=src python3 examples/torch_serve_swarm.py --chaos

``--stream`` drives the deadline-aware streaming gateway: an open-loop
arrival stream (plus an injected flood and a device stall past the retry
cap) flows through bounded admission into the rollout; the demo must
shed deterministically, degrade, and recover.

    PYTHONPATH=src python3 examples/torch_serve_swarm.py --stream
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import (ArchConfig, AttentionConfig, DECODE_32K,
                                      ServeConfig)
from repro_torch.core.channel import ICIChannel, ICIParams
from repro_torch.core.pipeline_opt import (H100_SXM_NVLINK_BYTES_ONE_WAY,
                                           ChipParams, card_chip,
                                           plan_pipeline)
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.serve_loop import ContinuousBatcher, Request

#: the interconnect figures no data sheet gives: this script's assumptions
HOP_LATENCY_S = 2e-6             # one NVLink hop, switch included
TORUS = (4, 4)                   # 16 stage groups, adjacent ones one hop apart
DCN_BYTES = 400e9 / 8            # one 400 Gb/s network port a card


def synced_wall(device, fn):
    """``fn()`` and its wall time in seconds, the device drained on both
    sides of the clock."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def planner_constants(args, device):
    """(chip, interconnect, where each figure comes from)."""
    card = None
    if args.chip_macs is None or args.chip_hbm_bytes is None:
        if device.type != "cuda":
            raise SystemExit("the CPU has no card to read: pass --chip-macs "
                             "and --chip-hbm-bytes")
        card = card_chip(device)
    chip = ChipParams(
        card.name if card else "chip",
        card.macs_per_s if args.chip_macs is None else args.chip_macs,
        card.hbm_bytes if args.chip_hbm_bytes is None
        else args.chip_hbm_bytes)
    link = H100_SXM_NVLINK_BYTES_ONE_WAY if args.link_bytes is None \
        else args.link_bytes
    ici = ICIChannel(ICIParams(link_bw_bytes=link,
                               hop_latency_s=args.hop_latency_s,
                               torus=tuple(args.torus),
                               dcn_bw_bytes=DCN_BYTES))
    given = "given on the command line"
    sources = {
        "chip_macs": given if args.chip_macs is not None else
        "H100 SXM data sheet: dense bf16 989 TFLOP/s, halved",
        "chip_hbm_bytes": given if args.chip_hbm_bytes is not None
        else "the card's total_memory",
        "link_bytes": given if args.link_bytes is not None else
        "H100 SXM data sheet: NVLink 900 GB/s both ways, one way"}
    return chip, ici, sources


def main_lm(args, device) -> dict:
    cfg = ArchConfig(
        name="serve-lm", family="dense", n_layers=4, d_model=256,
        d_ff=768, vocab_size=2048,
        attention=AttentionConfig(n_heads=4, n_kv_heads=2, head_dim=64),
        tie_embeddings=True, dtype="float32")
    model = build_model(cfg, device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    print(f"serving {cfg.name} ({cfg.n_params / 1e6:.1f}M params)")

    # LLHR placement of the decode stack (the paper's P3 on serve costs)
    chip, ici, sources = planner_constants(args, device)
    p = ici.params
    print(f"planner constants: chip {chip.name}, {chip.macs_per_s:.6g} MAC/s "
          f"({sources['chip_macs']}), {chip.hbm_bytes:.6g} B "
          f"({sources['chip_hbm_bytes']}); link {p.link_bw_bytes:.6g} B/s "
          f"({sources['link_bytes']}); assumed: hop {p.hop_latency_s:.6g} "
          f"s, torus {p.torus}, cross-host {p.dcn_bw_bytes:.6g} B/s")
    plan = plan_pipeline(cfg, DECODE_32K, n_stages=2, chips_per_stage=8,
                         chip=chip, ici=ici)
    print(f"LLHR decode placement: blocks/stage={plan.blocks_per_stage} "
          f"period={plan.bottleneck_s * 1e6:.1f}us "
          f"coords={plan.stage_coords}")

    scfg = ServeConfig(max_batch=4, max_seq=96)
    batcher = ContinuousBatcher(model, cfg, scfg, params)
    calls = {"prefill": 0, "decode": 0}
    for kind in calls:
        step = getattr(batcher, kind + "_step")

        def counted(*a, kind=kind, step=step):
            calls[kind] += 1
            return step(*a)
        setattr(batcher, kind + "_step", counted)
    rng = np.random.default_rng(0)
    n_req = 8
    for rid in range(n_req):
        prompt = [int(x) for x in rng.integers(2, cfg.vocab_size,
                                               size=rng.integers(4, 12))]
        batcher.submit(Request(rid, prompt=prompt, max_new=12))
    done, dt = synced_wall(device, lambda: batcher.run(max_steps=2000))
    tokens = sum(len(r.out) for r in done)
    print(f"completed {len(done)}/{n_req} requests, {tokens} tokens "
          f"in {dt:.3f}s ({tokens / dt:.1f} tok/s on {device}); "
          f"{calls['prefill']} prefill calls, {calls['decode']} decode steps")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt[:4]={r.prompt[:4]} -> "
              f"out[:8]={r.out[:8]}")
    assert len(done) == n_req
    return {"n_params": cfg.n_params, "n_layers": cfg.n_layers, "plan": plan,
            "chip": chip, "ici": p, "sources": sources,
            "completed": len(done), "tokens": tokens, "wall_s": dt,
            "prefill_calls": calls["prefill"],
            "decode_steps": calls["decode"]}


def main_chaos(device) -> dict:
    """One-crash chaos schedule through the live serve-loop recovery
    path: schedule -> heartbeats -> timeout -> contingency delegation."""
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.channel import RadioChannel, RadioParams
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.rollout import RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.chaos import ChaosHostDriver, FaultSchedule
    from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                     HealthTracker)
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.scenario_engine import (ContingencyTable,
                                                     PlanFnCache,
                                                     ScenarioEngine,
                                                     ScenarioGenerator)
    from repro_torch.runtime.serve_loop import (PeriodicReplanner,
                                                ReplanController,
                                                ServiceLevelObjective)

    U, T = 5, 12
    cache = PlanFnCache()
    devs = make_devices(U, mem_frac=2e-4)        # forced chain split
    mc = cnn_cost(LENET)
    ch = RadioChannel(RadioParams())
    base = hex_init(U, 40.0, jitter=0.5, seed=1)
    names = [d.name for d in devs]

    engine = ScenarioEngine(ch, devs, mc, plan_cache=cache, device=device)
    table = ContingencyTable(engine, base, source=0)
    tracker = HealthTracker(names, timeout_s=2.5, now=0.0)
    runner = FaultTolerantRunner(devs, lambda d: {"n": len(d)}, ".",
                                 contingency=table, health=tracker)
    rollout = FleetRollout(ch, devs, mc, RolloutSpec(frames=4),
                           plan_cache=cache, seed=0, device=device)
    replanner = PeriodicReplanner(
        engine, ScenarioGenerator(base, pos_sigma_m=1.0, seed=0),
        period=4, n_scenarios=4, rollout=rollout, rollout_horizon=4,
        rollout_trajectories=4)
    controller = ReplanController(
        replanner, ServiceLevelObjective(min_horizon_feasibility=0.25),
        runner=runner)

    schedule = FaultSchedule(U, T, seed=0).crash(frame=4, uav=2)
    host = ChaosHostDriver(schedule, tracker, base, frame_s=1.0)
    print(f"chaos: {U} UAVs, crash of uav2 at frame 4, "
          f"timeout {tracker.timeout}s, on {device}")
    t0 = time.perf_counter()
    for t in range(T):
        now = host.play_frame(t)
        controller.step(t, now=now)
    wall = time.perf_counter() - t0
    m = controller.metrics()
    failures = [e for e in runner.events if e["kind"] == "failure"]
    events = [(e["kind"], e.get("dead")) for e in runner.events]
    print(f"events: {events}")
    print(f"recovered: mode={controller.mode} unrecovered="
          f"{m['n_unrecovered']} mttr={m['mttr_frames']:.1f} frames "
          f"churn={m['generation_churn']} retraces={replanner.retraces}")
    assert failures and failures[0]["precomputed"], \
        "the armed contingency table must answer the crash"
    assert [d.name for d in runner.state.devices] == \
        [n for n in names if n != "uav2"]
    assert controller.mode == controller.NOMINAL and \
        m["n_unrecovered"] == 0, "loop must end recovered"
    assert replanner.retraces == 0
    print("chaos run recovered through the contingency path")
    return {"events": events, "mode": controller.mode,
            "metrics": m, "retraces": replanner.retraces,
            "refreshes": replanner.refreshes, "wall_s": wall}


def main_stream(device) -> dict:
    """Live streaming demo: an open-loop arrival stream floods the
    deadline-aware gateway while an injected device stall burns through
    the retry cap; the gateway must shed deterministically, fall into
    degraded admission, then recover on the next healthy window."""
    from repro_torch.configs.lenet import LENET
    from repro_torch.core.channel import RadioChannel, RadioParams
    from repro_torch.core.cost_model import cnn_cost
    from repro_torch.core.positions import hex_init
    from repro_torch.core.rollout import RolloutSpec
    from repro_torch.core.swarm import make_devices
    from repro_torch.runtime.chaos import FaultSchedule
    from repro_torch.runtime.fleet_rollout import FleetRollout
    from repro_torch.runtime.gateway import (GatewayConfig, LoadGenerator,
                                             StreamingGateway)
    from repro_torch.runtime.scenario_engine import PlanFnCache

    U, T, W = 4, 4, 5                     # UAVs, frames/window, windows
    cache = PlanFnCache()
    devs = make_devices(U, mem_frac=2e-4)        # forced chain split
    base = hex_init(U, 40.0, jitter=0.5, seed=1)
    rollout = FleetRollout(
        RadioChannel(RadioParams()), devs, cnn_cost(LENET),
        RolloutSpec(frames=T, requests_per_frame=3, recovery_prob=0.5),
        plan_cache=cache, seed=0, device=device)

    # window 1 stalls past the retry cap (-> degraded admission); windows
    # 2-3 offer a 3x arrival flood the bounded queue must shed through
    schedule = (FaultSchedule(U, T * W, seed=0)
                .device_stall(T, attempts=3)
                .arrival_flood(2 * T, 3.0, frames=2 * T))
    gw = StreamingGateway(
        rollout, base,
        GatewayConfig(window_frames=T, frame_s=1.0, queue_capacity=16,
                      frame_capacity=3, retry_base_backoff_s=0.001,
                      max_attempts=2),
        schedule=schedule, seed=0)
    gen = LoadGenerator(U, kind="poisson", rate=2.0, deadline_s=6.0,
                        seed=3, priorities=(0, 1),
                        priority_weights=(0.3, 0.7))
    print(f"stream: {U} UAVs, {W} windows x {T} frames, stall at window "
          f"1 (cap 2 attempts), 3x flood from frame {2 * T}, on {device}")
    windows = []
    t0 = time.perf_counter()
    for w in range(W):
        rep = gw.serve(gen, n_windows=1, drain=(w == W - 1))
        windows.append((rep["submitted"], rep["served"], rep["shed"],
                        gw.backpressure, gw.degraded))
        print(f"  window {w}: submitted={rep['submitted']} "
              f"served={rep['served']} shed={rep['shed']} "
              f"backpressure={gw.backpressure:.2f} "
              f"degraded={gw.degraded}")
    wall = time.perf_counter() - t0
    rep = gw.report()
    gw.close()
    print(f"stream: hit_rate={rep['deadline_hit_rate']:.3f} "
          f"p99={rep['latency_p99_s']:.1f}s retries={rep['retries']} "
          f"device_failures={rep['device_failures']} "
          f"windows_failed={rep['windows_failed']}")
    assert rep["device_failures"] == 1, "the stalled window must exhaust"
    assert not gw.degraded, "a healthy window must clear degraded mode"
    assert rep["served"] > 0 and rep["deadline_hit_rate"] == 1.0
    assert rep["served"] + rep["shed_total"] == rep["submitted"]
    print("stream demo recovered: flood shed at admission, stall shed at "
          "the retry cap, healthy windows served on time")
    return {"windows": windows, "report": rep, "wall_s": wall,
            "rollout_builds": rollout.build_count}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--chaos", action="store_true",
                    help="run the one-crash chaos recovery demo instead "
                         "of the LM serving demo")
    ap.add_argument("--stream", action="store_true",
                    help="run the streaming-gateway flood/stall recovery "
                         "demo instead of the LM serving demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--chip-macs", type=float, default=None,
                    help="a chip's MAC/s (default: the card's)")
    ap.add_argument("--chip-hbm-bytes", type=float, default=None,
                    help="a chip's memory in bytes (default: the card's)")
    ap.add_argument("--link-bytes", type=float, default=None,
                    help="link rate in bytes/s (default: H100 SXM NVLink, "
                         "one way)")
    ap.add_argument("--hop-latency-s", type=float, default=HOP_LATENCY_S)
    ap.add_argument("--torus", type=int, nargs=2, default=TORUS)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.chaos:
        return main_chaos(device)
    if args.stream:
        return main_stream(device)
    return main_lm(args, device)


if __name__ == "__main__":
    main()
