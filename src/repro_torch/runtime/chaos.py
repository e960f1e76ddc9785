"""Chaos harness: ONE seeded, replayable fault scenario that stresses both
halves of the robustness stack (the reference's ``runtime/chaos.py``;
host numpy, so its three compile targets are bitwise the reference's).

The paper's premise is reliability under failure — UAVs die, links fade,
batteries drain — but mechanisms that are never stressed are mechanisms
that don't work.  A ``FaultSchedule`` composes scripted and stochastic
fault events and compiles the SAME schedule into two synchronized views:

* ``rollout_inputs`` — the device-side view: a ``forced [T, B, U]``
  injection tensor (crashes and correlated bursts), per-frame link-gain
  fades ``gain_scale [T, B, U, U]`` and scripted battery drops
  ``extra_drain [T, B, U]``, ready to splat into ``FleetRollout.run`` —
  the whole scenario runs IN-TRACE, so the rollout's statistics
  (feasibility, latency, recovery frames) price exactly the injected
  faults;
* ``host_timeline`` — the host-side view: per-frame heartbeat /
  battery-telemetry / straggler events for one trajectory, which
  ``ChaosHostDriver`` feeds into a ``HealthTracker`` so the LIVE recovery
  loop (``FaultTolerantRunner`` delegation, ``ReplanController``
  escalation) is exercised by the same scenario.

Everything is deterministic in (schedule events, seed, B, positions):
stochastic members (burst cluster draws, Markov persistence, Bernoulli
crashes) use ``numpy`` child generators re-derived at compile time, so the
same schedule replays bitwise — the determinism tests rely on it.

Event vocabulary (all frames are rollout frame indices):

* ``crash(frame, uav)``          — scripted death from ``frame`` on
  (optionally for ``frames`` frames, after which Bernoulli recovery may
  revive the UAV if the ``RolloutSpec`` allows it).
* ``burst(frame, size)``         — CORRELATED burst failure: a spatially
  clustered group (the ``size`` UAVs nearest a drawn or given center) dies
  together at ``frame``, and each member stays forced-down with
  Markov persistence ``persistence`` per frame (geometric holding times,
  drawn independently per trajectory — exactly the correlated tail risk
  i.i.d. per-frame draws understate).
* ``link_fade(frame, db, ...)``  — multiplicative gain fade (dB) on every
  link touching ``uav``, or on one ``pair``, for ``frames`` frames.
* ``battery_drop(frame, uav, joules)`` — scripted charge loss.
* ``straggler(frame, uav, factor)``    — host-only: the UAV's reported
  step time inflates by ``factor`` from ``frame`` on (for ``frames``).
* ``silence(frame, uav)``        — host-only: heartbeats stop from
  ``frame`` on; the device keeps flying (a telemetry fault, not a crash).
* ``bernoulli(prob)``            — stochastic i.i.d. forced crashes per
  (frame, trajectory, UAV), on top of the scripted events.

Gateway-only events (consumed by ``runtime.gateway.StreamingGateway``
through the third compile target, ``gateway_timeline``; invisible to the
rollout tensors and the host heartbeat timeline):

* ``arrival_flood(frame, factor)`` — the open-loop load generator's
  offered rate is multiplied by ``factor`` for ``frames`` frames: an
  admission-side overload the bounded queues must absorb or shed.
* ``device_stall(frame, attempts)`` — the device call for the serving
  window containing ``frame`` fails its first ``attempts`` attempts
  (simulated stall/timeout), exercising the gateway's bounded
  retry + backoff + degradation path.
* ``clock_skew(frame, skew_s)``  — the gateway's admission clock is
  shifted by ``skew_s`` seconds over the span: submit stamps (and the
  deadlines derived from them) drift against the service clock.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class ChaosEvent:
    """One schedule entry; ``kind``-specific payload in the free fields."""

    kind: str                       # crash|burst|link_fade|battery_drop|
    #                                 straggler|silence|bernoulli
    frame: int
    uav: int = -1                   # -1 = drawn / not applicable
    frames: int = 0                 # duration; 0 = to the end of the run
    size: int = 0                   # burst cluster size
    value: float = 0.0              # dB, joules, factor, or probability
    pair: Optional[Tuple[int, int]] = None   # directed link for link_fade

    def key(self) -> tuple:
        return (self.kind, self.frame, self.uav, self.frames, self.size,
                self.value, self.pair)


@dataclass
class FrameEvents:
    """The host-side view of one frame of one trajectory."""

    frame: int
    down: Tuple[int, ...] = ()            # forced-dead UAVs (emit nothing)
    silent: Tuple[int, ...] = ()          # alive but heartbeat-silent
    straggler_factor: Dict[int, float] = field(default_factory=dict)
    battery_drop_j: Dict[int, float] = field(default_factory=dict)
    faded: Tuple[Tuple[int, int], ...] = ()   # links faded this frame


@dataclass
class GatewayFrameEvents:
    """The gateway-facing view of one frame of the compiled scenario."""

    frame: int
    flood_factor: float = 1.0       # offered-load multiplier (floods)
    stall_attempts: int = 0         # injected device-call failures
    skew_s: float = 0.0             # admission-clock offset (seconds)


class FaultSchedule:
    """A composable, seeded fault scenario over a (T frames, U UAVs) run.

    Builder methods append events and return ``self`` so schedules chain:

        sched = (FaultSchedule(n_uavs=8, frames=32, seed=7)
                 .burst(frame=8, size=3, persistence=0.7)
                 .link_fade(frame=4, uav=2, db=-15.0, frames=6)
                 .battery_drop(frame=12, uav=5, joules=2e3))
        trace = rollout.run(pos, n_trajectories=64,
                            **sched.rollout_inputs(64, pos))

    ``rollout_inputs``/``host_timeline`` are pure functions of the event
    list + seed (+ B, positions): compiling twice replays bitwise.
    """

    def __init__(self, n_uavs: int, frames: int, seed: int = 0):
        if n_uavs < 1 or frames < 1:
            raise ValueError("need at least one UAV and one frame")
        self.n_uavs = int(n_uavs)
        self.frames = int(frames)
        self.seed = int(seed)
        self.events: List[ChaosEvent] = []

    # -- builders ------------------------------------------------------
    def _check(self, frame: int, uav: Optional[int] = None) -> None:
        if not 0 <= frame < self.frames:
            raise ValueError(f"frame {frame} outside [0, {self.frames})")
        if uav is not None and not 0 <= uav < self.n_uavs:
            raise ValueError(f"uav {uav} outside [0, {self.n_uavs})")

    def crash(self, frame: int, uav: int,
              frames: int = 0) -> "FaultSchedule":
        """Scripted death of ``uav`` from ``frame`` (``frames`` frames;
        0 = to the end — permanent unless Bernoulli recovery revives it)."""
        self._check(frame, uav)
        self.events.append(ChaosEvent("crash", frame, uav=uav,
                                      frames=frames))
        return self

    def burst(self, frame: int, size: int, center: Optional[int] = None,
              persistence: float = 0.7,
              frames: int = 0) -> "FaultSchedule":
        """Correlated burst: the ``size`` UAVs nearest ``center`` (drawn
        from the schedule rng when None) die together at ``frame``; each
        stays forced-down with per-frame continuation probability
        ``persistence`` (geometric holding time, drawn per trajectory),
        truncated to ``frames`` when positive."""
        self._check(frame, center if center is not None else 0)
        if not 1 <= size <= self.n_uavs:
            raise ValueError(f"burst size {size} outside [1, {self.n_uavs}]")
        if not 0.0 <= persistence < 1.0:
            raise ValueError("persistence must be in [0, 1)")
        self.events.append(ChaosEvent(
            "burst", frame, uav=-1 if center is None else center,
            frames=frames, size=size, value=persistence))
        return self

    def link_fade(self, frame: int, db: float, uav: Optional[int] = None,
                  pair: Optional[Tuple[int, int]] = None,
                  frames: int = 1) -> "FaultSchedule":
        """Fade every link touching ``uav`` (or just the directed
        ``pair``) by ``db`` decibels for ``frames`` frames (0 = to the
        end).  Negative dB weakens the link."""
        if (uav is None) == (pair is None):
            raise ValueError("pass exactly one of uav or pair")
        self._check(frame, uav)
        if pair is not None:
            self._check(frame, pair[0])
            self._check(frame, pair[1])
        self.events.append(ChaosEvent(
            "link_fade", frame, uav=-1 if uav is None else uav,
            frames=frames, value=float(db),
            pair=None if pair is None else (int(pair[0]), int(pair[1]))))
        return self

    def battery_drop(self, frame: int, uav: int,
                     joules: float) -> "FaultSchedule":
        self._check(frame, uav)
        if joules < 0:
            raise ValueError("battery_drop joules must be nonnegative")
        self.events.append(ChaosEvent("battery_drop", frame, uav=uav,
                                      value=float(joules)))
        return self

    def straggler(self, frame: int, uav: int, factor: float = 3.0,
                  frames: int = 0) -> "FaultSchedule":
        """Host-only: ``uav``'s reported step time inflates by ``factor``
        from ``frame`` on (``frames`` frames; 0 = to the end)."""
        self._check(frame, uav)
        if factor <= 1.0:
            raise ValueError("straggler factor must exceed 1.0")
        self.events.append(ChaosEvent("straggler", frame, uav=uav,
                                      frames=frames, value=float(factor)))
        return self

    def silence(self, frame: int, uav: int,
                frames: int = 0) -> "FaultSchedule":
        """Host-only: heartbeats from ``uav`` stop from ``frame`` on —
        a telemetry fault the tracker must time out, while the rollout
        keeps the UAV flying."""
        self._check(frame, uav)
        self.events.append(ChaosEvent("silence", frame, uav=uav,
                                      frames=frames))
        return self

    def bernoulli(self, prob: float, start: int = 0,
                  stop: Optional[int] = None) -> "FaultSchedule":
        """Stochastic i.i.d. forced crashes: each (frame, trajectory, UAV)
        in [start, stop) is forced dead with probability ``prob``."""
        if not 0.0 <= prob <= 1.0:
            raise ValueError("prob must be in [0, 1]")
        self._check(start)
        self.events.append(ChaosEvent(
            "bernoulli", start, frames=(self.frames if stop is None
                                        else stop) - start, value=prob))
        return self

    def arrival_flood(self, frame: int, factor: float,
                      frames: int = 1) -> "FaultSchedule":
        """Gateway-only: multiply the open-loop load generator's offered
        rate by ``factor`` for ``frames`` frames (0 = to the end) — an
        arrival flood the admission queues must absorb or shed; the
        device never sees the overload directly."""
        self._check(frame)
        if factor <= 0.0:
            raise ValueError("flood factor must be positive")
        self.events.append(ChaosEvent("arrival_flood", frame, frames=frames,
                                      value=float(factor)))
        return self

    def device_stall(self, frame: int,
                     attempts: int = 1) -> "FaultSchedule":
        """Gateway-only: the device call for the serving window containing
        ``frame`` fails its first ``attempts`` attempts (a simulated
        stall / timeout) before succeeding — the gateway's bounded
        retry + exponential-backoff path must absorb it, or shed the
        window and degrade when ``attempts`` exceeds the retry cap."""
        self._check(frame)
        if attempts < 1:
            raise ValueError("device_stall needs at least one attempt")
        self.events.append(ChaosEvent("device_stall", frame,
                                      size=int(attempts)))
        return self

    def clock_skew(self, frame: int, skew_s: float,
                   frames: int = 0) -> "FaultSchedule":
        """Gateway-only: shift the gateway's admission clock by ``skew_s``
        seconds for ``frames`` frames (0 = to the end).  Submit stamps —
        and the absolute deadlines derived from them — drift against the
        service clock; shedding decisions stay deterministic."""
        self._check(frame)
        self.events.append(ChaosEvent("clock_skew", frame, frames=frames,
                                      value=float(skew_s)))
        return self

    # -- compilation helpers -------------------------------------------
    def key(self) -> tuple:
        """Hashable identity of the scenario (events + seed + shape)."""
        return (self.n_uavs, self.frames, self.seed,
                tuple(e.key() for e in self.events))

    def _span(self, e: ChaosEvent) -> Tuple[int, int]:
        """[start, stop) frame range of an event with a duration field."""
        stop = self.frames if e.frames <= 0 else min(self.frames,
                                                     e.frame + e.frames)
        return e.frame, stop

    def _event_rng(self, idx: int) -> np.random.Generator:
        """A child generator per (seed, event index): stochastic events
        replay identically however many times the schedule compiles."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, idx]))

    def burst_members(self, positions: np.ndarray) -> List[Tuple[int, ...]]:
        """The resolved (spatially clustered) member set of each burst
        event, in event order — who dies together, for tests and logs."""
        out = []
        for i, e in enumerate(self.events):
            if e.kind != "burst":
                continue
            out.append(tuple(self._cluster(e, i, np.asarray(positions))))
        return out

    def _cluster(self, e: ChaosEvent, idx: int,
                 positions: np.ndarray) -> np.ndarray:
        """The ``size`` UAVs nearest the burst center (center included):
        spatial correlation — a burst takes out a NEIGHBORHOOD, exactly
        what a local jammer / weather cell / collision does."""
        if positions.shape[0] != self.n_uavs:
            raise ValueError(
                f"positions are for {positions.shape[0]} UAVs, schedule "
                f"is for {self.n_uavs}")
        center = e.uav if e.uav >= 0 else \
            int(self._event_rng(idx).integers(self.n_uavs))
        d = np.linalg.norm(positions - positions[center], axis=-1)
        return np.argsort(d, kind="stable")[:e.size]

    # -- compile target (a): the device-side rollout -------------------
    def rollout_inputs(self, n_trajectories: int,
                       positions: np.ndarray) -> Dict[str, np.ndarray]:
        """Compile the schedule into ``FleetRollout.run`` keyword inputs:
        ``forced`` [T, B, U] (always), plus ``gain_scale`` [T, B, U, U]
        and ``extra_drain`` [T, B, U] only when fade / battery events
        exist (each selects a separately compiled scan)."""
        T, B, U = self.frames, int(n_trajectories), self.n_uavs
        positions = np.asarray(positions, np.float64)
        if positions.ndim == 3:          # per-trajectory starts: cluster
            positions = positions[0]     # on the shared nominal layout
        forced = np.zeros((T, B, U), dtype=bool)
        gain_db = None
        drain = None
        for i, e in enumerate(self.events):
            if e.kind == "crash":
                start, stop = self._span(e)
                forced[start:stop, :, e.uav] = True
            elif e.kind == "burst":
                members = self._cluster(e, i, positions)
                rng = self._event_rng(i)
                # Markov persistence: dead -> dead w.p. `value` per frame
                # => geometric holding times, independent per (b, member)
                hold = rng.geometric(max(1.0 - e.value, 1e-12),
                                     size=(B, members.size))
                if e.frames > 0:
                    hold = np.minimum(hold, e.frames)
                span = np.arange(T - e.frame)
                for j, u in enumerate(members):
                    live = span[None, :] < hold[:, j, None]   # [B, T-k]
                    forced[e.frame:, :, u] |= live.T
            elif e.kind == "link_fade":
                start, stop = self._span(e)
                if gain_db is None:
                    gain_db = np.zeros((T, U, U), np.float32)
                if e.pair is not None:
                    a, b = e.pair
                    gain_db[start:stop, a, b] += e.value
                else:
                    gain_db[start:stop, e.uav, :] += e.value
                    gain_db[start:stop, :, e.uav] += e.value
                    # the diagonal is self-transfer (rate inf) — harmless,
                    # but keep it neutral for cleanliness
                    gain_db[start:stop, e.uav, e.uav] = 0.0
            elif e.kind == "battery_drop":
                if drain is None:
                    drain = np.zeros((T, U), np.float32)
                drain[e.frame, e.uav] += e.value
            elif e.kind == "bernoulli":
                start, stop = self._span(e)
                rng = self._event_rng(i)
                forced[start:stop] |= \
                    rng.random((stop - start, B, U)) < e.value
            # straggler / silence are host-only; arrival_flood /
            # device_stall / clock_skew are gateway-only (gateway_timeline)
        out: Dict[str, np.ndarray] = {"forced": forced}
        if gain_db is not None:
            out["gain_scale"] = np.broadcast_to(
                (10.0 ** (gain_db / 10.0))[:, None], (T, B, U, U)).copy()
        if drain is not None:
            out["extra_drain"] = np.broadcast_to(
                drain[:, None], (T, B, U)).copy()
        return out

    # -- compile target (b): the host-side event stream ----------------
    def host_timeline(self, positions: np.ndarray,
                      trajectory: int = 0,
                      n_trajectories: int = 1) -> List[FrameEvents]:
        """The per-frame host view of ONE trajectory of the compiled
        scenario — who is down (no heartbeat), who is silent, who
        straggles and by how much, which batteries dropped — consistent
        with the tensors ``rollout_inputs`` hands the device for the same
        (B, positions)."""
        tensors = self.rollout_inputs(n_trajectories, positions)
        forced = tensors["forced"][:, trajectory]          # [T, U]
        timeline = [FrameEvents(frame=t) for t in range(self.frames)]
        for t in range(self.frames):
            timeline[t].down = tuple(np.flatnonzero(forced[t]))
        for i, e in enumerate(self.events):
            start, stop = self._span(e)
            if e.kind == "silence":
                for t in range(start, stop):
                    timeline[t].silent = tuple(
                        sorted(set(timeline[t].silent) | {e.uav}))
            elif e.kind == "straggler":
                for t in range(start, stop):
                    prev = timeline[t].straggler_factor.get(e.uav, 1.0)
                    timeline[t].straggler_factor[e.uav] = prev * e.value
            elif e.kind == "battery_drop":
                cur = timeline[e.frame].battery_drop_j.get(e.uav, 0.0)
                timeline[e.frame].battery_drop_j[e.uav] = cur + e.value
            elif e.kind == "link_fade":
                pairs = (e.pair,) if e.pair is not None else tuple(
                    (e.uav, k) for k in range(self.n_uavs) if k != e.uav)
                for t in range(start, stop):
                    timeline[t].faded = tuple(
                        sorted(set(timeline[t].faded) | set(pairs)))
        return timeline

    # -- compile target (c): the gateway fault view --------------------
    def gateway_timeline(self) -> List[GatewayFrameEvents]:
        """The per-frame serving-edge view of the compiled scenario:
        offered-load flood multipliers, injected device-call stall
        attempts, and admission-clock skew — what
        ``runtime.gateway.StreamingGateway`` consumes.  Pure function of
        the event list (no randomness), so replays are trivially
        bitwise."""
        timeline = [GatewayFrameEvents(frame=t) for t in range(self.frames)]
        for e in self.events:
            if e.kind == "arrival_flood":
                start, stop = self._span(e)
                for t in range(start, stop):
                    timeline[t].flood_factor *= e.value
            elif e.kind == "device_stall":
                timeline[e.frame].stall_attempts += e.size
            elif e.kind == "clock_skew":
                start, stop = self._span(e)
                for t in range(start, stop):
                    timeline[t].skew_s += e.value
        return timeline


class ChaosHostDriver:
    """Feeds one trajectory of a ``FaultSchedule`` into a
    ``HealthTracker``, frame by frame — the host half of the chaos run.

    Each ``play_frame(t)`` advances the wall clock by ``frame_s`` and:

    * emits a heartbeat (``base_step_time`` x any straggler factor) for
      every UAV that is neither forced-down nor silenced that frame;
    * withholds heartbeats from down/silent UAVs, so the tracker's
      timeout machinery — not this driver — declares them dead;
    * applies scripted battery drops to its host-side charge ledger and
      reports the result as battery telemetry.

    The driver never calls ``scan``/``tick`` itself: the recovery policy
    (``FaultTolerantRunner`` directly, or a ``ReplanController``) owns
    detection and delegation; the driver is only the fault injector.
    """

    def __init__(self, schedule: FaultSchedule, tracker,
                 positions: np.ndarray,
                 names: Optional[Sequence[str]] = None,
                 frame_s: float = 1.0, base_step_time: float = 0.1,
                 battery_j: float = math.inf, trajectory: int = 0,
                 n_trajectories: int = 1, start_s: float = 0.0):
        self.schedule = schedule
        self.tracker = tracker
        self.timeline = schedule.host_timeline(
            positions, trajectory=trajectory,
            n_trajectories=n_trajectories)
        self.names = list(names) if names is not None else \
            list(tracker.devices.keys())
        if len(self.names) != schedule.n_uavs:
            raise ValueError(
                f"{len(self.names)} device names for {schedule.n_uavs} "
                "UAVs")
        self.frame_s = float(frame_s)
        self.base_step_time = float(base_step_time)
        self.charge = {n: float(battery_j) for n in self.names}
        self.start_s = float(start_s)

    def now(self, frame: int) -> float:
        """Wall-clock time at the END of ``frame`` (when its heartbeats
        have been emitted and its telemetry applied)."""
        return self.start_s + (frame + 1) * self.frame_s

    def play_frame(self, frame: int) -> float:
        """Inject frame ``frame``'s events; returns the frame-end clock."""
        ev = self.timeline[frame]
        t = self.now(frame)
        quiet = set(ev.down) | set(ev.silent)
        for u, name in enumerate(self.names):
            drop = ev.battery_drop_j.get(u, 0.0)
            if drop:
                self.charge[name] = max(self.charge[name] - drop, 0.0)
                if name in self.tracker.devices:
                    self.tracker.battery(name, self.charge[name])
            if u in quiet or name not in self.tracker.devices:
                continue
            step = self.base_step_time * ev.straggler_factor.get(u, 1.0)
            self.tracker.heartbeat(name, step, now=t)
        return t


__all__ = ["ChaosEvent", "FaultSchedule", "FrameEvents", "ChaosHostDriver",
           "GatewayFrameEvents"]
