"""Deadline-aware streaming arrival gateway: live per-UAV request streams
-> the ``[T, B, U]`` arrival tensors ``FleetRollout.run`` consumes (the
reference's ``runtime/gateway.py``; the device call is the port's
``FleetRollout``, on the card unless it was built for the CPU).

Everything upstream of the rollout used to be offline: arrival tensors
drawn host-side in one shot.  The paper's premise, though, is real-time
requests under a strict end-to-end latency bound — a request served after
its deadline is worthless — so this gateway makes robustness the
contract, not an afterthought:

* **Bounded admission with explicit backpressure** — ``submit`` stamps
  the request against the gateway clock and returns it with a terminal
  or queued outcome immediately; a full queue sheds (``queue_full``),
  it NEVER blocks.  ``backpressure`` exposes the fill fraction so
  callers can throttle.
* **Deterministic deadline shedding with priority classes** — requests
  are packed into serving windows in ``(priority, deadline, rid)``
  order; a request whose deadline cannot survive to any frame with
  capacity is shed (``expired``) BEFORE device time is spent on it.
  Ties break on ``rid``, so replays are bitwise.
* **Double-buffered host->device staging** — the arrival tensor of
  window ``k+1`` is assembled (scheduling + ingest) while the device
  solves window ``k`` on a single worker thread.
* **Bounded retry around the device call** — a timed-out or failed
  solve retries under exponential backoff up to ``max_attempts``; an
  exhausted window sheds its requests (``device_failure``), flips the
  gateway into deterministic degraded-mode admission shedding, and —
  when a ``ReplanController`` is attached — falls through to its
  existing degradation ladder (``on_device_exhausted``).
* **Chaos-composable** — ``FaultSchedule``'s gateway events
  (``arrival_flood``, ``device_stall``, ``clock_skew``) drive the load
  generator, the solve wrapper, and the admission clock, while the same
  schedule's ``rollout_inputs`` tensors (crashes, bursts, fades) are
  sliced per window into the device call: one seeded scenario stresses
  the serving edge and the fleet together.

Time is a virtual frame clock (``frame_s`` seconds per frame), which is
what makes an entire serve — admission stamps, deadline decisions, shed
reasons, served statistics — a pure function of (event stream, schedule,
seeds): the soak tests replay it bitwise.  Wall-clock only appears in the
retry path's real timeouts and in benchmark throughput numbers.

Usage::

    gw = StreamingGateway(rollout, base_positions,
                          GatewayConfig(window_frames=8, frame_s=1.0),
                          schedule=sched, seed=0)
    gen = LoadGenerator(n_uavs=U, kind="poisson", rate=2.0,
                        deadline_s=12.0, seed=3)
    report = gw.serve(gen, n_windows=16)
"""
from __future__ import annotations

import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.runtime.chaos import FaultSchedule

# request outcomes: QUEUED is the only non-terminal state; everything
# else is set exactly once (``_shed`` asserts it)
QUEUED = "queued"
SERVED = "served"
SHED_QUEUE_FULL = "shed_queue_full"        # admission backpressure
SHED_EXPIRED = "shed_expired"              # deadline unmeetable, pre-device
SHED_DEGRADED = "shed_degraded"            # degraded-mode admission shedding
SHED_INFEASIBLE = "shed_infeasible_frame"  # solved frame came back infeasible
SHED_DEVICE_FAILURE = "shed_device_failure"  # window lost to retry exhaustion
SHED_SHUTDOWN = "shed_shutdown"            # still queued when serve() drained
SHED_REASONS = (SHED_QUEUE_FULL, SHED_EXPIRED, SHED_DEGRADED,
                SHED_INFEASIBLE, SHED_DEVICE_FAILURE, SHED_SHUTDOWN)


class DeviceStallError(RuntimeError):
    """Injected device stall (``FaultSchedule.device_stall``): the solve
    attempt 'hangs' and is treated exactly like a real timeout."""


@dataclass
class GatewayRequest:
    """One live request: who captured it, when it must be done, how much
    it matters.  ``submit_s``/``deadline_s`` are stamped on the (possibly
    skewed) gateway clock at admission; ``frame`` is the global frame it
    was scheduled into; ``latency_s`` the admission-to-result latency
    (queueing + frame service + the frame's solved per-request latency)."""

    rid: int
    uav: int
    submit_s: float
    deadline_s: float
    priority: int = 1
    outcome: str = QUEUED
    admitted: bool = False    # did admission take it (it may shed later)?
    frame: int = -1
    window: int = -1
    latency_s: float = float("inf")


@dataclass(frozen=True)
class GatewayConfig:
    """Static gateway knobs.

    ``window_frames`` x ``frame_s`` is the serving window the device
    solves per call; ``queue_capacity`` bounds the admission queue
    (backpressure past it); ``frame_capacity`` caps requests per frame
    (default: the rollout spec's ``requests_per_frame`` — the load the
    planner was sized for).  The retry triple bounds the device-call
    recovery: each attempt waits ``solve_timeout_s`` wall-clock, failures
    back off exponentially from ``retry_base_backoff_s`` (capped at
    ``retry_max_backoff_s``), and ``max_attempts`` total attempts are
    made before the window is shed and the gateway degrades, admitting
    only ``degraded_admit_fraction`` of new arrivals (deterministic
    token bucket) until a window succeeds again."""

    window_frames: int = 8
    frame_s: float = 1.0
    queue_capacity: int = 256
    frame_capacity: Optional[int] = None
    solve_timeout_s: float = 60.0
    retry_base_backoff_s: float = 0.02
    retry_max_backoff_s: float = 0.5
    max_attempts: int = 3
    degraded_admit_fraction: float = 0.5

    def __post_init__(self):
        if self.window_frames < 1:
            raise ValueError("window_frames must be positive")
        if self.frame_s <= 0:
            raise ValueError("frame_s must be positive")
        if self.queue_capacity < 1:
            raise ValueError("queue_capacity must be positive")
        if self.frame_capacity is not None and self.frame_capacity < 1:
            raise ValueError("frame_capacity must be positive (or None)")
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be at least 1")
        if not 0.0 <= self.degraded_admit_fraction <= 1.0:
            raise ValueError("degraded_admit_fraction must be in [0, 1]")


# ---------------------------------------------------------------------------
# Arrival sources
# ---------------------------------------------------------------------------


class ArrivalSchedule:
    """Scripted arrival stream — the chaos-schedule idiom for requests.

    Builder calls chain and replay bitwise (no randomness)::

        events = (ArrivalSchedule(frames=32)
                  .at(frame=3, uav=2, deadline_s=10.0)
                  .at(frame=3, uav=5, deadline_s=4.0, priority=0, count=2))

    Scripted counts are explicit, so flood factors do NOT scale them
    (floods belong to the open-loop ``LoadGenerator``).
    """

    def __init__(self, frames: int):
        if frames < 1:
            raise ValueError("need at least one frame")
        self.frames = int(frames)
        self._by_frame: Dict[int, List[Tuple[int, float, int]]] = \
            defaultdict(list)

    def at(self, frame: int, uav: int, deadline_s: float,
           priority: int = 1, count: int = 1) -> "ArrivalSchedule":
        if not 0 <= frame < self.frames:
            raise ValueError(f"frame {frame} outside [0, {self.frames})")
        if deadline_s <= 0:
            raise ValueError("deadline_s must be a positive relative bound")
        if count < 1:
            raise ValueError("count must be at least 1")
        self._by_frame[frame].extend(
            (int(uav), float(deadline_s), int(priority))
            for _ in range(count))
        return self

    def arrivals(self, frame: int,
                 flood_factor: float = 1.0) -> List[Tuple[int, float, int]]:
        return list(self._by_frame.get(frame, ()))


class LoadGenerator:
    """Open-loop synthetic arrival source with three profiles.

    * ``poisson`` — per-frame count ~ Poisson(``rate``), the memoryless
      steady stream.
    * ``burst``   — Poisson(``rate``) baseline, but every
      ``burst_every`` frames the next ``burst_frames`` frames run at
      ``burst_rate`` (default ``5 x rate``): periodic load spikes.
    * ``flood``   — a deterministic ``round(rate)`` requests EVERY
      frame: sustained saturation for overload/shedding curves.

    ``flood_factor`` (driven per frame by ``FaultSchedule.
    arrival_flood``) multiplies the offered rate.  Capturing UAV,
    priority class and deadline jitter are drawn per request.  Every
    draw comes from a child generator keyed on ``(seed, frame)``, so a
    frame's arrivals replay bitwise regardless of which frames were
    generated before it.
    """

    KINDS = ("poisson", "burst", "flood")

    def __init__(self, n_uavs: int, kind: str = "poisson",
                 rate: float = 1.0, seed: int = 0,
                 deadline_s: float = 8.0, deadline_jitter_s: float = 0.0,
                 priorities: Sequence[int] = (1,),
                 priority_weights: Optional[Sequence[float]] = None,
                 uav_weights: Optional[Sequence[float]] = None,
                 burst_every: int = 8, burst_frames: int = 2,
                 burst_rate: Optional[float] = None):
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}")
        if n_uavs < 1 or rate < 0:
            raise ValueError("need n_uavs >= 1 and rate >= 0")
        if deadline_s <= deadline_jitter_s:
            raise ValueError("deadline_s must exceed deadline_jitter_s "
                             "(deadlines must stay positive)")
        self.n_uavs = int(n_uavs)
        self.kind = kind
        self.rate = float(rate)
        self.seed = int(seed)
        self.deadline_s = float(deadline_s)
        self.deadline_jitter_s = float(deadline_jitter_s)
        self.priorities = tuple(int(p) for p in priorities)
        self._pr_p = self._norm(priority_weights, len(self.priorities),
                                "priority_weights")
        self._uav_p = self._norm(uav_weights, self.n_uavs, "uav_weights")
        self.burst_every = max(1, int(burst_every))
        self.burst_frames = int(burst_frames)
        self.burst_rate = float(burst_rate) if burst_rate is not None \
            else 5.0 * self.rate

    @staticmethod
    def _norm(w, n: int, name: str) -> Optional[np.ndarray]:
        if w is None:
            return None
        w = np.asarray(w, np.float64)
        if w.shape != (n,) or (w < 0).any() or w.sum() <= 0:
            raise ValueError(f"{name} must be {n} nonnegative values "
                             "with a positive sum")
        return w / w.sum()

    def arrivals(self, frame: int,
                 flood_factor: float = 1.0) -> List[Tuple[int, float, int]]:
        """The ``(uav, relative deadline_s, priority)`` arrivals of one
        frame, deterministic in ``(seed, frame, flood_factor)``."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, int(frame)]))
        rate = self.rate
        if self.kind == "burst" and \
                frame % self.burst_every < self.burst_frames:
            rate = self.burst_rate
        rate *= float(flood_factor)
        n = int(round(rate)) if self.kind == "flood" \
            else int(rng.poisson(rate))
        out = []
        for _ in range(n):
            u = int(rng.choice(self.n_uavs, p=self._uav_p))
            pr = int(rng.choice(np.asarray(self.priorities), p=self._pr_p))
            dl = self.deadline_s
            if self.deadline_jitter_s > 0:
                dl += float(rng.uniform(-self.deadline_jitter_s,
                                        self.deadline_jitter_s))
            out.append((u, dl, pr))
        return out


# ---------------------------------------------------------------------------
# The gateway
# ---------------------------------------------------------------------------


class StreamingGateway:
    """Aggregates live per-UAV arrivals into per-window ``[T, 1, U]``
    arrival tensors and drives ``FleetRollout.run`` over them, one
    double-buffered window at a time (see module docstring for the
    robustness contract).

    ``rollout``/``base_positions`` drive the real device path;
    ``solve_fn(window, arrivals)`` (returning anything with
    ``feasible [1, T]`` and ``source_latency [1, T, U]`` arrays)
    replaces it for tests.  ``schedule`` composes a ``FaultSchedule``:
    its gateway events steer floods / stalls / clock skew, its rollout
    tensors (``forced`` / ``gain_scale`` / ``extra_drain``) are sliced
    per window into the device call.  ``controller`` is an optional
    ``ReplanController``; retry exhaustion falls through to its ladder.
    """

    def __init__(self, rollout=None, base_positions=None,
                 config: Optional[GatewayConfig] = None,
                 schedule: Optional[FaultSchedule] = None,
                 controller=None, solve_fn: Optional[Callable] = None,
                 n_uavs: Optional[int] = None, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep):
        if rollout is None and solve_fn is None:
            raise ValueError("pass a FleetRollout or an injectable "
                             "solve_fn")
        self.rollout = rollout
        self.config = config if config is not None else GatewayConfig()
        if rollout is not None:
            self.n_uavs = len(rollout.devices)
            # the compiled rollout solves min(U, requests_per_frame)
            # source slots per frame; the scheduler must never exceed it
            self.slots = max(1, min(self.n_uavs,
                                    rollout.spec.requests_per_frame))
            default_cap = rollout.spec.requests_per_frame
            if base_positions is None:
                raise ValueError("a rollout-backed gateway needs "
                                 "base_positions")
        else:
            if n_uavs is None:
                raise ValueError("solve_fn-backed gateway needs n_uavs")
            self.n_uavs = int(n_uavs)
            self.slots = self.n_uavs
            default_cap = self.n_uavs
        self.frame_capacity = self.config.frame_capacity \
            if self.config.frame_capacity is not None else max(1, default_cap)
        self.base = None if base_positions is None \
            else np.asarray(base_positions, np.float64)
        self.schedule = schedule
        if schedule is not None and schedule.n_uavs != self.n_uavs:
            raise ValueError(
                f"schedule is for {schedule.n_uavs} UAVs, gateway serves "
                f"{self.n_uavs}")
        self._gw_timeline = schedule.gateway_timeline() \
            if schedule is not None else None
        # the device-side half of the schedule, sliced per window later
        self._chaos_np = schedule.rollout_inputs(1, self.base) \
            if schedule is not None and rollout is not None else None
        self.controller = controller
        self._solve_fn = solve_fn
        self.seed = int(seed)
        self._sleep = sleep
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="gateway-solve")

        # admission / accounting state
        self.queue: List[GatewayRequest] = []
        self.requests: List[GatewayRequest] = []   # every submit, rid order
        self.served: List[GatewayRequest] = []
        self.shed_counts: Dict[str, int] = {}
        self.arrival_tensors: List[np.ndarray] = []   # one [T, 1, U]/window
        self.retries = 0
        self.device_failures = 0
        self.windows_completed = 0
        self.windows_failed = 0
        self.degraded = False
        self._admit_credit = 0.0
        self._next_rid = 0
        self._window = 0          # next window index (serve() continues)
        self._ingest_frame = 0    # global frame currently ingesting
        self.now_s = 0.0          # virtual clock (start of _ingest_frame)

    # -- clock / chaos helpers -----------------------------------------
    def _gw_event(self, frame: int):
        if self._gw_timeline is None or not \
                0 <= frame < len(self._gw_timeline):
            return None
        return self._gw_timeline[frame]

    def _skew_at(self, frame: int) -> float:
        ev = self._gw_event(frame)
        return ev.skew_s if ev is not None else 0.0

    def _flood_at(self, frame: int) -> float:
        ev = self._gw_event(frame)
        return ev.flood_factor if ev is not None else 1.0

    def _stall_attempts(self, window: int) -> int:
        if self._gw_timeline is None:
            return 0
        T = self.config.window_frames
        return sum(self._gw_timeline[g].stall_attempts
                   for g in range(window * T, (window + 1) * T)
                   if 0 <= g < len(self._gw_timeline))

    @property
    def backpressure(self) -> float:
        """Queue fill fraction in [0, 1] — the throttle signal."""
        return len(self.queue) / self.config.queue_capacity

    # -- admission ------------------------------------------------------
    def submit(self, uav: int, deadline_s: float, priority: int = 1,
               now_s: Optional[float] = None) -> GatewayRequest:
        """Non-blocking admission of one request captured by ``uav`` with
        a RELATIVE deadline of ``deadline_s`` seconds.  Returns the
        stamped request; ``outcome`` is ``QUEUED`` on acceptance or a
        shed reason (already expired / degraded-mode shedding / queue
        backpressure) — never blocks, never raises on overload."""
        if not 0 <= uav < self.n_uavs:
            raise ValueError(f"uav {uav} outside [0, {self.n_uavs})")
        now = self.now_s if now_s is None else float(now_s)
        skew = self._skew_at(self._ingest_frame)
        req = GatewayRequest(rid=self._next_rid, uav=int(uav),
                             submit_s=now + skew,
                             deadline_s=now + skew + float(deadline_s),
                             priority=int(priority))
        self._next_rid += 1
        self.requests.append(req)
        if deadline_s <= 0:
            self._shed(req, SHED_EXPIRED)
        elif self.degraded and not self._degraded_admit():
            self._shed(req, SHED_DEGRADED)
        elif len(self.queue) >= self.config.queue_capacity:
            self._shed(req, SHED_QUEUE_FULL)
        else:
            req.admitted = True
            self.queue.append(req)
        return req

    def _degraded_admit(self) -> bool:
        """Deterministic token bucket passing ``degraded_admit_fraction``
        of arrivals while degraded (mirrors ``ReplanController.admit``)."""
        self._admit_credit += self.config.degraded_admit_fraction
        if self._admit_credit >= 1.0 - 1e-9:
            self._admit_credit -= 1.0
            return True
        return False

    def _shed(self, req: GatewayRequest, reason: str) -> None:
        """Shed exactly once, with a recorded reason."""
        assert req.outcome == QUEUED, \
            f"request {req.rid} shed twice ({req.outcome} -> {reason})"
        req.outcome = reason
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1

    # -- scheduling -----------------------------------------------------
    def _schedule_window(
            self, w: int) -> Tuple[List[GatewayRequest], np.ndarray]:
        """Deterministically pack the queue into window ``w``'s arrival
        tensor.  Requests are considered in (priority, deadline, rid)
        order; each lands in the EARLIEST frame that (a) completes by its
        deadline, (b) has per-frame capacity left, and (c) keeps the
        frame's distinct-source count within the compiled rollout's
        source slots.  A request no frame of this OR any later window can
        serve in time is shed ``expired`` — before any device time is
        spent on it."""
        T = self.config.window_frames
        fs = self.config.frame_s
        arr = np.zeros((T, 1, self.n_uavs), np.float32)
        counts = [0] * T
        sources: List[set] = [set() for _ in range(T)]
        scheduled: List[GatewayRequest] = []
        remaining: List[GatewayRequest] = []
        # first frame of the NEXT window completes at this virtual time:
        # a request that cannot survive even that far is expired now
        next_first_done = ((w + 1) * T + 1) * fs
        for r in sorted(self.queue,
                        key=lambda r: (r.priority, r.deadline_s, r.rid)):
            placed = False
            for t in range(T):
                done_s = (w * T + t + 1) * fs
                if done_s > r.deadline_s:
                    break                 # later frames only finish later
                if counts[t] >= self.frame_capacity:
                    continue
                if r.uav not in sources[t] and len(sources[t]) >= self.slots:
                    continue
                arr[t, 0, r.uav] += 1.0
                counts[t] += 1
                sources[t].add(r.uav)
                r.frame = w * T + t
                r.window = w
                placed = True
                break
            if placed:
                scheduled.append(r)
            elif r.deadline_s < next_first_done:
                self._shed(r, SHED_EXPIRED)
            else:
                remaining.append(r)
        remaining.sort(key=lambda r: r.rid)
        self.queue = remaining
        self.arrival_tensors.append(arr.copy())
        return scheduled, arr

    # -- ingest ---------------------------------------------------------
    def _ingest(self, w: int, source) -> None:
        """Advance the virtual clock over window ``w``'s frames, pulling
        arrivals from ``source`` (anything with ``arrivals(frame,
        flood_factor)`` — a ``LoadGenerator`` or ``ArrivalSchedule``)
        through ``submit``.  Runs on the host while the window solves on
        the device — the ingest half of the double buffer."""
        T = self.config.window_frames
        for t in range(T):
            g = w * T + t
            self._ingest_frame = g
            self.now_s = g * self.config.frame_s
            if source is None:
                continue
            for uav, deadline_s, priority in \
                    source.arrivals(g, self._flood_at(g)):
                self.submit(uav, deadline_s, priority)
        # clock rests at the end of the window: later direct submits are
        # stamped no earlier than anything ingested during it
        self.now_s = (w + 1) * T * self.config.frame_s
        self._ingest_frame = (w + 1) * T

    # -- the device call ------------------------------------------------
    def _solve(self, w: int, arr: np.ndarray, attempt: int):
        """One solve attempt for window ``w`` (runs on the worker
        thread).  Injected stalls fire BEFORE any device work — a stalled
        attempt costs no device time, exactly like a hung call that gets
        timed out."""
        if attempt <= self._stall_attempts(w):
            raise DeviceStallError(
                f"injected device stall (window {w}, attempt {attempt})")
        if self._solve_fn is not None:
            return self._solve_fn(w, arr)
        T = self.config.window_frames
        kw = {}
        if self._chaos_np is not None:
            lo, hi = w * T, (w + 1) * T
            for name, tensor in self._chaos_np.items():
                if lo < tensor.shape[0]:
                    window = tensor[lo:hi]
                    if window.shape[0] < T:     # schedule ran out: neutral
                        pad = T - window.shape[0]
                        fill = np.zeros_like(window[:1]) \
                            if name != "gain_scale" \
                            else np.ones_like(window[:1])
                        window = np.concatenate(
                            [window] + [fill] * pad, axis=0)
                    kw[name] = window
                elif name == "gain_scale":
                    kw[name] = np.ones((T,) + tensor.shape[1:],
                                       tensor.dtype)
                else:
                    kw[name] = np.zeros((T,) + tensor.shape[1:],
                                        tensor.dtype)
        # one child generator per window: a retried, reordered or
        # replayed window consumes bit-identical host draws
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, w]))
        return self.rollout.run(self.base, n_trajectories=1, frames=T,
                                arrivals=arr, rng=rng, **kw)

    def _dispatch(self, w: int, arr: np.ndarray, attempt: int = 1):
        return self._executor.submit(self._solve, w, arr, attempt)

    def _collect(self, w: int, fut, scheduled: List[GatewayRequest],
                 arr: np.ndarray) -> None:
        """Wait (bounded) for window ``w``; retry with exponential
        backoff on timeout/failure; on exhaustion shed the window and
        degrade; on success record every scheduled request's result."""
        cfg = self.config
        attempt = 1
        backoff = cfg.retry_base_backoff_s
        while True:
            try:
                trace = fut.result(timeout=cfg.solve_timeout_s)
                break
            except Exception:
                if attempt >= cfg.max_attempts:
                    self.windows_failed += 1
                    self.device_failures += 1
                    for r in scheduled:
                        self._shed(r, SHED_DEVICE_FAILURE)
                    if not self.degraded:
                        self.degraded = True
                        self._admit_credit = 0.0
                    if self.controller is not None:
                        self.controller.on_device_exhausted(
                            w * cfg.window_frames)
                    return
                self.retries += 1
                self._sleep(backoff)
                backoff = min(backoff * 2.0, cfg.retry_max_backoff_s)
                attempt += 1
                fut = self._dispatch(w, arr, attempt)
        self.windows_completed += 1
        if self.degraded:
            self.degraded = False
            if self.controller is not None:
                self.controller.on_device_recovered(w * cfg.window_frames)
        feas = np.asarray(trace.feasible)[0]            # [T]
        lat = np.asarray(trace.source_latency)[0]       # [T, U]
        for r in scheduled:
            t = r.frame - w * cfg.window_frames
            service = float(lat[t, r.uav])
            if not (bool(feas[t]) and np.isfinite(service)):
                # device time was spent, but the frame (or this source)
                # came back unservable — the result is unusable
                self._shed(r, SHED_INFEASIBLE)
                continue
            done_s = (r.frame + 1) * cfg.frame_s
            r.latency_s = done_s + service - r.submit_s
            r.outcome = SERVED
            self.served.append(r)

    # -- the serve loop --------------------------------------------------
    def serve(self, source=None, n_windows: int = 1,
              drain: bool = True) -> Dict:
        """Run ``n_windows`` serving windows (continuing from wherever a
        previous ``serve`` stopped).  Per window ``w``: schedule the
        admitted queue into the arrival tensor, dispatch it, ingest
        ``source``'s arrivals for the window's frames (overlapping the
        in-flight solve), then collect the PREVIOUS window — so tensor
        assembly of window ``k+1`` always overlaps the device solve of
        window ``k``.  Every wait is bounded (``solve_timeout_s`` x
        ``max_attempts``), so the loop can never block unboundedly.
        ``drain`` sheds whatever is still queued at the end
        (``shutdown``), leaving every submitted request with exactly one
        terminal outcome.  Returns ``report()``."""
        inflight = None
        for k in range(n_windows):
            w = self._window
            self._window += 1
            scheduled, arr = self._schedule_window(w)
            self._ingest(w, source)
            if inflight is not None:
                self._collect(*inflight)
            fut = self._dispatch(w, arr)
            inflight = (w, fut, scheduled, arr)
        if inflight is not None:
            self._collect(*inflight)
        if drain:
            for r in self.queue:
                self._shed(r, SHED_SHUTDOWN)
            self.queue = []
        return self.report()

    def close(self) -> None:
        self._executor.shutdown(wait=False)

    # -- reporting -------------------------------------------------------
    def report(self) -> Dict:
        """Deterministic served statistics (virtual-clock only — no
        wall-clock anywhere, so a replayed event stream reproduces this
        dict bitwise)."""
        lats = np.asarray(sorted(r.latency_s for r in self.served),
                          np.float64)
        hit = sum(1 for r in self.served
                  if (r.frame + 1) * self.config.frame_s <= r.deadline_s)
        shed_total = sum(self.shed_counts.values())
        horizon_s = self._window * self.config.window_frames * \
            self.config.frame_s
        return {
            "submitted": len(self.requests),
            "served": len(self.served),
            "shed": {k: self.shed_counts[k]
                     for k in sorted(self.shed_counts)},
            "shed_total": shed_total,
            "queued": len(self.queue),
            "deadline_hit_rate": hit / len(self.served)
            if self.served else 1.0,
            "latency_p50_s": float(np.percentile(lats, 50))
            if lats.size else float("nan"),
            "latency_p99_s": float(np.percentile(lats, 99))
            if lats.size else float("nan"),
            "latency_mean_s": float(lats.mean())
            if lats.size else float("nan"),
            "windows": self.windows_completed + self.windows_failed,
            "windows_failed": self.windows_failed,
            "retries": self.retries,
            "device_failures": self.device_failures,
            "throughput_rps": len(self.served) / horizon_s
            if horizon_s > 0 else 0.0,
            "offered_rps": len(self.requests) / horizon_s
            if horizon_s > 0 else 0.0,
        }


__all__ = ["ArrivalSchedule", "DeviceStallError", "GatewayConfig",
           "GatewayRequest", "LoadGenerator", "StreamingGateway",
           "QUEUED", "SERVED", "SHED_REASONS", "SHED_QUEUE_FULL",
           "SHED_EXPIRED", "SHED_DEGRADED", "SHED_INFEASIBLE",
           "SHED_DEVICE_FAILURE", "SHED_SHUTDOWN"]
