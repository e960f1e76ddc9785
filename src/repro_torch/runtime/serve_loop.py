"""Serving runtime (the reference's ``runtime/serve_loop.py``): the LMs'
prefill/decode step factories and a continuous batcher that keeps decode
slots full, and the swarm's serving loop — ``PeriodicReplanner`` (one
batched engine call per period, plus an optional rollout lookahead) and
``ReplanController``, the SLO watchdog that climbs a bounded degradation
ladder.

The KV layout is the dense per-slot cache the model defines.  Sampling
at temperature > 0 draws from a ``torch.Generator`` seeded with
``seed``: reproducible, but not the bits of the reference's
``jax.random.categorical``.  Greedy decoding (the default) takes the
first maximal logit, as ``jnp.argmax`` does.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ServeConfig
from repro_torch.parallel.sharding import current_mesh, pad_to_multiple


def make_prefill_step(model, cfg: ArchConfig, cache_len: int):
    """``prefill_step(params, tokens, extra=None)``: ``extra`` is whisper's
    frame embeddings (family ``audio``, where they are required) or the
    VLM's patch embeddings (family ``vlm``, optional)."""
    def prefill_step(params, tokens, extra=None):
        if cfg.family == "audio":
            return model.prefill(params, tokens, extra, cache_len)
        if cfg.family == "vlm":
            return model.prefill(params, tokens, cache_len,
                                 extra_embeds=extra)
        return model.prefill(params, tokens, cache_len)
    return prefill_step


def decode_start(cfg: ArchConfig, tokens: torch.Tensor,
                 extra: Optional[torch.Tensor] = None) -> int:
    """The position of the first decode step after ``prefill_step(params,
    tokens, extra)``: the prompt's length, plus the patch embeddings that
    a VLM prefill puts in front of it (whisper's frames feed the encoder
    and take no decoder position)."""
    if cfg.family == "vlm" and extra is not None:
        return tokens.shape[1] + extra.shape[1]
    return tokens.shape[1]


def make_decode_step(model, temperature: float = 0.0):
    def decode_step(params, cache, tokens, pos,
                    generator: Optional[torch.Generator] = None):
        logits, new_cache = model.decode_step(params, tokens, pos, cache)
        if temperature > 0.0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        return nxt.to(torch.int32), new_cache
    return decode_step


# ---------------------------------------------------------------------------
# Request batching
# ---------------------------------------------------------------------------


@dataclass
class Request:
    """One request: its prompt, and ``extra``, whisper's frame
    embeddings [enc_seq, d] (required for family ``audio``) or the VLM's
    patch embeddings [P, d] (optional), on the model's device."""
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    extra: Optional[torch.Tensor] = None


@dataclass
class SlotState:
    rid: int = -1
    pos: int = 0
    remaining: int = 0


class ContinuousBatcher:
    """Keeps ``max_batch`` decode slots full; prefill joins empty slots.

    Whenever the set of active requests changes, the whole batch is
    prefilled again (prompt plus the tokens generated so far, left-padded
    with token 0 and no padding mask, so pads are attended to, as in the
    reference), then decoded until a slot finishes.  ``seed`` seeds the
    sampling generator (temperature > 0).  ``max_pending`` bounds the
    admission queue: a full queue makes ``submit`` report backpressure
    (return ``False``, counted in ``rejected``); ``None`` leaves it
    unbounded.  Runs on the model's device.  Under ``use_mesh_rules``
    every batch runs at a multiple of the batch axes' positions: filler
    rows of token 0 make up the last data shard (``filler_rows`` counts
    them; their tokens are dropped), as GSPMD pads an uneven split, so
    the rows always split and the program a mesh gives the model is the
    same from one batch to the next.  Where that is the model's sharded
    program the weights are held by position once for each layout it
    runs (``shard_params``: FSDP-only for a prefill under
    ``attn_seq_shard``, by heads for decode) and each batch's cache is a
    ``ShardedCache`` (by slots under ``seq_shard_kv``).  A filler row's
    tokens are routed with its data shard's in an expert-parallel MoE,
    whose capacity is counted over the data shard.  A request's
    ``extra`` goes in with its prompt (whisper's frames, where a filler
    row's are zeros; a VLM's patches, decoding then from past them).
    """

    def __init__(self, model, cfg: ArchConfig, scfg: ServeConfig, params,
                 seed: int = 0, max_pending: Optional[int] = None):
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be positive (or None)")
        self.device = model.device
        self.model = model
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.seed = int(seed)
        self.max_pending = max_pending
        self.rejected = 0
        self.prefill_step = make_prefill_step(model, cfg, scfg.max_seq)
        self.decode_step = make_decode_step(model, scfg.temperature)
        self.pending: List[Request] = []
        self.active: List[Request] = []
        self._held = {}            # (mesh, rows) -> the weights by position
        self.filler_rows = 0

    @staticmethod
    def _rows(n: int) -> int:
        """The rows a batch of ``n`` requests runs at: ``n`` rounded up to
        a multiple of the current mesh's batch axes' positions."""
        mesh = current_mesh()
        if mesh is None:
            return n
        return pad_to_multiple(n, math.prod(
            mesh.shape[a] for a in ("pod", "data") if a in mesh.shape))

    def _params(self, kind: str, batch: int):
        """The weights for a ``kind`` call (``prefill``, ``decode``) on a
        batch of ``batch`` rows: held by position, once a mesh and
        layout, where the model runs this batch sharded."""
        sp = self.model.spmd(kind, batch) \
            if hasattr(self.model, "spmd") else None
        if sp is None:
            return self.params
        key = (sp.mesh, sp.seq_rows)
        if key not in self._held:
            from repro_torch.parallel.param_sharding import shard_params
            self._held[key] = shard_params(sp, self.params)
        return self._held[key]

    def submit(self, req: Request) -> bool:
        """Enqueue ``req``; returns ``False`` (backpressure, request NOT
        enqueued) when the pending queue is at ``max_pending``."""
        if self.max_pending is not None and \
                len(self.pending) >= self.max_pending:
            self.rejected += 1
            return False
        self.pending.append(req)
        return True

    def _batch_prompts(self, reqs: List[Request]) -> np.ndarray:
        maxlen = max(len(r.prompt) + len(r.out) for r in reqs)
        toks = np.zeros((len(reqs), maxlen), np.int32)
        for i, r in enumerate(reqs):
            seq = r.prompt + r.out
            toks[i, -len(seq):] = seq          # left-pad
        return toks

    def _batch_extra(self, reqs: List[Request], rows: int
                     ) -> Optional[torch.Tensor]:
        """The requests' ``extra`` embeddings stacked [rows, P, d] (zeros
        for the filler rows), or None where no request has them."""
        if all(r.extra is None for r in reqs):
            return None
        ex = [r.extra for r in reqs]
        like = next(e for e in ex if e is not None)
        ex = [torch.zeros_like(like) if e is None else e for e in ex]
        ex += [torch.zeros_like(like)] * (rows - len(reqs))
        return torch.stack(ex).to(self.device)

    def run(self, max_steps: int = 1000) -> List[Request]:
        done: List[Request] = []
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        while (self.pending or self.active) and max_steps > 0:
            while self.pending and len(self.active) < self.scfg.max_batch:
                self.active.append(self.pending.pop(0))
            reqs = self.active
            toks = torch.as_tensor(self._batch_prompts(reqs),
                                   device=self.device)
            rows = self._rows(len(reqs))
            if rows > len(reqs):
                toks = torch.cat([toks, toks.new_zeros(
                    (rows - len(reqs), toks.shape[1]))])
                self.filler_rows += rows - len(reqs)
            extra = self._batch_extra(reqs, rows)
            logits, cache = self.prefill_step(self._params("prefill", rows),
                                              toks, extra)
            params = self._params("decode", rows)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = decode_start(self.cfg, toks, extra)
            for r, t in zip(reqs, nxt.tolist()):
                r.out.append(t)
            # decode until any slot finishes, then re-batch
            steps = min(min(r.max_new - len(r.out) for r in reqs),
                        self.scfg.max_seq - pos - 1, max_steps)
            cur = nxt[:, None]
            for s in range(max(steps, 0)):
                p = torch.full((rows, 1), pos + s, dtype=torch.int32,
                               device=self.device)
                cur_next, cache = self.decode_step(params, cache, cur, p,
                                                   gen)
                for r, t in zip(reqs, cur_next.tolist()):
                    r.out.append(t)
                cur = cur_next[:, None]
                max_steps -= 1
            cache = None          # free this batch's cache before the next
            still = []
            for r in reqs:
                if len(r.out) >= r.max_new or (r.out and
                                               r.out[-1] == self.scfg.eos_id):
                    r.done = True
                    done.append(r)
                else:
                    still.append(r)
            self.active = still
            max_steps -= 1
        return done



# ---------------------------------------------------------------------------
# Periodic swarm re-optimization (amortized over in-flight batches)
# ---------------------------------------------------------------------------


class PeriodicReplanner:
    """Amortized LLHR re-optimization for a serving loop.

    The paper re-runs P1->P3 "periodically to support the dynamics of the
    system"; a fleet cannot afford a scalar re-solve per request.  Instead,
    every ``period`` ticks this wrapper makes ONE batched engine call over
    ``n_scenarios`` Monte-Carlo draws (mobility jitter, failures, shadowing)
    with the measured swarm state as scenario 0.  Between refreshes, every
    in-flight request batch serves off the cached nominal placement, and the
    scenario ensemble prices the robustness of that plan (p95 latency).

    When the engine carries a ``PositionSpec``, the refresh ALSO solves P2
    on device: measured positions are only the initialization, the fused
    plan returns where the swarm should fly (``planned_positions``), and —
    with ``adopt_positions`` (default) — the generator's nominal state
    follows the optimized positions, so no solved position ever crosses the
    host boundary on its way into the next plan.

    With a ``rollout`` (a ``repro_torch.runtime.fleet_rollout.
    FleetRollout``) and ``rollout_horizon > 0``, every refresh
    additionally rolls the nominal state ``rollout_horizon`` frames
    FORWARD over ``rollout_trajectories`` Monte-Carlo futures — mobility drift, failures, battery drain — in one
    more device call.  The scenario batch prices the plan's robustness NOW;
    the horizon prices where the fleet is heading (``horizon_feasibility``,
    ``horizon_latency``), which is what decides proactive re-positioning.
    ``rollout_mesh`` / ``rollout_devices`` split the lookahead's
    trajectories over a device mesh (``FleetRollout.run(mesh=,
    devices=)``).

    ``engine``/``generator`` come from
    ``repro_torch.runtime.scenario_engine``; the engine's device is where
    every refresh runs.
    """

    def __init__(self, engine, generator, period: int = 10,
                 n_scenarios: int = 128, source: int = 0,
                 adopt_positions: bool = True,
                 rollout=None, rollout_horizon: int = 0,
                 rollout_trajectories: int = 32,
                 rollout_mesh=None, rollout_devices=None):
        self.engine = engine
        self.generator = generator
        self.period = max(1, period)
        self.n_scenarios = n_scenarios
        self.source = source
        self.adopt_positions = adopt_positions
        self.rollout = rollout
        self.rollout_horizon = rollout_horizon
        self.rollout_trajectories = rollout_trajectories
        # shard the lookahead's trajectory axis over a device mesh: a
        # horizon priced over many Monte-Carlo futures is exactly the
        # embarrassingly-parallel axis
        self.rollout_mesh = rollout_mesh
        self.rollout_devices = rollout_devices
        self.horizon = None        # RolloutTrace of the last lookahead
        self.plan = None           # BatchPlan of the last refresh
        self.refreshes = 0
        self.last_refresh_s = 0.0  # wall-clock of the latest plan_batch call
        self._retraces = 0         # builds paid by refreshes after the first
        # refreshes whose scenario-0 plan came back INFEASIBLE: their P2
        # positions were not adopted (see tick) — a nonzero count is the
        # flag the SLO controller / operator reads
        self.infeasible_refreshes = 0

    # ------------------------------------------------------------------
    def tick(self, frame: int,
             positions: Optional[np.ndarray] = None,
             force: bool = False) -> bool:
        """Advance one serving tick; refresh the plan ensemble on period
        boundaries (and on the first tick).  ``positions``: newly measured
        UAV positions (updates the generator's nominal state).  ``force``
        refreshes regardless of the period — the proactive path a
        ``ReplanController`` takes when the horizon breaches its SLO.
        Returns True when a refresh happened."""
        if positions is not None:
            self.generator.base_positions = np.asarray(positions, np.float64)
        if self.plan is not None and frame % self.period != 0 and not force:
            return False
        batch = self.generator.draw(self.n_scenarios)
        # scenario 0 is pinned to the measured (nominal) swarm state: its
        # placement is the one requests are actually served with
        batch.positions[0] = self.generator.base_positions
        if batch.active is not None:
            batch.active[0] = True
        if batch.gain_scale is not None:
            batch.gain_scale[0] = 1.0
        batch.source[0] = self.source

        def builds() -> int:
            # count each (cache, key) once: the rollout shares the
            # engine's cache, and summing each engine's build_count would
            # double-count a shared key
            used = {(id(e.plan_cache), k): e.plan_cache.builds.get(k, 0)
                    for e in (self.engine, self.rollout) if e is not None
                    for k in e._cache_keys_used}
            return sum(used.values())

        builds_before = builds()
        t0 = time.perf_counter()
        self.plan = self.engine.plan_batch(batch)
        if (self.adopt_positions and self.plan.positions is not None
                and getattr(self.engine, "position_spec", None) is not None):
            if np.isfinite(float(self.plan.latency[0])):
                # the fused P2 solved where the swarm should fly; make that
                # the nominal state the next refresh (and its Monte-Carlo
                # draws) starts from
                self.generator.base_positions = np.asarray(
                    self.plan.positions[0], np.float64)
            else:
                # scenario 0 came back INFEASIBLE: its positions are a
                # garbage P2 solution (the solver never found a serving
                # chain to anchor them) — keep the measured positions and
                # flag the event instead of flying the fleet there
                self.infeasible_refreshes += 1
        if self.rollout is not None and self.rollout_horizon > 0:
            # lookahead: roll the (possibly adopted) nominal state forward
            # under the modelled dynamics — one more device call
            self.horizon = self.rollout.run(
                self.generator.base_positions,
                n_trajectories=self.rollout_trajectories,
                frames=self.rollout_horizon,
                mesh=self.rollout_mesh, devices=self.rollout_devices)
        self.last_refresh_s = time.perf_counter() - t0
        if self.refreshes > 0:
            # only builds paid DURING this refresh count: another engine
            # sharing the process-wide cache key must not show up here
            self._retraces += builds() - builds_before
        self.refreshes += 1
        return True

    @property
    def retraces(self) -> int:
        """Plan-function builds paid by refreshes AFTER the first one.

        The first refresh builds (or hits the process-wide plan cache);
        every later tick re-runs the same built plan, so this stays 0 in
        a healthy loop — the regression tests assert exactly that."""
        return self._retraces

    # ------------------------------------------------------------------
    @property
    def assignment(self) -> Optional[np.ndarray]:
        """Layer -> device placement currently being served (scenario 0)."""
        if self.plan is None:
            return None
        return self.plan.assign[0]

    @property
    def planned_positions(self) -> Optional[np.ndarray]:
        """[U, 2] positions the nominal plan was priced at — the device-side
        P2 solution when the engine optimizes positions (the swarm's flight
        target), else the measured positions echoed back."""
        if self.plan is None or self.plan.positions is None:
            return None
        return self.plan.positions[0]

    @property
    def nominal_latency(self) -> float:
        return float(self.plan.latency[0]) if self.plan is not None \
            else float("inf")

    def robust_latency(self, q: float = 95.0) -> float:
        """Latency percentile across the scenario ensemble — what the plan
        costs under the modelled dynamics, not just at the nominal state."""
        return self.plan.latency_percentile(q) if self.plan is not None \
            else float("inf")

    # ------------------------------------------------------------------
    @property
    def horizon_feasibility(self) -> float:
        """Fraction of (trajectory, frame) points in the rollout lookahead
        that stay feasible — the fleet's forward health, 0.0 before the
        first refresh (or without a rollout attached)."""
        return self.horizon.feasibility_rate if self.horizon is not None \
            else 0.0

    def horizon_latency(self, q: float = 95.0) -> float:
        """Latency percentile over the WHOLE lookahead ensemble (every
        frame of every rolled-out future, outages included as inf)."""
        return self.horizon.latency_percentile(q) \
            if self.horizon is not None else float("inf")


# ---------------------------------------------------------------------------
# SLO-driven degraded-mode replanning
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServiceLevelObjective:
    """What "healthy" means for the serving loop.

    ``min_horizon_feasibility``: the rollout lookahead must keep at least
    this fraction of (trajectory, frame) points feasible.
    ``max_latency_s``: the ``latency_quantile`` percentile of the horizon
    ensemble must stay under this bound (default inf: feasibility-only).
    The nominal (scenario-0) plan must additionally be feasible — a swarm
    that cannot serve the measured state is breaching by definition."""

    min_horizon_feasibility: float = 0.9
    max_latency_s: float = float("inf")
    latency_quantile: float = 95.0


class ReplanController:
    """SLO watchdog escalating a BOUNDED degradation ladder.

    ``PeriodicReplanner`` reports forward health (``horizon_feasibility``,
    ``horizon_latency``) but never acts on it; ``FaultTolerantRunner``
    recovers from deaths but knows nothing about where the fleet is
    heading.  This controller closes the loop: every frame it advances the
    replanner, scans host health, checks the SLO, and — on breach — climbs
    exactly one rung at a time:

    1. **early_refresh** — force an out-of-period plan refresh (proactive
       re-positioning), under exponential backoff with a retry cap so a
       persistently-infeasible world cannot trigger a refresh storm;
    2. **contingency** — a host-detected death answered from the
       precomputed ``ContingencyTable`` (via ``runner.on_failure``);
    3. **live_replan** — the same death when no table entry covers it:
       a live re-solve over the survivors;
    4. **degraded** — retries exhausted: hold the last-known-good plan and
       shed ``shed_fraction`` of admissions until the SLO recovers.

    Every breach opens an event that records frames-to-recover, frames
    served degraded, the rungs climbed, and the plan-generation churn it
    cost — ``metrics()`` aggregates them (MTTR, degraded-frame fraction),
    which is what a chaos run reports.
    """

    NOMINAL = "nominal"
    EARLY_REFRESH = "early_refresh"
    CONTINGENCY = "contingency"
    LIVE_REPLAN = "live_replan"
    DEGRADED = "degraded"

    def __init__(self, replanner: PeriodicReplanner,
                 slo: Optional[ServiceLevelObjective] = None,
                 runner=None,
                 base_backoff_frames: int = 1,
                 max_backoff_frames: int = 16,
                 max_refresh_retries: int = 4,
                 shed_fraction: float = 0.5):
        if not 0.0 <= shed_fraction <= 1.0:
            raise ValueError("shed_fraction must be in [0, 1]")
        self.replanner = replanner
        self.slo = slo if slo is not None else ServiceLevelObjective()
        self.runner = runner          # optional FaultTolerantRunner
        self.base_backoff = max(1, int(base_backoff_frames))
        self.max_backoff = max(self.base_backoff, int(max_backoff_frames))
        self.max_retries = int(max_refresh_retries)
        self.shed_fraction = shed_fraction

        self.mode = self.NOMINAL
        self.shedding = False
        self.last_good = None         # last plan that met the SLO
        self.events: List[Dict] = []  # one dict per breach episode
        self.frames_seen = 0
        self.degraded_frames_total = 0
        self._event: Optional[Dict] = None
        self._retries = 0
        self._backoff = self.base_backoff
        self._next_try = 0
        self._admit_credit = 0.0
        self._admitted = 0
        self._shed = 0

    # -- health --------------------------------------------------------
    def slo_ok(self) -> bool:
        """Does the current plan + lookahead meet the SLO right now?"""
        r = self.replanner
        if r.plan is None or not np.isfinite(r.nominal_latency):
            return False
        if r.rollout is not None and r.horizon is not None:
            if r.horizon_feasibility < self.slo.min_horizon_feasibility:
                return False
            if r.horizon_latency(self.slo.latency_quantile) > \
                    self.slo.max_latency_s:
                return False
        return True

    # -- the per-frame loop --------------------------------------------
    def step(self, frame: int,
             positions: Optional[np.ndarray] = None,
             now: Optional[float] = None) -> str:
        """Advance one frame: periodic refresh, host health scan, SLO
        check, ladder escalation.  Returns the mode the frame is served
        in."""
        self.frames_seen += 1
        self.replanner.tick(frame, positions)
        self._host_scan(frame, now)
        if not self.slo_ok():
            self._escalate(frame)
        if self.slo_ok():
            self._recover(frame)
        elif self._event is not None:
            self._event["degraded_frames"] += 1
            self.degraded_frames_total += 1
        return self.mode

    def _host_scan(self, frame: int, now: Optional[float]) -> None:
        """Run the runner's detect->delegate tick; a death lands on the
        contingency rung when the precomputed table answered, else on
        live_replan.  Either way the scenario ensemble is stale, so one
        un-backed-off refresh follows immediately (event-driven, not a
        storm: one per detected failure)."""
        if self.runner is None:
            return
        plan = self.runner.tick(now)
        if plan is None or not self.runner.events:
            return
        ev = self.runner.events[-1]
        if ev["kind"] == "failure":
            rung = self.CONTINGENCY if ev.get("precomputed") \
                else self.LIVE_REPLAN
            self._open(frame, kind="failure", dead=list(ev["dead"]))
            self._climb(rung)
            self.replanner.tick(frame, force=True)
            self._event["refresh_attempts"] += 1
        elif ev["kind"] == "straggler":
            self._open(frame, kind="straggler", slow=list(ev["slow"]))
            self._climb(self.LIVE_REPLAN)

    def _escalate(self, frame: int) -> None:
        self._open(frame, kind="slo_breach")
        if self._retries < self.max_retries:
            if frame >= self._next_try:
                self._climb(self.EARLY_REFRESH)
                self.replanner.tick(frame, force=True)
                self._event["refresh_attempts"] += 1
                self._retries += 1
                self._next_try = frame + self._backoff
                self._backoff = min(self._backoff * 2, self.max_backoff)
        else:
            # bounded: retries exhausted — hold the last-known-good plan
            # and shed load instead of hammering the engine
            self._climb(self.DEGRADED)
            self.shedding = True

    def _recover(self, frame: int) -> None:
        self.last_good = self.replanner.plan
        self.shedding = False
        self.mode = self.NOMINAL
        self._retries = 0
        self._backoff = self.base_backoff
        self._next_try = frame
        if self._event is not None:
            self._event["end_frame"] = frame
            self._event["frames_to_recover"] = \
                frame - self._event["start_frame"]
            self._event = None

    # -- event bookkeeping ---------------------------------------------
    def _open(self, frame: int, kind: str, **extra) -> None:
        if self._event is not None:
            # already inside an episode: a death during an SLO breach is
            # the same outage, just a deeper rung
            self._event.setdefault("kinds", []).append(kind)
            self._event.update({k: v for k, v in extra.items()})
            return
        self._event = {"kind": kind, "kinds": [kind],
                       "start_frame": frame, "end_frame": None,
                       "frames_to_recover": None, "degraded_frames": 0,
                       "refresh_attempts": 0, "rungs": [], **extra}
        self.events.append(self._event)

    def _climb(self, rung: str) -> None:
        self.mode = rung
        if self._event is not None and (not self._event["rungs"] or
                                        self._event["rungs"][-1] != rung):
            self._event["rungs"].append(rung)

    # -- gateway fall-through ------------------------------------------
    def on_device_exhausted(self, frame: int) -> None:
        """Entry point for the streaming gateway's bounded retry path
        (``repro_torch.runtime.gateway.StreamingGateway``): the serving
        device call burned through its attempt cap.  Opens (or deepens) a
        breach episode and drops straight to the DEGRADED rung with admission
        shedding on — the gateway's failure falls through to the SAME
        bounded ladder every other breach uses, so MTTR / degraded-frame
        metrics aggregate across both."""
        self._open(frame, kind="device_exhausted")
        self._climb(self.DEGRADED)
        self.shedding = True

    def on_device_recovered(self, frame: int) -> None:
        """Gateway counterpart to ``on_device_exhausted``: a later window
        solved.  Closes the episode (and stops shedding) when the SLO
        side is healthy too; a still-breaching SLO keeps the episode
        open — recovery then happens through ``step`` as usual."""
        if self.slo_ok():
            self._recover(frame)

    # -- admission control ---------------------------------------------
    def admit(self) -> bool:
        """Admission gate for new requests.  In degraded mode a
        deterministic token bucket passes ``1 - shed_fraction`` of
        arrivals; everywhere else, everything is admitted."""
        if not self.shedding:
            self._admitted += 1
            return True
        self._admit_credit += 1.0 - self.shed_fraction
        if self._admit_credit >= 1.0 - 1e-9:
            self._admit_credit -= 1.0
            self._admitted += 1
            return True
        self._shed += 1
        return False

    # -- reporting ------------------------------------------------------
    @property
    def serving_plan(self):
        """The plan requests are actually served with: the runner's
        survivor-addressed plan when a runner is attached (its ``assign``
        never references a dead device), else the replanner's current plan
        while healthy, else the last-known-good plan."""
        if self.runner is not None:
            return self.runner.state.plan
        if self.slo_ok():
            return self.replanner.plan
        return self.last_good if self.last_good is not None \
            else self.replanner.plan

    def metrics(self) -> Dict:
        """Aggregate recovery metrics across all breach episodes."""
        closed = [e for e in self.events
                  if e["frames_to_recover"] is not None]
        recoveries = [e["frames_to_recover"] for e in closed]
        refreshes = sum(e["refresh_attempts"] for e in self.events)
        churn = self.replanner.refreshes + \
            (self.runner.state.generation if self.runner is not None else 0)
        return {
            "frames": self.frames_seen,
            "n_events": len(self.events),
            "n_recovered": len(closed),
            "n_unrecovered": len(self.events) - len(closed),
            "mttr_frames": float(np.mean(recoveries)) if recoveries
            else 0.0,
            "max_frames_to_recover": int(max(recoveries)) if recoveries
            else 0,
            "degraded_frames": self.degraded_frames_total,
            "degraded_frame_fraction": self.degraded_frames_total /
            max(self.frames_seen, 1),
            "refresh_attempts": refreshes,
            "generation_churn": churn,
            "infeasible_refreshes": self.replanner.infeasible_refreshes,
            "admitted": self._admitted,
            "shed": self._shed,
            "events": [dict(e) for e in self.events],
        }


__all__ = ["ContinuousBatcher", "PeriodicReplanner", "ReplanController",
           "Request", "ServiceLevelObjective", "SlotState",
           "decode_start", "make_decode_step", "make_prefill_step"]
