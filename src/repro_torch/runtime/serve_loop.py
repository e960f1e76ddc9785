"""Serving runtime for the LMs: prefill/decode step factories and a
continuous batcher that keeps decode slots full (the reference's
``runtime/serve_loop.py``; its ``PeriodicReplanner`` and
``ReplanController`` wait for ROADMAP queue 1 item 10).

The KV layout is the dense per-slot cache the model defines.  Sampling
at temperature > 0 draws from a ``torch.Generator`` seeded with
``seed``: reproducible, but not the bits of the reference's
``jax.random.categorical``.  Greedy decoding (the default) takes the
first maximal logit, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ServeConfig


def make_prefill_step(model, cache_len: int):
    def prefill_step(params, tokens):
        return model.prefill(params, tokens, cache_len)
    return prefill_step


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
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False


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
    sampling generator (temperature > 0).  Runs on the model's device.
    """

    def __init__(self, model, cfg: ArchConfig, scfg: ServeConfig, params,
                 seed: int = 0):
        self.device = model.device
        self.model = model
        self.cfg = cfg
        self.scfg = scfg
        self.params = params
        self.seed = int(seed)
        self.prefill_step = make_prefill_step(model, scfg.max_seq)
        self.decode_step = make_decode_step(model, scfg.temperature)
        self.pending: List[Request] = []
        self.active: List[Request] = []

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def _batch_prompts(self, reqs: List[Request]) -> np.ndarray:
        maxlen = max(len(r.prompt) + len(r.out) for r in reqs)
        toks = np.zeros((len(reqs), maxlen), np.int32)
        for i, r in enumerate(reqs):
            seq = r.prompt + r.out
            toks[i, -len(seq):] = seq          # left-pad
        return toks

    def run(self, max_steps: int = 1000) -> List[Request]:
        done: List[Request] = []
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        while (self.pending or self.active) and max_steps > 0:
            while self.pending and len(self.active) < self.scfg.max_batch:
                self.active.append(self.pending.pop(0))
            reqs = self.active
            toks = torch.as_tensor(self._batch_prompts(reqs),
                                   device=self.device)
            logits, cache = self.prefill_step(self.params, toks)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            pos = toks.shape[1]
            for r, t in zip(reqs, nxt.tolist()):
                r.out.append(t)
            # decode until any slot finishes, then re-batch
            steps = min(min(r.max_new - len(r.out) for r in reqs),
                        self.scfg.max_seq - pos - 1, max_steps)
            cur = nxt[:, None]
            for s in range(max(steps, 0)):
                p = torch.full((len(reqs), 1), pos + s, dtype=torch.int32,
                               device=self.device)
                cur_next, cache = self.decode_step(self.params, cache, cur,
                                                   p, gen)
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


__all__ = ["ContinuousBatcher", "Request", "SlotState", "make_decode_step",
           "make_prefill_step"]
