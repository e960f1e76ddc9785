"""Data pipeline (the reference's ``data/pipeline.py``): deterministic
synthetic token streams (per-host sharded) with background prefetch, plus
an image batch source for the CNN examples.  NumPy on the host, drawn in
the reference's order, so both packages get the same batches bitwise.

Synthetic data is zipf-distributed token ids with a learnable structure
(a periodic grammar), so small-model training loss demonstrably
decreases.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    vocab_size: int = 256
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    structure: float = 0.8     # fraction of positions following the grammar


class SyntheticLM:
    """tokens[t+1] = (a * tokens[t] + c) mod V with prob ``structure``,
    else zipf noise — learnable but non-trivial."""

    def __init__(self, dcfg: DataConfig):
        self.cfg = dcfg
        self.rng = np.random.default_rng(dcfg.seed * dcfg.n_hosts
                                         + dcfg.host_id)
        v = dcfg.vocab_size
        self.a = 5 % v or 1
        self.c = 7 % v

    def batch(self) -> Dict[str, np.ndarray]:
        c = self.cfg
        b, s, v = c.batch, c.seq_len, c.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = self.rng.integers(0, v, size=b)
        structured = self.rng.random((b, s)) < c.structure
        noise = self.rng.zipf(1.5, size=(b, s)) % v
        for t in range(s):
            nxt = (self.a * toks[:, t] + self.c) % v
            toks[:, t + 1] = np.where(structured[:, t], nxt, noise[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()


class Prefetcher:
    """Background-thread prefetch with a bounded queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def lm_data(cfg: ArchConfig, batch: int, seq_len: int, seed: int = 0,
            host_id: int = 0, n_hosts: int = 1,
            prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """``SyntheticLM`` batches over ``cfg``'s vocabulary, behind a
    ``Prefetcher`` of ``prefetch`` batches (none at 0)."""
    dcfg = DataConfig(batch=batch, seq_len=seq_len,
                      vocab_size=cfg.vocab_size, seed=seed,
                      host_id=host_id, n_hosts=n_hosts)
    it = iter(SyntheticLM(dcfg))
    return Prefetcher(it, prefetch) if prefetch else it


def image_batches(hw: int, channels: int, batch: int, n_classes: int,
                  seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Class-conditional gaussian blobs — LeNet can overfit them quickly."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, hw, hw, channels)).astype(np.float32)
    while True:
        y = rng.integers(0, n_classes, size=batch)
        x = protos[y] + 0.3 * rng.normal(size=(batch, hw, hw, channels))
        yield {"image": x.astype(np.float32), "label": y.astype(np.int32)}


__all__ = ["DataConfig", "Prefetcher", "SyntheticLM", "image_batches",
           "lm_data"]
