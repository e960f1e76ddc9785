"""P2 helpers on the host: the hexagonal initial packing."""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def hex_init(n: int, spacing: float, center: Tuple[float, float] = (0., 0.),
             jitter: float = 0.0, seed: int = 0) -> np.ndarray:
    """Hexagonal close packing init: densest arrangement respecting d >= 2R."""
    pts: List[Tuple[float, float]] = []
    rows = int(math.ceil(math.sqrt(n))) + 2
    dy = spacing * math.sqrt(3.0) / 2.0
    for r in range(rows):
        for c in range(rows):
            x = c * spacing + (spacing / 2.0 if r % 2 else 0.0)
            pts.append((x, r * dy))
            if len(pts) >= n * 4:
                break
    arr = np.asarray(pts[:max(n * 4, n)], dtype=np.float64)
    arr -= arr.mean(axis=0)
    order = np.argsort((arr ** 2).sum(axis=1))
    out = arr[order[:n]] + np.asarray(center)
    if jitter:
        rng = np.random.default_rng(seed)
        out = out + rng.normal(scale=jitter, size=out.shape)
    return out


__all__ = ["hex_init"]
