"""Checkpoint discovery (the reference's ``runtime/checkpoint.py``
layout).  Layout::

    <dir>/step_<N>/
        manifest.json       # tree structure, shapes, dtypes, crc32 per leaf
        leaf_<i>.npy        # one file per leaf
        COMMIT              # written last: a checkpoint without it is torn

Only ``latest_step``, which ``FaultTolerantRunner.restore_step`` calls, is
ported; saving and restoring come with the training stack (ROADMAP queue
1 item 14.4).
"""
from __future__ import annotations

import os
from typing import Optional


def latest_step(dir_: str) -> Optional[int]:
    """The newest committed step under ``dir_`` (None when there is none):
    a step directory without its ``COMMIT`` file, or a ``.tmp`` one, is a
    torn write and never restored."""
    if not os.path.isdir(dir_):
        return None
    steps = []
    for name in os.listdir(dir_):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(dir_, name, "COMMIT")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


__all__ = ["latest_step"]
