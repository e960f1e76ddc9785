"""1-D device meshes over the fleet rollout's trajectory axis.

``fleet_mesh`` names the devices the trajectory axis B of a
``FleetRollout.run`` is split over, as a tuple of ``torch.device``s in
shard order: each device takes an equal block of
rows, runs the same built rollout on them and the host gathers the
blocks.  A mesh may name one device more than once; its shards then run
one after the other on that device.  That is how the split, the padding
of a ragged B and the ``RolloutTrace.valid`` mask are exercised on one
card, or on the CPU.

``mesh_signature`` is the hashable token a ``PlanFnCache`` key carries so
that a mesh's entries never collide with the single-device ones, and
``pad_to_multiple`` the padded B of a ragged split.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

#: Axis name of the 1-D fleet-rollout mesh (the B trajectory axis).
FLEET_AXIS = "traj"


def _pin(dev) -> torch.device:
    """A concrete device: a bare ``cuda`` names the current card."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def fleet_mesh(devices: Union[None, int, Sequence] = None
               ) -> Tuple[torch.device, ...]:
    """A 1-D mesh over ``devices`` for trajectory-axis sharding.

    ``devices`` may be an int n (the first n CUDA devices; n must not
    exceed ``torch.cuda.device_count()``), a sequence of devices (one
    device may appear more than once; an existing mesh is one), or None
    (every visible CUDA device; raises without one).
    """
    if devices is None or isinstance(devices, int):
        avail = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        n = avail if devices is None else devices
        if n < 1 or n > avail:
            raise ValueError(
                f"requested a {n}-device mesh but {avail} CUDA device(s) "
                f"are available (on the CPU, name a device more than once: "
                f"fleet_mesh([torch.device('cpu')] * n))")
        devs = tuple(torch.device("cuda", i) for i in range(n))
    else:
        devs = tuple(_pin(d) for d in devices)
        if not devs:
            raise ValueError("fleet_mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"fleet_mesh: one device type a mesh; got "
                             f"{[str(d) for d in devs]}")
        for d in devs:
            if d.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"fleet_mesh: {d} named but CUDA is not "
                                   "available")
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"fleet_mesh: unsupported device {d}")
    return devs


def mesh_signature(mesh: Optional[Sequence[torch.device]]
                   ) -> Optional[tuple]:
    """Hashable device-topology token for built-function cache keys:
    ``("mesh", axis, size, platform, device indices)``, None for no mesh.
    A mesh's shard rollouts and the single-device rollout are different
    entries; the key carries this signature so they never collide."""
    if mesh is None:
        return None
    idx = tuple(-1 if d.index is None else d.index for d in mesh)
    return ("mesh", FLEET_AXIS, len(mesh), mesh[0].type, idx)


def pad_to_multiple(n: int, multiple: int) -> int:
    """Smallest padded size >= n divisible by ``multiple`` (every shard
    takes the same number of rows)."""
    if multiple <= 1:
        return n
    return ((n + multiple - 1) // multiple) * multiple


__all__ = ["FLEET_AXIS", "fleet_mesh", "mesh_signature",
           "pad_to_multiple"]
