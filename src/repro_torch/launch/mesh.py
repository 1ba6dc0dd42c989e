"""Device meshes (PyTorch counterpart of ``repro/launch/mesh.py``'s fleet
mesh).

``make_fleet_mesh`` is a function, not a module constant, so importing this
module touches no device.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.distributed.sharding import FleetMesh


def make_fleet_mesh(n: int = 0, devices: Optional[Sequence] = None) -> FleetMesh:
    """1-D ``("fleet",)`` mesh over the first ``n`` entries of ``devices``
    (``n <= 0``: all of them).

    ``devices`` defaults to every visible CUDA device; without one it
    raises unless the caller names devices.  An explicit list may repeat a
    device (``["cuda:0"] * 4``: four shards on one card) or name the CPU
    (``["cpu"] * 8``), the port's counterpart of the JAX package's
    ``--xla_force_host_platform_device_count``.  ``n`` greater than the
    list raises, as in the reference.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_fleet_mesh: no CUDA device is visible; name the devices "
                "(devices=['cpu'] * n) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    avail = len(devices)
    if n <= 0:
        n = avail
    if n > avail:
        raise ValueError(f"mesh-fleet {n} > {avail} visible devices")
    return FleetMesh(tuple(devices[:n]))
