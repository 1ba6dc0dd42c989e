"""Device meshes (PyTorch counterpart of ``repro/launch/mesh.py``): the
production meshes of the dry-run, the fleet mesh, the small (data, model)
mesh of the model side, and a mesh of any axes (the pipeline's
``("stage",)``).

Each is a function, not a module constant, so importing this module
touches no device.  ``make_production_mesh`` builds the reference's 256-
and 512-chip pods with meta-device entries by default: the counterpart of
the 512 placeholder CPU devices the JAX package's dry-run forces, so the
dry-run (``launch/dryrun.py``) lays out and counts a pod's cell on a host
with no card or one.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.distributed.sharding import Mesh


def _visible(devices: Optional[Sequence], what: str) -> list:
    """``devices`` as ``torch.device``s (default: every visible CUDA device;
    without one it raises unless the caller names devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: no CUDA device is visible; name the devices "
                "(devices=['cpu'] * n) to build a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``shape`` over axes ``axes`` on the first prod(shape)
    entries of ``devices``, row-major (the reference's ``_make_mesh``).

    ``devices`` defaults to every visible CUDA device; without one it
    raises unless the caller names devices.  An explicit list may repeat a
    device (``["cuda:0"] * 8``: eight entries on one card) or name the CPU
    (``["cpu"] * 8``), the port's counterpart of the JAX package's
    ``--xla_force_host_platform_device_count``."""
    shape = tuple(int(n) for n in shape)
    devices = _visible(devices, "make_mesh")
    if math.prod(shape) > len(devices):
        raise ValueError(f"a mesh of {shape} needs {math.prod(shape)} entries > "
                         f"{len(devices)} visible devices")
    return Mesh(tuple(devices[:math.prod(shape)]), tuple(axes), shape)


def make_production_mesh(*, multi_pod: bool = False, devices: Optional[Sequence] = None) -> Mesh:
    """16 x 16 over ``("data", "model")`` (one 256-chip pod) or 2 x 16 x 16
    over ``("pod", "data", "model")`` (two pods), the reference's shapes.
    The entries default to the meta device; ``devices`` names them, as
    ``make_mesh`` takes them."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if devices is None:
        devices = [torch.device("meta")] * math.prod(shape)
    return make_mesh(shape, axes, devices)


def make_dev_mesh(data: int = 2, model: int = 2, devices: Optional[Sequence] = None) -> Mesh:
    """A small ``("data", "model")`` mesh (the reference's CPU multi-device
    tests use (2, 4), (4, 2) and (2, 2)), with ``make_mesh``'s device
    rules."""
    return make_mesh((data, model), ("data", "model"), devices)


def make_fleet_mesh(n: int = 0, devices: Optional[Sequence] = None) -> Mesh:
    """1-D ``("fleet",)`` mesh over the first ``n`` entries of ``devices``
    (``n <= 0``: all of them), with ``make_mesh``'s device rules; ``n``
    greater than the list raises, as in the reference."""
    devices = _visible(devices, "make_fleet_mesh")
    if n <= 0:
        n = len(devices)
    if n > len(devices):
        raise ValueError(f"mesh-fleet {n} > {len(devices)} visible devices")
    return Mesh(tuple(devices[:n]))
