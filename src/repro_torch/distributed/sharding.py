"""Stream-axis sharding: which devices a fleet's streams are split over
(PyTorch counterpart of the stream-axis half of
``repro/distributed/sharding.py``).

The JAX package resolves logical axis names ("stream", "heads", ...) to mesh
axes through a rule table and lets GSPMD place the arrays.  One torch
process has no partitioner, so here placement is explicit: a ``FleetMesh``
is a list of devices, and the shard paths (``engine.fleet.split_fleet``,
``engine.stream.ShardedStreamSession``) put shard k's rows on its k-th
entry.  What stays is the scope: ``activate(mesh)`` makes a mesh current for
the code under it, ``deactivate()`` hides it again for shard-local regions,
and ``fleet_axis_size()`` says how many shards the ``stream`` rule splits a
fleet into under the current scope (1 with none).

The rule table is the reference's, copied whole, so rule overrides written
for it carry over; only the ``stream`` rule is read here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

_state = threading.local()

DEFAULT_RULES: dict[str, object] = {
    "batch": ("pod", "data"),
    "stream": ("fleet", "pod", "data"),
    "seq": None,
    "seq_sp": "model",  # sequence-parallel regions (hillclimb variant)
    "seq_kv": "model",  # decode KV/latent cache length (flash-decoding style)
    "seq_attn": None,  # q rows in attention (enabled when heads don't divide)
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_cap": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "elm_hidden": None,
    "elm_out": None,
    "classes": None,
    "layers": None,
    "frames": None,
}


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """A 1-D mesh: the devices a fleet's stream axis is split over, one per
    shard.  Entries may repeat a device (``[cuda:0] * 4`` runs four shards
    on one card, as the JAX package's forced host device count does on a
    CPU)."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("fleet",)

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", tuple(torch.device(d) for d in self.devices))

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
        return {self.axis_names[0]: len(self.devices)}


def _current() -> tuple[Optional[FleetMesh], dict]:
    return getattr(_state, "mesh", None), getattr(_state, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def activate(mesh: FleetMesh, rules: Optional[dict] = None):
    """Make ``mesh`` (and ``rules`` over the defaults) current for the code
    under this scope; the previous scope comes back on exit, also on an
    exception."""
    prev = _current()
    _state.mesh = mesh
    _state.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


@contextlib.contextmanager
def deactivate():
    """Hide the current mesh inside an ``activate`` scope, for shard-local
    regions (a sharded stream session's per-shard calls, each on one
    device): under it ``mesh_or_none()`` is None and ``fleet_axis_size()``
    is 1."""
    prev = _current()
    _state.mesh, _state.rules = None, DEFAULT_RULES
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def mesh_or_none() -> Optional[FleetMesh]:
    return _current()[0]


def fleet_axis_size() -> int:
    """Number of shards the ``stream`` rule resolves to under the current
    mesh: the product of the sizes of the mesh axes it names.  1 with no
    mesh current; callers size the stream-axis padding with it."""
    mesh, rules = _current()
    if mesh is None:
        return 1
    target = rules.get("stream", None)
    if target is None:
        return 1
    parts = (target,) if isinstance(target, str) else tuple(target)
    n = 1
    for p in parts:
        n *= mesh.shape.get(p, 1)
    return n


def constrain_fleet(tree):
    """The identity: the reference constrains a fleet's leading axis to the
    ``stream`` rule for GSPMD; here the shard paths place rows explicitly."""
    return tree
