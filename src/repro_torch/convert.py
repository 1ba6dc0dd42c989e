"""Carry engine state and configs across between the JAX package and the port.

State crosses as numpy, flattened under dotted leaf names (``elm.P``,
``prune.level``, ``drift.active``, ``meter.up_bytes``, ...): the two
packages' ``EngineState`` trees have the same leaf names and dtypes, so one
flat dict describes either.  Configs cross as the nested dict of their field
values (``dataclasses.asdict`` of an ``EngineConfig`` from either package).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import drift as drift_mod
from repro_torch.core import labels as labels_mod
from repro_torch.core import oselm, pruning
from repro_torch.engine.types import EngineConfig, EngineState

_GROUPS = {
    "elm": oselm.OSELMState,
    "prune": pruning.PruneState,
    "drift": drift_mod.DriftState,
    "meter": labels_mod.CommMeter,
}


def engine_state_to_numpy(state) -> dict[str, np.ndarray]:
    """Flatten an ``EngineState`` of either package to ``{"group.leaf": array}``.

    Leaves may be torch tensors (any device) or anything ``np.asarray``
    takes, such as JAX arrays.
    """
    out = {}
    for group in _GROUPS:
        sub = getattr(state, group)
        for leaf in sub._fields:
            v = getattr(sub, leaf)
            out[f"{group}.{leaf}"] = (
                v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            )
    return out


def engine_state_from_numpy(
    arrays: dict[str, np.ndarray], device: str | torch.device | None = None
) -> EngineState:
    """Build a port ``EngineState`` from the flat dict, on CUDA unless
    ``device`` says otherwise.  Raises if a leaf is missing or extra."""
    device = resolve_device(device)
    want = {f"{g}.{leaf}" for g, cls in _GROUPS.items() for leaf in cls._fields}
    if set(arrays) != want:
        raise KeyError(
            f"state leaves differ: missing {sorted(want - set(arrays))}, "
            f"extra {sorted(set(arrays) - want)}"
        )
    groups = {
        g: cls(*(torch.as_tensor(np.array(arrays[f"{g}.{leaf}"]), device=device)
                 for leaf in cls._fields))
        for g, cls in _GROUPS.items()
    }
    return EngineState(**groups)


def config_to_dict(cfg) -> dict:
    """An ``EngineConfig`` of either package as the nested dict of its field
    values, ``{"elm": {...}, "prune": {...}, "drift": {...}}`` (the JAX
    package's ``snapshot.config_to_dict``; tuples stay tuples, as there)."""
    return {
        "elm": dataclasses.asdict(cfg.elm),
        "prune": dataclasses.asdict(cfg.prune),
        "drift": dataclasses.asdict(cfg.drift),
    }


def engine_config_from_dict(fields: dict) -> EngineConfig:
    """Build a port ``EngineConfig`` from ``{"elm": {...}, "prune": {...},
    "drift": {...}}`` — e.g. ``dataclasses.asdict`` of a JAX config."""
    prune = dict(fields["prune"])
    prune["ladder"] = tuple(prune["ladder"])
    return EngineConfig(
        elm=oselm.OSELMConfig(**fields["elm"]),
        prune=pruning.PruneConfig(**prune),
        drift=drift_mod.DriftConfig(**fields["drift"]),
    )

