"""Carry engine state and configs across between the JAX package and the port.

State crosses as numpy, flattened under dotted leaf names (``elm.P``,
``prune.level``, ``drift.active``, ``meter.up_bytes``, ...): the two
packages' ``EngineState`` trees have the same leaf names and dtypes, so one
flat dict describes either.  Configs cross as the nested dict of their field
values (``dataclasses.asdict`` of an ``EngineConfig`` from either package).

A backbone's params cross as the reference's nested dict of arrays
(``lm_params_from_numpy``), checked leaf by leaf against the port's schema,
and a serving state with its caches as ``serve_state_from_numpy``: the
JAX package's ``jax.random`` draws cannot be reproduced, so the parity tests
load its params through these.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import drift as drift_mod
from repro_torch.core import labels as labels_mod
from repro_torch.core import oselm, pruning
from repro_torch.engine.fleet import FleetShards
from repro_torch.engine.types import EngineConfig, EngineState
from repro_torch.models import layers as layers_mod
from repro_torch.models import model as model_mod

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


def fleet_shards_from_numpy(shards, device: str | torch.device | None = None) -> FleetShards:
    """The port's ``FleetShards`` from either package's (the JAX package's
    blocks are JAX arrays): every block through ``engine_state_to_numpy``
    and ``engine_state_from_numpy`` onto ``device`` (CUDA unless named),
    ``bounds`` and ``n_pad`` copied."""
    return FleetShards(
        states=tuple(engine_state_from_numpy(engine_state_to_numpy(st), device)
                     for st in shards.states),
        bounds=tuple((int(lo), int(hi)) for lo, hi in shards.bounds),
        n_pad=int(shards.n_pad),
    )


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



def _tensor(a, device, dtype=None) -> torch.Tensor:
    """A numpy-convertible array (bf16 ones included) as a tensor on
    ``device``; bf16 crosses through f32, which holds it exactly."""
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        t = torch.as_tensor(np.array(arr, np.float32)).to(torch.bfloat16)
    else:
        t = torch.as_tensor(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def lm_params_from_numpy(tree: dict, cfg, device: str | torch.device | None = None) -> dict:
    """A serving model's params from the JAX package's params (a nested dict
    of arrays, any leaf ``np.asarray`` takes), on CUDA unless ``device``
    says otherwise: every leaf of ``model.build_schema(cfg)`` with its shape
    checked, matmul and embedding weights cast to bf16 as the reference
    casts them at use (``layers.serving_dtype``).  Raises on a missing,
    extra or misshapen leaf."""
    device = resolve_device(device)
    schema = model_mod.build_schema(cfg)

    def walk(sub, sch, path):
        if set(sub) != set(sch):
            raise KeyError(f"params at {'/'.join(path) or '<root>'} differ: missing "
                           f"{sorted(set(sch) - set(sub))}, extra {sorted(set(sub) - set(sch))}")
        out = {}
        for k, leaf in sch.items():
            if not isinstance(leaf, layers_mod.Leaf):
                out[k] = walk(sub[k], leaf, path + (k,))
                continue
            arr = np.asarray(sub[k])
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{'/'.join(path + (k,))}: shape {arr.shape}, schema {leaf.shape}")
            out[k] = _tensor(np.asarray(arr, np.float32), device, layers_mod.serving_dtype(leaf))
        return out

    return walk(tree, schema, ())


def serve_state_from_numpy(state, device: str | torch.device | None = None):
    """The port's ``model.ServeState`` from the JAX package's (``caches`` a
    nested dict of arrays, ``pos``, ``odl`` an engine state), on CUDA unless
    ``device`` says otherwise; cache leaves keep their dtype (bf16)."""
    device = resolve_device(device)

    def walk(sub):
        return {k: walk(v) if isinstance(v, dict) else _tensor(v, device) for k, v in sub.items()}

    return model_mod.ServeState(
        caches=walk(state.caches),
        pos=_tensor(state.pos, device, torch.int32),
        odl=engine_state_from_numpy(engine_state_to_numpy(state.odl), device),
    )
