"""State and config types of the ODL engine (PyTorch counterpart of
``repro/engine/types.py``).

``EngineConfig`` / ``EngineState`` / ``FleetStepOutput`` describe one ODL
head when their leaves are axis-free, and a whole fleet when every leaf
carries a leading stream axis S.  Leaf names and dtypes are the JAX
package's: int32 counters, bool ``drift.active``, f32 meter.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import drift as drift_mod
from repro_torch.core import labels as labels_mod
from repro_torch.core import oselm, pruning


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """ODL configuration (identical semantics for S = 1 and a fleet)."""

    elm: oselm.OSELMConfig = oselm.OSELMConfig()
    prune: pruning.PruneConfig = None  # type: ignore[assignment]
    drift: drift_mod.DriftConfig = drift_mod.DriftConfig()

    def __post_init__(self):
        if self.prune is None:
            object.__setattr__(
                self, "prune", pruning.PruneConfig.for_hidden(self.elm.n_hidden)
            )


class EngineState(NamedTuple):
    """elm/prune/drift/meter; axis-free leaves for one head, leading-S
    leaves for a fleet."""

    elm: oselm.OSELMState
    prune: pruning.PruneState
    drift: drift_mod.DriftState
    meter: labels_mod.CommMeter


class FleetStepOutput(NamedTuple):
    pred: torch.Tensor  # int32 local predicted class c
    outputs: torch.Tensor  # (.., m) raw outputs O
    queried: torch.Tensor  # bool
    trained: torch.Tensor  # bool
    theta: torch.Tensor  # f32 current threshold
    confidence: torch.Tensor  # f32 p1 - p2
    mode_training: torch.Tensor  # bool


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over NamedTuples of tensors (nested any depth)."""
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, *parts) for parts in zip(tree, *rest)))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of NamedTuples of tensors (nested any depth), in field order."""
    if isinstance(tree, tuple):
        return [leaf for part in tree for leaf in tree_leaves(part)]
    return [tree]


def init_state(cfg: EngineConfig, device: str | torch.device | None = None) -> EngineState:
    """Fresh axis-free (single-head) state, on CUDA unless ``device`` says
    otherwise; broadcast for a fleet via ``engine.init_fleet``."""
    return EngineState(
        elm=oselm.init_state(cfg.elm, device),
        prune=pruning.init_state(device),
        drift=drift_mod.init_state(device),
        meter=labels_mod.CommMeter.zero(device),
    )


# Scalar-era names of the JAX package, kept so configs read the same.
ODLCoreConfig = EngineConfig
ODLCoreState = EngineState
StepOutput = FleetStepOutput
