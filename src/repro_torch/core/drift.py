"""Lightweight concept-drift detection (paper Alg. 1 line 3, citing Yamada+23).

PyTorch counterpart of ``repro/core/drift.py``: exponentially-weighted
moving statistics of a scalar score with a k-sigma test, plus hysteresis
(consecutive hits to enter drift, consecutive calm steps to leave).

Score sources: the feature moment ||x||_1 / n and the P1P2 confidence of the
local prediction; the default averages both.  Every transition is
elementwise, so the detector runs scalar or fleet-wide unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    ewma_decay: float = 0.98  # mean/var tracker decay
    k_sigma: float = 4.0  # deviation threshold
    warmup: int = 64  # steps before the test is armed
    enter_hits: int = 3  # consecutive outliers to declare drift
    exit_calm: int = 32  # consecutive calm steps to end the training phase
    use_confidence: bool = True
    use_features: bool = True


class DriftState(NamedTuple):
    mean: torch.Tensor  # f32 EWMA of score
    var: torch.Tensor  # f32 EWMA of squared deviation
    steps: torch.Tensor  # int32
    hits: torch.Tensor  # int32 consecutive outliers
    calm: torch.Tensor  # int32 consecutive calm steps
    active: torch.Tensor  # bool — currently in drift (training) mode


def init_state(device: str | torch.device | None = None) -> DriftState:
    device = resolve_device(device)

    def z(dtype):
        return torch.zeros((), dtype=dtype, device=device)

    return DriftState(
        mean=z(torch.float32),
        var=torch.ones((), dtype=torch.float32, device=device),
        steps=z(torch.int32),
        hits=z(torch.int32),
        calm=z(torch.int32),
        active=z(torch.bool),
    )


def score(x: torch.Tensor, outputs: torch.Tensor, cfg: DriftConfig,
          feature_mean: torch.Tensor | None = None) -> torch.Tensor:
    """Drift score; x: (..., n_in), outputs: (..., m) -> score (...,).
    ``feature_mean``: mean(|x|) over the last axis, where already computed."""
    parts = []
    if cfg.use_features:
        parts.append(ops.row_abs_mean(x) if feature_mean is None else feature_mean)
    if cfg.use_confidence:
        top2 = torch.topk(outputs, 2, dim=-1).values
        parts.append(-(top2[..., 0] - top2[..., 1]))  # low confidence -> high score
    return torch.stack(parts, dim=0).mean(dim=0)


def update(state: DriftState, s: torch.Tensor, cfg: DriftConfig) -> DriftState:
    """One detector step on score ``s``; returns the new state.

    ``state.active`` is the mode bit of the paper's Alg. 1: False=predicting,
    True=training.  IsDrift == rising edge of active; IsTrainDone == falling.
    """
    f32 = torch.float32
    d = s - state.mean
    # Relative variance floor (0.1% of the signal): the bootstrap estimate
    # can collapse on near-constant streams.
    var_floor = torch.square(1e-3 * torch.abs(state.mean)) + 1e-12
    std = torch.sqrt(torch.maximum(state.var, var_floor))
    armed = state.steps >= cfg.warmup
    outlier = armed & (torch.abs(d) > cfg.k_sigma * std)

    # Track statistics only on non-outlier samples (robustness).  decay and
    # 1 - decay are the f32 values the JAX package computes, kept as Python
    # floats so no host-to-device copy stalls the tick.
    decay = float(np.float32(cfg.ewma_decay))
    keep = float(np.float32(1.0) - np.float32(cfg.ewma_decay))
    upd = ~outlier
    new_mean = torch.where(upd, decay * state.mean + keep * s, state.mean)
    new_var = torch.where(upd, decay * state.var + keep * torch.square(d), state.var)
    # Early steps: bootstrap the tracker with running (not last-sample) stats.
    boot = state.steps < 8
    steps_f = state.steps.to(f32)
    new_mean = torch.where(boot, (state.mean * steps_f + s) / (steps_f + 1), new_mean)
    boot_var = (state.var * steps_f + torch.square(d)) / (steps_f + 1)
    new_var = torch.where(boot, torch.clamp(boot_var, min=1e-9), new_var)

    zero = torch.zeros_like(state.hits)
    hits = torch.where(outlier, state.hits + 1, zero)
    calm = torch.where(outlier, zero, state.calm + 1)

    enter = hits >= cfg.enter_hits
    leave = calm >= cfg.exit_calm
    active = torch.where(state.active, ~leave, enter)

    return DriftState(
        mean=new_mean,
        var=new_var,
        steps=state.steps + 1,
        hits=torch.where(enter, zero, hits),
        calm=torch.where(leave, zero, calm),
        active=active,
    )


def init_fleet(n_streams: int, device: str | torch.device | None = None) -> DriftState:
    return DriftState(*(a.expand((n_streams,)).clone() for a in init_state(device)))


def fleet_update(state: DriftState, s: torch.Tensor, cfg: DriftConfig) -> DriftState:
    """``update`` for S detectors (leaves and ``s`` of shape (S,)): the step
    is elementwise, so this is ``update`` itself."""
    return update(state, s, cfg)
