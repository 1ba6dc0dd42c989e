"""The paper's single-stream ODL API (Algorithm 1) — the S=1 view.

PyTorch counterpart of the JAX package's scalar view.  The state machine is
the batched fleet engine (``engine/fleet.py``); this view adds a leading
stream axis of 1, delegates to ``fleet_step`` / ``run_fleet``, and strips
the axis again, so each stream's semantics are the fleet's.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import oselm, pruning
from repro_torch.engine import fleet
from repro_torch.engine.types import (
    ODLCoreConfig,
    ODLCoreState,
    StepOutput,
    init_state,
    tree_map,
)

__all__ = [
    "ODLCoreConfig",
    "ODLCoreState",
    "StepOutput",
    "accuracy",
    "init_state",
    "run_stream",
    "run_training_phase",
    "step",
    "train_phase_step",
]


def _expand(tree):
    """Scalar state/tensors -> fleet of one stream (leading axis 1)."""
    return tree_map(lambda a: a[None], tree)


def _own_fleet(state):
    """A fleet of one stream in buffers of its own, as the JAX package's
    ``_expand`` makes new arrays: ``run_fleet`` donates it on the card, so
    the caller's state stays as it was."""
    return tree_map(lambda a: a[None].clone(), state)


def _squeeze(tree):
    return tree_map(lambda a: a[0], tree)


def _scalar_step(
    state: ODLCoreState,
    x: torch.Tensor,
    idx,
    teacher: Callable,
    cfg: ODLCoreConfig,
    mode: str,
    teacher_available: Optional[torch.Tensor],
    drift_active: Optional[torch.Tensor],
) -> tuple[ODLCoreState, StepOutput]:
    dev = state.elm.P.device
    x = torch.as_tensor(x, device=dev)
    t = torch.as_tensor(teacher(idx, x), device=dev).reshape(1)
    fstate, fout = fleet.fleet_step(
        _expand(state),
        x[None],
        t,
        cfg,
        mode=mode,
        teacher_available=None if teacher_available is None else _expand(teacher_available),
        drift_active=None if drift_active is None else _expand(drift_active),
    )
    return _squeeze(fstate), _squeeze(fout)


def train_phase_step(
    state: ODLCoreState,
    x: torch.Tensor,
    idx,
    teacher: Callable,
    cfg: ODLCoreConfig,
    drift_active: Optional[torch.Tensor] = None,
    teacher_available: Optional[torch.Tensor] = None,
) -> tuple[ODLCoreState, StepOutput]:
    """One sample of the paper's retraining phase (pruning always armed).

    ``drift_active`` models pruning condition 2 (default: not detected).
    ``teacher_available`` models the retry-or-skip fault policy: when False
    the query is suppressed *and* no training happens this step.
    """
    return _scalar_step(
        state, x, idx, teacher, cfg, "train_phase", teacher_available, drift_active
    )


def step(
    state: ODLCoreState,
    x: torch.Tensor,
    idx,
    teacher: Callable,
    cfg: ODLCoreConfig,
) -> tuple[ODLCoreState, StepOutput]:
    """Full Algorithm 1: drift detector switches predicting <-> training."""
    return _scalar_step(state, x, idx, teacher, cfg, "algo1", None, None)


def run_training_phase(
    state: ODLCoreState,
    xs,  # (T, n_in)
    teacher_labels,  # (T,) int
    cfg: ODLCoreConfig,
    teacher_available=None,  # (T,) bool
) -> tuple[ODLCoreState, StepOutput]:
    """The retraining phase over a stream (paper §3 step 3) — a one-stream
    ``run_fleet``.  Condition 1 is the lifetime trained count, so a head
    booted on max(N, 288) samples prunes from the first stream sample."""
    dev = state.elm.P.device
    state = state._replace(prune=pruning.reset_phase(state.prune))
    xs = torch.as_tensor(xs, device=dev)
    labels = torch.as_tensor(teacher_labels, device=dev)
    avail = None
    if teacher_available is not None:
        avail = torch.as_tensor(teacher_available, device=dev)[:, None]
    fstate, fouts = fleet.run_fleet(
        _own_fleet(state), xs[:, None], labels[:, None], cfg,
        mode="train_phase", teacher_available=avail, chunk=fleet.CHUNK_TICKS,
    )
    return _squeeze(fstate), tree_map(lambda a: a[:, 0], fouts)


def run_stream(
    state: ODLCoreState,
    xs,
    teacher_labels,
    cfg: ODLCoreConfig,
) -> tuple[ODLCoreState, StepOutput]:
    """The full Algorithm-1 ``step`` over a stream (one-stream fleet)."""
    dev = state.elm.P.device
    xs = torch.as_tensor(xs, device=dev)
    labels = torch.as_tensor(teacher_labels, device=dev)
    fstate, fouts = fleet.run_fleet(
        _own_fleet(state), xs[:, None], labels[:, None], cfg, mode="algo1",
        chunk=fleet.CHUNK_TICKS,
    )
    return _squeeze(fstate), tree_map(lambda a: a[:, 0], fouts)


def accuracy(state: ODLCoreState, xs, ys, cfg: ODLCoreConfig) -> torch.Tensor:
    """Batch test accuracy of the current head."""
    dev = state.elm.P.device
    preds, _ = oselm.predict(state.elm, torch.as_tensor(xs, device=dev), cfg.elm)
    return (preds == torch.as_tensor(ys, device=dev)).to(torch.float32).mean()
