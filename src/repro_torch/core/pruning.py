"""Auto data pruning with the P1P2 confidence metric (paper §2.2).

PyTorch counterpart of ``repro/core/pruning.py``.  A teacher query (and the
subsequent sequential-train step) is SKIPPED iff all three hold:
  1. at least ``min_trained`` samples have been trained (paper: max(N, 288)),
  2. drift is not currently detected,
  3. confidence p1 - p2 > theta.

``theta`` is auto-tuned on a fixed ladder (paper §3.2: {1, .64, .32, .16, .08}):
start at the top (theta = 1 never skips); after X consecutive successes step
down; whenever a query reveals disagreement (c != t), step up.

Every transition is elementwise, so the same functions run on scalar states
and on fleet states whose leaves carry a leading stream axis S.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch import resolve_device

# Paper ladder, ordered from most conservative (never prune) downward.
DEFAULT_LADDER = (1.0, 0.64, 0.32, 0.16, 0.08)
DEFAULT_X = 10  # consecutive successes required to relax theta


@dataclasses.dataclass(frozen=True)
class PruneConfig:
    ladder: tuple = DEFAULT_LADDER
    x_consec: int = DEFAULT_X
    min_trained: int = 288  # paper: max(N, 288); resolved by caller
    enabled: bool = True

    @staticmethod
    def for_hidden(n_hidden: int, **kw) -> "PruneConfig":
        return PruneConfig(min_trained=max(n_hidden, 288), **kw)


class PruneState(NamedTuple):
    """Auto-theta controller state (per stream)."""

    level: torch.Tensor  # int32 — index into the ladder
    streak: torch.Tensor  # int32 — consecutive successes
    queries: torch.Tensor  # int32 — total teacher queries issued
    skips: torch.Tensor  # int32 — total queries pruned
    phase_trained: torch.Tensor  # int32 — samples trained this phase (cond. 1)


def init_state(device: str | torch.device | None = None) -> PruneState:
    device = resolve_device(device)
    return PruneState(*(torch.zeros((), dtype=torch.int32, device=device) for _ in range(5)))


def reset_phase(state: PruneState) -> PruneState:
    """New training phase (drift detected): re-arm condition 1."""
    return state._replace(phase_trained=torch.zeros_like(state.phase_trained))


def theta_of(state: PruneState, cfg: PruneConfig) -> torch.Tensor:
    """The ladder value at ``state.level`` (clamped), as f32.

    Built by selects on the device: a ladder tensor copied from the host
    would make every tick wait for the card.
    """
    level = torch.clamp(state.level, 0, len(cfg.ladder) - 1)
    theta = torch.full(level.shape, cfg.ladder[0], dtype=torch.float32, device=level.device)
    for i, value in enumerate(cfg.ladder[1:], start=1):
        theta = torch.where(level == i, value, theta)
    return theta


def confidence(outputs: torch.Tensor) -> torch.Tensor:
    """P1P2 metric: difference of the top-2 outputs along the last axis,
    clamped to [0, 1] so theta = 1 means "never prune"."""
    top2 = torch.topk(outputs, 2, dim=-1).values
    return torch.clamp(top2[..., 0] - top2[..., 1], 0.0, 1.0)


def should_query(
    state: PruneState,
    outputs: torch.Tensor,
    trained_count: torch.Tensor,
    drift_active: torch.Tensor,
    cfg: PruneConfig,
) -> torch.Tensor:
    """True iff the teacher must be queried for this sample.

    Condition 1 compares the *lifetime* trained-sample count (OS-ELM's
    ``count``) against ``min_trained``; drifts are handled by condition 2.
    """
    if not cfg.enabled:
        return torch.ones(outputs.shape[:-1], dtype=torch.bool, device=outputs.device)
    high_conf = confidence(outputs) > theta_of(state, cfg)
    warm = trained_count >= cfg.min_trained
    prune = warm & ~drift_active & high_conf
    return ~prune


def update(
    state: PruneState,
    queried: torch.Tensor,  # bool — did we query the teacher this step?
    agree: torch.Tensor,  # bool — c == t (only meaningful when queried)
    conf: torch.Tensor,  # f32 — p1 - p2 of this sample
    cfg: PruneConfig,
    theta: torch.Tensor | None = None,  # threshold the decision was made against
) -> PruneState:
    """Auto-theta transition (paper §2.2):

      * success  = (p1-p2 > theta)  OR  (c == t when querying with p1-p2 <= theta)
      * mismatch = (c != t when querying with p1-p2 <= theta)

    ``theta`` defaults to the current ladder value; a deferred answer is
    judged against the theta in force when its query was issued.
    """
    n_levels = len(cfg.ladder)
    if theta is None:
        theta = theta_of(state, cfg)
    high = conf > theta
    low_query = queried & ~high
    success = high | (low_query & agree)
    mismatch = low_query & ~agree

    zero = torch.zeros_like(state.streak)
    streak = torch.where(success, state.streak + 1, zero)
    hit_x = streak >= cfg.x_consec
    level = state.level
    level = torch.where(hit_x, torch.clamp(level + 1, max=n_levels - 1), level)
    level = torch.where(mismatch, torch.clamp(level - 1, min=0), level)
    streak = torch.where(hit_x | mismatch, zero, streak)

    q = queried.to(torch.int32)
    return PruneState(
        level=level,
        streak=streak,
        queries=state.queries + q,
        skips=state.skips + (1 - q),
        phase_trained=state.phase_trained + q,
    )


def scan_update(
    state: PruneState,
    queried: torch.Tensor,  # (k,) bool
    agree: torch.Tensor,  # (k,) bool
    conf: torch.Tensor,  # (k,) f32
    cfg: PruneConfig,
) -> PruneState:
    """Exact sequential controller semantics over a batch of k samples
    (``train_step`` gates a whole batch against the batch-start theta, then
    replays the controller sample by sample): ``update`` once per row, in
    order, each against the theta of the level the rows before it left (the
    reference's ``lax.scan``)."""
    for q, a, c in zip(queried.unbind(0), agree.unbind(0), conf.unbind(0), strict=True):
        state = update(state, q, a, c, cfg)
    return state


def select(cond: torch.Tensor, a: PruneState, b: PruneState) -> PruneState:
    """Per-stream choice between two fleet states: ``a``'s rows where
    ``cond`` (S,) holds, else ``b``'s."""
    return PruneState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def comm_volume_fraction(state: PruneState) -> torch.Tensor:
    """Queries / (queries + skips) — Fig. 3's communication-volume metric."""
    total = state.queries + state.skips
    frac = state.queries.to(torch.float32) / torch.clamp(total, min=1).to(torch.float32)
    return torch.where(total > 0, frac, torch.ones_like(frac))


def init_fleet(n_streams: int, device: str | torch.device | None = None) -> PruneState:
    return PruneState(*(a.expand((n_streams,)).clone() for a in init_state(device)))


def fleet_should_query(state: PruneState, outputs, trained_count, drift_active,
                       cfg: PruneConfig) -> torch.Tensor:
    """``should_query`` for S streams (outputs (S, m), the rest (S,)):
    elementwise over S, so ``should_query`` itself."""
    return should_query(state, outputs, trained_count, drift_active, cfg)


def fleet_update(state: PruneState, queried, agree, conf, cfg: PruneConfig) -> PruneState:
    """``update`` for S streams: elementwise over S, so ``update`` itself."""
    return update(state, queried, agree, conf, cfg)
