"""Batched fleet engine for Algorithm 1 (PyTorch counterpart of
``repro/engine/fleet.py``).

Design rules, as in the JAX engine:
  * every leaf of ``EngineState`` carries a leading stream axis S;
  * all per-stream controller math (pruning ladder, drift detector) is
    elementwise, so the scalar transition functions in ``core/`` apply to
    (S,) tensors unchanged;
  * the device-heavy work is one (S, n_in) hidden projection per tick (the
    projection kernel) and one masked rank-1 RLS update per tick (the fused
    RLS kernel), plus the per-stream readout (S, N) x (S, N, m) (the readout
    kernel, one warp per stream, so a row's output does not depend on S);
  * one tick is split at the teacher round-trip: ``plan`` (predict, drift,
    query decision, comm metering) and ``learn`` (masked rank-1 RLS + the
    auto-theta controller observing answered queries).  ``fleet_step`` is
    exactly ``learn(plan(...))`` with same-tick labels.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import drift as drift_mod
from repro_torch.core import labels as labels_mod
from repro_torch.core import oselm, pruning
from repro_torch.engine.types import (
    EngineConfig,
    EngineState,
    FleetStepOutput,
    init_state,
    tree_leaves,
    tree_map,
)
from repro_torch.kernels import ops

MODES = ("algo1", "train_phase", "serve")

# How many tick-function factories each runner cache keeps per process (the
# stream runners in ``engine/stream.py``): a serving process cycles through a
# handful of (cfg, mode, donate) combinations, and an unbounded cache would
# keep one per combination forever.
RUNNER_CACHE_SIZE = 32


def init_fleet(
    cfg: EngineConfig, n_streams: int, device: str | torch.device | None = None
) -> EngineState:
    """Fresh state for ``n_streams`` streams, on CUDA unless ``device`` says otherwise."""
    return broadcast_streams(init_state(cfg, device), n_streams)


def broadcast_streams(state: EngineState, n_streams: int) -> EngineState:
    """Replicate one (scalar, no-S-axis) state across n_streams streams."""
    return tree_map(lambda a: a.expand((n_streams,) + a.shape).clone(), state)


def stream_slice(state: EngineState, s: int) -> EngineState:
    """Extract stream ``s`` as a scalar (axis-free) state."""
    return tree_map(lambda a: a[s], state)


# -- stacked-state helpers (cohort fusion, engine/cohort.py) ----------------
#
# A cohort stacks same-shaped tenants' EngineStates along the leading stream
# axis, so one plan/learn dispatch advances all of them.  Every op of plan and
# learn computes a row in an order that does not depend on S: the projection
# has no split over n_in, the RLS kernel works on one stream per block, the
# readout and the drift feature mean give a stream one warp, and their CPU
# versions are made alike (``kernels/ops``).  So row r of a stacked dispatch
# is bit for bit row r of the solo dispatch.


def stack_streams(states: list[EngineState]) -> EngineState:
    """Concatenate fleets along the leading stream axis (one ``torch.cat`` per leaf)."""
    return tree_map(lambda *ls: torch.cat(ls, dim=0), *states)


def slice_streams(state: EngineState, lo: int, hi: int) -> EngineState:
    """The ``[lo:hi]`` stream window (one cohort member's rows), as views."""
    return tree_map(lambda a: a[lo:hi], state)


def remove_streams(state: EngineState, lo: int, hi: int) -> EngineState:
    """Drop the ``[lo:hi]`` stream window (evict a member from a cohort)."""
    return tree_map(lambda a: torch.cat([a[:lo], a[hi:]], dim=0), state)


@functools.lru_cache(maxsize=RUNNER_CACHE_SIZE)
def _patch_learn_runner(cfg: EngineConfig, lo: int, hi: int, donate: bool):
    """Tick function that learns one member's ``[lo:hi]`` row window of a
    stacked cohort state, in place:
    ``fn(cur, spare, h, labels, pred, conf, mask, controller_on, theta)``.

    ``cur`` is the cohort's current state and ``spare`` its other buffer
    set (``engine/stream.py``'s ping-pong pair).  The member-width ``learn``
    reads the window of ``cur``, the RLS kernel writes P' and beta' into the
    window of ``spare`` (it must not write what it reads), and the window's
    new rows are copied back into ``cur``.  A straggler reply (a ticket asked
    before its tenant joined the cohort, or before a resize) so costs one
    member-width update and two window copies, never a copy of the stacked
    P; rows outside the window are untouched, so this is bit for bit the
    solo ``learn`` on those rows.  ``donate`` is part of the key, as in the
    JAX package."""
    del donate

    def run_patch(cur, spare, h, labels, pred, conf, mask, controller_on, theta):
        sub = slice_streams(cur, lo, hi)
        out = slice_streams(spare.elm, lo, hi)
        new = learn(sub, h, labels, pred, conf, mask, controller_on, cfg, theta=theta,
                    out=(out.P, out.beta))
        for dst, src in zip(tree_leaves(sub), tree_leaves(new)):
            if dst is not src:
                dst.copy_(src)

    return run_patch


def _tree_where(cond: torch.Tensor, a, b):
    """Per-stream select between two states of (S,)-leading leaves."""
    return tree_map(
        lambda x, y: torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())), x, y),
        a,
        b,
    )


def _predict(state: EngineState, x: torch.Tensor, cfg: EngineConfig):
    """Fleet predict: hidden projection once, then the per-stream readout."""
    h = oselm.hidden(x, cfg.elm)  # (S, N)
    o = ops.readout(h, state.elm.beta)  # (S, m)
    return h, torch.argmax(o, dim=-1).to(torch.int32), o


class PlanOutput(NamedTuple):
    """Everything the first half of a tick produces — including what must
    survive the teacher round-trip so ``learn`` can apply labels later."""

    h: torch.Tensor  # (S, N) hidden activations at query time
    pred: torch.Tensor  # (S,) int32 local prediction c
    outputs: torch.Tensor  # (S, m) raw outputs O
    confidence: torch.Tensor  # (S,) f32 p1 - p2
    queried: torch.Tensor  # (S,) bool — streams shipping feats to the teacher
    controller_on: torch.Tensor  # (S,) bool — ladder observes this tick
    theta: torch.Tensor  # (S,) f32 threshold in force this tick
    mode_training: torch.Tensor  # (S,) bool


def plan(
    state: EngineState,
    x: torch.Tensor,  # (S, n_in)
    cfg: EngineConfig,
    mode: str = "algo1",
    teacher_available: Optional[torch.Tensor] = None,  # (S,) bool
    drift_active: Optional[torch.Tensor] = None,  # (S,) bool (train_phase only)
) -> tuple[EngineState, PlanOutput]:
    """Teacher-facing half of one tick: predict → confidence → drift →
    should_query, charge the comm meter for issued queries, and account the
    pruning ladder's SKIP events (streams the controller observes but that
    do not query — their transition needs no label).

    ``elm`` passes through untouched.  Queried streams' ladder transitions
    wait for ``learn``.  The meter charges every *issued* query here, while
    ``prune.queries`` counts only *answered* ones (incremented in ``learn``).
    """
    if mode not in MODES:
        raise ValueError(f"unknown engine mode {mode!r}")
    n_streams = x.shape[0]
    dev = x.device
    if teacher_available is None:
        teacher_available = torch.ones((n_streams,), dtype=torch.bool, device=dev)
    off = torch.zeros((n_streams,), dtype=torch.bool, device=dev)

    h, c, o = _predict(state, x, cfg)
    conf = pruning.confidence(o)

    if mode == "serve":
        # ``gate`` semantics: live drift detector, a drifting stream is
        # forced to query, the controller is always armed, no training-mode
        # gating — so plan(mode='serve') + learn == gate + apply_labels.
        s = drift_mod.score(x, o, cfg.drift)
        new_drift = drift_mod.update(state.drift, s, cfg.drift)
        training = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        prune_st = state.prune
        want_query = pruning.should_query(
            prune_st, o, state.elm.count, new_drift.active, cfg.prune
        )
        queried = want_query & teacher_available
        controller_on = teacher_available
    elif mode == "algo1":
        # IsDrift / IsTrainDone: per-stream detector with hysteresis.
        s = drift_mod.score(x, o, cfg.drift)
        new_drift = drift_mod.update(state.drift, s, cfg.drift)
        training = new_drift.active
        # Rising edge == IsDrift fired: re-arm the per-phase counter.
        entering = training & ~state.drift.active
        prune_st = _tree_where(entering, pruning.reset_phase(state.prune), state.prune)
        want_query = pruning.should_query(prune_st, o, state.elm.count, off, cfg.prune)
        queried = training & want_query & teacher_available
        # Auto-theta only observes training-mode steps with a live teacher.
        controller_on = training & teacher_available
    else:
        if drift_active is None:
            drift_active = off
        new_drift = state.drift
        training = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        prune_st = state.prune
        want_query = pruning.should_query(
            prune_st, o, state.elm.count, drift_active, cfg.prune
        )
        queried = want_query & teacher_available
        controller_on = teacher_available

    theta = pruning.theta_of(prune_st, cfg.prune)
    meter = state.meter.charge_query(x.shape[-1], queried)
    # A skipped sample's ladder transition uses only (conf > theta), never
    # the teacher's answer, so it is accounted now.
    new_prune = _tree_where(
        controller_on & ~queried,
        pruning.update(prune_st, off, off, conf, cfg.prune),
        prune_st,
    )

    new_state = EngineState(elm=state.elm, prune=new_prune, drift=new_drift, meter=meter)
    out = PlanOutput(
        h=h,
        pred=c,
        outputs=o,
        confidence=conf,
        queried=queried,
        controller_on=controller_on,
        theta=theta,
        mode_training=training,
    )
    return new_state, out


def learn(
    state: EngineState,
    h: torch.Tensor,  # (S, N) hidden activations captured at plan time
    labels: torch.Tensor,  # (S,) int teacher answers (valid where mask)
    pred: torch.Tensor,  # (S,) int32 plan-time local predictions
    confidence: torch.Tensor,  # (S,) f32 plan-time P1P2 confidence
    mask: torch.Tensor,  # (S,) bool — answered queries to apply
    controller_on: torch.Tensor,  # (S,) bool — plan-time controller gate
    cfg: EngineConfig,
    theta: Optional[torch.Tensor] = None,  # (S,) plan-time threshold
    out: Optional[tuple[torch.Tensor, torch.Tensor]] = None,  # (P', beta') buffers
) -> EngineState:
    """Deferred half of a tick: masked rank-1 RLS on the teacher's answers
    (the fused RLS kernel) plus the auto-theta ladder transition for the
    answered queries, judged against the plan-time values.  A stream outside
    ``mask`` is an exact identity.  ``out``: buffers the new P and beta are
    written into (``oselm.fleet_rank1_update_h``)."""
    y = labels_mod.one_hot(labels, cfg.elm.n_out)  # (S, m)
    agree = pred == labels
    new_elm = oselm.fleet_rank1_update_h(state.elm, h, y, cfg.elm, mask=mask, out=out)
    new_prune = _tree_where(
        controller_on & mask,
        pruning.update(state.prune, mask, agree, confidence, cfg.prune, theta=theta),
        state.prune,
    )
    return state._replace(elm=new_elm, prune=new_prune)


def fleet_step(
    state: EngineState,
    x: torch.Tensor,  # (S, n_in)
    labels: torch.Tensor,  # (S,) int teacher answers (used only where queried)
    cfg: EngineConfig,
    mode: str = "algo1",
    teacher_available: Optional[torch.Tensor] = None,  # (S,) bool
    drift_active: Optional[torch.Tensor] = None,  # (S,) bool (train_phase only)
) -> tuple[EngineState, FleetStepOutput]:
    """One tick for all S streams — ``learn`` composed directly on ``plan``
    (a zero-latency teacher)."""
    state, p = plan(
        state, x, cfg, mode=mode,
        teacher_available=teacher_available, drift_active=drift_active,
    )
    state = learn(
        state, p.h, labels, p.pred, p.confidence, p.queried, p.controller_on, cfg,
        theta=p.theta,
    )
    out = FleetStepOutput(
        pred=p.pred,
        outputs=p.outputs,
        queried=p.queried,
        trained=p.queried,
        theta=p.theta,
        confidence=p.confidence,
        mode_training=p.mode_training,
    )
    return state, out


def fleet_accuracy(
    state: EngineState,
    xs: torch.Tensor,  # (B, n_in) shared test batch
    ys: torch.Tensor,  # (B,) int
    cfg: EngineConfig,
) -> torch.Tensor:
    """Per-stream test accuracy of every head against one shared batch:
    one hidden projection, per-stream readout via einsum — returns (S,)."""
    h = oselm.hidden(xs, cfg.elm)  # (B, N)
    o = torch.einsum("bn,snm->sbm", h, state.elm.beta)  # (S, B, m)
    preds = torch.argmax(o, dim=-1)  # (S, B)
    return (preds == ys.to(preds.device)[None, :]).to(torch.float32).mean(dim=-1)


def runner_cache_info() -> dict:
    """Hit/miss/size counters of this module's runner caches, for serving
    stats (``engine.stream.cache_stats`` merges these with its own): the
    patch-learn runners.  ``run_fleet`` is an eager per-tick loop and caches
    no chunk runner."""
    info = _patch_learn_runner.cache_info()
    return {"patch_learn_runner": {"hits": info.hits, "misses": info.misses,
                                   "size": info.currsize, "maxsize": info.maxsize}}


def run_fleet(
    state: EngineState,
    xs,  # (T, S, n_in) tensor or array
    labels,  # (T, S) int
    cfg: EngineConfig,
    mode: str = "algo1",
    teacher_available=None,  # (T, S) bool
    chunk: Optional[int] = None,
    donate: Optional[bool] = None,
) -> tuple[EngineState, FleetStepOutput]:
    """Run T ticks of S streams through the engine on ``state``'s device.
    Returns (final state, outputs stacked over (T, S)).

    The ticks run in a Python loop, one ``fleet_step`` each.  ``chunk`` and
    ``donate`` are accepted so calls written for the JAX engine carry over;
    the result does not depend on them.  The counterpart of donation is
    that the loop keeps only the newest state: each tick's RLS kernel
    writes fresh P and beta buffers and the previous ones are released, so
    peak memory holds two copies of P, not T.
    """
    del chunk, donate
    dev = state.elm.P.device
    xs = torch.as_tensor(xs, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    t_total, s = xs.shape[0], xs.shape[1]
    if teacher_available is not None:
        teacher_available = torch.as_tensor(teacher_available, device=dev)
    outs = []
    for t in range(t_total):
        state, out = fleet_step(
            state, xs[t], labels[t], cfg, mode=mode,
            teacher_available=None if teacher_available is None else teacher_available[t],
        )
        outs.append(out)
    if not outs:
        m = cfg.elm.n_out
        return state, FleetStepOutput(
            pred=torch.zeros((0, s), dtype=torch.int32, device=dev),
            outputs=torch.zeros((0, s, m), dtype=torch.float32, device=dev),
            queried=torch.zeros((0, s), dtype=torch.bool, device=dev),
            trained=torch.zeros((0, s), dtype=torch.bool, device=dev),
            theta=torch.zeros((0, s), dtype=torch.float32, device=dev),
            confidence=torch.zeros((0, s), dtype=torch.float32, device=dev),
            mode_training=torch.zeros((0, s), dtype=torch.bool, device=dev),
        )
    return state, tree_map(lambda *a: torch.stack(a, dim=0), *outs)


# ---------------------------------------------------------------------------
# Serving entry points: one tick split at the teacher round-trip.
# ---------------------------------------------------------------------------


class GateOutput(NamedTuple):
    """Plan-time decision context of one serving tick: everything
    ``apply_labels`` needs to judge a teacher answer that comes back later."""

    h: torch.Tensor  # (S, N) hidden activations at query time
    pred: torch.Tensor  # (S,) int32 local prediction c
    outputs: torch.Tensor  # (S, m) raw outputs O
    confidence: torch.Tensor  # (S,) f32 p1 - p2 at query time
    queried: torch.Tensor  # (S,) bool — streams shipping feats to the teacher
    theta: torch.Tensor  # (S,) f32 threshold in force at query time
    feats: torch.Tensor  # (S, n_in) the raw features (for a real teacher RPC)
    drift_active: torch.Tensor  # (S,) bool


def gate(
    state: EngineState,
    x: torch.Tensor,  # (S, n_in) features, one per stream
    cfg: EngineConfig,
) -> tuple[EngineState, GateOutput]:
    """Predict + decide which streams must consult the teacher.

    Runs the drift detector (a drifting stream is forced to query), charges
    the comm meter for issued queries, and accounts the ladder's skip
    events for the non-querying streams.  Labels arrive later via
    ``apply_labels`` with the returned ``GateOutput``.
    """
    h, c, o = _predict(state, x, cfg)
    conf = pruning.confidence(o)
    s = drift_mod.score(x, o, cfg.drift)
    new_drift = drift_mod.update(state.drift, s, cfg.drift)
    query_mask = pruning.should_query(
        state.prune, o, state.elm.count, new_drift.active, cfg.prune
    )
    theta = pruning.theta_of(state.prune, cfg.prune)
    meter = state.meter.charge_query(x.shape[-1], query_mask)
    off = torch.zeros_like(query_mask)
    new_prune = _tree_where(
        ~query_mask,
        pruning.update(state.prune, off, off, conf, cfg.prune),
        state.prune,
    )
    new_state = state._replace(drift=new_drift, meter=meter, prune=new_prune)
    out = GateOutput(
        h=h,
        pred=c,
        outputs=o,
        confidence=conf,
        queried=query_mask,
        theta=theta,
        feats=x,
        drift_active=new_drift.active,
    )
    return new_state, out


def apply_labels(
    state: EngineState,
    ctx: Union[GateOutput, PlanOutput],
    labels: torch.Tensor,  # (S,) int teacher answers (valid where mask)
    mask: torch.Tensor,  # (S,) bool — streams whose teacher answered
    cfg: EngineConfig,
) -> EngineState:
    """Asynchronous label application: masked rank-1 RLS + auto-theta step,
    judged against the plan-time context ``ctx`` (exactly like ``learn``).
    Only the answered streams (``mask``) transition the ladder."""
    if not isinstance(ctx, (GateOutput, PlanOutput)):
        raise TypeError(
            "apply_labels needs the plan-time decision context: pass the "
            f"GateOutput returned by gate() (or a PlanOutput). Got {type(ctx).__name__}."
        )
    agree = ctx.pred == labels
    y = labels_mod.one_hot(labels, cfg.elm.n_out)
    new_elm = oselm.fleet_rank1_update_h(state.elm, ctx.h, y, cfg.elm, mask=mask)
    new_prune = _tree_where(
        mask,
        pruning.update(state.prune, mask, agree, ctx.confidence, cfg.prune, theta=ctx.theta),
        state.prune,
    )
    return state._replace(elm=new_elm, prune=new_prune)

