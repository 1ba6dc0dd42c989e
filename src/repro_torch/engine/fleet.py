"""Batched fleet engine for Algorithm 1 (PyTorch counterpart of
``repro/engine/fleet.py``).

Design rules, as in the JAX engine:
  * every leaf of ``EngineState`` carries a leading stream axis S;
  * all per-stream controller math (pruning ladder, drift detector) is
    elementwise, so the scalar transition functions in ``core/`` apply to
    (S,) tensors unchanged;
  * the device-heavy work is one (S, n_in) hidden projection per tick (the
    projection kernel) and one masked rank-1 RLS update per tick (the fused
    RLS kernel); the rest of the plan (readout, confidence, drift detector,
    query decision, meter) is one per-stream pass (``ops.plan_rows``), each
    row summed in an order fixed by the shapes, so a row's output does not
    depend on S;
  * one tick is split at the teacher round-trip: ``plan`` (predict, drift,
    query decision, comm metering) and ``learn`` (masked rank-1 RLS + the
    auto-theta controller observing answered queries).  ``fleet_step`` is
    exactly ``learn(plan(...))`` with same-tick labels.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import labels as labels_mod
from repro_torch.core import oselm, pruning
from repro_torch.distributed import sharding
from repro_torch.engine import graphs
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

# Ticks a chunk for callers that run a stretch of ticks once (the S=1 view,
# a paper trial, the examples): ``run_fleet``'s own default stays one chunk
# of T, as in the JAX package, but on the card one graph of all T ticks
# costs a capture linear in T, which a one-shot run never earns back (1,008
# ticks at S=1 took 1.6-3.4 s to capture on an H100, against a 1.36 s eager
# run; 16 ticks take ~60 ms, then 63 replays).
CHUNK_TICKS = 16

# How many chunk graphs the card keeps, over all chunk runners: each holds
# its own two copies of the state (2.15 GB of P at S=16,384, N=128) and its
# memory pool.  Enough for a run's chunk and its ragged tail in two modes.
CHUNK_GRAPHS = 4


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
# plan's per-stream pass sums a row in an order fixed by the shapes, and
# their CPU versions are made alike (``kernels/ops``).  So row r of a
# stacked dispatch is bit for bit row r of the solo dispatch.


def stack_streams(states: list[EngineState]) -> EngineState:
    """Concatenate fleets along the leading stream axis (one ``torch.cat`` per leaf)."""
    return tree_map(lambda *ls: torch.cat(ls, dim=0), *states)


def slice_streams(state: EngineState, lo: int, hi: int) -> EngineState:
    """The ``[lo:hi]`` stream window (one cohort member's rows), as views."""
    return tree_map(lambda a: a[lo:hi], state)


def remove_streams(state: EngineState, lo: int, hi: int) -> EngineState:
    """Drop the ``[lo:hi]`` stream window (evict a member from a cohort)."""
    return tree_map(lambda a: torch.cat([a[:lo], a[hi:]], dim=0), state)


def store_into(dst: EngineState, new: EngineState) -> None:
    """Write ``new``'s leaves into ``dst``'s buffers, skipping those already
    there (P and beta, which the RLS kernel writes into ``dst`` or which a
    plan passes through; the prune, drift and meter leaves, which the plan
    writes into ``dst``)."""
    pairs = [(d, n) for d, n in zip(tree_leaves(dst), tree_leaves(new)) if d is not n]
    graphs.copy_into([d for d, _ in pairs], [n for _, n in pairs])


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

    # odlint(torch): captured
    def run_patch(cur, spare, h, labels, pred, conf, mask, controller_on, theta):
        sub = slice_streams(cur, lo, hi)
        out = slice_streams(spare.elm, lo, hi)
        new = learn(sub, h, labels, pred, conf, mask, controller_on, cfg, theta=theta,
                    out=(out.P, out.beta))
        for dst, src in zip(tree_leaves(sub), tree_leaves(new)):
            if dst is not src:
                dst.copy_(src)

    return run_patch


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
    out: Optional[EngineState] = None,
) -> tuple[EngineState, PlanOutput]:
    """Teacher-facing half of one tick: predict → confidence → drift →
    should_query, charge the comm meter for issued queries, and account the
    pruning ladder's SKIP events (streams the controller observes but that
    do not query — their transition needs no label).

    The projection kernel, then one per-stream pass for the rest
    (``ops.plan_rows``; its plain version ``ref.plan_rows_ref`` spells the
    steps out).  ``elm`` passes through untouched.  Queried streams' ladder
    transitions wait for ``learn``.  The meter charges every *issued* query
    here, while ``prune.queries`` counts only *answered* ones (incremented
    in ``learn``).  ``out``: a state whose prune, drift and meter buffers
    the new leaves are written into (``engine/stream.py``'s other buffer
    set).
    """
    if mode not in MODES:
        raise ValueError(f"unknown engine mode {mode!r}")
    h = oselm.hidden(x, cfg.elm)  # (S, N)
    r = ops.plan_rows(h, state.elm.beta, x, state.elm.count, state.prune, state.drift,
                      state.meter, cfg, mode, teacher_available, drift_active,
                      out=None if out is None else (out.prune, out.drift, out.meter))
    new_state = EngineState(elm=state.elm, prune=r.prune, drift=r.drift, meter=r.meter)
    return new_state, PlanOutput(
        h=h,
        pred=r.pred,
        outputs=r.outputs,
        confidence=r.confidence,
        queried=r.queried,
        controller_on=r.controller_on,
        theta=r.theta,
        mode_training=r.mode_training,
    )


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
    new_prune = pruning.select(
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


# ---------------------------------------------------------------------------
# Chunked time scan
# ---------------------------------------------------------------------------


def _tick_into(src: EngineState, dst: EngineState, x, labels, avail, cfg: EngineConfig,
               mode: str) -> FleetStepOutput:
    """One ``fleet_step`` that reads ``src`` and writes the new state into
    ``dst``'s buffers (``plan`` and ``learn`` with ``out=``)."""
    mid, p = plan(src, x, cfg, mode=mode, teacher_available=avail, out=dst)
    new = learn(mid, p.h, labels, p.pred, p.confidence, p.queried, p.controller_on, cfg,
                theta=p.theta, out=(dst.elm.P, dst.elm.beta))
    store_into(dst, new)
    return FleetStepOutput(pred=p.pred, outputs=p.outputs, queried=p.queried,
                           trained=p.queried, theta=p.theta, confidence=p.confidence,
                           mode_training=p.mode_training)


def _unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


# The card's chunk graphs: (cfg, mode, shape key) -> (TickGraph, the other
# buffer set), least recently used first, at most ``CHUNK_GRAPHS``.  The
# donate variants of a runner share them: on the card donation decides only
# where ``run_fleet`` puts the final state, not what a graph holds.
_chunk_graphs: collections.OrderedDict = collections.OrderedDict()


def release_chunk_graphs() -> None:
    """Drop every chunk graph the card holds, with its buffers and memory
    pool (the next call at a shape captures again).  A state that
    ``run_fleet`` returned is the caller's own and stays."""
    _chunk_graphs.clear()


@functools.lru_cache(maxsize=RUNNER_CACHE_SIZE)
def _chunk_runner(cfg: EngineConfig, mode: str, donate: bool):  # odlint(torch): donates(0)
    """Runner of ``fleet_step`` over a (chunk, S) block of ticks:
    ``runner(state, xs, labels, avail) -> (state, outputs stacked over (c, S))``.

    Cached per (cfg, mode, donate), a bounded LRU as in the JAX package.
    The ticks alternate between two buffer sets: tick t reads the chunk's
    input set when t is even and writes the other set, and back; so the
    new state ends in the input set after an even chunk and in the other
    set after an odd one.

    On CUDA tensors the runner replays one CUDA graph per chunk shape (c, S,
    n_in), on its device, captured on first use (``graphs.TickGraph``) and
    replayed after that; a failed capture raises.  The input set is the
    graph's static input: every call copies the state into it before the
    replay, so the ticks that write it during the warm-up leave nothing a
    replay depends on (two sets of P, not three: the equivalent of a third,
    read-only set).  The returned state lives in the graph's buffers, and a
    later call at that shape overwrites it; a state a call returned is
    passed back in without a copy when it sits in the input set (an even
    chunk), which is how ``run_fleet`` hands the state on between chunks.
    ``run_fleet`` then copies the final state into the caller's buffers
    (``donate``) or into new ones.  The graphs live in ``_chunk_graphs``,
    shared by the donate variants of a (cfg, mode) and bounded over all
    runners (``CHUNK_GRAPHS``; ``release_chunk_graphs`` drops them).

    On CPU tensors the ticks run eagerly over the same two sets, the
    input set being the caller's own buffers with ``donate`` (the result
    lands in them, as the JAX package's CPU donation aliases) and a copy
    without it.  ``runner._cache_size()`` counts the chunk shapes the runner
    has run, on CPU as on the card, as the JAX runner counts executables."""
    shapes: set = set()
    skeleton = None  # the EngineState tree without its tensors

    def run_chunk(*leaves):
        n = (len(leaves) - 3) // 2
        xs, labels, avail = leaves[2 * n:]
        other = _unflatten(skeleton, leaves[:n])
        cur = _unflatten(skeleton, leaves[n:2 * n])
        sets = (cur, other)
        outs = [_tick_into(sets[t % 2], sets[(t + 1) % 2], xs[t], labels[t], avail[t], cfg, mode)
                for t in range(xs.shape[0])]
        return tree_map(lambda *a: torch.stack(a, dim=0), *outs)

    def warm_up(*leaves):
        n = (len(leaves) - 3) // 2
        return run_chunk(*leaves[:2 * n], *(a[:1] for a in leaves[2 * n:]))

    def runner(state: EngineState, xs, labels, avail):
        nonlocal skeleton
        c, s = xs.shape[0], xs.shape[1]
        if (tuple(labels.shape) != (c, s) or tuple(avail.shape) != (c, s)
                or state.elm.P.shape[0] != s):
            raise ValueError(
                f"chunk runner: xs {tuple(xs.shape)}, labels {tuple(labels.shape)}, avail "
                f"{tuple(avail.shape)} and a state of {state.elm.P.shape[0]} streams disagree")
        skeleton = tree_map(lambda _: None, state)
        dev = xs.device
        shape_key = (str(dev), tuple(xs.shape), xs.dtype, labels.dtype)
        shapes.add(shape_key)
        leaves = tree_leaves(state)
        if dev.type == "cpu":
            cur = leaves if donate else [a.clone() for a in leaves]
            other = [torch.empty(a.shape, dtype=a.dtype) for a in cur]
            out = run_chunk(*other, *cur, xs, labels, avail)
            if c % 2:
                graphs.copy_into(cur, other)
            return _unflatten(state, cur), out
        if dev.type != "cuda":
            raise ValueError(f"the chunk runner runs on CUDA or CPU tensors, got {dev}")
        key = (cfg, mode, shape_key)
        entry = _chunk_graphs.get(key)
        if entry is None:
            while len(_chunk_graphs) >= CHUNK_GRAPHS:
                _chunk_graphs.popitem(last=False)
            # Contiguous, whatever the caller's strides: the RLS kernel's
            # ``out=`` buffers must be.
            other = [torch.empty(a.shape, dtype=a.dtype, device=a.device) for a in leaves]
            graph = graphs.TickGraph("chunk_runner", run_chunk, tuple(other),
                                     [*leaves, xs, labels, avail], warmup=warm_up)
            entry = _chunk_graphs[key] = (graph, other)
        else:
            _chunk_graphs.move_to_end(key)
        graph, other = entry
        out = graph(*leaves, xs, labels, avail)
        final = graph.inputs[:len(leaves)] if c % 2 == 0 else other
        return _unflatten(state, final), out

    runner._cache_size = lambda: len(shapes)
    return runner


def runner_cache_info() -> dict:
    """Hit/miss/size counters of this module's runner caches, for serving
    stats (``engine.stream.cache_stats`` merges these with its own), under
    the JAX package's keys."""
    out = {}
    for name, fn in (
        ("chunk_runner", _chunk_runner),
        ("patch_learn_runner", _patch_learn_runner),
    ):
        info = fn.cache_info()
        out[name] = {"hits": info.hits, "misses": info.misses, "size": info.currsize,
                     "maxsize": info.maxsize}
    return out


def run_fleet(  # odlint(torch): donates(0)
    state: EngineState,
    xs,  # (T, S, n_in) tensor or array
    labels,  # (T, S) int
    cfg: EngineConfig,
    mode: str = "algo1",
    teacher_available=None,  # (T, S) bool
    chunk: Optional[int] = None,
    donate: Optional[bool] = None,
) -> tuple[EngineState, FleetStepOutput]:
    """Run T ticks of S streams through the engine on ``state``'s device,
    ``chunk`` ticks per runner call (``_chunk_runner``: one CUDA graph
    replay per chunk on the card, the same ticks eagerly on the CPU).
    Returns (final state, outputs stacked over (T, S)).

    ``chunk=None`` or ``chunk > T`` means T; when T is a multiple of
    ``chunk`` every call replays one graph, and a ragged final chunk costs
    exactly one more capture.  A caller that runs its ticks once passes
    ``chunk=CHUNK_TICKS``: on the card a graph's capture grows with its
    ticks.  ``teacher_available=None`` means every teacher answers.

    ``donate`` defaults to True when the state is on CUDA and to False on
    the CPU (the JAX package's ``jax.default_backend() != "cpu"``, decided
    here by the state's device).  ``donate=False`` leaves the caller's
    state bit for bit unchanged and returns new buffers.  ``donate=True``
    writes the final state into the caller's own buffers: the returned
    leaves share storage with the ones passed in, on the CPU too (the JAX
    package's CPU donation aliases in place), so a later read of the passed
    state silently sees the new one (odlint's ODL002 reports such a read
    unless the call passes ``donate=False``).  Resident callers that own
    their state (``run_fleet_sharded``, ``run_fleet_shards``) pass
    ``donate=True``.
    """
    dev = state.elm.P.device
    xs = torch.as_tensor(xs, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    t_total, s = xs.shape[0], xs.shape[1]
    if t_total == 0:
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
    if chunk is None or chunk > t_total:
        chunk = t_total
    if donate is None:
        donate = dev.type != "cpu"
    if teacher_available is None:
        teacher_available = torch.ones((t_total, s), dtype=torch.bool, device=dev)
    else:
        teacher_available = torch.as_tensor(teacher_available, device=dev).to(torch.bool)

    runner = _chunk_runner(cfg, mode, donate)
    caller = state
    outs = []
    t = 0
    while t < t_total:
        c = min(chunk, t_total - t)
        state, out = runner(state, xs[t:t + c], labels[t:t + c], teacher_available[t:t + c])
        outs.append(out)
        t += c
    if dev.type == "cuda":
        # The final state sits in the runner's buffers: hand it out.
        if donate:
            store_into(caller, state)
            state = caller
        else:
            state = tree_map(torch.clone, state)
    if len(outs) == 1:
        return state, outs[0]
    return state, tree_map(lambda *a: torch.cat(a, dim=0), *outs)


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
    h = oselm.hidden(x, cfg.elm)  # (S, N)
    r = ops.plan_rows(h, state.elm.beta, x, state.elm.count, state.prune, state.drift,
                      state.meter, cfg, "serve")
    new_state = state._replace(drift=r.drift, meter=r.meter, prune=r.prune)
    out = GateOutput(
        h=h,
        pred=r.pred,
        outputs=r.outputs,
        confidence=r.confidence,
        queried=r.queried,
        theta=r.theta,
        feats=x,
        drift_active=r.drift.active,
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
    new_prune = pruning.select(
        mask,
        pruning.update(state.prune, mask, agree, ctx.confidence, cfg.prune, theta=ctx.theta),
        state.prune,
    )
    return state._replace(elm=new_elm, prune=new_prune)


# ---------------------------------------------------------------------------
# Sharded fleets: the stream axis split over a ("fleet",) device mesh.
# ---------------------------------------------------------------------------
#
# Every op of a tick computes a row in an order that does not depend on S
# (see the stacked-state helpers above), so a fleet split along its stream
# axis, advanced block by block and stitched back in row order, is bit for
# bit the unsplit run, with no traffic between shards.  The JAX package
# offers two layouts: one array that GSPMD partitions (``shard_fleet`` +
# ``run_fleet_sharded``) and explicit per-shard blocks (``split_fleet`` +
# ``run_fleet_shards``).  One torch process has no partitioner: the first
# layout runs here on a mesh whose entries are all one device, as one padded
# full-width dispatch, which is what the partitioned dispatch computes; the
# second runs on any device list.

# Streams per block of the explicit shard-local path, the reference's: P is
# 64 KB a stream at N=128, so a 512-stream block's P (32 MB) fits the H100's
# 50 MB L2 across the block's T-tick loop.
DEFAULT_STREAM_BLOCK = 512


def pad_streams(state: EngineState, cfg: EngineConfig, n_pad: int) -> EngineState:
    """Append ``n_pad`` fresh-init dead rows to a fleet (S padded up to a
    multiple of the shard count), on the fleet's device.  Dead rows run
    with ``teacher_available=False``, so they never query or learn; callers
    strip their rows from the outputs."""
    if n_pad <= 0:
        return state
    return stack_streams([state, init_fleet(cfg, n_pad, state.elm.P.device)])


def _canon(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _one_device(mesh, what: str) -> torch.device:
    """The device of a mesh whose entries are all one device; raises for a
    mesh of distinct devices, which only the explicit shard path runs."""
    devices = {_canon(d) for d in mesh.devices}
    if len(devices) != 1:
        raise NotImplementedError(
            f"{what} partitions one dispatch over the mesh, which needs GSPMD; on a mesh "
            f"of distinct devices ({sorted(map(str, devices))}) use split_fleet and "
            "run_fleet_shards")
    return devices.pop()


def shard_fleet(
    state: EngineState, cfg: EngineConfig, mesh=None
) -> tuple[EngineState, int]:
    """Place a fleet on the current mesh (or ``mesh``): pad S to a multiple
    of the mesh's fleet-axis size and put every leaf on the mesh's device.
    Returns ``(placed_state, n_pad)``; the identity (and ``n_pad=0``) with
    no mesh.  Advance it with ``run_fleet_sharded``.  A mesh of distinct
    devices raises ``NotImplementedError`` (use ``split_fleet``)."""
    if mesh is not None and mesh is not sharding.mesh_or_none():
        with sharding.activate(mesh):
            return shard_fleet(state, cfg)
    mesh = sharding.mesh_or_none()
    if mesh is None:
        return state, 0
    dev = _one_device(mesh, "shard_fleet")
    n_shards = sharding.fleet_axis_size()
    s = state.elm.P.shape[0]
    n_pad = (-s) % n_shards
    state = pad_streams(tree_map(lambda a: a.to(dev), state), cfg, n_pad)
    return state, n_pad


def _pad_rows(a: torch.Tensor, n_dead: int, value=0) -> torch.Tensor:
    """``a`` (T, S, ...) with ``n_dead`` rows of ``value`` appended on axis 1."""
    pad = torch.full((a.shape[0], n_dead) + tuple(a.shape[2:]), value, dtype=a.dtype,
                     device=a.device)
    return torch.cat([a, pad], dim=1)


def run_fleet_sharded(
    state: EngineState,  # shard_fleet-placed (possibly padded) fleet
    xs,  # (T, S_real, n_in)
    labels,  # (T, S_real) int
    cfg: EngineConfig,
    mode: str = "algo1",
    teacher_available=None,  # (T, S_real) bool
    chunk: Optional[int] = None,
) -> tuple[EngineState, FleetStepOutput]:
    """Advance a ``shard_fleet``-placed fleet by full-width dispatches on
    its device.  Inputs are in real (unpadded) width: dead rows are
    appended here with ``teacher_available=False`` and stripped from the
    returned outputs, so callers never see padding.  Under a mesh of
    distinct devices it raises ``NotImplementedError`` (use
    ``run_fleet_shards``)."""
    mesh = sharding.mesh_or_none()
    if mesh is not None:
        _one_device(mesh, "run_fleet_sharded")
    dev = state.elm.P.device
    s_pad = state.elm.P.shape[0]
    xs = torch.as_tensor(xs, device=dev)
    labels = torch.as_tensor(labels, device=dev)
    t, s_real = xs.shape[0], xs.shape[1]
    if s_pad < s_real:
        raise ValueError(f"state has {s_pad} streams < input width {s_real}")
    if teacher_available is not None:
        teacher_available = torch.as_tensor(teacher_available, device=dev).to(torch.bool)
    if s_pad != s_real:
        n_dead = s_pad - s_real
        if teacher_available is None:
            teacher_available = torch.ones((t, s_real), dtype=torch.bool, device=dev)
        xs, labels = _pad_rows(xs, n_dead), _pad_rows(labels, n_dead)
        teacher_available = _pad_rows(teacher_available, n_dead, False)
    state, out = run_fleet(state, xs, labels, cfg, mode=mode,
                           teacher_available=teacher_available, chunk=chunk, donate=True)
    if s_pad != s_real:
        out = tree_map(lambda a: a[:, :s_real], out)
    return state, out


class FleetShards(NamedTuple):
    """Explicit shard-local layout: the fleet split into per-block states,
    shard k's blocks on device k.

    Each block is advanced by its own block-width dispatches, so a shard's
    P and beta never leave its device, and a block's P can stay in cache
    across the T-tick loop.  The sharded stream session
    (``stream.ShardedStreamSession``) uses the same row partition.
    """

    states: tuple  # per-block EngineState, block b on its shard's device
    bounds: tuple  # per-block (lo, hi) row window in the padded fleet
    n_pad: int  # dead rows appended to the tail (never surfaced in outputs)


def split_fleet(
    state: EngineState,
    cfg: EngineConfig,
    n_shards: Optional[int] = None,
    block: Optional[int] = None,
    devices=None,
) -> FleetShards:
    """Split a fleet into ``FleetShards``: pad S to a multiple of
    ``n_shards`` (default: the current mesh's fleet-axis size, 1 with no
    mesh), divide each shard into ``block``-stream blocks (default
    ``DEFAULT_STREAM_BLOCK``, capped at the shard width), and put shard k's
    blocks on ``devices[k]`` (default: the current mesh's
    ``fleet_devices()``, else the fleet's own device).  Every block owns its tensors."""
    if n_shards is None:
        n_shards = sharding.fleet_axis_size()
    if devices is None:
        devices = sharding.fleet_devices()
    if devices is not None and len(devices) < n_shards:
        raise ValueError(f"{n_shards} shards > {len(devices)} devices")
    s = state.elm.P.shape[0]
    n_pad = (-s) % n_shards
    state = pad_streams(state, cfg, n_pad)
    width = (s + n_pad) // n_shards
    if block is None:
        block = DEFAULT_STREAM_BLOCK
    block = max(1, min(block, width))
    states, bounds = [], []
    for k in range(n_shards):
        dev = torch.device(devices[k]) if devices is not None else state.elm.P.device
        lo = k * width
        while lo < (k + 1) * width:
            hi = min(lo + block, (k + 1) * width)
            states.append(tree_map(lambda a: a[lo:hi].to(dev, copy=True), state))
            bounds.append((lo, hi))
            lo = hi
    return FleetShards(states=tuple(states), bounds=tuple(bounds), n_pad=n_pad)


def merge_fleet(shards: FleetShards) -> EngineState:
    """One fleet on the host (CPU tensors) from shard-local blocks, with the
    dead-row padding stripped (the checkpoint and inspection path; the hot
    path never gathers)."""
    full = stack_streams([tree_map(lambda a: a.cpu(), st) for st in shards.states])
    if shards.n_pad:
        full = slice_streams(full, 0, full.elm.P.shape[0] - shards.n_pad)
    return full


def run_fleet_shards(
    shards: FleetShards,
    xs,  # (T, S_real, n_in)
    labels,  # (T, S_real) int
    cfg: EngineConfig,
    mode: str = "algo1",
    teacher_available=None,  # (T, S_real) bool
    chunk: Optional[int] = None,
) -> tuple[FleetShards, FleetStepOutput]:
    """Advance every block of a ``FleetShards`` by its own dispatches on its
    device and stitch the outputs in row order, on the host (CPU tensors).
    Bit for bit the unsplit ``run_fleet`` at equal S; dead tail rows run
    with ``teacher_available=False`` and are stripped from the outputs.

    The blocks are shard-local, so the loop runs under
    ``sharding.deactivate()``: a caller's mesh scope does not reach them."""
    with sharding.deactivate():
        return _run_fleet_shards_body(shards, xs, labels, cfg, mode, teacher_available, chunk)


# odlint: shard-local
def _run_fleet_shards_body(
    shards, xs, labels, cfg, mode, teacher_available, chunk
) -> tuple[FleetShards, FleetStepOutput]:
    xs, labels = torch.as_tensor(xs), torch.as_tensor(labels)
    if teacher_available is not None:
        teacher_available = torch.as_tensor(teacher_available).to(torch.bool)
    s_real = xs.shape[1]
    new_states, outs = [], []
    for st, (lo, hi) in zip(shards.states, shards.bounds):
        dev = st.elm.P.device
        real_hi = max(lo, min(hi, s_real))  # a block may sit wholly in the padding
        n_dead = hi - real_hi
        x_b = xs[:, lo:real_hi].to(dev)
        lab_b = labels[:, lo:real_hi].to(dev)
        av_b = None if teacher_available is None else teacher_available[:, lo:real_hi].to(dev)
        if n_dead:
            if av_b is None:
                av_b = torch.ones(lab_b.shape, dtype=torch.bool, device=dev)
            x_b, lab_b = _pad_rows(x_b, n_dead), _pad_rows(lab_b, n_dead)
            av_b = _pad_rows(av_b, n_dead, False)
        st, out = run_fleet(st, x_b, lab_b, cfg, mode=mode, teacher_available=av_b,
                            chunk=chunk, donate=True)
        if n_dead:
            out = tree_map(lambda a: a[:, : hi - lo - n_dead], out)
        new_states.append(st)
        outs.append(out)
    merged = tree_map(lambda *a: torch.cat([x.cpu() for x in a], dim=1), *outs)
    return shards._replace(states=tuple(new_states)), merged
