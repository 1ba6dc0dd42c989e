"""Streaming async-teacher runtime: Algorithm 1 from a tick iterator
(PyTorch counterpart of ``repro/engine/stream.py``).

``run_fleet`` needs the whole stream as one ``(T, S, n_in)`` array with
same-tick labels.  In the paper's deployment each tick arrives once and the
teacher's answers come back late, out of order, partly, or never::

    ticks ──▶ plan (device) ──▶ queried feats ──▶ Teacher.ask ──╮
      ▲                                                         │ latency,
      │  host ingests tick t+1 while the device runs tick t     │ jitter,
      ╰─ learn (device) ◀── PendingRing ◀──── Teacher.poll ◀────╯ loss

Pieces, as in the JAX package:

* ``Teacher`` protocol (``ask``/``poll``/``in_flight``); ``LatencyTeacher``
  models latency, jitter, loss, partial answers and a permanent outage with
  numpy's PCG64, so its draws equal the JAX package's; ``array_labels``
  makes a label array the teacher (the paper's protocol).
* ``PendingRing``: in-flight tickets with their plan-time context, bounded;
  what happens when it is full is the backpressure policy
  (``BACKPRESSURE_POLICIES``: ``drop_oldest``, ``drop_newest``, ``block``,
  ``coalesce``).
* ``StreamSession``: one tenant's runtime as a state machine (``start``,
  ``advance``, ``finish``); ``run`` drives one session over an iterator.

Every stream-query the plan decides to issue ends in exactly one of
``labels_applied``, ``queries_dropped``, ``queries_lost`` or
``queries_coalesced`` (``StreamStats.reconciled``).  With a zero-latency
teacher the runtime reproduces ``run_fleet`` bit for bit: ``plan`` and
``learn`` are the two halves of ``fleet_step``.

The per-tick runners (plan; learn; learn fused with the next plan; and the
two with a ``teacher_available`` vector) are tick functions made by
``lru_cache`` factories keyed on ``(cfg, mode, donate)``.  On the card a
session replays each as a CUDA graph (``engine/graphs.py``) over state
buffers of its own (``_StateBuffers``): two sets, written in turn
(ping-pong), because a graph replays fixed addresses and the RLS kernel
writes P' out of place.  A runner reads one set and writes the other: P and
beta flip when it learns, the small leaves (count, controllers, meter) on
every runner.  Everything a session keeps past a replay (plan outputs in the
ring, collected columns, shipped ticks) is a copy of its own.  A cohort
(``engine/cohort.py``) holds its stacked state the same way, and its members'
plans as ``PlanSlice`` row views of its full-width plan.

Durability: ``StreamSession.snapshot`` / ``StreamSession.restore``
(``engine/snapshot.py``) capture a live session into host memory the
snapshot owns and rebuild it on a device of the caller's choosing.

Telemetry (``runtime/telemetry.py``): ``advance`` is one ``stream.tick``
span (``t=``, ``queries=``) begun and ended on the host, outside any graph
capture; a ring eviction is a ``ring.evict`` event; ``sync_telemetry``
mirrors ``StreamStats`` into the registry at ``finish()`` and at live
scrapes, from host integers only; a shard's session labels its series
``shard=<k>``.

Sharding: ``ShardedStreamSession`` / ``run_sharded`` split the stream axis
into shard-local sessions, each with its own ring, backpressure and teacher,
advanced in lockstep over row windows of one full-width tick source;
``aggregate_stats`` folds their stats, the accounting identity held per
shard.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import time
from typing import Callable, Iterable, NamedTuple, Optional, Protocol

import numpy as np
import torch

from repro_torch.core import oselm
from repro_torch.distributed import sharding
from repro_torch.engine import fleet, graphs
from repro_torch.engine.types import (
    EngineConfig,
    EngineState,
    FleetStepOutput,
    tree_leaves,
    tree_map,
)
from repro_torch.runtime import telemetry as _telemetry

# Safety bound on drain polling: a broken Teacher that reports in-flight
# tickets forever must not hang the runtime.
MAX_DRAIN_TICKS = 1_000_000

# Sleep between empty drain polls while replies are still in flight, so a
# wall-clock teacher's drain waits out real latency without spinning a core.
DRAIN_IDLE_SLEEP_S = 200e-6

# Latency distributions keep a sliding window: a long-running server must
# not grow per-tick history without bound.
STATS_WINDOW = 4096

# Smoothing of StreamStats.tick_rate_ema (a load signal, not a counter).
TICK_RATE_EMA_ALPHA = 0.1

BACKPRESSURE_POLICIES = ("drop_oldest", "drop_newest", "block", "coalesce")

# Pinned host buffers per (shape, dtype) in a session's tick shipper: one
# being copied to the card while the next is filled.
SHIP_DEPTH = 2


class TeacherReply(NamedTuple):
    """One answered ticket.  ``answered`` may be a subset of the asked mask."""

    ticket: int
    labels: np.ndarray  # (S,) int32, valid where ``answered``
    answered: np.ndarray  # (S,) bool


class Teacher(Protocol):
    """Asynchronous label oracle with tick-granular time."""

    def ask(self, feats, mask: np.ndarray, tick: int) -> int:
        """Submit one query batch (feats (S, n_in); mask (S,) bool marks the
        streams actually querying).  ``tick`` is the tick the query is
        about: the current one, or the origin tick of a deferred ask.
        Returns a ticket id."""
        ...

    def poll(self, tick: int) -> list[TeacherReply]:
        """Labels that have arrived by ``tick`` (possibly out of order)."""
        ...

    def in_flight(self) -> int:
        """Tickets asked but not yet answered nor lost."""
        ...


# (tick, feats) -> (S,) int32 labels.  ``feats`` may be a tensor on the card;
# pull it to the host only if the labels depend on it.
LabelFn = Callable[[int, object], np.ndarray]


def array_labels(labels) -> LabelFn:
    """Adapt a materialized (T, S) label array to a ``LabelFn``: ground
    truth plays the teacher (the paper's evaluation protocol)."""
    arr = np.asarray(labels)

    def fn(tick, feats):
        del feats
        return np.asarray(arr[tick], np.int32)

    return fn


@dataclasses.dataclass
class LatencyTeacher:
    """Teacher with a latency / jitter / loss / partial-answer / outage model.

    Each ``ask`` is one ticket answered ``latency`` ticks later plus a
    uniform jitter in [0, jitter]; a ``loss_prob`` share of tickets is never
    answered; ``partial_prob`` drops each asked stream from its reply; every
    ticket asked at or after ``outage_after`` is lost.  Draws come from
    numpy's PCG64 in the JAX package's order, so both packages' teachers
    answer alike for one seed.
    """

    label_fn: LabelFn
    latency: int = 0
    jitter: int = 0
    loss_prob: float = 0.0
    partial_prob: float = 0.0
    outage_after: Optional[int] = None
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._next_ticket = 0
        # (due_tick, ticket, mask, labels); labels are drawn at ask time.
        self._inbox: list[tuple[int, int, np.ndarray, np.ndarray]] = []

    def ask(self, feats, mask, tick):
        ticket = self._next_ticket
        self._next_ticket += 1
        lost = (
            self.outage_after is not None and tick >= self.outage_after
        ) or (self.loss_prob > 0.0 and self._rng.uniform() < self.loss_prob)
        if not lost:
            due = tick + self.latency
            if self.jitter:
                due += int(self._rng.integers(0, self.jitter + 1))
            answered = np.asarray(mask, bool)
            if self.partial_prob > 0.0:
                keep = self._rng.uniform(size=answered.shape) >= self.partial_prob
                answered = answered & keep
            labels = np.asarray(self.label_fn(tick, feats), np.int32)
            self._inbox.append((due, ticket, answered, labels))
        return ticket

    def poll(self, tick):
        ready = [e for e in self._inbox if e[0] <= tick]
        if not ready:
            return []
        self._inbox = [e for e in self._inbox if e[0] > tick]
        ready.sort(key=lambda e: (e[0], e[1]))
        return [TeacherReply(ticket=t, labels=lab, answered=m) for _, t, m, lab in ready]

    def in_flight(self):
        return len(self._inbox)

    def snapshot_state(self) -> dict:
        """The teacher's whole state as a numpy/JSON tree (RNG, ticket
        counter, undelivered inbox), in the JAX package's layout.
        ``label_fn`` is not in it: the restoring side builds the teacher
        with the same label source, then calls ``restore_snapshot``."""
        meta = {
            "kind": "latency",
            "next_ticket": self._next_ticket,
            "rng": self._rng.bit_generator.state,
        }
        return {
            "meta": np.asarray(json.dumps(meta, default=int)),
            "inbox": [
                {
                    "due": np.asarray(due, np.int64),
                    "ticket": np.asarray(ticket, np.int64),
                    "answered": np.asarray(answered, bool),
                    "labels": np.asarray(labels, np.int32),
                }
                for due, ticket, answered, labels in self._inbox
            ],
        }

    def restore_snapshot(self, tree: dict) -> None:
        meta = json.loads(np.asarray(tree["meta"]).item())
        self._next_ticket = int(meta["next_ticket"])
        self._rng.bit_generator.state = meta["rng"]
        self._inbox = [
            (
                int(np.asarray(e["due"])),
                int(np.asarray(e["ticket"])),
                np.asarray(e["answered"], bool),
                np.asarray(e["labels"], np.int32),
            )
            for e in tree["inbox"]
        ]


class PendingTicket(NamedTuple):
    """What must survive the teacher round-trip: the plan-time features and
    controller context of one asked tick, and the tick itself."""

    tick: int
    queried: np.ndarray  # (S,) bool host copy of the asked mask
    plan: fleet.PlanOutput  # the session's own copy of the query-time plan
    x: object  # the tick's features as shipped


class PlanSlice:
    """Lazy row-window view of a cohort's full-width ``fleet.PlanOutput``.

    Cohort fusion (``engine/cohort.py``) plans all members of a cohort in one
    stacked dispatch; each member session's current plan and ring entries
    then hold a ``PlanSlice`` instead of a solo-width ``PlanOutput``.  An
    attribute reads the ``[lo:hi]`` rows of the full plan's field (a view on
    its device), and ``_asdict`` follows the NamedTuple protocol, so the solo
    drain and the patch-learn path treat it exactly like a ``PlanOutput``.
    ``materialize()`` turns it into a solo-width ``PlanOutput`` of its own
    (detaching from the cohort).
    """

    __slots__ = ("full", "lo", "hi")

    def __init__(self, full: fleet.PlanOutput, lo: int, hi: int):
        self.full = full
        self.lo = lo
        self.hi = hi

    def __getattr__(self, name):
        # Only reached for names not in __slots__, i.e. PlanOutput fields.
        return getattr(self.full, name)[self.lo : self.hi]

    def _asdict(self):
        return {k: getattr(self.full, k)[self.lo : self.hi] for k in fleet.PlanOutput._fields}

    def materialize(self) -> fleet.PlanOutput:
        return fleet.PlanOutput(**{k: v.clone() for k, v in self._asdict().items()})


class DeferredAsk(NamedTuple):
    """A ``block``-policy ask waiting for a free ring slot."""

    tick: int
    x: object
    queried: np.ndarray  # (S,) bool
    plan: fleet.PlanOutput


class PendingRing:
    """Fixed-capacity ordered map ticket -> entry.  ``push`` evicts and
    returns the oldest entry when full; ``pop`` of an unknown or evicted
    ticket returns None."""

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._slots: "collections.OrderedDict[int, object]" = collections.OrderedDict()

    def __len__(self):
        return len(self._slots)

    def full(self) -> bool:
        return len(self._slots) >= self.capacity

    def push(self, ticket: int, entry):
        dropped = None
        if len(self._slots) >= self.capacity:
            dropped = self._slots.popitem(last=False)[1]
        self._slots[ticket] = entry
        return dropped

    def pop(self, ticket: int):
        return self._slots.pop(ticket, None)

    def entries(self):
        """Live entries, oldest first."""
        return self._slots.values()

    def tickets(self):
        """Live ticket ids, oldest first."""
        return self._slots.keys()

    def drain(self):
        """Remove and return all entries (oldest first)."""
        out = list(self._slots.values())
        self._slots.clear()
        return out


def _percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


@dataclasses.dataclass
class StreamStats:
    """Counters and latency distributions of one ``run`` (or serving loop).

    Every query the plan decided to issue lands in exactly one terminal
    bucket: ``queries_issued == labels_applied + queries_dropped +
    queries_lost + queries_coalesced`` (``reconciled``).
    """

    ticks: int = 0
    stream_steps: int = 0
    tickets_issued: int = 0  # teacher.ask calls actually made
    queries_issued: int = 0  # stream-queries the plan decided to issue
    labels_applied: int = 0  # stream-labels applied through ``learn``
    tickets_dropped: int = 0  # evicted / refused / expired by backpressure
    queries_dropped: int = 0
    replies_orphaned: int = 0  # answered after their ticket was evicted
    tickets_lost: int = 0  # never answered (teacher loss / outage / timeout)
    queries_lost: int = 0  # incl. the residue of partially answered tickets
    tickets_coalesced: int = 0  # asks merged (at least partly) into in-flight
    queries_coalesced: int = 0  # stream-queries settled by an in-flight ticket
    asks_deferred: int = 0  # ``block``: asks that waited for a ring slot
    tickets_reasked: int = 0  # in-flight tickets re-submitted after a restore
    wall_s: float = 0.0
    # Load signals: a wall-clock EMA of the tick rate (not deterministic)
    # and the ring's high-water occupancy.
    tick_rate_ema: float = 0.0
    ring_occupancy_hwm: int = 0
    tick_ms: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STATS_WINDOW)
    )
    label_latency_ticks: "collections.deque" = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=STATS_WINDOW)
    )

    @property
    def tick_p50_ms(self) -> float:
        return _percentile(self.tick_ms, 50)

    @property
    def tick_p95_ms(self) -> float:
        return _percentile(self.tick_ms, 95)

    @property
    def label_latency_p50(self) -> float:
        return _percentile(self.label_latency_ticks, 50)

    @property
    def label_latency_p95(self) -> float:
        return _percentile(self.label_latency_ticks, 95)

    @property
    def steps_per_s(self) -> float:
        return self.stream_steps / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def reconciled(self) -> bool:
        """The query-accounting identity (see class docstring)."""
        return self.queries_issued == (
            self.labels_applied
            + self.queries_dropped
            + self.queries_lost
            + self.queries_coalesced
        )

    def summary(self) -> dict:
        return {
            "ticks": self.ticks,
            "stream_steps": self.stream_steps,
            "steps_per_s": self.steps_per_s,
            "tickets_issued": self.tickets_issued,
            "queries_issued": self.queries_issued,
            "labels_applied": self.labels_applied,
            "tickets_dropped": self.tickets_dropped,
            "queries_dropped": self.queries_dropped,
            "replies_orphaned": self.replies_orphaned,
            "tickets_lost": self.tickets_lost,
            "queries_lost": self.queries_lost,
            "tickets_coalesced": self.tickets_coalesced,
            "queries_coalesced": self.queries_coalesced,
            "asks_deferred": self.asks_deferred,
            "tickets_reasked": self.tickets_reasked,
            "queries_reconciled": self.reconciled,
            "tick_rate_ema": self.tick_rate_ema,
            "ring_occupancy_hwm": self.ring_occupancy_hwm,
            "tick_p50_ms": self.tick_p50_ms,
            "tick_p95_ms": self.tick_p95_ms,
            "label_latency_p50": self.label_latency_p50,
            "label_latency_p95": self.label_latency_p95,
            "caches": cache_stats(),
        }


# The runners are tick functions ``fn(src, dst, [avail,] *inputs)``: they
# read the state in ``src`` and write the new state into ``dst``'s buffers
# (``graphs`` explains why they must not write what they read).  A runner
# that only plans leaves P and beta where they are (``dst`` shares them with
# ``src``).  ``donate`` is part of the keys, as in the JAX package, so calls
# written for it carry over; a session always works in buffers of its own.


def _learn_into(src: EngineState, dst: EngineState, cfg: EngineConfig, h, labels, pred, conf,
                mask, controller_on, theta) -> EngineState:
    return fleet.learn(src, h, labels, pred, conf, mask, controller_on, cfg, theta=theta,
                       out=(dst.elm.P, dst.elm.beta))


@functools.lru_cache(maxsize=fleet.RUNNER_CACHE_SIZE)
def _plan_runner(cfg: EngineConfig, mode: str, donate: bool):
    del donate

    # odlint(torch): captured
    def run_plan(src, dst, x):
        new, p = fleet.plan(src, x, cfg, mode=mode, out=dst)
        fleet.store_into(dst, new)
        return p

    return run_plan


@functools.lru_cache(maxsize=fleet.RUNNER_CACHE_SIZE)
def _learn_runner(cfg: EngineConfig, donate: bool):
    del donate

    # odlint(torch): captured
    def run_learn(src, dst, h, labels, pred, conf, mask, controller_on, theta):
        new = _learn_into(src, dst, cfg, h, labels, pred, conf, mask, controller_on, theta)
        fleet.store_into(dst, new)

    return run_learn


@functools.lru_cache(maxsize=fleet.RUNNER_CACHE_SIZE)
def _learn_plan_runner(cfg: EngineConfig, mode: str, donate: bool):
    """Steady-state fused tick: apply one reply's labels, then plan the next
    tick, in one replay."""
    del donate

    # odlint(torch): captured
    def run_learn_plan(src, dst, h, labels, pred, conf, mask, controller_on, theta, x_next):
        mid = _learn_into(src, dst, cfg, h, labels, pred, conf, mask, controller_on, theta)
        new, p = fleet.plan(mid, x_next, cfg, mode=mode, out=dst)
        fleet.store_into(dst, new)
        return p

    return run_learn_plan


@functools.lru_cache(maxsize=fleet.RUNNER_CACHE_SIZE)
def _plan_avail_runner(cfg: EngineConfig, mode: str, donate: bool):
    """``_plan_runner`` with a ``teacher_available`` vector: a session with
    dead padding rows (``live`` < S) plans them unavailable, so they never
    query or learn."""
    del donate

    # odlint(torch): captured
    def run_plan(src, dst, avail, x):
        new, p = fleet.plan(src, x, cfg, mode=mode, teacher_available=avail, out=dst)
        fleet.store_into(dst, new)
        return p

    return run_plan


@functools.lru_cache(maxsize=fleet.RUNNER_CACHE_SIZE)
def _learn_plan_avail_runner(cfg: EngineConfig, mode: str, donate: bool):
    """``_learn_plan_runner`` with a ``teacher_available`` vector for the
    planned next tick."""
    del donate

    # odlint(torch): captured
    def run_learn_plan(src, dst, avail, h, labels, pred, conf, mask, controller_on, theta,
                       x_next):
        mid = _learn_into(src, dst, cfg, h, labels, pred, conf, mask, controller_on, theta)
        new, p = fleet.plan(mid, x_next, cfg, mode=mode, teacher_available=avail,
                            out=dst)
        fleet.store_into(dst, new)
        return p

    return run_learn_plan


def cache_stats() -> dict:
    """Hit/miss counters of every runner cache in the engine, under the JAX
    package's keys (``fleet.runner_cache_info``'s chunk and patch-learn
    runners, then the stream runners)."""
    out = dict(fleet.runner_cache_info())
    for name, fn in (
        ("plan_runner", _plan_runner),
        ("learn_runner", _learn_runner),
        ("learn_plan_runner", _learn_plan_runner),
        ("plan_avail_runner", _plan_avail_runner),
        ("learn_plan_avail_runner", _learn_plan_avail_runner),
    ):
        info = fn.cache_info()
        out[name] = {
            "hits": info.hits,
            "misses": info.misses,
            "size": info.currsize,
            "maxsize": info.maxsize,
        }
    return out


class _PinnedShip:
    """Ships host arrays to the card while it computes.

    Each array is staged in a pinned host buffer and copied by a
    non-blocking copy on a side stream into a new tensor on the card; the
    compute stream waits on the copy's event, and a pinned buffer is filled
    again only after its last copy's event has completed.  A tensor already
    on the card passes through.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self._slots: dict[tuple, list] = {}  # (shape, dtype) -> [[pinned, event], ...]
        self._turn: dict[tuple, int] = {}

    def __call__(self, a) -> torch.Tensor:
        if torch.is_tensor(a) and a.device.type == "cuda":
            return a
        host = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a))
        key = (tuple(host.shape), host.dtype)
        slots = self._slots.setdefault(key, [])
        i = self._turn.get(key, 0)
        self._turn[key] = (i + 1) % SHIP_DEPTH
        if i == len(slots):
            slots.append([torch.empty(host.shape, dtype=host.dtype, pin_memory=True), None])
        pinned, done = slots[i]
        if done is not None:
            done.synchronize()
        pinned.copy_(host)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self.stream):
            dev = torch.empty(host.shape, dtype=host.dtype, device=self.device)
            dev.copy_(pinned, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        slots[i][1] = done
        compute.wait_event(done)
        dev.record_stream(compute)
        return dev


def _default_ship(device: torch.device) -> Callable:
    """On the card, ship each tick through pinned buffers on a side stream
    (``_PinnedShip``) so the copy overlaps the tick in flight; on the CPU,
    ``torch.as_tensor``."""
    if device.type == "cuda":
        return _PinnedShip(device)
    return lambda a: torch.as_tensor(a, device=device)


class _StateBuffers:
    """An ``EngineState`` held in two sets of buffers written in turn
    (ping-pong), and the CUDA graphs of the tick functions run over them.

    ``_pe`` says which set holds P and beta now, ``_pc`` which holds the
    small leaves.  ``tick`` runs a runner from the current buffers into the
    other ones (P and beta flip when it learns, the small leaves always) and
    replays it as a graph on the card, captured on first use per runner and
    parity pair (``graphs.run``).  ``prefix`` goes in front of the runner
    names the graphs are tallied under.  The buffers never move while this
    object lives, so its graphs stay valid; writing rows in (``write``)
    copies into the current buffers.
    """

    def __init__(self, own: EngineState, prefix: str = ""):
        self._bufs = (own, tree_map(torch.empty_like, own))
        self._pe = self._pc = 0
        self.graphs: dict = {}
        self.prefix = prefix

    @property
    def state(self) -> EngineState:
        """The current state (views of the buffers)."""
        return self._compose(self._pe, self._pc)

    @property
    def spare(self) -> EngineState:
        """The other buffer set, whose contents are scratch."""
        return self._compose(1 - self._pe, 1 - self._pc)

    def _compose(self, pe: int, pc: int) -> EngineState:
        e, c = self._bufs[pe].elm, self._bufs[pc]
        return c._replace(elm=c.elm._replace(beta=e.beta, P=e.P))

    def tick(self, runner: tuple, learns: bool, inputs: tuple):
        """Run one runner ``(name, tick function, extra fixed tensors)`` from
        the current buffers into the other ones; returns its output."""
        name, fn, extra = runner
        pe, pc = self._pe, self._pc
        src = self._compose(pe, pc)
        dst = self._compose(1 - pe if learns else pe, 1 - pc)
        out = graphs.run(self.graphs, (name, pe, pc), self.prefix + name, fn,
                         (src, dst, *extra), inputs)
        self._pc = 1 - pc
        if learns:
            self._pe = 1 - pe
        return out

    def write(self, state: EngineState) -> None:
        """Copy ``state``'s leaves into the current buffers (shapes must match)."""
        cur = tree_leaves(self.state)
        new = tree_leaves(state)
        for d, n in zip(cur, new, strict=True):
            if d.shape != n.shape:
                raise ValueError(f"state leaf {tuple(n.shape)} does not fit the session's "
                                 f"{tuple(d.shape)}")
        graphs.copy_into(cur, new)


class StreamSession:
    """One stream's (one tenant's) async-teacher runtime as a state machine.

    Lifecycle::

        sess = StreamSession(state, cfg, teacher, ...)
        sess.start(x0)          # plan the first tick
        sess.advance(x1)        # finish tick 0 (ask/poll/learn), plan tick 1
        ...
        sess.advance(None)      # finish the last tick (no next plan)
        state, outs, stats = sess.finish()   # drain + accounting + outputs

    ``backpressure`` picks the ring-saturation policy
    (``BACKPRESSURE_POLICIES``).  The session copies ``state`` into buffers
    of its own once, whatever ``donate`` says, so the caller's state
    survives the run; on the card it captures its own graphs of the runners
    (``engine/graphs.py``) over those buffers.  Assigning ``state`` copies
    the given rows into those buffers (a cohort writes a member's rows back
    so), which keeps the graphs valid.
    """

    def __init__(
        self,
        state: EngineState,
        cfg: EngineConfig,
        teacher: Teacher,
        mode: str = "algo1",
        capacity: int = 64,
        backpressure: str = "drop_oldest",
        collect: bool = True,
        donate: Optional[bool] = None,
        stats: Optional[StreamStats] = None,
        ship: Optional[Callable] = None,
        live: Optional[int] = None,
    ):
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {backpressure!r}; "
                f"choose one of {BACKPRESSURE_POLICIES}"
            )
        if donate is None:
            donate = True
        own = tree_map(lambda a: a.clone(memory_format=torch.contiguous_format), state)
        self._buf = _StateBuffers(own)
        self._donate = donate
        self.device = own.elm.P.device
        # ODLBase's alpha is copied to the card here, never inside a capture.
        oselm.make_alpha(cfg.elm, self.device)
        self.cfg = cfg
        self.teacher = teacher
        self.mode = mode
        self.backpressure = backpressure
        self.collect = collect
        self.stats = stats if stats is not None else StreamStats()
        self.ring = PendingRing(capacity)
        self.ship = ship if ship is not None else _default_ship(self.device)
        # ``live``: only the first ``live`` rows are real streams; the tail
        # is dead padding that plans with teacher_available=False and is
        # left out of ``stream_steps``.
        n_streams = own.elm.P.shape[0]
        self.live = None if live is not None and live >= n_streams else live
        # Runners as (name, tick function, extra fixed tensors).
        if self.live is None:
            self._plan_fn = ("plan_runner", _plan_runner(cfg, mode, donate), ())
            self._fused_fn = ("learn_plan_runner", _learn_plan_runner(cfg, mode, donate), ())
        else:
            avail = (torch.arange(n_streams, device=self.device) < self.live,)
            self._plan_fn = ("plan_avail_runner", _plan_avail_runner(cfg, mode, donate), avail)
            self._fused_fn = ("learn_plan_avail_runner",
                              _learn_plan_avail_runner(cfg, mode, donate), avail)
        self._learn_fn = ("learn_runner", _learn_runner(cfg, donate), ())
        # ``block``: asks waiting for a ring slot (bounded like the ring).
        self._deferred: "collections.deque[DeferredAsk]" = collections.deque()
        self._cols: dict[str, list] = {
            k: []
            for k in ("pred", "outputs", "queried", "theta", "confidence", "mode_training")
        }
        self._trained_rows: list[np.ndarray] = []
        self._full_mask_dev = None  # cached all-True apply mask on the device
        self._x = None  # current tick's features (planned, not asked yet)
        self._p = None  # current tick's PlanOutput
        self.t = 0
        self._t_start: Optional[float] = None
        self._finished = False
        # Label set for this session's telemetry series; owners fill it in.
        # Never read on the compute path.
        self.telemetry_labels: dict = {}

    # -- state buffers -----------------------------------------------------

    @property
    def state(self) -> EngineState:
        """The session's current state (views of its own buffers)."""
        return self._buf.state

    @state.setter
    def state(self, state: EngineState) -> None:
        self._buf.write(state)

    def _tick(self, runner: tuple, learns: bool, inputs: tuple):
        return self._buf.tick(runner, learns, inputs)

    # -- lifecycle ---------------------------------------------------------

    def started(self) -> bool:
        return self._t_start is not None

    # odlint: shard-local
    def start(self, x0) -> None:
        """Plan the first tick (nothing pending yet)."""
        assert not self.started(), "session already started"
        self._t_start = time.perf_counter()
        x0 = self.ship(x0)
        self._x, self._p = x0, self._tick(self._plan_fn, False, (x0,))

    # odlint: shard-local
    def advance(self, nxt) -> None:
        """Finish the current tick (ask → poll → learn) and plan ``nxt``
        (the next tick's features, or None when the source is exhausted)."""
        x, p = self._x, self._p
        assert p is not None, "advance() before start()"
        t = self.t
        t0 = time.perf_counter()
        tel = _telemetry.TELEMETRY
        tok = tel.tracer.begin("stream.tick") if tel is not None else None
        if nxt is not None:
            nxt = self.ship(nxt)
        queried_host = p.queried.cpu().numpy()  # the host waits for tick t here
        if self.collect:
            for k in self._cols:
                self._cols[k].append(
                    queried_host if k == "queried" else getattr(p, k).cpu().numpy())
            self._trained_rows.append(np.zeros(queried_host.shape, bool))
        n_q = int(queried_host.sum())
        if n_q:
            # The comm meter charged these queries inside plan; every one
            # must end in exactly one of applied / dropped / lost / coalesced.
            self.stats.queries_issued += n_q
            self._submit(x, queried_host, p, t)
        applies = [
            a for a in (self._claim(r, t) for r in self.teacher.poll(t)) if a is not None
        ]
        # Replies just freed ring slots: submit deferred (``block``) asks.
        self._flush_deferred(t)
        if nxt is not None:
            # Steady state: the last reply's learn fused with the next plan
            # (earlier replies apply first, so all of tick t's answers land
            # before tick t+1 is planned).
            if applies:
                for args in applies[:-1]:
                    self._learn(args)
                p_next = self._tick(self._fused_fn, True, (*applies[-1], nxt))
            else:
                p_next = self._tick(self._plan_fn, False, (nxt,))
        else:
            for args in applies:
                self._learn(args)
            p_next = None
        self.stats.ticks += 1
        self.stats.stream_steps += self.live if self.live is not None else int(x.shape[0])
        tick_s = time.perf_counter() - t0
        self.stats.tick_ms.append(tick_s * 1e3)
        if tick_s > 0:
            rate = 1.0 / tick_s
            ema = self.stats.tick_rate_ema
            self.stats.tick_rate_ema = (
                rate if ema == 0.0 else ema + TICK_RATE_EMA_ALPHA * (rate - ema)
            )
        self.t += 1
        self._x, self._p = nxt, p_next
        if tok is not None:
            tel.tracer.end(tok, t=t, queries=n_q, **self.telemetry_labels)

    def drain_replies(
        self,
        max_ticks: int = MAX_DRAIN_TICKS,
        idle_sleep_s: float = DRAIN_IDLE_SLEEP_S,
    ) -> bool:
        """Wait out in-flight replies after the tick source is exhausted.

        Polls while the ring holds tickets, asks are deferred, or the
        teacher has replies in flight (a reply to an evicted ticket must
        still be polled so ``replies_orphaned`` meters it).  Returns True
        when ``max_ticks`` ran out with work possibly still in flight, False
        when the drain is complete.
        """
        drained = 0
        while len(self.ring) or self._deferred or self.teacher.in_flight() > 0:
            if drained >= max_ticks:
                return True
            replies = self._poll_and_apply()
            self._flush_deferred(self.t)
            self.t += 1
            drained += 1
            if self.teacher.in_flight() == 0 and not replies:
                # A threaded teacher may resolve a ticket between the poll
                # and the in_flight check: poll once more before concluding
                # that nothing can arrive.
                if not self._poll_and_apply():
                    break
            elif not replies and idle_sleep_s > 0:
                time.sleep(idle_sleep_s)
        return False

    def quiesce(
        self,
        max_ticks: int = 4096,
        idle_sleep_s: float = DRAIN_IDLE_SLEEP_S,
    ) -> bool:
        """Wait out in-flight replies without advancing the tick clock (a
        mid-stream move keeps ``t`` matched to the tick source).  Returns
        True when the ring fully quiesced."""
        t0 = self.t
        try:
            self.drain_replies(max_ticks=max_ticks, idle_sleep_s=idle_sleep_s)
        finally:
            self.t = t0
        return not len(self.ring)

    def pending_queries(self) -> int:
        """Stream-queries issued but not yet settled (ring plus deferred
        asks): with it the accounting identity closes at any instant."""
        n = sum(int(ent.queried.sum()) for ent in self.ring.entries())
        n += sum(int(d.queried.sum()) for d in self._deferred)
        return n

    def sync_telemetry(self) -> None:
        """Mirror this session's ``StreamStats`` into the enabled registry
        (no-op when telemetry is off).  Called at ``finish()`` and by live
        scrapes, never on the per-tick path; reads host integers only."""
        tel = _telemetry.TELEMETRY
        if tel is not None:
            _telemetry.sync_stream_stats(tel.registry, self.stats, pending=self.pending_queries(),
                                         **self.telemetry_labels)

    def _poll_and_apply(self) -> list[TeacherReply]:
        replies = self.teacher.poll(self.t)
        for reply in replies:
            args = self._claim(reply, self.t)
            if args is not None:
                self._learn(args)
        return replies

    # odlint: shard-local
    def finish(
        self, drain: bool = True
    ) -> tuple[EngineState, Optional[FleetStepOutput], StreamStats]:
        """Drain, settle terminal accounting, and build stacked host outputs."""
        assert self._p is None, "finish() with a planned tick still pending"
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        if drain:
            self.drain_replies()
        for ent in self.ring.drain():
            self.stats.tickets_lost += 1
            self.stats.queries_lost += int(ent.queried.sum())
        for d in self._deferred:
            # ``block`` asks that never got a slot never hit the wire:
            # backpressure dropped them.
            self.stats.tickets_dropped += 1
            self.stats.queries_dropped += int(d.queried.sum())
        self._deferred.clear()
        if self._t_start is not None:
            self.stats.wall_s += time.perf_counter() - self._t_start
        self.sync_telemetry()
        outs = None
        if self.collect and self._cols["pred"]:
            outs = FleetStepOutput(
                pred=np.stack(self._cols["pred"]),
                outputs=np.stack(self._cols["outputs"]),
                queried=np.stack(self._cols["queried"]),
                trained=np.stack(self._trained_rows),
                theta=np.stack(self._cols["theta"]),
                confidence=np.stack(self._cols["confidence"]),
                mode_training=np.stack(self._cols["mode_training"]),
            )
        return self.state, outs, self.stats

    # -- durability (engine/snapshot.py) -----------------------------------

    def snapshot(self) -> dict:
        """Full-fidelity serialization of this session: state, ring contents
        with their plan-time context, deferred asks, stats, the in-flight
        tick, the tick-source cursor and, when the teacher supports it, the
        teacher's own state.  Every leaf is a host numpy array the tree owns
        (copied after the replay that wrote it), plus one JSON meta leaf:
        hand it to ``runtime.checkpoint.CheckpointManager`` for atomic keep-k
        publication.  The session keeps running."""
        from repro_torch.engine import snapshot as snapshot_mod

        return snapshot_mod.capture(self)

    @classmethod
    def restore(
        cls,
        tree: dict,
        teacher: Teacher,
        cfg=None,
        ship: Optional[Callable] = None,
        pending: str = "auto",
        device=None,
    ) -> "StreamSession":
        """Rebuild a session from ``snapshot()``'s tree (either package's) on
        ``device``, CUDA unless named (``engine.snapshot.restore`` has the
        pending-ticket policies).  The caller repositions the tick source at
        ``engine.snapshot.ticks_consumed(tree)`` and resumes driving
        ``advance``; under a deterministic snapshot-capable teacher the
        resumed run is bit for bit the uninterrupted one."""
        from repro_torch.engine import snapshot as snapshot_mod

        return snapshot_mod.restore(tree, teacher, cfg=cfg, ship=ship, pending=pending,
                                    device=device)

    # -- internals ---------------------------------------------------------

    def _ask(self, x, queried: np.ndarray, p, t: int):
        """One teacher.ask and ring push (evicting the oldest, metered)."""
        ticket = self.teacher.ask(x, queried, t)
        self.stats.tickets_issued += 1
        dropped = self.ring.push(ticket, PendingTicket(t, queried, p, x))
        self.stats.ring_occupancy_hwm = max(self.stats.ring_occupancy_hwm, len(self.ring))
        if dropped is not None:
            self.stats.tickets_dropped += 1
            self.stats.queries_dropped += int(dropped.queried.sum())
            tel = _telemetry.TELEMETRY
            if tel is not None:
                tel.tracer.event("ring.evict", t=t, evicted_tick=dropped.tick,
                                 queries=int(dropped.queried.sum()), **self.telemetry_labels)

    def _submit(self, x, queried: np.ndarray, p, t: int) -> None:
        """Route one tick's decided queries through the backpressure policy."""
        policy = self.backpressure
        if policy == "coalesce":
            # Streams already covered by an in-flight ticket are merged into
            # it: its answer settles the decision it belongs to.
            entries = list(self.ring.entries())  # oldest first
            cover = np.zeros_like(queried)
            for ent in entries:
                cover |= ent.queried
            rest = queried & ~cover
            if rest.any() and self.ring.full() and entries:
                # The residual ask will evict the oldest ticket, whose
                # coverage can then settle nothing: streams only it covered
                # ride the new ticket.
                cover = np.zeros_like(queried)
                for ent in entries[1:]:
                    cover |= ent.queried
                rest = queried & ~cover
            merged = queried & cover
            n_m = int(merged.sum())
            if n_m:
                self.stats.tickets_coalesced += 1
                self.stats.queries_coalesced += n_m
            if rest.any():
                self._ask(x, rest, p, t)
            return
        if policy == "drop_newest" and self.ring.full():
            self.stats.tickets_dropped += 1
            self.stats.queries_dropped += int(queried.sum())
            return
        if policy == "block" and (self.ring.full() or self._deferred):
            # FIFO: a new ask never jumps a deferred one.
            self.stats.asks_deferred += 1
            self._deferred.append(DeferredAsk(t, x, queried, p))
            if len(self._deferred) > self.ring.capacity:
                d = self._deferred.popleft()
                self.stats.tickets_dropped += 1
                self.stats.queries_dropped += int(d.queried.sum())
            return
        self._ask(x, queried, p, t)

    def _flush_deferred(self, now: int) -> None:
        del now
        while self._deferred and not self.ring.full():
            d = self._deferred.popleft()
            # Ask with the origin tick, so the ring entry marks the right
            # ``trained`` row and label latency counts from the decision.
            self._ask(d.x, d.queried, d.plan, d.tick)

    def _claim_entry(self, reply: TeacherReply, now: int):
        """Accounting half of a reply claim: resolve the ticket against the
        ring with all drop/orphan/loss metering and trained-row marking.
        Returns ``(entry, mask)`` or None when nothing is applicable."""
        stats = self.stats
        ent = self.ring.pop(reply.ticket)
        if ent is None:
            stats.replies_orphaned += 1
            return None
        asked = int(ent.queried.sum())
        mask = ent.queried & np.asarray(reply.answered, bool)
        n = int(mask.sum())
        if n == 0:
            # Answered, but none of its asked streams: all of them are lost.
            stats.tickets_lost += 1
            stats.queries_lost += asked
            return None
        stats.labels_applied += n
        # The unanswered residue of a partial answer is lost now.
        stats.queries_lost += asked - n
        stats.label_latency_ticks.append(now - ent.tick)
        if self.collect and ent.tick < len(self._trained_rows):
            self._trained_rows[ent.tick] |= mask
        return ent, mask

    def _build_learn_args(self, ent: PendingTicket, reply: TeacherReply, mask: np.ndarray):
        """Device half of a reply claim: the learn runner's inputs (the
        plan-time context, the shipped labels and the apply mask)."""
        if int(mask.sum()) == mask.shape[0]:
            # Everyone queried and answered: one cached device mask.
            if self._full_mask_dev is None or self._full_mask_dev.shape != mask.shape:
                self._full_mask_dev = torch.ones(mask.shape, dtype=torch.bool, device=self.device)
            mask_dev = self._full_mask_dev
        else:
            mask_dev = self.ship(mask)
        p = ent.plan
        return (
            p.h,
            self.ship(np.asarray(reply.labels, np.int32)),
            p.pred,
            p.confidence,
            mask_dev,
            p.controller_on,
            p.theta,
        )

    def _claim(self, reply: TeacherReply, now: int):
        """Resolve a reply against the ring; returns learn inputs or None."""
        claimed = self._claim_entry(reply, now)
        if claimed is None:
            return None
        ent, mask = claimed
        return self._build_learn_args(ent, reply, mask)

    def _learn(self, args) -> None:
        self._tick(self._learn_fn, True, args)


def run(
    state: EngineState,
    ticks: Iterable,  # yields (S, n_in) feature arrays, one per tick
    cfg: EngineConfig,
    teacher: Teacher,
    mode: str = "algo1",
    capacity: int = 64,
    backpressure: str = "drop_oldest",
    collect: bool = True,
    drain: bool = True,
    donate: Optional[bool] = None,
    stats: Optional[StreamStats] = None,
) -> tuple[EngineState, Optional[FleetStepOutput], StreamStats]:
    """Drive the engine from a tick iterator with an asynchronous teacher.

    Per tick: plan on the device, ingest and ship the next tick while it
    runs, submit the queried features to ``teacher.ask`` and apply whatever
    ``teacher.poll`` returns through ``learn``, out of order, against the
    features captured at query time.  Pending tickets live in a
    ``capacity``-slot ring whose saturation follows ``backpressure``.  After
    the iterator ends, answers still in flight are drained (``drain``).

    Returns ``(final state, outputs, stats)``: ``outputs`` mirrors
    ``run_fleet``'s stacked (T, S) ``FleetStepOutput`` as host arrays
    (``trained`` marks label-application ticks), or None when
    ``collect=False`` or the iterator was empty.  The state lives on the
    device of ``state``; the caller's ``state`` is left as it was.
    """
    sess = StreamSession(
        state, cfg, teacher, mode=mode, capacity=capacity,
        backpressure=backpressure, collect=collect, donate=donate, stats=stats,
    )
    it = iter(ticks)
    nxt = next(it, None)
    if nxt is not None:
        sess.start(nxt)
        while nxt is not None:
            # Double buffering: pull tick t+1 (shipped inside advance) while
            # the device works on tick t.
            nxt = next(it, None)
            sess.advance(nxt)
    return sess.finish(drain=drain)


# ---------------------------------------------------------------------------
# Sharded streaming: per-shard sessions with shard-local pending rings.
# ---------------------------------------------------------------------------


class ShardedStreamSession:
    """N shard-local ``StreamSession``s advanced in lockstep over row
    windows of one full-width tick source.

    Everything per tick is shard-local: shard k's state rows live on
    ``devices[k]`` (the current mesh's ``fleet_devices()``, or the fleet's
    own device); its plan and learn dispatches, pending ring, backpressure state and
    teacher cover only rows ``[k*width, (k+1)*width)``; and a label learns
    back only into the shard that planned the query.  Each shard gets a
    row window of the incoming tick (a view for a shard with no padding).
    Per-shard query accounting reconciles shard-locally
    (``stats_summary()["per_shard"]``), which is how the tests show that no
    label crosses shards.

    ``teachers`` is one ``Teacher`` per shard, a factory ``shard_idx ->
    Teacher``, or an object with a ``tenant`` method (an
    ``rpc.BatchedRpcClient``): each shard then asks through its own handle,
    ``teachers.tenant(name=f"shard{k}")``, and the shards' asks share the
    client's batched frames on one socket.

    S is padded up to a multiple of ``n_shards`` with dead rows at the
    tail: they plan with ``teacher_available=False`` (never query, never
    learn, left out of ``stream_steps``), every shard keeps the same
    width, and ``finish()`` strips them from the merged state and outputs.
    Under a deterministic lossless teacher the result is bit for bit the
    unsharded ``run`` at equal S.
    """

    def __init__(
        self,
        state: EngineState,
        cfg: EngineConfig,
        teachers,
        n_shards: Optional[int] = None,
        mode: str = "algo1",
        capacity: int = 64,
        backpressure: str = "drop_oldest",
        collect: bool = True,
        donate: Optional[bool] = None,
        devices=None,
    ):
        if n_shards is None:
            n_shards = sharding.fleet_axis_size()
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if devices is None:
            devices = sharding.fleet_devices()
        if devices is not None and len(devices) < n_shards:
            raise ValueError(f"{n_shards} shards > {len(devices)} devices")
        if hasattr(teachers, "tenant"):
            client = teachers
            teachers = [client.tenant(name=f"shard{k}") for k in range(n_shards)]
        elif callable(teachers):
            teachers = [teachers(k) for k in range(n_shards)]
        teachers = list(teachers)
        if len(teachers) != n_shards:
            raise ValueError(f"need one teacher per shard: {len(teachers)} != {n_shards}")
        s = int(state.elm.P.shape[0])
        self.s_real = s
        self.n_shards = n_shards
        self.n_pad = (-s) % n_shards
        self.width = (s + self.n_pad) // n_shards
        self.bounds = [(k * self.width, (k + 1) * self.width) for k in range(n_shards)]
        padded = fleet.pad_streams(state, cfg, self.n_pad)
        self.sessions: list[StreamSession] = []
        for k, (lo, hi) in enumerate(self.bounds):
            sub = fleet.slice_streams(padded, lo, hi)
            if devices is not None:
                sub = tree_map(lambda a: a.to(devices[k]), sub)
            sess = StreamSession(
                sub, cfg, teachers[k], mode=mode, capacity=capacity,
                backpressure=backpressure, collect=collect, donate=donate,
                live=min(self.width, max(0, s - lo)),
            )
            sess.telemetry_labels = {"shard": str(k)}
            self.sessions.append(sess)
        self._zeros = None  # (key, window): shared by the fully dead shards

    def _shard_tick(self, x, k: int):
        """Shard k's rows of a full-width tick (numpy array or tensor)."""
        lo, hi = self.bounds[k]
        if hi <= self.s_real:
            return x[lo:hi]  # a view, no copy
        shape = (self.width,) + tuple(x.shape[1:])
        if lo >= self.s_real:
            key = (torch.is_tensor(x), shape, x.dtype, getattr(x, "device", None))
            if self._zeros is None or self._zeros[0] != key:
                self._zeros = (key, _zeros_like(x, shape))
            return self._zeros[1]
        # A tail shard with live and dead rows gets a fresh buffer every
        # tick: the session asks with the previous tick's rows on the next
        # advance, and ring tickets keep them, so a buffer written in place
        # would change what they hold.
        buf = _zeros_like(x, shape)
        buf[: self.s_real - lo] = x[lo:]
        return buf

    def started(self) -> bool:
        return self.sessions[0].started()

    # The per-shard calls are shard-local (each session's tensors live on one
    # device), so they run under ``sharding.deactivate()``: a caller's mesh
    # scope does not reach them.

    def start(self, x0) -> None:
        x0 = _as_tick(x0)
        with sharding.deactivate():
            for k, sess in enumerate(self.sessions):
                sess.start(self._shard_tick(x0, k))

    def advance(self, nxt) -> None:
        nxt = None if nxt is None else _as_tick(nxt)
        with sharding.deactivate():
            for k, sess in enumerate(self.sessions):
                sess.advance(None if nxt is None else self._shard_tick(nxt, k))

    def finish(
        self, drain: bool = True
    ) -> tuple[EngineState, Optional[FleetStepOutput], list[StreamStats]]:
        """Drain every shard and merge states (on the host, as CPU tensors)
        and outputs in row order, with the dead rows stripped; returns the
        per-shard stats list (``aggregate_stats`` folds it)."""
        states, outs, stats = [], [], []
        with sharding.deactivate():
            for sess in self.sessions:
                st, o, sstats = sess.finish(drain=drain)
                states.append(tree_map(lambda a: a.cpu(), st))
                outs.append(o)
                stats.append(sstats)
        merged = fleet.stack_streams(states)
        if self.n_pad:
            merged = fleet.slice_streams(merged, 0, self.s_real)
        out = None
        if outs and all(o is not None for o in outs):
            out = FleetStepOutput(*(np.concatenate(a, axis=1) for a in zip(*outs)))
            if self.n_pad:
                out = FleetStepOutput(*(a[:, : self.s_real] for a in out))
        return merged, out, stats

    def stats_summary(self) -> dict:
        return aggregate_stats([s.stats for s in self.sessions], padded_streams=self.n_pad)


def _as_tick(x):
    """A tick as a tensor or a numpy array (anything else through numpy)."""
    return x if torch.is_tensor(x) else np.asarray(x)


def _zeros_like(x, shape):
    if torch.is_tensor(x):
        return torch.zeros(shape, dtype=x.dtype, device=x.device)
    return np.zeros(shape, x.dtype)


def aggregate_stats(stats_list: list, padded_streams: int = 0) -> dict:
    """Fold per-shard ``StreamStats`` into one fleet-wide summary.

    Counters sum; latency percentiles pool the shard windows; the
    accounting identity must hold per shard (a reply can settle only a
    query its own shard issued), so ``queries_reconciled`` is the AND: a
    label crossing shards shows as one shard over- and another
    under-counting."""
    counters = (
        "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
        "tickets_dropped", "queries_dropped", "replies_orphaned",
        "tickets_lost", "queries_lost", "tickets_coalesced",
        "queries_coalesced", "asks_deferred", "tickets_reasked",
    )
    out = {k: sum(getattr(s, k) for s in stats_list) for k in counters}
    out["ticks"] = max((s.ticks for s in stats_list), default=0)
    out["wall_s"] = max((s.wall_s for s in stats_list), default=0.0)
    out["steps_per_s"] = out["stream_steps"] / out["wall_s"] if out["wall_s"] > 0 else 0.0
    tick_ms = [v for s in stats_list for v in s.tick_ms]
    lab = [v for s in stats_list for v in s.label_latency_ticks]
    out["tick_p50_ms"] = _percentile(tick_ms, 50)
    out["tick_p95_ms"] = _percentile(tick_ms, 95)
    out["label_latency_p50"] = _percentile(lab, 50)
    out["label_latency_p95"] = _percentile(lab, 95)
    out["queries_reconciled"] = all(s.reconciled for s in stats_list)
    out["padded_streams"] = padded_streams
    out["n_shards"] = len(stats_list)
    out["per_shard"] = [s.summary() for s in stats_list]
    return out


def run_sharded(
    state: EngineState,
    ticks: Iterable,  # yields full-width (S, n_in) feature arrays or tensors
    cfg: EngineConfig,
    teachers,  # one Teacher per shard, a factory shard_idx -> Teacher, or a BatchedRpcClient
    n_shards: Optional[int] = None,
    mode: str = "algo1",
    capacity: int = 64,
    backpressure: str = "drop_oldest",
    collect: bool = True,
    drain: bool = True,
    donate: Optional[bool] = None,
    devices=None,
) -> tuple[EngineState, Optional[FleetStepOutput], list[StreamStats]]:
    """``run`` over a sharded fleet: the stream axis splits into
    ``n_shards`` shard-local sessions (default: the current mesh's fleet
    axis), each with its own pending ring and teacher (see
    ``ShardedStreamSession``).  Returns ``(final state, outputs, per-shard
    stats)``, state and outputs merged back to full (unpadded) width on
    the host."""
    sess = ShardedStreamSession(
        state, cfg, teachers, n_shards=n_shards, mode=mode, capacity=capacity,
        backpressure=backpressure, collect=collect, donate=donate, devices=devices,
    )
    it = iter(ticks)
    nxt = next(it, None)
    if nxt is not None:
        sess.start(nxt)
        while nxt is not None:
            nxt = next(it, None)
            sess.advance(nxt)
    return sess.finish(drain=drain)
