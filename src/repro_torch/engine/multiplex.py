"""Multi-tenant stream multiplexer: N independent fleets in one process
(PyTorch counterpart of ``repro/engine/multiplex.py``).

Each tenant is an independent fleet (its own ``EngineConfig``,
``EngineState``, tick source, ``Teacher``, pending-query ring and
backpressure policy), and all of them run in one process, sharing the
engine's bounded runner caches (``stream._plan_runner`` / ``_learn_runner``
/ ``_learn_plan_runner``): tenants with the same ``(cfg, mode, donate)``
share one set of tick functions.

Cohort fusion (``fuse=True``, the default) goes one step further: tenants
that also share a stream width are packed into cohorts
(``engine/cohort.py``) whose states stack along the leading stream axis, so
one stacked dispatch per tick (one CUDA graph replay on the card) advances
the whole cohort instead of one per tenant.  Each tenant keeps its own ring,
teacher, backpressure, stats and tick cursor, and its results are bit for
bit those of the unfused run and of a solo ``stream.run``; ``fuse=False``
restores the one-dispatch-per-tenant scheduler.

Scheduling (``sched``):

* ``"rr"`` (default): round robin with a ``quantum``-tick time slice: each
  tenant advances by up to ``quantum`` plan/ask/poll/learn cycles before the
  scheduler moves on;
* ``"drr"``: deficit round robin in stream-step (cost) units: every round
  each live tenant's deficit grows by the same credit (``quantum × min S``)
  and one tick debits that tenant's own S, so a tenant's share of device
  time is equal whatever its size.  Unspent credit carries over.

A session's per-tenant op sequence does not depend on what the scheduler
interleaves around it, so a multiplexed tenant reproduces its solo
``stream.run`` bit for bit under either scheduler at any quantum.  Tenants
whose tick source is exhausted are drained in bounded slices and finished;
the multiplexer ends when every tenant has finished.

Durability (``engine/snapshot.py``): pass ``snapshot_dir`` and
``snapshot_every`` and each tenant's session is captured every
``snapshot_every`` ticks into ``<snapshot_dir>/<tenant>/step_*`` through
``runtime.checkpoint.CheckpointManager`` (atomic publish, keep-k, crashed
``.tmp`` fallback; ``snapshot_full_every`` > 1 makes all but every k-th save
a delta).  A fused member's rows are written back into its session first.
``resume=True`` restores each tenant from its latest published snapshot and
seeks its (seekable) tick source to the recorded cursor.
``run_supervised`` wraps the whole thing in
``runtime.fault.run_with_restarts``: crash, restore, continue, bounded.

Live migration: ``Multiplexer.extract(name)`` releases a tenant from its
cohort (its rows and pending plan written back into its session), quiesces
it unless its teacher can snapshot, snapshots it and removes it from this
scheduler; ``admit(tenant, snapshot=...)`` (or the ``snapshots=``
constructor argument) restores it into another multiplexer, where it may
join a cohort at the next round.  In-flight tickets that did not drain are
re-asked through the new teacher and metered (``tickets_reasked``), so the
query-accounting identity reconciles across the move.

Usage::

    results, agg = multiplex.run([
        multiplex.Tenant("edge-a", state_a, ticks_a, cfg_a, teacher_a),
        multiplex.Tenant("edge-b", state_b, ticks_b, cfg_b, teacher_b,
                         backpressure="coalesce"),
    ], sched="drr", snapshot_dir="/var/ckpt", snapshot_every=1000)

Teachers over the wire: ``shared_rpc_teachers`` gives each tenant a
``stream.Teacher`` handle on one shared ``rpc.BatchedRpcClient`` per teacher
endpoint (``engine/rpc.py``), so tenants of one host share one socket, one
handshake and batched frames.

Telemetry (``runtime/telemetry.py``): ``admit`` and ``extract`` are the
``migrate.admit`` / ``migrate.extract`` spans, forming and dissolving a
cohort the ``cohort.pack`` / ``cohort.dissolve`` events, each round counts
``odl_mux_rounds`` and its stream-step debits, and ``sync_telemetry``
mirrors every tenant's ``StreamStats`` (labelled by tenant name) at scrapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import time
from typing import Iterable, NamedTuple, Optional

from repro_torch import convert
from repro_torch.engine import cohort as cohort_mod
from repro_torch.engine import snapshot as snapshot_mod
from repro_torch.engine import stream
from repro_torch.engine.types import EngineConfig, EngineState, FleetStepOutput
from repro_torch.runtime import fault
from repro_torch.runtime import telemetry as _telemetry
from repro_torch.runtime.checkpoint import CheckpointManager

SCHEDULERS = ("rr", "drr")
DEFAULT_QUANTUM = 8


def shape_key(cfg: EngineConfig, mode: str, donate: Optional[bool], s: int) -> str:
    """Stable cross-process id of a tenant's shape class: the cohort fuse key
    ``(cfg, mode, donate, S)`` as a short hash.  Two tenants with equal keys
    share runners and can fuse into one cohort.  The digest is the JAX
    package's for the same configuration (a digest of the JSON config, not a
    Python hash), so a router can pack tenants of either package by it."""
    blob = json.dumps(
        {
            "cfg": convert.config_to_dict(cfg),
            "mode": mode,
            "donate": bool(True if donate is None else donate),
            "s": int(s),
        },
        sort_keys=True,
    )
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


@dataclasses.dataclass
class Tenant:
    """One fleet behind the multiplexer.

    ``name`` keys the result dict (must be unique).  Everything else is
    exactly what ``stream.run`` takes, per tenant: its own config, state,
    tick source, teacher, ring capacity and backpressure policy
    (``stream.BACKPRESSURE_POLICIES``).  ``state`` may be None when the
    tenant is admitted from a snapshot (the snapshot carries the state).
    A restored session lives on ``device``; when that is None, on the
    device of ``state`` if one is given, else on CUDA.
    """

    name: str
    state: Optional[EngineState]
    ticks: Iterable  # yields (S, n_in) feature arrays or tensors, one per tick
    cfg: Optional[EngineConfig]
    teacher: stream.Teacher
    mode: str = "algo1"
    capacity: int = 64
    backpressure: str = "drop_oldest"
    collect: bool = True
    donate: Optional[bool] = None
    device: Optional[str] = None


def shared_rpc_teachers(
    endpoints,
    timeout_s: float = 5.0,
    connect_timeout_s: float = 5.0,
    secret: Optional[str] = None,
    batch_window_s: Optional[float] = None,
    batch_max: Optional[int] = None,
    compress: bool = False,
):
    """Per-tenant teachers over shared batched RPC connections.

    ``endpoints[i]`` is tenant i's ``(host, port)``; tenants with the same
    endpoint share one ``rpc.BatchedRpcClient``: one socket per teacher
    host, one HMAC handshake per connection (not per tenant), and every
    tenant's asks coalesced into batched frames within the flush window.
    Returns ``(teachers, clients)``: ``teachers[i]`` is tenant i's
    ``stream.Teacher`` handle, ``clients`` the deduplicated connections
    (close them, not the handles, when the run is done).  If a later
    endpoint cannot be dialled, the clients already built are closed before
    the error propagates.
    """
    from repro_torch.engine import rpc  # deferred: keep `python -m ...engine.rpc` clean

    if batch_window_s is None:
        batch_window_s = rpc.DEFAULT_BATCH_WINDOW_S
    if batch_max is None:
        batch_max = rpc.DEFAULT_BATCH_MAX
    clients: dict = {}
    teachers = []
    try:
        for i, (host, port) in enumerate(endpoints):
            key = (host, int(port))
            client = clients.get(key)
            if client is None:
                client = clients[key] = rpc.BatchedRpcClient(
                    host, int(port), timeout_s=timeout_s, connect_timeout_s=connect_timeout_s,
                    secret=secret, batch_window_s=batch_window_s, batch_max=batch_max,
                    compress=compress,
                )
            teachers.append(client.tenant(name=f"tenant{i}"))
    except BaseException:
        # The clients already built own sockets and reader/flusher threads
        # that would otherwise outlive the call.
        for client in clients.values():
            with contextlib.suppress(Exception):
                client.close()
        raise
    return teachers, list(clients.values())


class TenantResult(NamedTuple):
    name: str
    state: EngineState
    outputs: Optional[FleetStepOutput]
    stats: stream.StreamStats


@dataclasses.dataclass
class MultiplexStats:
    """Aggregate view over one multiplexed run.

    ``wall_s`` is the scheduler's wall time (shared by all tenants: each
    tenant's own ``StreamStats.wall_s`` spans the whole multiplexed run, so
    per-tenant ``steps_per_s`` is not additive; use ``steps_per_s`` here
    for aggregate throughput).
    """

    n_tenants: int = 0
    rounds: int = 0
    stream_steps: int = 0
    ticks: int = 0
    snapshots: int = 0
    wall_s: float = 0.0

    @property
    def steps_per_s(self) -> float:
        return self.stream_steps / self.wall_s if self.wall_s > 0 else 0.0

    def summary(self) -> dict:
        return {
            "n_tenants": self.n_tenants,
            "rounds": self.rounds,
            "ticks": self.ticks,
            "stream_steps": self.stream_steps,
            "snapshots": self.snapshots,
            "steps_per_s": self.steps_per_s,
            "wall_s": self.wall_s,
            "caches": stream.cache_stats(),
        }


class _Slot:
    """Scheduler-side bookkeeping for one tenant."""

    # Drain polls allowed per scheduler slice: a drain poll is far cheaper
    # than a real tick (no device dispatch), but a laggy teacher must not
    # head-of-line block live tenants, so a draining tenant gets a bounded
    # budget per round and resumes next round.
    DRAIN_TICKS_PER_SLICE = 64
    DRAIN_IDLE_SLEEP_S = 50e-6

    def __init__(
        self,
        tenant: Tenant,
        manager: Optional[CheckpointManager] = None,
        snapshot_every: int = 0,
        resume: bool = False,
        snapshot_tree: Optional[dict] = None,
        pending: str = "auto",
        positioned: bool = False,
    ):
        self.tenant = tenant
        self.manager = manager
        self.snapshot_every = snapshot_every
        from_manager = False
        if snapshot_tree is None and resume and manager is not None:
            if manager.latest_step() is not None:
                _, snapshot_tree = manager.restore()
                from_manager = True
        if snapshot_tree is not None:
            device = tenant.device
            if device is None and tenant.state is not None:
                device = tenant.state.elm.P.device
            self.session = stream.StreamSession.restore(
                snapshot_tree, tenant.teacher, cfg=tenant.cfg, pending=pending, device=device
            )
            consumed = snapshot_mod.ticks_consumed(snapshot_tree)
            if from_manager or getattr(tenant.ticks, "seek", None) is not None:
                # Crash-restart: the fresh source is at tick 0 and MUST be
                # seekable (seek_ticks raises otherwise; replaying ticks
                # 0..k-1 into a t=k session would corrupt training).
                snapshot_mod.seek_ticks(tenant.ticks, consumed)
            elif not positioned:
                # A migration snapshot may hand over the partially consumed
                # iterator itself (what ``extract`` returns), but only with
                # an explicit opt-in: a fresh tick-0 iterator taken as
                # positioned at tick k would replay ticks into the session.
                raise ValueError(
                    f"tenant {tenant.name!r}: restoring a snapshot needs a "
                    "seekable tick source (snapshot.ResumableTicks), or "
                    "pass positioned=True when handing over the "
                    "partially-consumed iterator returned by extract()"
                )
        else:
            if tenant.state is None or tenant.cfg is None:
                raise ValueError(
                    f"tenant {tenant.name!r} has no state/cfg and no snapshot to restore from"
                )
            self.session = stream.StreamSession(
                tenant.state,
                tenant.cfg,
                tenant.teacher,
                mode=tenant.mode,
                capacity=tenant.capacity,
                backpressure=tenant.backpressure,
                collect=tenant.collect,
                donate=tenant.donate,
            )
        # Telemetry series for this tenant key on its name.
        self.session.telemetry_labels = {"tenant": tenant.name}
        # Tick cost for the deficit scheduler = this tenant's stream count.
        self.s = int(self.session.state.elm.count.shape[0])
        self.deficit = 0.0
        self.last_ticks = 0  # real ticks advanced in the last step() call
        self.unit: Optional["_CohortUnit"] = None  # set while fused
        self.snapshots_taken = 0
        self._last_snap_t = self.session.t
        self.draining = False
        self._drain_ticks = 0  # cumulative, capped at stream.MAX_DRAIN_TICKS
        self.result: Optional[TenantResult] = None
        self._it = None

    def step(self, drain: bool, n_ticks: int) -> bool:
        """Advance this tenant by up to ``n_ticks`` scheduler events (or one
        bounded drain slice once its ticks are exhausted).  Returns True
        while the tenant still wants scheduling."""
        sess = self.session
        self.last_ticks = 0
        if not self.draining:
            for _ in range(n_ticks):
                if not sess.started():
                    x0 = next(self.it, None)
                    if x0 is None:  # empty tick source: nothing to run
                        self.draining = True
                        break
                    sess.start(x0)
                    continue
                if sess._p is None:
                    # Restored from a snapshot taken after its stream
                    # ended: nothing left to plan, only the drain.
                    self.draining = True
                    break
                nxt = next(self.it, None)
                sess.advance(nxt)
                self.last_ticks += 1
                if nxt is None:
                    self.draining = True
                    break
            self.maybe_snapshot()
            if not self.draining:
                return True
            if not drain:
                self._finish()
                return False
        # Draining: one bounded slice per round, so other tenants keep
        # ticking while this one waits out its teacher.  The cumulative cap
        # keeps a broken always-in-flight teacher from pinning the scheduler
        # forever (the same bound a solo run's drain has).
        self._drain_ticks += self.DRAIN_TICKS_PER_SLICE
        if self._drain_ticks <= stream.MAX_DRAIN_TICKS and sess.drain_replies(
            max_ticks=self.DRAIN_TICKS_PER_SLICE,
            idle_sleep_s=self.DRAIN_IDLE_SLEEP_S,
        ):
            return True
        self._finish()
        return False

    @property
    def it(self):
        if self._it is None:
            self._it = iter(self.tenant.ticks)
        return self._it

    def maybe_snapshot(self, force: bool = False) -> bool:
        """Cadence snapshot: capture now (host copies the tree owns), write
        on the manager's background thread (atomic publish: a crash
        mid-write falls back to the previous good step)."""
        if self.manager is None or self.result is not None:
            return False
        due = self.snapshot_every > 0 and self.session.t - self._last_snap_t >= self.snapshot_every
        if not (due or force) or not self.session.started():
            return False
        if self.unit is not None:
            # Fused member: its session state is stale while the cohort
            # holds the authoritative stacked rows; write them back first.
            self.unit.cohort.refresh(self.session)
        self.manager.save_async(self.session.t, self.session.snapshot())
        self._last_snap_t = self.session.t
        self.snapshots_taken += 1
        return True

    def _finish(self) -> None:
        # Any draining already happened incrementally in step().
        if self.manager is not None:
            self.manager.wait()  # never finish with a snapshot mid-write
        state, outs, stats = self.session.finish(drain=False)
        self.result = TenantResult(name=self.tenant.name, state=state, outputs=outs, stats=stats)


class _CohortUnit:
    """Scheduler-side unit driving one fused cohort of slots.

    Takes the place of its member slots in the scheduler's live list: one
    ``step`` advances the whole cohort in lockstep with stacked dispatches
    (``engine/cohort.py``).  ``s``, the DRR tick cost, is the shared member
    width, so each fused member receives exactly the credit and debit
    schedule its solo slot would (cohorts only form between same-width
    tenants).
    """

    def __init__(self, slots: list[_Slot]):
        self.slots = list(slots)
        self.cohort = cohort_mod.CohortSession([s.session for s in slots])
        self.s = slots[0].s
        self.deficit = 0.0
        self.last_ticks = 0
        self.draining = False  # members drain solo, after release

    def attach(self, slot: _Slot) -> None:
        self.cohort.attach(slot.session)
        self.slots.append(slot)
        slot.unit = self

    def release(self, slot: _Slot) -> list[_Slot]:
        """Detach one member (live migration out).  Returns the slots freed
        as a side effect: when one member remains the cohort dissolves and
        that member continues solo."""
        self.cohort.detach(slot.session)
        self.slots.remove(slot)
        slot.unit = None
        freed = []
        if len(self.slots) == 1:
            last = self.slots.pop()
            self.cohort.detach(last.session)
            last.unit = None
            freed.append(last)
        return freed

    def step(self, drain: bool, n_ticks: int) -> tuple[bool, list[_Slot]]:
        """Advance the cohort by up to ``n_ticks`` fused ticks.  Returns
        ``(live, released)``: live is False once the cohort dissolved;
        released slots (exhausted members, or the last member of a dissolved
        cohort) re-enter the scheduler as independent slots."""
        del drain  # released members drain through their solo slot path
        self.last_ticks = 0
        released: list[_Slot] = []
        for _ in range(n_ticks):
            if len(self.slots) < 2:
                break
            nxts = [next(s.it, None) for s in self.slots]
            detached, advanced = self.cohort.tick(nxts)
            if advanced:
                self.last_ticks += 1
            for sess in detached:
                slot = next(s for s in self.slots if s.session is sess)
                self.slots.remove(slot)
                slot.unit = None
                slot.draining = True
                slot.maybe_snapshot()
                released.append(slot)
        for slot in self.slots:
            slot.maybe_snapshot()
        if len(self.slots) == 1:
            # A cohort of one is pure overhead: dissolve, continue solo.
            last = self.slots.pop()
            self.cohort.detach(last.session)
            last.unit = None
            released.append(last)
        return bool(self.slots), released


class Multiplexer:
    """The scheduler: drives N tenant sessions round robin (or DRR), with
    optional per-tenant durability (see the module docstring).

    ``round()`` runs one scheduler round and returns True while any tenant
    is live: drive it by hand to interleave control (admitting or
    extracting tenants mid-run), or call ``run()`` to completion.
    """

    def __init__(
        self,
        tenants: list[Tenant],
        drain: bool = True,
        quantum: int = DEFAULT_QUANTUM,
        sched: str = "rr",
        snapshot_dir: Optional[str] = None,
        snapshot_every: int = 0,
        snapshot_full_every: int = 1,
        resume: bool = False,
        snapshots: Optional[dict] = None,
        pending: str = "auto",
        fuse: bool = True,
    ):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if sched not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {sched!r}; choose {SCHEDULERS}")
        if resume and snapshot_dir is None:
            raise ValueError(
                "resume=True needs snapshot_dir: without it every tenant "
                "would silently start afresh"
            )
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")
        self.drain = drain
        self.quantum = quantum
        self.sched = sched
        self.fuse = fuse
        self._cohorts: dict = {}  # fuse key -> live _CohortUnit
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = snapshot_every
        # Cadence saves ship only changed leaves, with a full snapshot every
        # k-th save (runtime/checkpoint.py); 1 = every save full.
        self.snapshot_full_every = snapshot_full_every
        self._resume = resume
        self._pending = pending
        self.agg = MultiplexStats(n_tenants=len(tenants))
        self._slots: list[_Slot] = []
        # Scheduling units: solo _Slots and fused _CohortUnits (fuse=True).
        self._live: list = []
        self._t0: Optional[float] = None
        for t in tenants:
            self.admit(t, snapshot=(snapshots or {}).get(t.name))
        self.agg.n_tenants = len(self._slots)

    # -- tenant management -------------------------------------------------

    def _manager_for(self, name: str) -> Optional[CheckpointManager]:
        if self.snapshot_dir is None:
            return None
        return CheckpointManager(
            os.path.join(self.snapshot_dir, name), full_every=self.snapshot_full_every
        )

    def admit(self, tenant: Tenant, snapshot: Optional[dict] = None,
              positioned: bool = False) -> None:
        """Add a tenant, before the run or while it runs (a fused multiplexer
        packs it into a matching cohort at the next round): fresh, resumed
        from its snapshot directory, or restored from an explicit
        ``snapshot`` tree (live migration).  ``positioned=True`` asserts
        that a non-seekable ``tenant.ticks`` is already at the snapshot's
        cursor (the iterator ``extract`` returned, not a fresh source)."""
        if any(s.tenant.name == tenant.name for s in self._slots):
            raise ValueError(f"tenant name {tenant.name!r} already admitted")
        tel = _telemetry.TELEMETRY
        tok = tel.tracer.begin("migrate.admit") if tel is not None else None
        slot = _Slot(
            tenant,
            manager=self._manager_for(tenant.name),
            snapshot_every=self.snapshot_every,
            resume=self._resume,
            snapshot_tree=snapshot,
            pending=self._pending,
            positioned=positioned,
        )
        self._slots.append(slot)
        self._live.append(slot)
        self.agg.n_tenants = len(self._slots)
        if tok is not None:
            tel.tracer.end(tok, tenant=tenant.name, restored=snapshot is not None)
            tel.registry.count("odl_mux_admits")

    def _slot(self, name: str) -> _Slot:
        for s in self._slots:
            if s.tenant.name == name:
                return s
        raise KeyError(f"no tenant named {name!r}")

    def session(self, name: str) -> stream.StreamSession:
        return self._slot(name).session

    def finished(self, name: str) -> bool:
        return self._slot(name).result is not None

    def live_tenants(self) -> list[str]:
        """Names of tenants still being scheduled (admission order)."""
        return [s.tenant.name for s in self._slots if s.result is None]

    def finished_results(self) -> dict[str, TenantResult]:
        """Per-tenant results of every finished tenant; unlike ``results()``,
        callable while others are still live."""
        return {s.tenant.name: s.result for s in self._slots if s.result is not None}

    def load_report(self) -> list[dict]:
        """Per-live-tenant load signals for a router: tick cursor, tick-rate
        EMA, ring occupancy (current, high water, capacity), the shape key
        placement packs by, and whether the tenant rides a fused cohort.
        Accurate while fused: all of it is per-tenant host state, which
        cohort ticking keeps current."""
        out = []
        for slot in self._slots:
            if slot.result is not None:
                continue
            sess = slot.session
            stats = sess.stats
            out.append({
                "name": slot.tenant.name,
                "t": sess.t,
                "s": slot.s,
                "shape_key": shape_key(sess.cfg, sess.mode, sess._donate, slot.s),
                "tick_rate_ema": stats.tick_rate_ema,
                "ring": len(sess.ring),
                "ring_hwm": stats.ring_occupancy_hwm,
                "ring_capacity": sess.ring.capacity,
                "queries_issued": stats.queries_issued,
                "labels_applied": stats.labels_applied,
                "draining": slot.draining,
                "fused": slot.unit is not None,
            })
        return out

    def sync_telemetry(self) -> None:
        """Mirror every tenant's ``StreamStats`` (live sessions and finished
        results alike) into the enabled registry, and the tenant count.
        Called by live scrapes and end-of-run reports; no-op when telemetry
        is off, never on the per-tick path."""
        tel = _telemetry.TELEMETRY
        if tel is None:
            return
        for slot in self._slots:
            if slot.result is not None:
                _telemetry.sync_stream_stats(tel.registry, slot.result.stats, pending=0,
                                             tenant=slot.tenant.name)
            else:
                slot.session.sync_telemetry()
        tel.registry.gauge("odl_mux_tenants", len(self._slots))

    def extract(self, name: str, quiesce_ticks: int = 4096):
        """Live-migrate a tenant out: snapshot its session and remove it from
        this scheduler.

        A fused member is released from its cohort first (its stacked rows
        and pending plan are written back into its session).  When the
        teacher cannot snapshot its own state, the session then quiesces
        (bounded drain of in-flight replies, salvaging answers that would
        die with the connection; unanswered tickets travel in the snapshot
        and are re-asked on restore).  A snapshot-capable teacher skips the
        quiesce: its undelivered inbox rides the snapshot, so the restored
        run replays every reply at its original due tick.  Draining early
        would apply labels before the plans they interleave with in the
        uninterrupted run, which can flip query decisions.

        Returns ``(snapshot_tree, ticks)``: the serialized session and the
        tenant's partially consumed tick iterator (positioned at the next
        unread tick).  Hand both to another multiplexer's ``admit`` (with
        ``positioned=True`` for a non-seekable source), or persist the tree
        through a ``CheckpointManager`` and reopen a seekable source at
        ``snapshot.ticks_consumed(tree)``.
        """
        tel = _telemetry.TELEMETRY
        tok = tel.tracer.begin("migrate.extract") if tel is not None else None
        slot = self._slot(name)
        if slot.result is not None:
            raise ValueError(f"tenant {name!r} already finished; nothing to migrate")
        if slot.unit is not None:
            unit = slot.unit
            freed = unit.release(slot)
            if not unit.slots and unit in self._live:
                idx = self._live.index(unit)
                self._live[idx : idx + 1] = freed
            else:
                self._live.extend(freed)
            self._cohorts = {k: u for k, u in self._cohorts.items() if u.slots}
        snapshot_capable = getattr(slot.session.teacher, "snapshot_state", None) is not None
        if quiesce_ticks > 0 and not snapshot_capable:
            slot.session.quiesce(max_ticks=quiesce_ticks, idle_sleep_s=slot.DRAIN_IDLE_SLEEP_S)
        tree = slot.session.snapshot()
        if slot.manager is not None:
            slot.manager.wait()
            slot.manager.save(slot.session.t, tree)
        self._slots.remove(slot)
        if slot in self._live:
            self._live.remove(slot)
        self.agg.n_tenants = len(self._slots)
        if tok is not None:
            tel.tracer.end(tok, tenant=name, t=slot.session.t)
            tel.registry.count("odl_mux_extracts")
        return tree, slot.it

    # -- scheduling --------------------------------------------------------

    def round(self) -> bool:
        """One scheduler round over all live tenants.  Returns True while any
        tenant still wants scheduling."""
        try:
            return self._round()
        except BaseException:
            # Settle in-flight background snapshot writes before the crash
            # propagates: a supervised restart in this process must never
            # race an orphaned writer thread for the same step directory.
            for s in self._slots:
                if s.manager is not None:
                    with contextlib.suppress(Exception):
                        s.manager.wait()
            raise

    def _form_cohorts(self) -> None:
        """Pack fusable live slots into cohorts by ``(cfg, mode, donate, S)``.

        Runs at every round start, so tenants admitted mid-run join a
        matching cohort at the next scheduling boundary.  Singleton groups
        stay on the solo slot path: a cohort only pays off with two members
        or more.  The stream width S is part of the key: members tick in
        lockstep, and fusing different widths would break the DRR
        scheduler's per-tenant fairness."""
        groups: dict = {}
        for u in self._live:
            if not isinstance(u, _Slot) or u.unit is not None or u.draining:
                continue
            sess = u.session
            if sess.started() and sess._p is None:
                continue  # restored after its stream ended: drain only
            key = (sess.cfg, sess.mode, sess._donate, u.s)
            groups.setdefault(key, []).append(u)
        for key, slots in groups.items():
            unit = self._cohorts.get(key)
            if unit is not None and unit.slots:
                for s in slots:
                    unit.attach(s)
                    self._live.remove(s)
            elif len(slots) >= 2:
                unit = _CohortUnit(slots)
                for s in slots:
                    s.unit = unit
                idx = min(self._live.index(s) for s in slots)
                for s in slots:
                    self._live.remove(s)
                self._live.insert(idx, unit)
                self._cohorts[key] = unit
                tel = _telemetry.TELEMETRY
                if tel is not None:
                    tel.tracer.event("cohort.pack", members=len(slots), s=unit.s,
                                     tenants=",".join(s.tenant.name for s in slots))
                    tel.registry.count("odl_mux_cohorts_packed")

    def _step_unit(self, u, n_ticks: int) -> list:
        """Step one scheduler unit; returns the units live after it (the unit
        itself, plus any slots a cohort released this round: an exhausted
        member immediately gets its first solo drain slice, like the solo
        path's same-call drain)."""
        out = []
        if isinstance(u, _CohortUnit):
            live, released = u.step(self.drain, n_ticks)
            if live:
                out.append(u)
            else:
                self._cohorts = {k: un for k, un in self._cohorts.items() if un is not u}
                tel = _telemetry.TELEMETRY
                if tel is not None:
                    tel.tracer.event("cohort.dissolve", released=len(released))
                    tel.registry.count("odl_mux_cohorts_dissolved")
            for r in released:
                r.deficit = 0.0
                if r.draining and not self.drain:
                    r._finish()  # drain=False: settle, exactly like solo
                elif not r.draining or r.step(self.drain, 0):
                    out.append(r)
        elif u.step(self.drain, n_ticks):
            out.append(u)
        return out

    def _round(self) -> bool:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if not self._live:
            return False
        self.agg.rounds += 1
        if self.fuse:
            self._form_cohorts()
        units = list(self._live)  # the round's units, for the debit meter below
        nxt = []
        if self.sched == "drr":
            # Credit is sized by the smallest ticking tenant: a tenant that is
            # only draining costs no device time and must not gate everyone
            # else's budget.  A cohort unit's cost is its (shared) member
            # width, so each fused member sees the same credit and debit
            # schedule as its solo slot.
            ticking = [u.s for u in self._live if not u.draining]
            credit = self.quantum * min(ticking) if ticking else 0
            for u in self._live:
                u.deficit += credit
                stepped = self._step_unit(u, int(u.deficit // u.s))
                u.deficit -= u.last_ticks * u.s
                if u.draining:
                    u.deficit = 0.0  # drained slices don't consume credit
                nxt.extend(stepped)
        else:
            for u in self._live:
                nxt.extend(self._step_unit(u, self.quantum))
        self._live = nxt
        tel = _telemetry.TELEMETRY
        if tel is not None:
            # Scheduler meters: rounds, and the stream-step debits this round
            # charged (ticks × each unit's S: the DRR deficit currency; under
            # rr the same product measures the round's device work).
            tel.registry.count("odl_mux_rounds")
            tel.registry.count("odl_mux_quantum_debits", sum(u.last_ticks * u.s for u in units))
            tel.registry.gauge("odl_mux_live_units", len(self._live))
        return bool(self._live)

    def run(self) -> tuple[dict[str, TenantResult], MultiplexStats]:
        while self.round():
            pass
        return self.results()

    def results(self) -> tuple[dict[str, TenantResult], MultiplexStats]:
        """Finalize and collect per-tenant results and aggregate stats."""
        if self._live:
            raise RuntimeError("results() with tenants still live; drive round()")
        if self._t0 is not None:
            self.agg.wall_s = time.perf_counter() - self._t0
        self.agg.stream_steps = sum(s.result.stats.stream_steps for s in self._slots)
        self.agg.ticks = sum(s.result.stats.ticks for s in self._slots)
        # Snapshots *taken* this run (keep-k GC prunes the directories, so
        # counting surviving step dirs would undercount).
        self.agg.snapshots = sum(s.snapshots_taken for s in self._slots)
        return {s.tenant.name: s.result for s in self._slots}, self.agg


def run(
    tenants: list[Tenant],
    drain: bool = True,
    quantum: int = DEFAULT_QUANTUM,
    sched: str = "rr",
    snapshot_dir: Optional[str] = None,
    snapshot_every: int = 0,
    resume: bool = False,
    fuse: bool = True,
) -> tuple[dict[str, TenantResult], MultiplexStats]:
    """Multiplex every tenant's stream over this process to completion.

    ``quantum`` is the scheduler's time slice: how many consecutive ticks one
    tenant runs before the scheduler moves on.  ``sched="drr"`` measures the
    slice in stream steps instead of ticks, so small tenants are not starved
    by large ones.  ``fuse`` (default True) packs tenants with the same
    ``(cfg, mode, donate)`` and stream width into cohorts advanced by one
    stacked dispatch per tick (``engine/cohort.py``).  The per-tenant result
    is bit for bit the same for every quantum, scheduler and ``fuse``: only
    the dispatch count and the wall-clock interleaving change.

    ``snapshot_dir`` + ``snapshot_every`` enable per-tenant durability;
    ``resume=True`` restores tenants from their latest published snapshot
    (tick sources must then be seekable: ``snapshot.ResumableTicks``).

    Returns ``(results, agg)``: ``results[name]`` is that tenant's ``(state,
    outputs, stats)``, identical to what a solo ``stream.run`` over the same
    inputs returns, and ``agg`` the aggregate ``MultiplexStats``.
    """
    if not tenants:
        raise ValueError("multiplex.run needs at least one tenant")
    return Multiplexer(
        tenants,
        drain=drain,
        quantum=quantum,
        sched=sched,
        snapshot_dir=snapshot_dir,
        snapshot_every=snapshot_every,
        resume=resume,
        fuse=fuse,
    ).run()


def run_supervised(
    make_tenants,
    snapshot_dir: str,
    snapshot_every: int = 1000,
    max_restarts: int = 3,
    **kw,
):
    """Crash-restart supervision around a durable multiplexed run.

    ``make_tenants()`` must build a *fresh* tenant list (fresh teachers,
    seekable tick sources) on every attempt: the previous attempt's objects
    died with it.  Each attempt resumes every tenant from its latest
    published snapshot under ``snapshot_dir`` (or afresh when none
    exists yet); ``runtime.fault.run_with_restarts`` bounds the retries.
    It catches every exception, so a caller that must tell a crash it
    injected from a real failure counts the attempts (``make_tenants``
    calls) against the crashes it injected.
    """

    class _DirView:
        """The per-tenant snapshot directories viewed as one checkpointed
        unit for the supervisor (restore is a no-op: each tenant restores
        itself from its own subdirectory)."""

        def latest_step(self):
            names = os.listdir(snapshot_dir) if os.path.isdir(snapshot_dir) else []
            steps = [
                s
                for name in names
                if os.path.isdir(os.path.join(snapshot_dir, name))
                for s in [CheckpointManager(os.path.join(snapshot_dir, name)).latest_step()]
                if s is not None
            ]
            return max(steps) if steps else None

        def restore(self):
            return self.latest_step(), None

    def run_attempt(state, start_step):
        del state, start_step  # per-tenant restore happens inside run()
        return run(
            make_tenants(),
            snapshot_dir=snapshot_dir,
            snapshot_every=snapshot_every,
            resume=True,
            **kw,
        )

    return fault.run_with_restarts(lambda: None, run_attempt, _DirView(),
                                   max_restarts=max_restarts)


# Runner sharing is observable here: tenant configs that hash equal hit the
# same cache entries.
cache_stats = stream.cache_stats
