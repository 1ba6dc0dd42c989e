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

Usage::

    results, agg = multiplex.run([
        multiplex.Tenant("edge-a", state_a, ticks_a, cfg_a, teacher_a),
        multiplex.Tenant("edge-b", state_b, ticks_b, cfg_b, teacher_b,
                         backpressure="coalesce"),
    ], sched="drr")

Not ported here, and absent from the signatures: durability
(``snapshot_dir``, ``snapshot_every``, ``snapshot_full_every``, ``resume``,
``snapshots``, ``admit(snapshot=..., positioned=...)``, cadence snapshots,
``extract`` with the cohort's ``release``, ``run_supervised``), the shared
RPC teacher connections (``shared_rpc_teachers``), and telemetry
(``sync_telemetry``, the ``cohort.pack`` / ``cohort.dissolve`` events and
the scheduler's meters).  ``Multiplexer.round`` holds the body of the JAX
package's ``_round``: the wrapper around it there only settles snapshot
writes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Iterable, NamedTuple, Optional

from repro_torch import convert
from repro_torch.engine import cohort as cohort_mod
from repro_torch.engine import stream
from repro_torch.engine.types import EngineConfig, EngineState, FleetStepOutput

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
    (``stream.BACKPRESSURE_POLICIES``).
    """

    name: str
    state: EngineState
    ticks: Iterable  # yields (S, n_in) feature arrays or tensors, one per tick
    cfg: EngineConfig
    teacher: stream.Teacher
    mode: str = "algo1"
    capacity: int = 64
    backpressure: str = "drop_oldest"
    collect: bool = True
    donate: Optional[bool] = None


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

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
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
        # Tick cost for the deficit scheduler = this tenant's stream count.
        self.s = int(self.session.state.elm.count.shape[0])
        self.deficit = 0.0
        self.last_ticks = 0  # real ticks advanced in the last step() call
        self.unit: Optional["_CohortUnit"] = None  # set while fused
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
                nxt = next(self.it, None)
                sess.advance(nxt)
                self.last_ticks += 1
                if nxt is None:
                    self.draining = True
                    break
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

    def _finish(self) -> None:
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
                released.append(slot)
        if len(self.slots) == 1:
            # A cohort of one is pure overhead: dissolve, continue solo.
            last = self.slots.pop()
            self.cohort.detach(last.session)
            last.unit = None
            released.append(last)
        return bool(self.slots), released


class Multiplexer:
    """The scheduler: drives N tenant sessions round robin (or DRR).

    ``round()`` runs one scheduler round and returns True while any tenant
    is live: drive it by hand to interleave control (admitting tenants
    mid-run), or call ``run()`` to completion.
    """

    def __init__(
        self,
        tenants: list[Tenant],
        drain: bool = True,
        quantum: int = DEFAULT_QUANTUM,
        sched: str = "rr",
        fuse: bool = True,
    ):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        if sched not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {sched!r}; choose {SCHEDULERS}")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"tenant names must be unique, got {names}")
        self.drain = drain
        self.quantum = quantum
        self.sched = sched
        self.fuse = fuse
        self._cohorts: dict = {}  # fuse key -> live _CohortUnit
        self.agg = MultiplexStats(n_tenants=len(tenants))
        self._slots: list[_Slot] = []
        # Scheduling units: solo _Slots and fused _CohortUnits (fuse=True).
        self._live: list = []
        self._t0: Optional[float] = None
        for t in tenants:
            self.admit(t)

    # -- tenant management -------------------------------------------------

    def admit(self, tenant: Tenant) -> None:
        """Add a tenant, before the run or while it runs: a fused multiplexer
        packs it into a matching cohort at the next round."""
        if any(s.tenant.name == tenant.name for s in self._slots):
            raise ValueError(f"tenant name {tenant.name!r} already admitted")
        slot = _Slot(tenant)
        self._slots.append(slot)
        self._live.append(slot)
        self.agg.n_tenants = len(self._slots)

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

    # -- scheduling --------------------------------------------------------

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
            for r in released:
                r.deficit = 0.0
                if r.draining and not self.drain:
                    r._finish()  # drain=False: settle, exactly like solo
                elif not r.draining or r.step(self.drain, 0):
                    out.append(r)
        elif u.step(self.drain, n_ticks):
            out.append(u)
        return out

    def round(self) -> bool:
        """One scheduler round over all live tenants.  Returns True while any
        tenant still wants scheduling."""
        if self._t0 is None:
            self._t0 = time.perf_counter()
        if not self._live:
            return False
        self.agg.rounds += 1
        if self.fuse:
            self._form_cohorts()
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
        return {s.tenant.name: s.result for s in self._slots}, self.agg


def run(
    tenants: list[Tenant],
    drain: bool = True,
    quantum: int = DEFAULT_QUANTUM,
    sched: str = "rr",
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

    Returns ``(results, agg)``: ``results[name]`` is that tenant's ``(state,
    outputs, stats)``, identical to what a solo ``stream.run`` over the same
    inputs returns, and ``agg`` the aggregate ``MultiplexStats``.
    """
    if not tenants:
        raise ValueError("multiplex.run needs at least one tenant")
    return Multiplexer(tenants, drain=drain, quantum=quantum, sched=sched, fuse=fuse).run()


# Runner sharing is observable here: tenant configs that hash equal hit the
# same cache entries.
cache_stats = stream.cache_stats
