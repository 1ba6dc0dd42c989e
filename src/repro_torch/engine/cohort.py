"""Cohort fusion: advance N same-shaped tenants in one stacked dispatch per
tick (PyTorch counterpart of ``repro/engine/cohort.py``).

Tenants with the same ``(cfg, mode, donate)`` and stream width stack their
``EngineState`` rows along the leading stream axis (the tenant axis folded
onto S), and one ``plan`` / ``learn`` / fused ``learn+plan`` per tick
advances all of them.  Every op of a tick computes a row in an order that
does not depend on S (``engine/fleet.py``), so row r of a stacked dispatch
is bit for bit row r of the solo dispatch.

What fuses, and what stays per tenant:

* **Fused**: the device work (plan, learn, the steady-state learn+plan), the
  ``queried`` host sync, and the per-tick pulls of the collected columns.
* **Per tenant**: everything a tenant observes: its ``PendingRing``,
  ``Teacher``, backpressure policy, ``StreamStats``, collected outputs and
  tick cursor.  Each member's rows of the stacked plan drive its own
  ``_submit`` / ``_claim_entry`` exactly as solo, so every output, counter
  and the query-accounting identity are bit for bit the solo run's.

Replies come back through three learn paths, chosen per reply:

* **aligned**: the reply's ring entry is a ``stream.PlanSlice`` of a
  full-width plan at the member's current bounds.  All aligned replies of a
  round that share one full plan combine into ONE full-width learn: each
  member's mask and labels scatter into its row window, and every other row
  rides along under ``mask=False``, an exact identity;
* **fused**: when the last round is a single aligned group and no member
  joins or leaves, its learn fuses with the next tick's stacked plan;
* **patch**: stragglers, tickets asked before their tenant joined the
  cohort or before a resize.  Their solo-width plan context learns through
  ``fleet._patch_learn_runner``, which updates that member's row window of
  the stacked state in place.  The path is rare and runs eagerly, without a
  graph.

On the card the cohort owns its stacked state as two buffer sets written in
turn (``stream._StateBuffers``, as a session does) and replays the shared
runners (the same ``lru_cache`` tick functions the sessions use) as CUDA
graphs over them, tallied under ``cohort.``-prefixed runner names in
``engine/graphs.py``.  ``attach`` and ``detach`` reallocate the stacked
buffers, so they drop the cohort's graphs and the next tick captures new
ones.  A member keeps its own session buffers and graphs while fused; its
``session.state`` is stale then, and ``detach`` / ``refresh`` copy its rows
back into the session's current buffers, so the session's graphs stay
valid.  Each ``tick`` is one ``cohort.tick`` telemetry span (``members=``,
``s=``, ``detached=``), begun and ended on the host around the stacked
replays, never inside a capture.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.engine import fleet, stream
from repro_torch.runtime import telemetry as _telemetry

_COL_KEYS = ("pred", "outputs", "queried", "theta", "confidence", "mode_training")


class CohortSession:
    """Lockstep driver for N member ``StreamSession``s on one stacked state.

    Members keep their own sessions (ring, teacher, stats, tick cursor);
    while fused, a member's ``session.state`` is stale: the cohort's stacked
    ``state`` is authoritative, and ``detach`` / ``refresh`` write the
    member's rows back.
    """

    def __init__(self, members: list[stream.StreamSession]):
        if not members:
            raise ValueError("cohort needs at least one member")
        head = members[0]
        self.cfg = head.cfg
        self.mode = head.mode
        self.donate = head._donate
        self.ship = head.ship
        self.device = head.device
        self.members: list[stream.StreamSession] = []
        self.bounds: list[tuple[int, int]] = []
        self._buf: Optional[stream._StateBuffers] = None
        # The members' own runners (same LRU keys): fusing adds no cache entry.
        self._plan_fn = ("plan_runner", stream._plan_runner(self.cfg, self.mode, self.donate), ())
        self._learn_fn = ("learn_runner", stream._learn_runner(self.cfg, self.donate), ())
        self._fused_fn = ("learn_plan_runner",
                          stream._learn_plan_runner(self.cfg, self.mode, self.donate), ())
        self._full_mask_dev = None  # cached all-True apply mask on the device
        # Stack every founding member in ONE concat per leaf (attach-at-a-time
        # would pay N-1 intermediate full copies).
        for m in members:
            self._admit_bookkeeping(m)
        self._restack(fleet.stack_streams([m.state for m in members]))

    @property
    def total(self) -> int:
        return self.bounds[-1][1] if self.bounds else 0

    @property
    def state(self):
        """The stacked state (views of the cohort's current buffers), or None
        once every member has left."""
        return self._buf.state if self._buf is not None else None

    def _restack(self, own) -> None:
        """Own ``own`` as the new stacked state: new buffers, no graphs yet."""
        self._buf = None  # release the old buffers and graphs first
        self._buf = stream._StateBuffers(own, prefix="cohort.")

    # -- membership --------------------------------------------------------

    def attach(self, sess: stream.StreamSession) -> None:
        """Absorb a session: fresh, or running solo.

        Its current state rows are appended to the stacked state; a pending
        solo-width plan (mid-stream join) keeps working through the
        straggler patch-learn path until the next fused plan re-aligns it.
        The caller must supply this member's next tick on the very next
        ``tick()``: its rows take part in every fused dispatch from then on,
        exactly like its solo session would have.
        """
        self._admit_bookkeeping(sess)
        parts = [sess.state] if self._buf is None else [self.state, sess.state]
        self._restack(fleet.stack_streams(parts))

    def _admit_bookkeeping(self, sess: stream.StreamSession) -> None:
        """Validate a joining session and claim its row window: everything
        ``attach`` does except touching the stacked state, so ``__init__``
        can stack all founders in one concat."""
        if (sess.cfg, sess.mode, sess._donate) != (self.cfg, self.mode, self.donate):
            raise ValueError(
                "cohort members must share (cfg, mode, donate); "
                f"got {(sess.cfg, sess.mode, sess._donate)!r}"
            )
        if sess.live is not None:
            raise ValueError("a cohort plans every row: members cannot carry dead rows")
        if sess.device != self.device:
            raise ValueError(f"cohort members must share a device; got {sess.device}")
        if sess.started() and sess._p is None:
            raise ValueError("cannot attach a session with nothing left to plan")
        s = int(sess.state.elm.count.shape[0])
        lo = self.total
        self.members.append(sess)
        self.bounds.append((lo, lo + s))

    def detach(self, sess: stream.StreamSession) -> stream.StreamSession:
        """Hand a member back to solo operation: write its current rows (and a
        materialized solo plan, if one is pending) back into the session and
        drop them from the stacked state.  Ring entries that still hold
        ``PlanSlice`` views keep working: solo learns slice them lazily."""
        i = self.members.index(sess)
        lo, hi = self.bounds[i]
        sess.state = fleet.slice_streams(self.state, lo, hi)
        if isinstance(sess._p, stream.PlanSlice):
            sess._p = sess._p.materialize()
        self.members.pop(i)
        w = hi - lo
        self.bounds = self.bounds[:i] + [(a - w, b - w) for a, b in self.bounds[i + 1:]]
        if self.members:
            self._restack(fleet.remove_streams(self.state, lo, hi))
        else:
            self._buf = None
        return sess

    def refresh(self, sess: stream.StreamSession) -> None:
        """Write a member's current rows back into its (stale) session state
        without detaching."""
        lo, hi = self.bounds[self.members.index(sess)]
        sess.state = fleet.slice_streams(self.state, lo, hi)

    # -- the fused tick ----------------------------------------------------

    def tick(self, nxts: list) -> tuple[list, bool]:
        """Advance every member one tick with stacked device dispatches.

        ``nxts[i]`` is member i's next tick features: its first tick when the
        member has not started, None when its source is exhausted (the member
        finishes this tick's asks, polls and learns like a solo
        ``advance(None)``, then detaches).  Returns ``(detached, advanced)``:
        the sessions handed back to solo operation, and whether any member
        actually advanced a tick (False for the all-start first tick).
        """
        t0 = time.perf_counter()
        tel = _telemetry.TELEMETRY
        tok = tel.tracer.begin("cohort.tick") if tel is not None else None
        members = list(self.members)
        if len(nxts) != len(members):
            raise ValueError(f"{len(nxts)} next ticks for {len(members)} members")
        full = self._aligned_full()
        # One host sync for the whole cohort (the algorithm's wait for tick t),
        # and one pull per collected column instead of one per member.
        queried_full = full.queried.cpu().numpy() if full is not None else None
        cols_full = None
        if queried_full is not None and any(m.collect and m.started() for m in members):
            cols_full = {k: (queried_full if k == "queried" else getattr(full, k).cpu().numpy())
                         for k in _COL_KEYS}

        # Per-member tick bookkeeping: collect, submit asks, claim replies.
        # Cross-member order is irrelevant (rows are independent); each
        # member's own op order matches its solo ``advance`` exactly.
        applies: list[list] = []
        ticking: list[int] = []
        for i, m in enumerate(members):
            if not m.started():
                applies.append([])
                continue
            ticking.append(i)
            lo, hi = self.bounds[i]
            p = m._p
            queried_host = (queried_full[lo:hi] if queried_full is not None
                            else p.queried.cpu().numpy())
            if m.collect:
                for k in _COL_KEYS:
                    m._cols[k].append(
                        cols_full[k][lo:hi] if cols_full is not None
                        else getattr(p, k).cpu().numpy())
                m._trained_rows.append(np.zeros(queried_host.shape, bool))
            n_q = int(queried_host.sum())
            if n_q:
                m.stats.queries_issued += n_q
                m._submit(m._x, queried_host, p, m.t)
            member_applies = []
            for r in m.teacher.poll(m.t):
                claimed = m._claim_entry(r, m.t)
                if claimed is not None:
                    member_applies.append((claimed[0], claimed[1], r))
            m._flush_deferred(m.t)
            applies.append(member_applies)

        planning = [i for i in range(len(members)) if nxts[i] is not None]
        resizing = len(planning) != len(members)
        p_next = None

        def x_next_stacked():
            xs = [nxts[i] for i in planning]
            if len(xs) == 1:
                return self.ship(xs[0])
            if any(torch.is_tensor(x) for x in xs):
                return torch.cat([self.ship(x) for x in xs], dim=0)
            # Host ticks: one concatenate and ONE transfer for the cohort.
            return self.ship(np.concatenate(xs, axis=0))

        # Learns in rounds: round j applies each member's j-th claimed reply,
        # preserving every member's own apply order while letting replies
        # that share a full plan combine into one dispatch.
        n_rounds = max((len(a) for a in applies), default=0)
        for j in range(n_rounds):
            groups: dict[int, list] = {}
            order: list[tuple[int, fleet.PlanOutput]] = []
            stragglers: list[tuple[int, object, np.ndarray, object]] = []
            for i, member_applies in enumerate(applies):
                if j >= len(member_applies):
                    continue
                ent, mask, reply = member_applies[j]
                p = ent.plan
                if (isinstance(p, stream.PlanSlice)
                        and p.full.queried.shape[0] == self.total
                        and (p.lo, p.hi) == self.bounds[i]):
                    key = id(p.full)
                    if key not in groups:
                        groups[key] = []
                        order.append((key, p.full))
                    groups[key].append((i, ent, mask, reply))
                else:
                    stragglers.append((i, ent, mask, reply))
            fuse = j == n_rounds - 1 and not resizing and len(order) == 1 and not stragglers
            for key, fullp in order:
                args = self._group_args(fullp, groups[key])
                if fuse:
                    p_next = self._buf.tick(self._fused_fn, True, (*args, x_next_stacked()))
                else:
                    self._buf.tick(self._learn_fn, True, args)
            for i, ent, mask, reply in stragglers:
                self._patch_learn(i, ent, mask, reply)

        # Tick accounting for members that advanced (solo ``advance`` parity;
        # the shared wall time lands in every advanced member's tick_ms).
        for i in ticking:
            m = members[i]
            m.stats.ticks += 1
            m.stats.stream_steps += int(m._x.shape[0])
            m.t += 1

        # Detach exhausted members before the next plan re-slices bounds.
        detached = []
        leaving = [i for i in range(len(members)) if nxts[i] is None]
        if leaving and len(leaving) == len(self.members):
            # Equal-length streams all run dry on the same tick, the common
            # shutdown: write each member's rows back and drop the stacked
            # state wholesale instead of restacking once per member.
            for i in leaving:
                m = members[i]
                m._x, m._p = None, None
                m.state = fleet.slice_streams(self.state, *self.bounds[i])
                detached.append(m)
            self.members, self.bounds, self._buf = [], [], None
        else:
            for i in leaving:
                m = members[i]
                m._x, m._p = None, None
                detached.append(self.detach(m))

        # Plan the next tick for everyone remaining (starts fresh members).
        if planning and p_next is None:
            p_next = self._buf.tick(self._plan_fn, False, (x_next_stacked(),))
        if p_next is not None:
            for idx, i in enumerate(planning):
                m = members[i]
                lo, hi = self.bounds[idx]
                if not m.started():
                    m._t_start = t0
                m._x = nxts[i]
                m._p = stream.PlanSlice(p_next, lo, hi)
        wall_ms = (time.perf_counter() - t0) * 1e3
        rate = 1e3 / wall_ms if wall_ms > 0 else 0.0
        for i in ticking:
            st = members[i].stats
            st.tick_ms.append(wall_ms)
            if rate > 0:  # the load signal solo ``advance`` keeps
                st.tick_rate_ema = (
                    rate if st.tick_rate_ema == 0.0
                    else st.tick_rate_ema + stream.TICK_RATE_EMA_ALPHA * (rate - st.tick_rate_ema))
        if tok is not None:
            tel.tracer.end(tok, members=len(members), s=self.total, detached=len(detached))
        return detached, bool(ticking)

    # -- internals ---------------------------------------------------------

    def _aligned_full(self) -> Optional[fleet.PlanOutput]:
        """The one full-width plan every started member's pending plan slices
        at current bounds, or None (first tick, or a member joined mid-stream
        with a solo plan or a pre-resize slice)."""
        full = None
        for i, m in enumerate(self.members):
            if not m.started():
                continue
            p = m._p
            if (not isinstance(p, stream.PlanSlice)
                    or p.full.queried.shape[0] != self.total
                    or (p.lo, p.hi) != self.bounds[i]):
                return None
            if full is None:
                full = p.full
            elif p.full is not full:
                return None
        return full

    def _group_args(self, fullp: fleet.PlanOutput, group: list) -> tuple:
        """Scatter one round's aligned member masks and labels into full-width
        learn inputs against their shared full plan.  Members outside the
        group ride along under mask=False, an exact identity."""
        total = self.total
        mask_full = np.zeros((total,), bool)
        labels_full = np.zeros((total,), np.int32)
        for i, ent, mask, reply in group:
            lo, hi = self.bounds[i]
            mask_full[lo:hi] = mask
            labels_full[lo:hi] = np.asarray(reply.labels, np.int32)
        if mask_full.all():
            if self._full_mask_dev is None or self._full_mask_dev.shape[0] != total:
                self._full_mask_dev = torch.ones((total,), dtype=torch.bool, device=self.device)
            mask_dev = self._full_mask_dev
        else:
            mask_dev = self.ship(mask_full)
        return (fullp.h, self.ship(labels_full), fullp.pred, fullp.confidence, mask_dev,
                fullp.controller_on, fullp.theta)

    def _patch_learn(self, i: int, ent, mask: np.ndarray, reply) -> None:
        """Straggler reply: learn one member's solo-width plan context into its
        row window of the stacked state (eagerly; the path is rare)."""
        m = self.members[i]
        lo, hi = self.bounds[i]
        args = m._build_learn_args(ent, reply, mask)
        fn = fleet._patch_learn_runner(self.cfg, lo, hi, self.donate)
        fn(self._buf.state, self._buf.spare, *args)
