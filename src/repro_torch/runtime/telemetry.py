"""Process-local observability: metrics registry and span tracer (the
port's own copy of the JAX package's ``runtime/telemetry.py``).

The runtime's subsystems (stream sessions, cohorts, the multiplexer, the RPC
transport) each keep private counters: ``StreamStats``, ``MultiplexStats``,
the ``BatchedRpcClient`` wire meters, the ``LabelServer`` request counters.
This module gives them one shared, scrape-able surface:

* a metrics **registry**: named counters, gauges and histograms with label
  sets (``{tenant, endpoint, ...}``), exported as Prometheus text exposition
  or a JSON snapshot; and
* a bounded ring-buffer **span tracer**: monotonic-clock spans for the
  stream and cohort ticks, ring evictions, snapshot save/restore, RPC flushes
  and reconnects, cohort pack/dissolve and migration extract/admit, exported
  as Chrome ``trace_event`` JSON (``chrome://tracing`` / Perfetto) or a JSONL
  event log.

Design constraints (the streaming hot path is instrumented per tick):

* **Disabled is branch-cheap.**  Telemetry is off by default; the global
  ``TELEMETRY`` is ``None`` and every instrumentation site is one module
  attribute read plus an ``is not None`` branch.  Nothing is allocated, no
  lock is taken, no clock is read.
* **Enabled is sampled.**  ``SpanTracer`` records one in ``sample``
  begin/end spans per name (rare events always record); the ring is bounded
  (``deque(maxlen)``), so a long-running process never grows trace memory.
* **Counters are mirrored, not forked.**  ``StreamStats`` stays the single
  source of truth for query accounting; ``sync_stream_stats`` copies its
  fields into the registry at sync points (``finish()``, live scrapes) by
  absolute ``set_counter`` writes, so the two views are identical by
  construction.
* **Off the card.**  Every span begins and ends on the host, around the
  tick, the cohort tick and the snapshot calls, never inside a CUDA graph
  capture; mirroring reads host integers only and never syncs the card.
  Telemetry never changes the device op sequence: an instrumented run is bit
  for bit the uninstrumented one.

This module is the port's: its ``TELEMETRY`` global is a separate object
from the JAX package's, so enabling one does not enable the other.  The
Prometheus text of one sequence of registry calls is byte for byte the
reference's, and each package's ``parse_prometheus`` reads the other's.

Snapshot semantics: the registry and the trace ring are process-local and
excluded from session snapshots.  A migrated tenant's ``StreamStats``
(including ``tick_rate_ema`` / ``ring_occupancy_hwm``) rides the snapshot
and re-mirrors on the destination; spans recorded on the source stay there.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Optional

from repro_torch.runtime import lockdebug

__all__ = [
    "Registry", "SpanTracer", "Telemetry", "TELEMETRY",
    "enable", "disable", "get",
    "sync_stream_stats", "parse_prometheus", "check_stream_identity",
    "STREAM_COUNTER_FIELDS", "STREAM_GAUGE_FIELDS", "STREAM_MIRROR_EXCLUDED",
]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    esc = lambda v: v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    return "{" + ",".join(f'{k}="{esc(v)}"' for k, v in key) + "}"


class Registry:
    """Named counters / gauges / histograms with label sets.

    Counters support both relative ``count`` (hot-path increments: mux
    rounds, RPC flushes) and absolute ``set_counter`` (mirroring an
    authoritative source like ``StreamStats``).  Histograms keep
    count/sum/min/max — enough for occupancy and size distributions
    without per-observation storage.  All methods are thread-safe (one
    lock; the RPC client's flush thread and the worker's control thread
    write concurrently with the tick loop).
    """

    def __init__(self):
        self._lock = lockdebug.make_lock("telemetry.Registry._lock")
        # name -> {label_key: value}
        self._counters: "dict[str, dict[tuple, float]]" = {}
        self._gauges: "dict[str, dict[tuple, float]]" = {}
        # name -> {label_key: [count, total, min, max]}
        self._hists: "dict[str, dict[tuple, list]]" = {}

    # -- writes ------------------------------------------------------------

    def count(self, name: str, value: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            series = self._counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + value

    def set_counter(self, name: str, value: float, **labels) -> None:
        """Absolute write — for mirroring a counter whose source of truth
        lives elsewhere (``StreamStats`` fields)."""
        with self._lock:
            self._counters.setdefault(name, {})[_label_key(labels)] = float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges.setdefault(name, {})[_label_key(labels)] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        key = _label_key(labels)
        v = float(value)
        with self._lock:
            h = self._hists.setdefault(name, {}).get(key)
            if h is None:
                self._hists[name][key] = [1, v, v, v]
            else:
                h[0] += 1
                h[1] += v
                h[2] = min(h[2], v)
                h[3] = max(h[3], v)

    # -- reads -------------------------------------------------------------

    def get_counter(self, name: str, **labels) -> float:
        with self._lock:
            return self._counters.get(name, {}).get(_label_key(labels), 0.0)

    def get_gauge(self, name: str, **labels) -> float:
        with self._lock:
            return self._gauges.get(name, {}).get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        """JSON-able dump: ``{"counters": {name: [{"labels": {...},
        "value": v}, ...]}, "gauges": ..., "histograms": ...}``."""
        def rows(series):
            return [
                {"labels": dict(key), "value": value}
                for key, value in sorted(series.items())
            ]

        with self._lock:
            return {
                "counters": {n: rows(s) for n, s in sorted(self._counters.items())},
                "gauges": {n: rows(s) for n, s in sorted(self._gauges.items())},
                "histograms": {
                    n: [
                        {
                            "labels": dict(key),
                            "count": h[0], "sum": h[1], "min": h[2], "max": h[3],
                        }
                        for key, h in sorted(s.items())
                    ]
                    for n, s in sorted(self._hists.items())
                },
            }

    def prometheus_text(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines = []
        with self._lock:
            for name, series in sorted(self._counters.items()):
                lines.append(f"# TYPE {name} counter")
                for key, value in sorted(series.items()):
                    lines.append(f"{name}{_fmt_labels(key)} {_num(value)}")
            for name, series in sorted(self._gauges.items()):
                lines.append(f"# TYPE {name} gauge")
                for key, value in sorted(series.items()):
                    lines.append(f"{name}{_fmt_labels(key)} {_num(value)}")
            for name, series in sorted(self._hists.items()):
                lines.append(f"# TYPE {name} summary")
                for key, h in sorted(series.items()):
                    lines.append(f"{name}_count{_fmt_labels(key)} {h[0]}")
                    lines.append(f"{name}_sum{_fmt_labels(key)} {_num(h[1])}")
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


def _num(v: float) -> str:
    # Integral values print without a trailing .0 — counters are ints in
    # spirit and the cross-check tests compare exact values.
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class SpanTracer:
    """Bounded ring buffer of monotonic-clock spans.

    ``begin(name)`` returns an opaque token (or None when the span is
    sampled out — every instrumentation site must handle None);
    ``end(token, **labels)`` records it.  ``event`` records an instant
    (zero-duration, never sampled — evictions, reconnects, drops are rare
    and individually meaningful).  The ring is ``deque(maxlen=capacity)``:
    old spans fall off, memory is bounded, nothing is ever flushed on the
    hot path.
    """

    def __init__(self, capacity: int = 8192, sample: int = 1):
        self.capacity = int(capacity)
        self.sample = max(1, int(sample))
        self._ring: "collections.deque" = collections.deque(maxlen=self.capacity)
        self._lock = lockdebug.make_lock("telemetry.SpanTracer._lock")
        self._seq: "dict[str, int]" = {}
        self.dropped = 0  # sampled-out spans (visibility into what's missing)

    def begin(self, name: str):
        if self.sample > 1:
            with self._lock:
                n = self._seq.get(name, 0)
                self._seq[name] = n + 1
                if n % self.sample:
                    # Bumped by every session thread — a plain += outside
                    # the lock loses updates under contention.
                    self.dropped += 1  # odlint: guarded-by(_lock)
                    return None
        return (name, time.monotonic_ns())

    def end(self, token, **labels) -> None:
        if token is None:
            return
        name, t0 = token
        now = time.monotonic_ns()
        self._ring.append(
            (name, t0, now - t0, threading.get_ident(), labels or None)
        )

    @contextlib.contextmanager
    def span(self, name: str, **labels):
        tok = self.begin(name)
        try:
            yield
        finally:
            self.end(tok, **labels)

    def event(self, name: str, **labels) -> None:
        self._ring.append(
            (name, time.monotonic_ns(), 0, threading.get_ident(), labels or None)
        )

    # -- exporters ---------------------------------------------------------

    def spans(self) -> list:
        """Snapshot of the ring, oldest first:
        ``(name, t0_ns, dur_ns, tid, labels|None)`` tuples."""
        return list(self._ring)

    def chrome_trace(self) -> dict:
        """Chrome ``trace_event`` JSON (open in chrome://tracing or
        https://ui.perfetto.dev): complete ('X') events for spans, instant
        ('i') events for zero-duration ones."""
        pid = os.getpid()
        events = []
        for name, t0, dur, tid, labels in self.spans():
            ev = {
                "name": name,
                "cat": name.split(".", 1)[0],
                "ts": t0 / 1e3,  # trace_event wants microseconds
                "pid": pid,
                "tid": tid,
                "args": labels or {},
            }
            if dur:
                ev["ph"] = "X"
                ev["dur"] = dur / 1e3
            else:
                ev["ph"] = "i"
                ev["s"] = "t"
            events.append(ev)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def to_jsonl(self) -> str:
        """One JSON object per line — greppable event log."""
        lines = []
        for name, t0, dur, tid, labels in self.spans():
            row = {"name": name, "ts_ns": t0, "dur_ns": dur, "tid": tid}
            if labels:
                row.update(labels)
            lines.append(json.dumps(row, default=str))
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self) -> None:
        self._ring.clear()
        with self._lock:
            self._seq.clear()
            self.dropped = 0


class Telemetry:
    """The enabled-state bundle: one registry + one tracer."""

    def __init__(self, span_capacity: int = 8192, span_sample: int = 1):
        self.registry = Registry()
        self.tracer = SpanTracer(capacity=span_capacity, sample=span_sample)


# The global switch.  ``None`` == disabled: instrumentation sites read
# this once per call and branch — no allocation, no lock, no clock.
TELEMETRY: Optional[Telemetry] = None


def enable(span_capacity: int = 8192, span_sample: int = 1) -> Telemetry:
    """Turn telemetry on process-wide (idempotent: an existing enabled
    instance is kept so counters survive repeated calls)."""
    global TELEMETRY
    if TELEMETRY is None:
        TELEMETRY = Telemetry(span_capacity=span_capacity, span_sample=span_sample)
    return TELEMETRY


def disable() -> None:
    global TELEMETRY
    TELEMETRY = None


def get() -> Optional[Telemetry]:
    return TELEMETRY


# ---------------------------------------------------------------------------
# StreamStats mirroring — one source of truth, two views.
# ---------------------------------------------------------------------------

# Every integer accounting counter of engine.stream.StreamStats, mirrored
# verbatim as ``odl_stream_<field>``.  The query-accounting identity
# (queries_issued == labels_applied + queries_dropped + queries_lost +
# queries_coalesced, plus queries_pending mid-run) is therefore checkable
# from a live scrape, not just an end-of-run dump.
STREAM_COUNTER_FIELDS = (
    "ticks", "stream_steps",
    "tickets_issued", "queries_issued", "labels_applied",
    "tickets_dropped", "queries_dropped", "replies_orphaned",
    "tickets_lost", "queries_lost",
    "tickets_coalesced", "queries_coalesced",
    "asks_deferred", "tickets_reasked",
)

# Load signals: not monotonic, exported as gauges.
STREAM_GAUGE_FIELDS = ("tick_rate_ema", "ring_occupancy_hwm")

# StreamStats fields deliberately NOT mirrored into the registry:
# wall-clock totals and raw per-tick sample deques belong to the
# end-of-run report (histograms of them would re-aggregate what the
# spans already carry).  Every StreamStats field must appear in exactly
# one of COUNTER/GAUGE/EXCLUDED (tests/test_torch_telemetry.py's growth
# guard checks the port's StreamStats against these lists).
STREAM_MIRROR_EXCLUDED = ("wall_s", "tick_ms", "label_latency_ticks")


def sync_stream_stats(registry: Registry, stats, pending: Optional[int] = None,
                      **labels) -> None:
    """Mirror a ``StreamStats`` into ``registry`` (absolute writes — the
    stats object stays the source of truth).  ``pending`` is the session's
    in-flight query count (``StreamSession.pending_queries()``): with it,
    the scraped identity ``issued == applied + dropped + lost + coalesced
    + pending`` holds at *any* instant, not just after a drain."""
    for f in STREAM_COUNTER_FIELDS:
        registry.set_counter(f"odl_stream_{f}", getattr(stats, f), **labels)
    for f in STREAM_GAUGE_FIELDS:
        registry.gauge(f"odl_stream_{f}", float(getattr(stats, f)), **labels)
    if pending is not None:
        registry.gauge("odl_stream_queries_pending", float(pending), **labels)


# ---------------------------------------------------------------------------
# Prometheus exposition parsing: a scrape must parse, and the accounting
# identity must hold on what it carries (chip_smoke.py phase 6h checks both
# mid-run and at the end).
# ---------------------------------------------------------------------------


def _unescape(v: str) -> str:
    # Sequential scan, not chained str.replace — ``\\n`` is an escaped
    # backslash followed by a literal 'n', NOT a newline.
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_prometheus(text: str) -> dict:
    """Parse text exposition back to ``{(name, label_key): value}``.

    Minimal but strict for what the registry emits: raises ValueError on
    a malformed sample line, so the CI check "the exposition parses"
    means something."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, _, value = line.rpartition(" ")
        if not body:
            raise ValueError(f"malformed sample line: {line!r}")
        if body.endswith("}"):
            name, _, rest = body.partition("{")
            if not rest.endswith("}"):
                raise ValueError(f"malformed labels: {line!r}")
            labels = {}
            rest = rest[:-1]
            if rest:
                for part in rest.split(","):
                    k, _, v = part.partition("=")
                    if not (v.startswith('"') and v.endswith('"')):
                        raise ValueError(f"malformed label value: {line!r}")
                    labels[k] = _unescape(v[1:-1])
            key = _label_key(labels)
        else:
            name, key = body, ()
        out[(name, key)] = float(value)
    return out


def check_stream_identity(parsed: dict) -> dict:
    """Per-label-set query-accounting identity over a *scraped* view.

    ``parsed`` is ``parse_prometheus`` output.  For every label set that
    carries ``odl_stream_queries_issued``, checks

        issued == applied + dropped + lost + coalesced + pending

    (``pending`` defaults to 0 when the gauge is absent — e.g. an
    end-of-run scrape after drain).  Returns ``{label_key: bool}``; an
    empty dict means the scrape carried no stream counters at all, which
    callers should treat as a failure, not a pass.
    """
    out = {}
    for (name, key), issued in parsed.items():
        if name != "odl_stream_queries_issued":
            continue
        applied = parsed.get(("odl_stream_labels_applied", key), 0.0)
        dropped = parsed.get(("odl_stream_queries_dropped", key), 0.0)
        lost = parsed.get(("odl_stream_queries_lost", key), 0.0)
        coalesced = parsed.get(("odl_stream_queries_coalesced", key), 0.0)
        pending = parsed.get(("odl_stream_queries_pending", key), 0.0)
        out[key] = issued == applied + dropped + lost + coalesced + pending
    return out
