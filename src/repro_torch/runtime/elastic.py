"""Elastic control plane: a fleet of multiplexer workers behind a
shape-aware router (PyTorch counterpart of ``repro/runtime/elastic.py``).

``runtime/worker.py`` is one worker: a ``Multiplexer`` behind a control
socket.  This module is the other half: the controller that spawns workers
as subprocesses, decides *where* each tenant runs, and moves them while
they stream:

  * **placement** (``Router.place``) is compiled-shape-affinity first:
    tenants sharing a ``multiplex.shape_key`` land on the same worker so
    its multiplexer can cohort-fuse them into one stacked dispatch (one
    CUDA graph replay per tick on the card).  A per-worker ``capacity``
    bounds packing, so four fusable tenants over two capacity-2 workers
    split 2+2: two fused pairs, not one fused quad and an idle worker;
  * **migration** (``Router.migrate``) is extract → ship → admit: the
    source worker snapshots the tenant and returns it as wire bytes
    (``engine.snapshot.encode_snapshot``), the destination restores it
    and the run continues bit-for-bit (a snapshot-capable teacher's
    state, including its undelivered inbox, rides the snapshot; an RPC
    teacher is quiesced first, which waits for its in-flight tickets'
    answers, and only tickets still unanswered when that wait runs out
    are re-asked on the destination, metered as ``tickets_reasked``);
  * **rebalance** walks the same path under load: when one worker's
    aggregate tick throughput demand (Σ streams·tick_rate_EMA) exceeds the
    coldest worker's by ``factor``, the hottest tenant moves;
  * **scale-in** (``Router.scale_in``) drains a worker (migrates every
    live tenant off, collects finished results), then shuts it down.

Workers never talk to each other; every byte of tenant state moves through
the router, so the fleet-wide query-accounting identity
(``queries_issued == labels_applied + dropped + lost (+ coalesced)``)
survives any sequence of migrations: ``reconcile`` checks it from the
collected stats.  The control wire is the JAX package's, so this router
drives that package's workers too, and its router drives these.

On one card, N workers share the device: each has its own CUDA context,
its own graphs and its own copy of every tenant state it holds.
``spawn_worker`` starts each on the card unless ``device`` names another.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import subprocess
import sys
import time
from typing import Optional

from repro_torch.engine import rpc, snapshot
from repro_torch.runtime import lockdebug
from repro_torch.runtime import telemetry as _telemetry
from repro_torch.runtime import worker as worker_mod


class WorkerError(RuntimeError):
    """A worker replied with an error frame (the worker itself is fine)."""


# ---------------------------------------------------------------------------
# WorkerClient: one control-socket connection to one worker
# ---------------------------------------------------------------------------


class WorkerClient:
    """Controller-side handle on a worker: a persistent control connection
    plus (optionally) the worker subprocess itself."""

    def __init__(
        self,
        host: str,
        port: int,
        name: Optional[str] = None,
        proc: Optional[subprocess.Popen] = None,
        connect_timeout_s: float = 10.0,
    ):
        self.host, self.port = host, port
        self.name = name or f"{host}:{port}"
        self.proc = proc
        self._sock = socket.create_connection(
            (host, port), timeout=connect_timeout_s
        )
        # Commands block for as long as the worker needs (extract quiesces
        # the tenant, which can take many scheduler rounds).
        self._sock.settimeout(None)
        self._file = self._sock.makefile("rb")
        self._frames = rpc._iter_wire(self._file)
        self._lock = lockdebug.make_lock("elastic.WorkerClient._lock")

    def _request(self, header: dict, payload: bytes = b"") -> tuple[dict, bytes]:
        header = dict(header)
        header["payload_len"] = len(payload)
        with self._lock:
            self._sock.sendall(rpc._encode_frame(header, payload))
            _, reply, reply_payload = next(self._frames)
        if reply.get("kind") == "error":
            raise WorkerError(f"{self.name}: {reply['error']}")
        return reply, reply_payload

    # -- commands ----------------------------------------------------------

    def status(self) -> dict:
        """Live-tenant load report + finished-tenant names."""
        return self._request({"kind": "status"})[0]

    def admit(self, spec: dict, snapshot_wire: bytes = b"") -> dict:
        """Start a tenant from its spec; with ``snapshot_wire``, restore it
        from a migrated snapshot instead of fresh state."""
        return self._request({"kind": "admit", "spec": spec}, snapshot_wire)[0]

    def extract(self, name: str) -> tuple[dict, bytes]:
        """Quiesce + snapshot + remove a live tenant; returns its spec and
        the snapshot wire bytes, ready to ``admit`` elsewhere."""
        header, wire = self._request({"kind": "extract", "name": name})
        return header["spec"], wire

    def result(self, name: str) -> tuple[dict, dict]:
        """A finished tenant's (stats dict, {"state": ..., "outputs"?} tree)."""
        header, wire = self._request({"kind": "result", "name": name})
        return header["stats"], snapshot.decode_snapshot(wire)

    def report(self) -> dict:
        """Stats dicts of every finished tenant, keyed by name."""
        return self._request({"kind": "report"})[0]["results"]

    def metrics(self, trace: bool = False) -> tuple[dict, bytes]:
        """Live telemetry scrape: the reply header carries the worker's
        Prometheus exposition text (``"prometheus"``) and registry JSON
        (``"metrics"``); with ``trace`` the payload is the worker's span
        ring as Chrome ``trace_event`` JSON bytes."""
        return self._request({"kind": "metrics", "trace": bool(trace)})

    def shutdown(self) -> None:
        with contextlib.suppress(WorkerError, OSError, EOFError, StopIteration):
            self._request({"kind": "shutdown"})

    def close(self, shutdown: bool = True, timeout_s: float = 10.0) -> None:
        if shutdown:
            self.shutdown()
        rpc._shutdown_socket(self._sock)
        if self.proc is not None:
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            if self.proc.stdout is not None:
                self.proc.stdout.close()


def spawn_worker(
    name: str = "w0",
    host: str = "127.0.0.1",
    quantum: Optional[int] = None,
    sched: str = "rr",
    fuse: bool = True,
    pending: str = "auto",
    snapshot_dir: Optional[str] = None,
    snapshot_every: int = 0,
    snapshot_full_every: int = 8,
    env: Optional[dict] = None,
    device: Optional[str] = None,
) -> WorkerClient:
    """Launch ``python -m repro_torch.runtime.worker`` as a subprocess and
    dial its control port (the worker prints ``PORT <p>`` once listening).
    The worker runs on the card unless ``device`` names another; one that
    cannot start (no CUDA device and none named) raises here."""
    src_root = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    child_env = dict(env if env is not None else os.environ)
    child_env["PYTHONPATH"] = src_root + (
        os.pathsep + child_env["PYTHONPATH"] if child_env.get("PYTHONPATH") else ""
    )
    cmd = [
        sys.executable, "-m", "repro_torch.runtime.worker",
        "--host", host, "--port", "0", "--name", name,
        "--sched", sched,
        "--fuse-cohorts", "on" if fuse else "off",
        "--pending", pending,
        "--snapshot-every", str(snapshot_every),
        "--snapshot-full-every", str(snapshot_full_every),
    ]
    if quantum is not None:
        cmd += ["--quantum", str(quantum)]
    if snapshot_dir is not None:
        cmd += ["--snapshot-dir", snapshot_dir]
    if device is not None:
        cmd += ["--device", str(device)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, text=True, env=child_env
    )
    line = proc.stdout.readline()
    if not line.startswith("PORT "):
        proc.kill()
        proc.wait()
        proc.stdout.close()
        raise RuntimeError(f"worker {name!r} failed to start: {line!r}")
    return WorkerClient(host, int(line.split()[1]), name=name, proc=proc)


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


def _tenant_load(row: dict) -> float:
    """One live tenant's throughput demand: streams × achieved tick rate."""
    return row["s"] * row["tick_rate_ema"]


class Router:
    """Places tenants on workers, migrates them, scales the fleet in.

    ``capacity`` bounds live tenants per worker (None: unbounded).  The
    router keeps no authoritative state: placement decisions re-read
    worker ``status`` every time, so it recovers its world view from the
    fleet itself (the ``_placement`` map is just a fast path)."""

    def __init__(self, workers, capacity: Optional[int] = None):
        self.workers: list[WorkerClient] = list(workers)
        self.capacity = capacity
        self._placement: dict[str, WorkerClient] = {}

    # -- placement ---------------------------------------------------------

    def place(self, spec: dict, exclude=()) -> WorkerClient:
        """Pick the worker for a spec: under capacity first, then
        shape-affinity (a same-key tenant already lives there, so the pair
        cohort-fuses), then fewest tenants, then lowest load."""
        exclude = set(id(w) for w in exclude)
        key = worker_mod.spec_shape_key(spec)
        best, best_rank = None, None
        for w in self.workers:
            if id(w) in exclude:
                continue
            live = w.status()["live"]
            n = len(live)
            affinity = any(
                t["shape_key"] == key and not t["draining"] for t in live
            )
            rank = (
                self.capacity is not None and n >= self.capacity,
                not affinity,
                n,
                sum(_tenant_load(t) for t in live),
            )
            if best_rank is None or rank < best_rank:
                best, best_rank = w, rank
        if best is None:
            raise WorkerError("no worker available for placement")
        return best

    def admit(self, spec: dict) -> WorkerClient:
        w = self.place(spec)
        w.admit(spec)
        self._placement[spec["name"]] = w
        return w

    def worker_of(self, name: str) -> WorkerClient:
        w = self._placement.get(name)
        if w is not None and w in self.workers:
            return w
        for w in self.workers:  # recover from a stale map
            st = w.status()
            if any(t["name"] == name for t in st["live"]) or name in st["finished"]:
                self._placement[name] = w
                return w
        raise WorkerError(f"tenant {name!r} not found on any worker")

    # -- migration ---------------------------------------------------------

    def migrate(self, name: str, dst: Optional[WorkerClient] = None) -> WorkerClient:
        """Move a live tenant to ``dst`` (default: best non-source worker).
        The tenant resumes bit-for-bit from its wire snapshot."""
        src = self.worker_of(name)
        # Router-side span covers the whole ship (extract + place + admit);
        # the workers' own traces carry the migrate.extract / migrate.admit
        # halves.  No-op unless telemetry is enabled in *this* process.
        tel = _telemetry.TELEMETRY
        tok = tel.tracer.begin("migrate.ship") if tel is not None else None
        spec, wire = src.extract(name)
        if dst is None:
            dst = self.place(spec, exclude=(src,))
        dst.admit(spec, wire)
        if tok is not None:
            tel.tracer.end(tok, tenant=name, src=src.name, dst=dst.name,
                           wire_bytes=len(wire))
            tel.registry.count("odl_router_migrations")
        self._placement[name] = dst
        return dst

    def rebalance(self, factor: float = 2.0, max_moves: int = 1) -> list[dict]:
        """Migrate tenants off overloaded workers.  A worker is overloaded
        when its summed tenant load exceeds the coldest worker's by
        ``factor``; the hottest tenant moves there.  Returns the moves made
        (``{"name", "src", "dst"}`` each)."""
        moves = []
        for _ in range(max_moves):
            loads = []
            for w in self.workers:
                live = [t for t in w.status()["live"] if not t["draining"]]
                loads.append((sum(_tenant_load(t) for t in live), live, w))
            if len(loads) < 2:
                break
            loads.sort(key=lambda x: x[0])
            cold_load, _, cold = loads[0]
            hot_load, hot_live, hot = loads[-1]
            if len(hot_live) < 2 or hot_load <= factor * max(cold_load, 1e-9):
                break
            victim = max(hot_live, key=_tenant_load)["name"]
            self.migrate(victim, dst=cold)
            moves.append({"name": victim, "src": hot.name, "dst": cold.name})
        return moves

    # -- scale-in ----------------------------------------------------------

    def drain(self, w: WorkerClient) -> tuple[list[str], dict]:
        """Migrate every live tenant off ``w``; returns the migrated names
        and the stats of tenants that finished on ``w`` (collect them: they
        leave the fleet when the worker shuts down)."""
        migrated = []
        for row in w.status()["live"]:
            name = row["name"]
            try:
                spec, wire = w.extract(name)
            except WorkerError:
                continue  # finished between status and extract: in report
            dst = self.place(spec, exclude=(w,))
            dst.admit(spec, wire)
            self._placement[name] = dst
            migrated.append(name)
        return migrated, w.report()

    def scale_in(self, w: WorkerClient) -> tuple[list[str], dict]:
        """Drain ``w``, then shut it down and drop it from the fleet."""
        migrated, finished = self.drain(w)
        self.workers.remove(w)
        self._placement = {
            name: wk for name, wk in self._placement.items() if wk is not w
        }
        w.close(shutdown=True)
        return migrated, finished

    # -- fleet-wide views --------------------------------------------------

    def wait_finished(
        self, names, timeout_s: float = 300.0, poll_s: float = 0.05
    ) -> None:
        """Block until every named tenant has finished, wherever it ran."""
        remaining = set(names)
        deadline = time.monotonic() + timeout_s
        while remaining:
            for w in self.workers:
                st = w.status()
                remaining -= set(st["finished"])
            if not remaining:
                return
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"tenants never finished: {sorted(remaining)}"
                )
            time.sleep(poll_s)

    def fleet_metrics(self, trace: bool = False) -> dict:
        """One live scrape of the whole fleet.

        Returns ``{"workers": {worker_name: metrics_header}, "traces":
        {worker_name: chrome_trace_dict}}`` where each metrics header is
        the worker's ``metrics`` reply (``"prometheus"`` exposition text +
        ``"metrics"`` registry JSON).  Traces are only fetched (and only
        present) when ``trace=True``.  Scraping is read-only: it never
        perturbs tenant state, so it is safe mid-run at any cadence.
        """
        out: dict = {"workers": {}, "traces": {}}
        for w in self.workers:
            header, payload = w.metrics(trace=trace)
            out["workers"][w.name] = header
            if trace and payload:
                out["traces"][w.name] = json.loads(payload)
        return out

    def fleet_results(self) -> dict:
        """Finished-tenant stats from every live worker, name → stats dict.
        (Stats collected by ``scale_in`` before a worker left must be
        merged by the caller: that worker is gone.)"""
        out = {}
        for w in self.workers:
            for name, stats in w.report().items():
                out[name] = stats
        return out

    def close(self, shutdown: bool = True) -> None:
        for w in self.workers:
            w.close(shutdown=shutdown)
        self.workers = []
        self._placement = {}


def reconcile(results: dict) -> dict:
    """Fleet-wide query accounting from collected stats dicts: sums every
    counter and checks the conservation identity
    ``queries_issued == labels_applied + dropped + lost (+ coalesced)``
    per tenant and in aggregate.  Migrations must not leak tickets."""
    keys = (
        "ticks", "stream_steps", "tickets_issued", "queries_issued",
        "labels_applied", "queries_dropped", "queries_lost",
        "queries_coalesced", "tickets_dropped", "tickets_lost",
        "tickets_coalesced", "replies_orphaned", "asks_deferred",
        "tickets_reasked",
    )
    totals = {k: 0 for k in keys}
    per_tenant_ok = {}
    for name, stats in results.items():
        for k in keys:
            totals[k] += int(stats.get(k, 0))
        per_tenant_ok[name] = bool(stats.get("reconciled", False))
    totals["reconciled"] = totals["queries_issued"] == (
        totals["labels_applied"]
        + totals["queries_dropped"]
        + totals["queries_lost"]
        + totals["queries_coalesced"]
    )
    totals["per_tenant"] = per_tenant_ok
    return totals
