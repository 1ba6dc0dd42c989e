"""One multiplexer worker of the elastic fleet: a ``Multiplexer`` behind a
control socket (PyTorch counterpart of ``repro/runtime/worker.py``,
wire-compatible with it).

The elastic control plane (``runtime/elastic.py``) scales the multi-tenant
runtime *horizontally*: N worker processes, each driving its own
``engine.multiplex.Multiplexer`` on its own CUDA context, with a router
placing tenants by compiled-shape affinity and migrating them
worker-to-worker over the snapshot wire codec
(``engine.snapshot.encode_snapshot``).  This module is the worker half: the
scheduler loop runs in the main thread, and a small control protocol (v2
binary frames, the conventions of the teacher wire in ``engine/wire.py``)
runs on a loopback socket:

  * ``status``   — per-tenant load (tick-rate EMA, ring occupancy,
    compiled-shape key: ``Multiplexer.load_report``) + finished names;
  * ``metrics``  — a live telemetry scrape (Prometheus text, registry JSON,
    optionally the span ring as Chrome trace JSON in the payload); the
    registry also carries this process's kernel launches, graph replays and
    launch shapes (``odl_worker_kernel_*``) and, on the card, its peak
    device memory (``odl_worker_device_peak_bytes``);
  * ``admit``    — start a tenant from a JSON *spec* (below), optionally
    restoring it from snapshot-wire bytes in the frame payload (the
    receiving half of a live migration);
  * ``extract``  — snapshot → remove a tenant (``Multiplexer.extract``
    quiesces first only for teachers that can't snapshot); the reply payload
    is the encoded snapshot and the header returns the spec, so the caller
    can re-admit it anywhere (the sending half of a migration);
  * ``result`` / ``report`` — finished tenants' final state/outputs/stats;
  * ``shutdown`` — stop the scheduler loop (the router drains live tenants
    off a worker *before* shutting it down — scale-in).

Specs, commands and reply headers are the JAX package's byte for byte, so
either package's router drives either package's workers, and a tenant
extracted from a worker of one package is admitted on a worker of the other.

Every command runs on the scheduler thread, between two rounds.  A control
connection's thread only reads the frame, queues the command and waits for
its reply; the scheduler runs every queued command before its next round,
so a command waits out at most the round in flight, never a tenant's whole
run.  On the card this also keeps all device work on one thread, one
current stream: a restore's copies are ordered before the tenant's first
tick, and no command's copies can land inside a round's graph capture.
Since the multiplexer and the specs are touched by that one thread only,
they need no lock: ``_cmd_cond`` guards the command queue and nothing else.

Tenants cross the wire as **specs**, not objects: a JSON dict naming the
engine config (``snapshot.config_to_dict``), the tick source, and the
teacher, so both sides of a migration can rebuild identical Python objects.
Tick sources are always seekable (``snapshot.ResumableTicks``): the
destination worker seeks to the snapshot's cursor, never replays ticks.
Tick kinds: ``synth`` (features seeded per tick, byte for byte the JAX
package's) and ``decode`` (one backbone decode step per tick, the serve
path's tick source, ``launch.serve._decode_feats``).  A worker builds each
distinct backbone spec once (``Worker._decode_cache``) and every tenant and
every seek of that spec shares it; the weights are drawn from the spec's
seed with process-stable generators, so two workers given one spec build
the same backbone and a decode tenant migrates bit for bit.
Teacher kinds:

  * ``latency`` — in-process ``stream.LatencyTeacher`` answering the same
    deterministic rule as the RPC label server (``rpc.expected_label``).
    Its internal state (RNG, inbox) travels inside the snapshot, so a
    migrated tenant continues **bit-for-bit** the run it would have had
    uninterrupted, across processes.
  * ``rpc`` — a real label server endpoint; the worker keeps one shared
    ``rpc.BatchedRpcClient`` per endpoint (as ``shared_rpc_teachers``
    does).  Sockets cannot migrate: ``extract`` first quiesces the tenant,
    waiting for the server to answer its in-flight tickets, and only the
    tickets still unanswered when that wait runs out are re-asked on the
    destination (metered as ``tickets_reasked``).

Every tenant lives on the worker's device: CUDA unless ``--device`` names
another; with no CUDA device and none named, the worker fails before it
listens.  Run standalone (the router spawns these as subprocesses)::

    PYTHONPATH=src python -m repro_torch.runtime.worker --port 0 [--device cpu]
    # prints "PORT <p>" once listening
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import itertools
import json
import socket
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.engine import fleet as fleet_mod
from repro_torch.engine import graphs, multiplex, rpc, snapshot, stream
from repro_torch.kernels import ops
from repro_torch.runtime import lockdebug
from repro_torch.runtime import telemetry as _telemetry
from repro_torch.runtime.checkpoint import to_host

TICK_KINDS = ("synth", "decode")
TEACHER_KINDS = ("latency", "rpc")

# How long an idle scheduler (no live tenants) waits for a command before it
# looks at the stop flag again.
_IDLE_SLEEP_S = 2e-3


# ---------------------------------------------------------------------------
# Tenant specs: tenants as JSON, rebuildable on either side of the wire
# ---------------------------------------------------------------------------


def tenant_spec(
    name: str,
    cfg,
    s: int,
    ticks: dict,
    teacher: dict,
    mode: str = "algo1",
    capacity: int = 64,
    backpressure: str = "drop_oldest",
    collect: bool = False,
    donate: Optional[bool] = None,
) -> dict:
    """Build a tenant spec dict.  ``cfg`` may be an ``EngineConfig`` (of
    either package) or an already-encoded ``config_to_dict`` dict."""
    if not isinstance(cfg, dict):
        cfg = snapshot.config_to_dict(cfg)
    if ticks.get("kind") not in TICK_KINDS:
        raise ValueError(f"unknown tick-source kind {ticks.get('kind')!r}; "
                         f"choose one of {TICK_KINDS}")
    if teacher.get("kind") not in TEACHER_KINDS:
        raise ValueError(f"unknown teacher kind {teacher.get('kind')!r}; "
                         f"choose one of {TEACHER_KINDS}")
    return {
        "name": name, "cfg": cfg, "s": int(s), "ticks": ticks,
        "teacher": teacher, "mode": mode, "capacity": int(capacity),
        "backpressure": backpressure, "collect": bool(collect),
        "donate": donate,
    }


def spec_shape_key(spec: dict) -> str:
    """The compiled-shape affinity key of a spec, computable router-side
    without building any engine objects; equals ``multiplex.shape_key`` of
    the tenant the spec builds (and the JAX package's for the same spec)."""
    return multiplex.shape_key(
        snapshot.config_from_dict(spec["cfg"]),
        spec.get("mode", "algo1"),
        spec.get("donate"),
        spec["s"],
    )


def synth_ticks_spec(seed: int, t_total: int, tick_sleep_ms: float = 0.0) -> dict:
    return {"kind": "synth", "seed": int(seed), "t_total": int(t_total),
            "tick_sleep_ms": float(tick_sleep_ms)}


def latency_teacher_spec(n_out: int, latency: int = 1, jitter: int = 0,
                         loss: float = 0.0, partial: float = 0.0,
                         seed: int = 0) -> dict:
    return {"kind": "latency", "n_out": int(n_out), "latency": int(latency),
            "jitter": int(jitter), "loss": float(loss),
            "partial": float(partial), "seed": int(seed)}


def rpc_teacher_spec(host: str, port: int, timeout_s: float = 5.0,
                     secret: Optional[str] = None, compress: bool = False) -> dict:
    return {"kind": "rpc", "host": host, "port": int(port),
            "timeout_s": float(timeout_s), "secret": secret,
            "compress": bool(compress)}


def _build_ticks(spec: dict, decode_cache: Optional[dict] = None,
                 device: str | torch.device | None = None) -> snapshot.ResumableTicks:
    """The spec's tick source; ``decode`` ticks run the backbone on
    ``device`` (CUDA unless named), built once per distinct backbone spec
    into ``decode_cache``."""
    t = spec["ticks"]
    sleep_s = float(t.get("tick_sleep_ms", 0.0)) / 1e3
    if t["kind"] == "synth":
        # Per-tick seeded features: O(1) seek (no replay), identical in any
        # process and in either package, which the cross-process references
        # of the fleet tests depend on.
        s, n_in = spec["s"], int(spec["cfg"]["elm"]["n_in"])
        seed, t_total = int(t["seed"]), int(t["t_total"])

        def factory(start):
            for tick in range(start, t_total):
                if sleep_s > 0:
                    time.sleep(sleep_s)
                rng = np.random.default_rng((seed, tick))
                yield np.tanh(rng.normal(size=(s, n_in))).astype(np.float32)

        return snapshot.ResumableTicks(factory)

    # "decode": one backbone decode step per tick.  The decode replays bit
    # for bit, so seek(k) replays it to tick k; params and the prefill are
    # built once per distinct backbone spec and shared by every tenant (and
    # every seek) on this worker.
    from repro_torch import configs
    from repro_torch.launch import serve as serve_lib

    device = resolve_device(device)
    if decode_cache is None:
        decode_cache = {}
    key_fields = ("arch", "variant", "batch", "prompt_len", "max_len", "seed")
    cache_key = tuple(t.get(k) for k in key_fields)
    entry = decode_cache.get(cache_key)
    if entry is None:
        cfg = configs.get_config(t["arch"], t.get("variant", "smoke"))
        params, prompts, state = serve_lib.build_backbone(
            cfg, int(t["batch"]), int(t.get("prompt_len", 16)), int(t.get("max_len", 128)),
            int(t.get("seed", 0)), device)
        entry = decode_cache[cache_key] = (cfg, params, state, prompts)
    cfg, params, state, prompts = entry
    t_total = int(t["t_total"])

    def decode_factory(start):
        it = itertools.islice(
            serve_lib._decode_feats(params, state, prompts, cfg, t_total), start, None)
        for x in it:
            if sleep_s > 0:
                time.sleep(sleep_s)
            yield x

    return snapshot.ResumableTicks(decode_factory)


def _build_teacher(spec: dict, rpc_clients: dict):
    t = spec["teacher"]
    if t["kind"] == "latency":
        n_out = int(t["n_out"])

        def label_fn(tick, feats, n_out=n_out):
            # feats is a tensor (on the card for a solo tenant) or a host
            # array (a cohort member's rows); only its row count is read.
            return rpc.expected_labels(tick, int(feats.shape[0]), n_out)

        return stream.LatencyTeacher(
            label_fn=label_fn, latency=int(t.get("latency", 1)),
            jitter=int(t.get("jitter", 0)), loss_prob=float(t.get("loss", 0.0)),
            partial_prob=float(t.get("partial", 0.0)), seed=int(t.get("seed", 0)),
        )
    # "rpc": one shared batched connection per endpoint for the whole
    # worker; per-tenant handles demux replies (multiplex.shared_rpc_teachers
    # semantics, cached worker-side so migrations reuse the socket).
    key = (t["host"], int(t["port"]))
    client = rpc_clients.get(key)
    if client is None:
        client = rpc_clients[key] = rpc.BatchedRpcClient(
            t["host"], int(t["port"]), timeout_s=float(t.get("timeout_s", 5.0)),
            secret=t.get("secret"), compress=bool(t.get("compress", False)),
        )
    return client.tenant(name=spec["name"])


def _stats_to_wire(stats: stream.StreamStats) -> dict:
    """Every StreamStats field as JSON-able values (deques become lists)."""
    out = {}
    for f in dataclasses.fields(stream.StreamStats):
        v = getattr(stats, f.name)
        if f.name in ("tick_ms", "label_latency_ticks"):
            out[f.name] = [float(x) for x in v]
        else:
            out[f.name] = v
    out["reconciled"] = stats.reconciled
    return out


def stats_from_wire(d: dict) -> stream.StreamStats:
    stats = stream.StreamStats()
    for k, v in d.items():
        if k == "reconciled":
            continue
        if k in ("tick_ms", "label_latency_ticks"):
            getattr(stats, k).extend(v)
        else:
            setattr(stats, k, type(getattr(stats, k))(v))
    return stats


# ---------------------------------------------------------------------------
# The worker
# ---------------------------------------------------------------------------


class _Command:
    """One control command on its way to the scheduler thread and back."""

    def __init__(self, header: dict, payload: bytes):
        self.header = header
        self.payload = payload
        self.reply: Optional[tuple[dict, bytes]] = None
        self.done = threading.Event()

    def answer(self, reply: tuple[dict, bytes]) -> None:
        self.reply = reply
        self.done.set()


class Worker:
    """A ``Multiplexer`` wrapped in a control-socket server.

    The scheduler runs in whatever thread calls :meth:`serve_forever`, and
    so does every command: control connections are handled one thread each,
    and each queues its commands for the scheduler, which runs all queued
    commands between two rounds (see the module docstring).
    """

    def __init__(
        self,
        name: str = "worker",
        host: str = "127.0.0.1",
        port: int = 0,
        quantum: int = multiplex.DEFAULT_QUANTUM,
        sched: str = "rr",
        fuse: bool = True,
        pending: str = "auto",
        snapshot_dir: Optional[str] = None,
        snapshot_every: int = 0,
        snapshot_full_every: int = 8,
        telemetry: bool = True,
        device: str | torch.device | None = None,
    ):
        self.name = name
        # No card and no device named: raise here, before the port is bound.
        self.device = resolve_device(device)
        if telemetry:
            # Process-wide: every session/client in this worker records into
            # the same registry; the ``metrics`` command scrapes it live.
            _telemetry.enable()
        self.mux = multiplex.Multiplexer(
            [], quantum=quantum, sched=sched, fuse=fuse, pending=pending,
            snapshot_dir=snapshot_dir, snapshot_every=snapshot_every,
            snapshot_full_every=snapshot_full_every,
        )
        self._specs: dict[str, dict] = {}
        # Decode backbones built by this worker, one per distinct spec.
        self._decode_cache: dict = {}
        self._rpc_clients: dict = {}
        # Commands waiting for the scheduler thread, oldest first.
        self._cmd_cond = lockdebug.make_condition("worker.Worker._cmd_cond")
        self._commands: collections.deque[_Command] = collections.deque()
        self._stop = threading.Event()
        self._sock = socket.create_server((host, port))
        self.host, self.port = self._sock.getsockname()[:2]
        self._conns: list[socket.socket] = []
        self._threads: list[threading.Thread] = []
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True
        )
        self._accept_thread.start()

    # -- scheduler loop ----------------------------------------------------

    def serve_forever(self) -> None:
        """Drive the multiplexer until ``shutdown`` arrives, running the
        queued control commands before every round.  An idle worker (no
        live tenants) waits for commands: the router admits tenants at any
        time."""
        try:
            while not self._stop.is_set():
                self._run_commands()
                if self._stop.is_set():
                    break
                live = self.mux.round()
                if not live:
                    with self._cmd_cond:
                        if not self._commands and not self._stop.is_set():
                            self._cmd_cond.wait(_IDLE_SLEEP_S)
        finally:
            self._stop.set()
            self._fail_commands("worker is shutting down")

    def _run_commands(self) -> None:
        """Run every queued command, in arrival order (this round boundary's
        commands, and any that arrive while they run)."""
        while True:
            with self._cmd_cond:
                if not self._commands:
                    return
                cmd = self._commands.popleft()
            cmd.answer(self._handle(cmd.header, cmd.payload))

    def _fail_commands(self, why: str) -> None:
        with self._cmd_cond:
            while self._commands:
                self._commands.popleft().answer(({"kind": "error", "error": why}, b""))

    def _submit(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        """Queue one command for the scheduler thread; wait for its reply."""
        cmd = _Command(header, payload)
        with self._cmd_cond:
            if self._stop.is_set():
                return {"kind": "error", "error": "worker is shutting down"}, b""
            self._commands.append(cmd)
            self._cmd_cond.notify_all()
        cmd.done.wait()
        return cmd.reply

    def close(self) -> None:
        self._stop.set()
        self._fail_commands("worker is shutting down")
        rpc._shutdown_socket(self._sock)
        for conn in list(self._conns):
            rpc._shutdown_socket(conn)
        for t in self._threads:
            t.join(timeout=5)
        for client in self._rpc_clients.values():
            with contextlib.suppress(Exception):
                client.close()

    # -- control protocol --------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            self._conns.append(conn)
            t = threading.Thread(target=self._serve_conn, args=(conn,), daemon=True)
            self._threads.append(t)
            t.start()

    def _serve_conn(self, conn: socket.socket) -> None:
        f = conn.makefile("rb")
        try:
            for kind, header, payload in rpc._iter_wire(f):
                if kind != "v2":
                    continue  # this port speaks only the control protocol
                reply, reply_payload = self._submit(header, payload)
                reply["payload_len"] = len(reply_payload)
                conn.sendall(rpc._encode_frame(reply, reply_payload))
                if header.get("kind") == "shutdown":
                    break
        except (EOFError, OSError, ValueError):
            pass  # dropped controller connection; worker keeps serving
        finally:
            rpc._shutdown_socket(conn)
            with contextlib.suppress(ValueError):
                self._conns.remove(conn)

    def _handle(self, header: dict, payload: bytes) -> tuple[dict, bytes]:
        cmd = header.get("kind")
        try:
            if cmd == "status":
                return self._status(), b""
            if cmd == "metrics":
                return self._metrics(bool(header.get("trace", False)))
            if cmd == "admit":
                return self._admit(header["spec"], payload), b""
            if cmd == "extract":
                return self._extract(header["name"])
            if cmd == "result":
                return self._result(header["name"])
            if cmd == "report":
                return {
                    "kind": "report_ok",
                    "results": {
                        name: _stats_to_wire(r.stats)
                        for name, r in self.mux.finished_results().items()
                    },
                }, b""
            if cmd == "shutdown":
                self._stop.set()
                return {"kind": "ok"}, b""
            return {"kind": "error",
                    "error": f"unknown control command {cmd!r}"}, b""
        except Exception as e:  # command errors must not kill the worker
            return {"kind": "error", "error": f"{type(e).__name__}: {e}"}, b""

    def _status(self) -> dict:
        return {
            "kind": "status_ok",
            "worker": self.name,
            "live": self.mux.load_report(),
            "finished": sorted(self.mux.finished_results()),
        }

    def _metrics(self, trace: bool) -> tuple[dict, bytes]:
        """Live scrape: sync every meter into the registry, then export.

        Returns both renderings in the header (Prometheus exposition text
        + the registry's JSON snapshot); when ``trace`` is requested the
        reply payload carries the span ring as Chrome ``trace_event`` JSON
        (``chrome://tracing`` / Perfetto loads it directly).
        """
        tel = _telemetry.TELEMETRY
        if tel is None:
            return {"kind": "metrics_ok", "worker": self.name,
                    "enabled": False, "prometheus": "", "metrics": {}}, b""
        self.mux.sync_telemetry()
        for (host, port), client in self._rpc_clients.items():
            client.sync_telemetry(endpoint=f"{host}:{port}")
        # This process's kernels: eager launches, launches by graph replays
        # and every shape launched or captured at (each 0 or empty at start;
        # the workers of a fleet are processes of their own).
        for kernel, n in ops.launch_counts.items():
            tel.registry.gauge("odl_worker_kernel_launches", n, worker=self.name, kernel=kernel)
            tel.registry.gauge("odl_worker_kernel_replays", graphs.kernel_replays[kernel],
                               worker=self.name, kernel=kernel)
            for shape in ops.launch_shapes[kernel]:
                tel.registry.gauge("odl_worker_kernel_shape", 1, worker=self.name, kernel=kernel,
                                   shape=",".join(map(str, shape)))
        if self.device.type == "cuda":
            # This process's share of a card that several workers split: the
            # most device memory its allocator has held.
            tel.registry.gauge("odl_worker_device_peak_bytes",
                               torch.cuda.max_memory_reserved(self.device), worker=self.name)
        header = {
            "kind": "metrics_ok",
            "worker": self.name,
            "enabled": True,
            "prometheus": tel.registry.prometheus_text(),
            "metrics": tel.registry.snapshot(),
        }
        payload = json.dumps(tel.tracer.chrome_trace()).encode() if trace else b""
        return header, payload

    def _admit(self, spec: dict, payload: bytes) -> dict:
        tree = snapshot.decode_snapshot(payload) if payload else None
        cfg = snapshot.config_from_dict(spec["cfg"])
        tenant = multiplex.Tenant(
            name=spec["name"],
            # A migrated-in tenant's state rides the snapshot.
            state=None if tree is not None else fleet_mod.init_fleet(cfg, spec["s"], self.device),
            ticks=_build_ticks(spec, self._decode_cache, self.device),
            cfg=cfg,
            teacher=_build_teacher(spec, self._rpc_clients),
            mode=spec.get("mode", "algo1"),
            capacity=spec.get("capacity", 64),
            backpressure=spec.get("backpressure", "drop_oldest"),
            collect=spec.get("collect", False),
            donate=spec.get("donate"),
            device=self.device,
        )
        self.mux.admit(tenant, snapshot=tree)
        self._specs[spec["name"]] = spec
        return {"kind": "ok", "name": spec["name"],
                "migrated": tree is not None}

    def _extract(self, name: str) -> tuple[dict, bytes]:
        tree, _it = self.mux.extract(name)
        # The partially-consumed iterator stays behind: specs only build
        # seekable sources, so the destination seeks to the snapshot cursor.
        spec = self._specs.pop(name)
        wire = snapshot.encode_snapshot(tree)
        return {"kind": "snapshot_ok", "spec": spec,
                "t": snapshot.ticks_consumed(tree)}, wire

    def _result(self, name: str) -> tuple[dict, bytes]:
        results = self.mux.finished_results()
        if name not in results:
            raise KeyError(f"tenant {name!r} has no finished result here")
        r = results[name]
        tree: dict = {"state": snapshot.state_to_tree(r.state)}
        if r.outputs is not None:
            tree["outputs"] = {k: to_host(v) for k, v in r.outputs._asdict().items()}
        wire = snapshot.encode_snapshot(tree)
        return {"kind": "result_ok", "stats": _stats_to_wire(r.stats)}, wire


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="control port (0: ephemeral, printed as 'PORT <p>')")
    ap.add_argument("--name", default="worker")
    ap.add_argument("--quantum", type=int, default=multiplex.DEFAULT_QUANTUM)
    ap.add_argument("--sched", default="rr", choices=multiplex.SCHEDULERS)
    ap.add_argument("--fuse-cohorts", default="on", choices=("on", "off"))
    ap.add_argument("--pending", default="auto", choices=snapshot.PENDING_POLICIES,
                    help="how admits-from-wire handle in-flight tickets")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--snapshot-full-every", type=int, default=8,
                    help="cadence saves ship only changed leaves; every k-th "
                    "save is full (1: all saves full)")
    ap.add_argument("--telemetry", default="on", choices=("on", "off"),
                    help="process-local metrics registry + span tracer "
                    "(scraped via the 'metrics' control command)")
    ap.add_argument("--device", default=None,
                    help="device every tenant lives on (default: CUDA; with no "
                    "CUDA device the worker refuses to start)")
    args = ap.parse_args(argv)
    worker = Worker(
        name=args.name, host=args.host, port=args.port, quantum=args.quantum,
        sched=args.sched, fuse=args.fuse_cohorts == "on", pending=args.pending,
        snapshot_dir=args.snapshot_dir, snapshot_every=args.snapshot_every,
        snapshot_full_every=args.snapshot_full_every,
        telemetry=args.telemetry == "on", device=args.device,
    )
    print(f"PORT {worker.port}", flush=True)
    try:
        worker.serve_forever()
    finally:
        worker.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
