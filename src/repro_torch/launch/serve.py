"""Serving entry point: prefill -> decode loop with multi-tenant ODL cascades
(PyTorch counterpart of ``repro/launch/serve.py``, flag for flag).

The backbone decodes once per tick; the per-tick stream features fan out to
``--tenants`` independent ODL fleets multiplexed over this process by
``repro_torch.engine.multiplex`` — each tenant has its own engine state,
pending ring, teacher connection, and backpressure policy
(``--backpressure``: drop_oldest / drop_newest / block / coalesce), while
same-shaped tenants fuse into one cohort dispatch (``--fuse-cohorts``).
Streams whose P1P2 confidence clears auto-theta SKIP the teacher — the
paper's data pruning as a serving-compute/communication saver.  Tenants run
the engine's ``serve`` mode: the per-stream drift detector runs live and a
drifting stream is forced to query (pruning condition 2), exactly the
``gate`` decision logic the single-tenant ``model.serve_step`` path uses.
Teacher answers arrive asynchronously (out of order, possibly partial) and
are applied against the *plan-time* decision context.

``--teacher rpc`` swaps the in-process latency model for a real loopback
TCP label server (``repro_torch.engine.rpc``), with wall-clock timeout →
loss, all tenants sharing one batched connection per teacher host
(``--teacher-batch-window``, ``--teacher-batch-max``, ``--teacher-secret``,
``--teacher-compress``, as in the reference).

``--mesh-fleet N`` shards one tenant's stream axis over an N-entry
``("fleet",)`` mesh — one shard-local session per entry
(``stream.run_sharded``); the mesh's entries are every visible card, or
``--device`` N times (``--device cpu --mesh-fleet 4`` on a CPU host).

``--workers N`` runs the elastic fleet: N worker subprocesses behind the
shape-aware router (``repro_torch.runtime.elastic``), with ``--fleet-ticks
decode`` driving the real backbone in each worker.

Durable sessions: ``--snapshot-dir`` + ``--snapshot-every`` publish
per-tenant snapshots as the decode loop runs; ``--resume`` restores every
tenant from its latest snapshot, replaying the backbone decode up to the
recorded tick cursor (the decode gives the same bits on every replay).
``--migrate`` moves tenant0 mid-stream into a second multiplexer behind a
fresh teacher connection.

Weights are random, drawn on the device from ``--seed``
(``model.build_params``); prompts come from a ``torch.Generator`` seeded with
``--seed``.  Everything runs on the card unless ``--device`` names another
device; with no card and no ``--device`` it exits before serving.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --tokens 32 \\
      --tenants 2 --backpressure coalesce --teacher-latency 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import configs, engine, resolve_device
from repro_torch.engine import graphs, multiplex, rpc, snapshot, stream
from repro_torch.models import model as model_lib
from repro_torch.runtime import telemetry


def build_backbone(cfg, batch: int, prompt_len: int, max_len: int, seed: int, device):
    """Random weights from ``seed`` on ``device``, ``batch`` prompts of
    ``prompt_len`` tokens from a generator seeded with ``seed``, and their
    prefill: ``(params, prompts, prefill state)``.  Every process building
    one spec gets the same weights, prompts and caches."""
    params = model_lib.build_params(cfg, seed, device)
    gen = torch.Generator().manual_seed(int(seed))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                            dtype=torch.int64).to(device)
    _, state = model_lib.prefill(params, prompts, cfg, max_len=max_len)
    return params, prompts, state


class _Decoded(NamedTuple):
    feats: torch.Tensor  # (B, d) f32
    next_token: torch.Tensor  # (B, 1) greedy feedback


# Cache leaves a decode step rewrites whole (the SSD and RG-LRU states and
# conv tails), as against the attention caches it writes one slot of.
RECURRENT_LEAVES = ("state", "conv", "h")


def _cache_leaves(tree: dict, prefix: tuple = ()):
    """(path, leaf) of every leaf of a cache tree, in sorted path order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _cache_leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _nest(paths, leaves) -> dict:
    """The cache tree whose leaf at each of ``paths`` is the matching leaf."""
    out: dict = {}
    for path, leaf in zip(paths, leaves, strict=True):
        sub = out
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        sub[path[-1]] = leaf
    return out


def _decode_tick(params, cfg, paths):
    """One decode step as a tick function of ``engine.graphs``.  Its fixed
    buffers are two sets of the cache leaves at ``paths`` (sorted): the step
    reads the first and writes the recurrent leaves' new values into the
    second; the attention leaves (K and V, or MLA's latent and rope key) are
    one tensor in both sets and written in place at ``pos``.  It returns the
    features and the next token.  Run twice on the same inputs it writes the
    same values, so a graph's warm-up call leaves nothing its replays depend
    on."""
    n = len(paths)

    def tick(*args):
        *leaves, pos, token = args
        read, written = _nest(paths, leaves[:n]), _nest(paths, leaves[n:])
        state = model_lib.ServeState(caches=read, pos=pos, odl=None)
        logits, feats, _ = model_lib.decode_step(params, state, token, cfg, out=written)
        return _Decoded(feats, torch.argmax(logits, -1)[:, None])

    return tick


def _decode_feats(params, state, prompts, cfg, gen_tokens):
    """Tick source: one backbone decode step per tick, yielding (B, d)
    stream features (greedy next-token feedback, ODL state untouched).

    The decode starts from a copy of the prefill's caches, so every call
    replays the same ticks bit for bit.  A stack with recurrent leaves (SSD,
    RG-LRU) gets a second set of them, and the steps alternate which set
    they read and which they write.  On the card each step replays one CUDA
    graph of the whole step (``engine.graphs``; one per set read): an eager
    step is some 18,000 dispatches from the host; on the CPU the step runs
    eagerly."""
    paths, leaves = zip(*_cache_leaves(state.caches))
    bufs = [tuple(a.clone() for a in leaves)]
    if any(p[-1] in RECURRENT_LEAVES for p in paths):
        bufs.append(tuple(torch.empty_like(a) if p[-1] in RECURRENT_LEAVES else a
                          for p, a in zip(paths, bufs[0])))
    pos, token = state.pos, prompts[:, -1:]
    tick = _decode_tick(params, cfg, paths)
    graph_cache: dict = {}
    for step in range(gen_tokens):
        i = step % len(bufs)
        fixed = bufs[i] + bufs[(i + 1) % len(bufs)]
        out = graphs.run(graph_cache, i, "decode", tick, fixed, [pos, token])
        pos, token = pos + 1, out.next_token
        yield out.feats


def _print_stream_report(parsed: dict) -> dict:
    """ONE render for every serve path's per-session counter block.

    ``parsed`` is a ``telemetry.parse_prometheus`` view — the same shape
    whether it came from this process's registry (solo / mesh) or a worker
    scrape (fleet).  Prints one line per label set carrying stream counters
    and returns the summed counters plus ``identity_ok`` / ``sessions``.
    """
    ident = telemetry.check_stream_identity(parsed)
    fields = ("queries_issued", "stream_steps", "labels_applied",
              "queries_dropped", "queries_lost", "queries_coalesced",
              "replies_orphaned", "tickets_reasked")
    totals = dict.fromkeys(fields, 0)
    for key in sorted(ident):
        def g(f, key=key):
            return int(parsed.get((f"odl_stream_{f}", key), 0))
        who = ",".join(
            f"{k}{v}" if k in ("shard", "cohort") else v for k, v in key
        ) or "session"
        recon = "ok" if ident[key] else "BROKEN"
        issued, steps = g("queries_issued"), g("stream_steps")
        print(f"{who}: queries {issued}/{steps} "
              f"({100 * issued / max(steps, 1):.1f}% comm volume), "
              f"labels {g('labels_applied')}, dropped {g('queries_dropped')}, "
              f"lost {g('queries_lost')}, coalesced {g('queries_coalesced')}, "
              f"orphaned {g('replies_orphaned')}, "
              f"reasked {g('tickets_reasked')}, accounting {recon}")
        for f in fields:
            totals[f] += g(f)
    totals["identity_ok"] = bool(ident) and all(ident.values())
    totals["sessions"] = len(ident)
    return totals


def _print_label_server_stats(ls: dict) -> None:
    """The label server's own counters, scraped over the wire
    (``rpc.server_stats``): the server is a subprocess."""
    comp = ""
    if ls.get("frames_compressed"):
        win_in = ls["raw_bytes_in"] / max(ls["compressed_bytes_in"], 1)
        win_out = ls["raw_bytes_out"] / max(ls["compressed_bytes_out"], 1)
        comp = (f", compression x{win_in:.1f} in / x{win_out:.1f} out over "
                f"{ls['frames_compressed']} frames")
    print(f"label server: {ls['asks_served']} asks "
          f"({ls['frames_v2']} v2 frames, {ls['requests_v1']} v1 requests), "
          f"frame errors {ls['frame_errors']}, auth failures "
          f"{ls['auth_failures']}, {ls['connections_accepted']} "
          f"connection(s), {ls['thread_count']} live thread(s){comp}")


def _write_metrics_json(path: str, doc: dict, traces: dict = None) -> None:
    """``--metrics-json``: machine-readable run metrics, plus one Chrome
    ``trace_event`` file per traced process."""
    import json as json_mod

    with open(path, "w") as f:
        json_mod.dump(doc, f, indent=2, sort_keys=True, default=str)
    written = [path]
    for tag, trace in (traces or {}).items():
        tpath = f"{path}.{tag}.trace.json" if tag else f"{path}.trace.json"
        with open(tpath, "w") as f:
            json_mod.dump(trace, f)
        written.append(tpath)
    print(f"metrics written: {', '.join(written)}")


def _latency_teacher(cfg, seed, latency, jitter, loss):
    """The smoke teacher: random classes (a real deployment points label_fn
    at a pod-side backbone ensemble); latency, jitter and loss model the
    round trip in decode ticks."""
    rng = np.random.default_rng(seed)
    return stream.LatencyTeacher(
        label_fn=lambda tick, feats: rng.integers(0, cfg.odl.n_out, size=int(feats.shape[0])),
        latency=latency, jitter=jitter, loss_prob=loss, seed=seed,
    )


def _serve_mesh(cfg, odl_cfg, params, state, prompts, *, mesh_fleet, batch,
                gen_tokens, seed, teacher, teacher_latency, teacher_jitter,
                teacher_loss, pending_capacity, backpressure, rpc_timeout_s,
                teacher_batch_window_s, teacher_batch_max, teacher_secret,
                teacher_compress, device, explicit_device, metrics_json=None):
    """Mega-fleet path: one tenant, its stream axis sharded over a
    ``("fleet",)`` mesh — one shard-local session (pending ring, teacher
    connection, plan/learn dispatch) per entry, a label learning back only
    into the shard that planned it (``stream.run_sharded``)."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import mesh as mesh_lib

    fleet_mesh = mesh_lib.make_fleet_mesh(
        mesh_fleet, devices=[device] * mesh_fleet if explicit_device else None)
    ticks = _decode_feats(params, state, prompts, cfg, gen_tokens)
    with contextlib.ExitStack() as stack:
        if teacher == "rpc":
            host, port = stack.enter_context(
                rpc.loopback_server(n_out=cfg.odl.n_out, secret=teacher_secret)
            )
            # One shared batched connection; each shard gets its own tenant
            # handle (the demux is per handle).
            client = rpc.BatchedRpcClient(
                host, port, timeout_s=rpc_timeout_s, secret=teacher_secret,
                batch_window_s=teacher_batch_window_s,
                batch_max=teacher_batch_max, compress=teacher_compress,
            )
            stack.callback(client.close)

            def teachers(k):
                return client.tenant(name=f"shard{k}")
        else:
            def teachers(k):
                return _latency_teacher(cfg, seed + k, teacher_latency, teacher_jitter,
                                        teacher_loss)

        with sharding.activate(fleet_mesh):
            n_shards = sharding.fleet_axis_size()
            st, _, stats_list = stream.run_sharded(
                engine.init_fleet(odl_cfg, batch, device), ticks, odl_cfg, teachers,
                mode="serve", capacity=pending_capacity,
                backpressure=backpressure, collect=False,
            )
        rpc_bytes = client.wire_bytes if teacher == "rpc" else None
        label_server_stats = None
        if teacher == "rpc":
            client.sync_telemetry()
            label_server_stats = rpc.server_stats(host, port, secret=teacher_secret)

    tel = telemetry.get() or telemetry.enable()
    for k, s in enumerate(stats_list):
        telemetry.sync_stream_stats(tel.registry, s, pending=0, shard=str(k))
    report = _print_stream_report(
        telemetry.parse_prometheus(tel.registry.prometheus_text()))
    queries = report["queries_issued"]
    skips = report["stream_steps"] - report["queries_issued"]
    if not report["identity_ok"]:
        raise AssertionError(
            "shard query accounting does not reconcile: "
            + "; ".join(s.summary() for s in stats_list))
    if label_server_stats is not None:
        _print_label_server_stats(label_server_stats)
    agg = stream.aggregate_stats(stats_list, padded_streams=(-batch) % max(n_shards, 1))
    meter_kb = float(np.asarray(st.meter.total).sum()) / 1e3
    rpc_note = f"; rpc wire {rpc_bytes / 1e3:.1f} kB" if rpc_bytes else ""
    print(f"mesh aggregate: {n_shards} shard(s) x {gen_tokens} tokens x "
          f"{batch} streams = {agg['stream_steps']} steps in "
          f"{agg['wall_s']:.2f}s ({agg['steps_per_s']:,.0f} steps/s); "
          f"padded {agg['padded_streams']} dead rows; "
          f"backpressure={backpressure}, teacher={teacher}"
          f"{rpc_note}; {meter_kb:.1f} kB metered")
    if metrics_json:
        _write_metrics_json(metrics_json, {
            "mode": "mesh", "shards": n_shards, "tokens": gen_tokens,
            "report": report, "aggregate": agg,
            "prometheus": tel.registry.prometheus_text(),
            "registry": tel.registry.snapshot(),
            "label_server": label_server_stats,
        }, {"": tel.tracer.chrome_trace()})
    return queries, skips


def decode_ticks_spec(arch: str, variant: str, batch: int, seed: int, t_total: int,
                      tick_sleep_ms: float = 0.0, prompt_len: int = 16,
                      max_len: int = 128) -> dict:
    """A worker tick source of real backbone decode steps (the reference's
    ``serve_fleet --fleet-ticks decode`` spec)."""
    return {"kind": "decode", "arch": arch, "variant": variant, "batch": int(batch),
            "prompt_len": int(prompt_len), "max_len": int(max_len), "seed": int(seed),
            "t_total": int(t_total), "tick_sleep_ms": float(tick_sleep_ms)}


def serve_fleet(workers: int = 2, tenants: int = 4, batch: int = 4,
                gen_tokens: int = 2000, fleet_ticks: str = "synth",
                arch: str = "qwen3-4b", variant: str = "smoke", seed: int = 0,
                tick_sleep_ms: float = 1.0, teacher_latency: int = 2,
                teacher_jitter: int = 1, teacher_loss: float = 0.0,
                pending_capacity: int = 8, backpressure: str = "drop_oldest",
                worker_capacity: int = None, migrate: bool = True,
                drain: bool = True, snapshot_full_every: int = 8,
                metrics_json: str = None, device=None):
    """Elastic fleet path (``--workers N``): spin ``workers`` multiplexer
    worker subprocesses behind a shape-aware router, admit ``tenants``
    tenants by shape affinity, optionally live-migrate one mid-stream and
    drain a whole worker (scale-in), then reconcile the fleet-wide
    query-accounting identity across every migration.  The workers run on
    ``device`` (CUDA unless named)."""
    import time as time_mod

    from repro_torch.runtime import elastic
    from repro_torch.runtime import worker as worker_mod

    worker_device = str(device) if device is not None else None
    if fleet_ticks == "decode":
        # Real backbone decode ticks: each worker builds (and caches) the
        # backbone once per distinct spec; n_in is the model dim.
        odl_cfg = model_lib.core_config(configs.get_config(arch, variant))
        ticks_spec = decode_ticks_spec(arch, variant, batch, seed, gen_tokens, tick_sleep_ms)
    else:
        # Synthetic per-tick-seeded features: O(1) seek, identical bytes in
        # any process — the migration-parity default.
        from repro_torch.core import drift as drift_mod
        from repro_torch.core import oselm, pruning

        odl_cfg = engine.EngineConfig(
            elm=oselm.OSELMConfig(n_in=16, n_hidden=16, n_out=4,
                                  variant="hash", ridge=1e-2),
            prune=pruning.PruneConfig(min_trained=1_000_000),
            drift=drift_mod.DriftConfig(),
        )
        ticks_spec = None  # per-tenant (distinct seeds), built below

    if worker_capacity is None:
        # Spread evenly so same-shape tenants split into fused cohorts.
        worker_capacity = max(1, -(-tenants // workers))

    tel = telemetry.enable()
    tel.registry.clear()
    fleet = [elastic.spawn_worker(f"w{i}", device=worker_device) for i in range(workers)]
    router = elastic.Router(fleet, capacity=worker_capacity)
    collected: dict = {}
    try:
        specs = []
        for i in range(tenants):
            spec = worker_mod.tenant_spec(
                f"tenant{i}", odl_cfg, s=batch, mode="serve",
                capacity=pending_capacity, backpressure=backpressure,
                ticks=(ticks_spec or worker_mod.synth_ticks_spec(
                    seed=seed + 100 + i, t_total=gen_tokens,
                    tick_sleep_ms=tick_sleep_ms)),
                teacher=worker_mod.latency_teacher_spec(
                    n_out=odl_cfg.elm.n_out, latency=teacher_latency,
                    jitter=teacher_jitter, loss=teacher_loss, seed=seed + i),
            )
            specs.append(spec)
            w = router.admit(spec)
            print(f"placed {spec['name']} -> {w.name} "
                  f"(shape key {worker_mod.spec_shape_key(spec)})")

        if migrate:
            # Live migration: wait until tenant0 is mid-stream, then move it.
            target = max(2, gen_tokens // 2)
            deadline = time_mod.monotonic() + 300
            while time_mod.monotonic() < deadline:
                src = router.worker_of("tenant0")
                st = src.status()
                row = next((t for t in st["live"] if t["name"] == "tenant0"), None)
                if row is None:
                    print("tenant0 finished before the migration point "
                          "(--tokens too small); continuing without migration")
                    break
                if row["t"] >= target:
                    dst = router.migrate("tenant0")
                    print(f"tenant0 migrated {src.name} -> {dst.name} "
                          f"at tick >= {row['t']}")
                    break
                time_mod.sleep(0.02)

        # Mid-run live scrape: the scraped identity (issued == applied +
        # dropped + lost + coalesced + pending) must close at this instant.
        scrape = router.fleet_metrics()
        midrun = {}
        for h in scrape["workers"].values():
            midrun.update(telemetry.check_stream_identity(
                telemetry.parse_prometheus(h["prometheus"])))
        print(f"mid-run scrape: {len(midrun)} tenant series across "
              f"{len(scrape['workers'])} worker(s), identity "
              f"{'ok' if midrun and all(midrun.values()) else 'BROKEN'}")
        if not midrun or not all(midrun.values()):
            raise AssertionError(f"mid-run scraped query accounting broken: {midrun}")

        if drain and len(router.workers) > 1:
            victim = router.workers[-1]
            moved, finished = router.scale_in(victim)
            collected.update(finished)
            print(f"scale-in: drained {victim.name} "
                  f"(migrated {moved or 'nothing'}; "
                  f"{len(finished)} finished there)")

        # A tenant that finished on the drained worker left the fleet with it:
        # its stats are already collected, and no live worker will list it.
        router.wait_finished([s["name"] for s in specs if s["name"] not in collected],
                             timeout_s=600)

        # Final scrape BEFORE the workers go away, then ONE render over the
        # collected stats (the solo and mesh paths' `_print_stream_report`).
        final_scrape = router.fleet_metrics(trace=bool(metrics_json))
        for w in router.workers:
            collected.update(w.report())
        reg = telemetry.Registry()
        for name, s in collected.items():
            telemetry.sync_stream_stats(
                reg, worker_mod.stats_from_wire(s), pending=0, tenant=name)
        report = _print_stream_report(telemetry.parse_prometheus(reg.prometheus_text()))
        agg = elastic.reconcile(collected)
        recon = "ok" if agg["reconciled"] else "BROKEN"
        print(f"fleet aggregate: {len(collected)} tenant(s) over "
              f"{workers} worker(s) -> {len(router.workers)} after scale-in; "
              f"{agg['stream_steps']} steps, queries {agg['queries_issued']}, "
              f"labels {agg['labels_applied']}, dropped "
              f"{agg['queries_dropped']}, lost {agg['queries_lost']}, "
              f"coalesced {agg['queries_coalesced']}, reasked "
              f"{agg['tickets_reasked']}, accounting {recon}")
        if not agg["reconciled"] or not all(agg["per_tenant"].values()):
            raise AssertionError(f"fleet query accounting does not reconcile: {agg}")
        if not report["identity_ok"]:
            raise AssertionError("scraped metrics identity does not hold at end of run")
        if metrics_json:
            traces = dict(final_scrape["traces"])
            traces["router"] = tel.tracer.chrome_trace()
            _write_metrics_json(metrics_json, {
                "mode": "fleet", "workers_spawned": workers,
                "workers": final_scrape["workers"],
                "report": report,
                "aggregate": {k: v for k, v in agg.items() if k != "per_tenant"},
                "per_tenant_reconciled": agg["per_tenant"],
                "midrun_series": len(midrun),
            }, traces)
        return agg["queries_issued"], agg["stream_steps"] - agg["queries_issued"]
    finally:
        router.close()


def serve(arch: str, variant: str = "smoke", batch: int = 4, prompt_len: int = 16,
          gen_tokens: int = 32, max_len: int = 128, seed: int = 0,
          teacher_latency: int = 1, teacher_jitter: int = 0,
          teacher_loss: float = 0.0, pending_capacity: int = 8,
          tenants: int = 1, backpressure: str = "drop_oldest",
          teacher: str = "latency", rpc_timeout_s: float = 5.0,
          teacher_batch_window_s: float = rpc.DEFAULT_BATCH_WINDOW_S,
          teacher_batch_max: int = rpc.DEFAULT_BATCH_MAX,
          teacher_secret: str = None, sched: str = "rr",
          snapshot_dir: str = None, snapshot_every: int = 0,
          resume: bool = False, migrate: bool = False,
          fuse_cohorts: bool = True, teacher_compress: bool = False,
          mesh_fleet: int = 0, metrics_json: str = None, device=None):
    """Prefill, then decode ``gen_tokens`` ticks feeding ``tenants`` ODL
    fleets; prints the per-tenant and aggregate report and returns
    ``(queries, skips)``.  Runs on ``device`` (CUDA unless named)."""
    explicit_device = device is not None
    device = resolve_device(device)
    # Process-level telemetry, cleared per run (serve() may be called twice
    # in one process, and stale tenant series must not leak).
    tel = telemetry.enable()
    tel.registry.clear()
    cfg = configs.get_config(arch, variant)
    params, prompts, state = build_backbone(cfg, batch, prompt_len, max_len, seed, device)

    odl_cfg = model_lib.core_config(cfg)
    if mesh_fleet:
        if tenants != 1:
            raise ValueError(
                "--mesh-fleet shards ONE fleet's stream axis across devices; "
                "it does not compose with --tenants > 1 (run one sharded "
                "process per tenant instead)")
        if snapshot_dir is not None or resume or migrate:
            raise ValueError(
                "--mesh-fleet does not compose with snapshots/resume/migrate "
                "(per-shard sessions are not snapshot-capable yet)")
        return _serve_mesh(
            cfg, odl_cfg, params, state, prompts, mesh_fleet=mesh_fleet,
            batch=batch, gen_tokens=gen_tokens, seed=seed,
            teacher=teacher, teacher_latency=teacher_latency,
            teacher_jitter=teacher_jitter, teacher_loss=teacher_loss,
            pending_capacity=pending_capacity, backpressure=backpressure,
            rpc_timeout_s=rpc_timeout_s,
            teacher_batch_window_s=teacher_batch_window_s,
            teacher_batch_max=teacher_batch_max,
            teacher_secret=teacher_secret, teacher_compress=teacher_compress,
            device=device, explicit_device=explicit_device, metrics_json=metrics_json,
        )
    durable = snapshot_dir is not None
    # One backbone decode feeds every tenant: tee the tick source N ways
    # (the scheduler keeps tenants within one time slice of each other, so
    # the tee buffer stays bounded by the quantum).
    shared = itertools.tee(_decode_feats(params, state, prompts, cfg, gen_tokens), tenants)
    if durable:
        # A *seekable* source per tenant: the live path keeps sharing the
        # one tee'd decode (cursor 0); only a resume (cursor k > 0) pays for
        # a fresh decode replayed to the snapshot's tick cursor.
        def make_feed(branch):
            def factory(start, branch=branch):
                if start == 0:
                    return branch
                return itertools.islice(
                    _decode_feats(params, state, prompts, cfg, gen_tokens), start, None)
            return snapshot.ResumableTicks(factory)

        feeds = [make_feed(b) for b in shared]
    else:
        feeds = shared

    with contextlib.ExitStack() as stack:
        def make_teacher(i):
            if teacher == "rpc":
                # Only the migration path lands here: a migrated tenant is
                # on a new host, so it gets a FRESH connection.
                client = rpc.BatchedRpcClient(
                    host, port, timeout_s=rpc_timeout_s, secret=teacher_secret,
                    batch_window_s=teacher_batch_window_s,
                    batch_max=teacher_batch_max, compress=teacher_compress,
                )
                stack.callback(client.close)
                return client.tenant(name=f"tenant{i}")
            return _latency_teacher(cfg, seed + i, teacher_latency, teacher_jitter, teacher_loss)

        if teacher == "rpc":
            host, port = stack.enter_context(
                rpc.loopback_server(n_out=cfg.odl.n_out, secret=teacher_secret)
            )
            # Every tenant with the same endpoint shares one batched connection.
            rpc_teachers, rpc_clients = multiplex.shared_rpc_teachers(
                [(host, port)] * tenants, timeout_s=rpc_timeout_s,
                secret=teacher_secret, batch_window_s=teacher_batch_window_s,
                batch_max=teacher_batch_max, compress=teacher_compress,
            )
            for client in rpc_clients:
                stack.callback(client.close)
            teachers = {f"tenant{i}": t for i, t in enumerate(rpc_teachers)}
        else:
            teachers = {f"tenant{i}": make_teacher(i) for i in range(tenants)}

        tenant_list = [
            multiplex.Tenant(
                name=f"tenant{i}",
                state=engine.init_fleet(odl_cfg, batch, device),
                ticks=feeds[i],
                cfg=odl_cfg,
                teacher=teachers[f"tenant{i}"],
                mode="serve",  # gate semantics: live drift detector
                capacity=pending_capacity,
                backpressure=backpressure,
                collect=False,  # long-running servers keep no history
                device=device,
            )
            for i in range(tenants)
        ]
        if resume and snapshot_dir is None:
            raise ValueError("--resume needs --snapshot-dir (nothing to restore from otherwise)")
        mux = multiplex.Multiplexer(
            tenant_list, sched=sched, snapshot_dir=snapshot_dir,
            snapshot_every=snapshot_every, resume=resume, fuse=fuse_cohorts,
            # Migration wants to stop mid-stream: schedule tick by tick.
            quantum=1 if migrate else multiplex.DEFAULT_QUANTUM,
        )
        if migrate:
            while mux.round():
                if mux.session("tenant0").t >= max(2, gen_tokens // 2):
                    break
            if mux.finished("tenant0"):
                print("tenant0 finished before the migration point "
                      "(--tokens too small); serving without migration")
                migrate = False
        if migrate:
            tree, rest_ticks = mux.extract("tenant0")
            results, agg = mux.run()  # finish the remaining tenants
            fresh = make_teacher(0)
            teachers["tenant0"] = fresh
            # pending="reask": the destination teacher is a new connection;
            # re-ask whatever is still in flight.
            mux_b = multiplex.Multiplexer([], sched=sched, pending="reask", fuse=fuse_cohorts)
            mux_b.admit(
                multiplex.Tenant(
                    name="tenant0", state=None, ticks=rest_ticks, cfg=odl_cfg,
                    teacher=fresh, mode="serve", capacity=pending_capacity,
                    backpressure=backpressure, collect=False, device=device,
                ),
                snapshot=tree,
                positioned=True,  # rest_ticks is extract()'s live iterator
            )
            results_b, agg_b = mux_b.run()
            migrated = results_b["tenant0"]
            print(f"tenant0 migrated at tick {snapshot.ticks_consumed(tree)} "
                  f"(re-asked {migrated.stats.tickets_reasked} in-flight "
                  f"tickets through the fresh teacher)")
            results = {**results, "tenant0": migrated}
            agg.stream_steps += agg_b.stream_steps
            agg.ticks += agg_b.ticks
            agg.wall_s += agg_b.wall_s
            agg.n_tenants = tenants
        else:
            results, agg = mux.run()

        # Pull every meter into the registry while the teachers are alive,
        # and scrape the label server's own counters over the wire.
        mux.sync_telemetry()
        if migrate:
            mux_b.sync_telemetry()
        label_server_stats = None
        if teacher == "rpc":
            for client in rpc_clients:
                client.sync_telemetry()
            label_server_stats = rpc.server_stats(host, port, secret=teacher_secret)

    report = _print_stream_report(telemetry.parse_prometheus(tel.registry.prometheus_text()))
    queries = report["queries_issued"]
    skips = report["stream_steps"] - report["queries_issued"]
    for name in sorted(results):  # details the registry doesn't carry
        r = results[name]
        s = r.stats
        meter_kb = float(r.state.meter.total.sum()) / 1e3
        rpc_note = f"; rpc timeouts {teachers[name].timed_out}" if teacher == "rpc" else ""
        print(f"  {name}: tick p50/p95 {s.tick_p50_ms:.2f}/{s.tick_p95_ms:.2f}"
              f" ms; label latency p50/p95 {s.label_latency_p50:.0f}/"
              f"{s.label_latency_p95:.0f} ticks; "
              f"{meter_kb:.1f} kB metered{rpc_note}")
        if not s.reconciled:
            raise AssertionError(f"{name}: query accounting does not reconcile: {s.summary()}")
    if not report["identity_ok"]:
        raise AssertionError("scraped metrics identity does not hold")
    if label_server_stats is not None:
        _print_label_server_stats(label_server_stats)
    caches = stream.cache_stats()["plan_runner"]
    extras = f", sched={sched}"
    if durable:
        extras += f", snapshots under {snapshot_dir} every {snapshot_every} ticks"
    print(f"aggregate: {tenants} tenant(s) x {gen_tokens} tokens x {batch} streams "
          f"= {agg.stream_steps} steps in {agg.wall_s:.2f}s "
          f"({agg.steps_per_s:,.0f} steps/s); backpressure={backpressure}, "
          f"teacher={teacher}{extras}; plan-runner cache "
          f"{caches['hits']} hits / {caches['misses']} misses "
          f"(tenants share executables); device {device}")
    if metrics_json:
        _write_metrics_json(metrics_json, {
            "mode": "solo", "tenants": tenants, "tokens": gen_tokens,
            "report": report,
            "aggregate": {"stream_steps": agg.stream_steps,
                          "wall_s": agg.wall_s,
                          "steps_per_s": agg.steps_per_s},
            "prometheus": tel.registry.prometheus_text(),
            "registry": tel.registry.snapshot(),
            "label_server": label_server_stats,
        }, {"": tel.tracer.chrome_trace()})
    return queries, skips


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.ARCH_IDS)
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tenants", type=int, default=1,
                    help="independent ODL fleets multiplexed over this process")
    ap.add_argument("--backpressure", default="drop_oldest",
                    choices=stream.BACKPRESSURE_POLICIES,
                    help="pending-ring saturation policy (per tenant)")
    ap.add_argument("--sched", default="rr", choices=multiplex.SCHEDULERS,
                    help="rr: fixed quantum-tick round robin; drr: deficit "
                    "round robin in stream-step units (size-fair)")
    ap.add_argument("--fuse-cohorts", default="on", choices=("on", "off"),
                    help="stack same-shaped tenants into one batched "
                    "plan/learn dispatch per quantum (bit-for-bit identical "
                    "to unfused; off: one dispatch per tenant)")
    ap.add_argument("--teacher", default="latency", choices=("latency", "rpc"),
                    help="latency: in-process tick-granular model; "
                    "rpc: loopback TCP label server with timeout->loss")
    ap.add_argument("--teacher-latency", type=int, default=1,
                    help="teacher answer latency in decode ticks")
    ap.add_argument("--teacher-jitter", type=int, default=0,
                    help="extra uniform per-ticket latency in [0, J] ticks")
    ap.add_argument("--teacher-loss", type=float, default=0.0,
                    help="fraction of tickets silently lost by the teacher")
    ap.add_argument("--teacher-secret", default=None,
                    help="shared secret: HMAC-authenticate the rpc teacher "
                    "connection (both ends)")
    ap.add_argument("--rpc-timeout", type=float, default=5.0,
                    help="rpc teacher reply deadline in wall seconds")
    ap.add_argument("--teacher-batch-window", type=float,
                    default=rpc.DEFAULT_BATCH_WINDOW_S * 1e3,
                    help="rpc ask-coalescing flush window in ms (0 sends one "
                    "frame per ask)")
    ap.add_argument("--teacher-batch-max", type=int, default=rpc.DEFAULT_BATCH_MAX,
                    help="max asks coalesced into one rpc frame")
    ap.add_argument("--teacher-compress", action="store_true",
                    help="wrap rpc frames in zlib envelopes (negotiated in "
                    "the HMAC handshake when --teacher-secret is set)")
    ap.add_argument("--mesh-fleet", type=int, default=0,
                    help="shard the (single) tenant's stream axis over this "
                    "many mesh entries — every visible card, or --device N "
                    "times; 0: off")
    ap.add_argument("--pending-capacity", type=int, default=8,
                    help="in-flight query ring capacity (see --backpressure)")
    ap.add_argument("--snapshot-dir", default=None,
                    help="publish per-tenant session snapshots here "
                    "(atomic, keep-k) — enables --resume")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot cadence in decode ticks (0: only explicit)")
    ap.add_argument("--resume", action="store_true",
                    help="restore every tenant from its latest published "
                    "snapshot under --snapshot-dir")
    ap.add_argument("--migrate", action="store_true",
                    help="demo: quiesce+snapshot tenant0 mid-stream and "
                    "restore it into a second multiplexer behind a fresh "
                    "teacher connection")
    ap.add_argument("--workers", type=int, default=0,
                    help="elastic fleet mode: spin this many multiplexer "
                    "worker subprocesses behind the shape-aware router; "
                    "0: single-process serve")
    ap.add_argument("--fleet-ticks", default="synth", choices=("synth", "decode"),
                    help="fleet tick source: synth (per-tick-seeded "
                    "features, O(1) seek) or decode (each worker drives "
                    "the real backbone)")
    ap.add_argument("--fleet-tick-sleep", type=float, default=1.0,
                    help="per-tick sleep in ms (keeps tenants mid-stream "
                    "long enough to migrate)")
    ap.add_argument("--worker-capacity", type=int, default=None,
                    help="max live tenants per worker (default: spread "
                    "--tenants evenly over --workers)")
    ap.add_argument("--no-fleet-migrate", action="store_true",
                    help="fleet mode: skip the mid-stream live migration")
    ap.add_argument("--no-fleet-drain", action="store_true",
                    help="fleet mode: skip the scale-in worker drain")
    ap.add_argument("--snapshot-full-every", type=int, default=8,
                    help="worker cadence saves ship only changed leaves; "
                    "every k-th save is full (1: all saves full)")
    ap.add_argument("--metrics-json", default=None, metavar="PATH",
                    help="write run metrics (registry snapshot + Prometheus "
                    "text + per-tenant report) to PATH, plus Chrome "
                    "trace_event files PATH.<tag>.trace.json")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: CUDA; with no CUDA "
                    "device it exits before serving)")
    args = ap.parse_args(argv)
    # No card and no --device: fail here, before anything is built.
    resolve_device(args.device)
    if args.workers:
        return serve_fleet(
            workers=args.workers, tenants=args.tenants, batch=args.batch,
            gen_tokens=args.tokens, fleet_ticks=args.fleet_ticks,
            arch=args.arch, variant=args.variant, seed=args.seed,
            tick_sleep_ms=args.fleet_tick_sleep,
            teacher_latency=args.teacher_latency,
            teacher_jitter=args.teacher_jitter,
            teacher_loss=args.teacher_loss,
            pending_capacity=args.pending_capacity,
            backpressure=args.backpressure,
            worker_capacity=args.worker_capacity,
            migrate=not args.no_fleet_migrate,
            drain=not args.no_fleet_drain,
            snapshot_full_every=args.snapshot_full_every,
            metrics_json=args.metrics_json, device=args.device)
    return serve(
        args.arch, args.variant, batch=args.batch, gen_tokens=args.tokens,
        seed=args.seed, teacher_latency=args.teacher_latency,
        teacher_jitter=args.teacher_jitter, teacher_loss=args.teacher_loss,
        pending_capacity=args.pending_capacity, tenants=args.tenants,
        backpressure=args.backpressure, teacher=args.teacher,
        rpc_timeout_s=args.rpc_timeout,
        teacher_batch_window_s=args.teacher_batch_window / 1e3,
        teacher_batch_max=args.teacher_batch_max,
        teacher_secret=args.teacher_secret, sched=args.sched,
        snapshot_dir=args.snapshot_dir, snapshot_every=args.snapshot_every,
        resume=args.resume, migrate=args.migrate,
        fuse_cohorts=args.fuse_cohorts == "on",
        teacher_compress=args.teacher_compress,
        mesh_fleet=args.mesh_fleet, metrics_json=args.metrics_json,
        device=args.device)


if __name__ == "__main__":
    main()
