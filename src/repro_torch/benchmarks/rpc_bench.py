"""The teacher transports on the port, against a loopback ``LabelServer``
(counterpart of the JAX package's ``benchmarks/rpc_bench.py``, at its
shapes: n_in=64, N=64, m=6; S=64 streams per tenant, T=200 ticks).

N ∈ {1, 2, 4} tenants multiplexed in one process, each transport in turn:

* ``per_tenant_v1``: one ``RpcTeacher`` connection per tenant, newline JSON;
* ``per_tenant``: one connection per tenant, v2 binary frames;
* ``batched``: one shared ``BatchedRpcClient`` connection for all tenants
  (``multiplex.shared_rpc_teachers``), asks coalesced within the flush
  window.

Reported per transport: request messages on the wire, request bytes per
query, messages per applied label, and aggregate stream·ticks/s (best of
``--iters``, after a warm-up run).  A ``faults`` pass per N (the server
loses 15 % of the asks and jitters replies by up to 2 ms, the client's
deadline is 0.5 s) checks that every tenant's accounting reconciles exactly
and that the deadline mapped silence to loss.  Coalescing depends on the
wall clock (a tick against the flush window), so only counts and identities
are checked, never a ratio of messages.

The tenants run on CUDA unless ``--device`` names another device; the
label server answers from numpy.  Writes ``bench_artifacts/BENCH_rpc_torch.json``
(``_quick`` with ``--quick``: 2 tenants, S=16, T=48), never the JAX
package's committed ``BENCH_rpc*.json``.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.rpc_bench [--device cpu] [--quick]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import pathlib
import time

import numpy as np
import torch

from repro_torch import engine, resolve_device
from repro_torch.core import drift as drift_mod
from repro_torch.core import oselm, pruning
from repro_torch.engine import multiplex, rpc

N_IN, N_HIDDEN, N_OUT = 64, 64, 6
TRANSPORTS = ("per_tenant_v1", "per_tenant", "batched")
ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "bench_artifacts"


def _cfg() -> engine.EngineConfig:
    return engine.EngineConfig(
        elm=oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, variant="hash",
                              ridge=1e-2),
        prune=pruning.PruneConfig(min_trained=8),
        drift=drift_mod.DriftConfig(),
    )


def _data(t: int, s: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_once(transport, cfg, tenant_data, device, capacity=32, timeout_s=10.0,
             window_s=5e-3, batch_max=64, loss=0.0, jitter_s=0.0, compress=False,
             wrap=None, subprocess_server=False):
    """One multiplexed run of every tenant over ``transport`` against a fresh
    server: in process, or with ``subprocess_server`` a ``loopback_server``
    child whose counters are scraped over the wire.  ``compress`` asks for
    zlib envelopes; ``wrap``, if given, is applied to each tenant's teacher
    (a label checker, say) before the run.  Returns (wall s, results, wire
    messages, wire bytes, server stats).  Every tenant must reconcile and
    the server must see no frame error."""
    device = resolve_device(device)
    n_out = cfg.elm.n_out
    with contextlib.ExitStack() as stack:
        if subprocess_server:
            host, port = stack.enter_context(
                rpc.loopback_server(n_out=n_out, loss_prob=loss, jitter_s=jitter_s))

            def server_stats():
                return rpc.server_stats(host, port)
        else:
            server = rpc.LabelServer(n_out=n_out, loss_prob=loss, jitter_s=jitter_s,
                                     seed=0).start()
            stack.callback(server.close)
            host, port, server_stats = "127.0.0.1", server.port, server.stats
        n = len(tenant_data)
        if transport == "batched":
            teachers, clients = multiplex.shared_rpc_teachers(
                [(host, port)] * n, timeout_s=timeout_s, batch_window_s=window_s,
                batch_max=batch_max, compress=compress)
            for c in clients:
                stack.callback(c.close)
        else:
            wire = "v1" if transport == "per_tenant_v1" else "v2"
            clients = []
            for _ in range(n):
                clients.append(rpc.RpcTeacher(host, port, timeout_s=timeout_s, wire=wire,
                                              compress=compress))
                stack.callback(clients[-1].close)
            teachers = clients
        if wrap is not None:
            teachers = [wrap(t) for t in teachers]
        tenants = [
            multiplex.Tenant(name=f"tenant{i}", state=engine.init_fleet(cfg, xs.shape[1], device),
                             ticks=iter(xs), cfg=cfg, teacher=teachers[i], mode="train_phase",
                             capacity=capacity, collect=False)
            for i, xs in enumerate(tenant_data)
        ]
        _sync(device)
        t0 = time.perf_counter()
        results, _ = multiplex.run(tenants)
        _sync(device)
        dt = time.perf_counter() - t0
        for r in results.values():
            if not r.stats.reconciled:
                raise AssertionError(f"{transport}: accounting does not reconcile: "
                                     f"{r.stats.summary()}")
        sstats = server_stats()
        if sstats["frame_errors"]:
            raise AssertionError(f"{transport}: {sstats['frame_errors']} frame errors")
        msgs = sum(c.wire_messages for c in clients)
        nbytes = sum(c.wire_bytes for c in clients)
        return dt, results, msgs, nbytes, sstats


def bench_transport(transport, cfg, tenant_data, device, iters, **kw):
    """Best-of-``iters`` wall time after a warm-up run (graph captures on
    the card); the wire counters come from the best run."""
    run_once(transport, cfg, tenant_data, device, **kw)
    best = None
    gc.collect()
    gc.disable()
    try:
        for _ in range(iters):
            out = run_once(transport, cfg, tenant_data, device, **kw)
            if best is None or out[0] < best[0]:
                best = out
    finally:
        gc.enable()
    return best


def bench(device, tenant_counts=(1, 2, 4), s=64, t=200, iters=3, window_ms=5.0, batch_max=64,
          log=print) -> list[dict]:
    """The rows of the benchmark: one per tenant count, each with every
    transport's wire counts and rate, and the faults pass."""
    device = resolve_device(device)
    cfg = _cfg()
    window_s = window_ms / 1e3
    rows = []
    for n in tenant_counts:
        tenant_data = [_data(t, s, seed=i) for i in range(n)]
        steps = n * t * s
        row = {"tenants": n, "streams": s, "ticks": t, "n_hidden": N_HIDDEN,
               "batch_window_ms": window_ms, "batch_max": batch_max,
               "quantum": multiplex.DEFAULT_QUANTUM, "transports": {}}
        for transport in TRANSPORTS:
            dt, results, msgs, nbytes, _ = bench_transport(
                transport, cfg, tenant_data, device, iters, window_s=window_s,
                batch_max=batch_max)
            queries = sum(r.stats.queries_issued for r in results.values())
            labels = sum(r.stats.labels_applied for r in results.values())
            d = row["transports"][transport] = {
                "steps_per_s": steps / dt,
                "wire_messages": msgs,
                "wire_bytes": nbytes,
                "bytes_per_query": nbytes / max(queries, 1),
                "messages_per_label": msgs / max(labels, 1),
                "labels_applied": labels,
            }
            log(f"N={n} {transport:>14}: {d['steps_per_s']:>12,.0f} stream·ticks/s | "
                f"{msgs:5d} msgs | {d['bytes_per_query']:8.1f} B/query | "
                f"{d['messages_per_label']:.4f} msg/label")
        row["faults"] = {}
        for transport in ("per_tenant", "batched"):
            _, results, _, _, sstats = run_once(
                transport, cfg, tenant_data, device, timeout_s=0.5, window_s=window_s,
                batch_max=batch_max, loss=0.15, jitter_s=2e-3)
            per = {name: {"queries_issued": r.stats.queries_issued,
                          "labels_applied": r.stats.labels_applied,
                          "queries_dropped": r.stats.queries_dropped,
                          "queries_lost": r.stats.queries_lost,
                          "reconciled": r.stats.reconciled}
                   for name, r in sorted(results.items())}
            if not any(v["queries_lost"] > 0 for v in per.values()):
                raise AssertionError(f"faults {transport}: no query was lost")
            row["faults"][transport] = {"tenants": per, "asks_served": sstats["asks_served"]}
        log(f"N={n}    faults (loss 0.15, jitter 2 ms, deadline 0.5 s): every tenant "
            "reconciles")
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="2 tenants, S=16, T=48")
    ap.add_argument("--device", default=None, help="device of the tenants (default: cuda)")
    ap.add_argument("--window-ms", type=float, default=5.0, help="batched flush window")
    ap.add_argument("--batch-max", type=int, default=64)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    counts, s, t = ((2,), 16, 48) if args.quick else ((1, 2, 4), 64, 200)
    print(f"== RPC transport on {device} ({'quick' if args.quick else 'full'}: S={s}, T={t}, "
          f"window={args.window_ms} ms, batch_max={args.batch_max}) ==")
    rows = bench(device, counts, s, t, args.iters, args.window_ms, args.batch_max)
    out = pathlib.Path(args.out) if args.out else (
        ARTIFACT_DIR / f"BENCH_rpc_torch{'_quick' if args.quick else ''}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    out.write_text(json.dumps({"bench": "rpc", "device": str(device), "kind": kind,
                               "rows": rows}, indent=2) + "\n")
    print(f"wrote {out}")
    return rows


if __name__ == "__main__":
    main()
