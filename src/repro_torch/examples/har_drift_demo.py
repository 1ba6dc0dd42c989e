"""Full Algorithm-1 demo on the port's streaming runtime: ticks arrive one
at a time, teacher answers arrive late.

A sensor stream starts with known-subject data (predicting mode), then the
distribution shifts to the held-out subjects.  The core detects the drift,
enters training mode, acquires labels through the auto-pruned teacher
channel, converges, and drops back to predicting mode: the complete loop of
the paper's Fig. 2/Algorithm 1, plus the Fig. 4 power accounting.

Part two scales the same loop to a fleet: S users hit the drift at
different severities and a laggy, jittery teacher answers out of order
while ``repro_torch.engine.stream.run`` keeps every stream's detector,
pruner and head moving (its per-tick runners replay as CUDA graphs on the
card); ``engine.run_fleet`` runs the same ticks offline (one CUDA graph
replay a chunk on the card) for the throughput comparison.  Counterpart of the JAX package's
``examples/har_drift_demo.py``.

Run:  python -m repro_torch.examples.har_drift_demo [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import engine, resolve_device
from repro_torch.core import drift, labels, oselm, power_model, pruning
from repro_torch.data import har
from repro_torch.engine import stream

CALM = 400


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Algorithm 1 on the stream runtime")
    ap.add_argument("--device", default=None, help="default: cuda")
    device = resolve_device(ap.parse_args(argv).device)
    data = har.generate(seed=0)
    elm = oselm.OSELMConfig(n_in=561, n_hidden=128, n_out=6, variant="hash")
    cfg = engine.EngineConfig(
        elm=elm,
        prune=pruning.PruneConfig.for_hidden(128),
        drift=drift.DriftConfig(warmup=48, k_sigma=3.0, enter_hits=2, exit_calm=64),
    )
    on = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    core = engine.init_state(cfg, device)._replace(
        elm=oselm.init_state_batch(elm, on(data.train_x), labels.one_hot(on(data.train_y), 6))
    )

    # ---- Part one: one stream, zero-latency teacher (the paper's loop). ---
    ticks, ys = har.drift_tick_stream(data, n_streams=1, seed=0, calm=CALM, severities=[2.0])
    t_total = len(ys)
    teacher = stream.LatencyTeacher(stream.array_labels(ys), latency=0)
    st, outs, _ = stream.run(
        engine.broadcast_streams(core, 1), ticks, cfg, teacher, mode="algo1"
    )

    training = outs.mode_training[:, 0]
    queried = outs.queried[:, 0]
    first_train = int(training.argmax()) if training.any() else -1
    print(f"stream length          : {t_total} samples (shift at {CALM})")
    print(f"drift detected at      : sample {first_train}")
    print(f"training-mode samples  : {int(training.sum())}")
    print(f"teacher queries        : {int(queried.sum())} "
          f"({100*queried.sum()/max(training.sum(),1):.1f}% of training mode)")

    # Fig. 4-style power accounting at one event per second.
    comm = float(queried.sum() / max(training.sum(), 1))
    for period in (1.0, 5.0, 10.0):
        mw = power_model.avg_power_mw(comm, period)
        red = power_model.power_reduction_pct(comm, period)
        print(f"power @ 1 ev/{period:>4.0f}s     : {mw:6.3f} mW "
              f"({red:4.1f}% saved vs no pruning)")

    # ---- Part two: fleet of S streams, laggy out-of-order teacher. --------
    n_streams = 8
    severities = np.linspace(1.2, 2.6, n_streams)
    ticks, ys = har.drift_tick_stream(
        data, n_streams=n_streams, seed=0, calm=CALM, severities=severities
    )
    fstate0 = engine.broadcast_streams(core, n_streams)
    lag_teacher = stream.LatencyTeacher(stream.array_labels(ys), latency=3, jitter=4, seed=1)
    fstate, fouts, stats = stream.run(
        fstate0, ticks, cfg, lag_teacher, mode="algo1", capacity=32
    )

    print(f"\nfleet of {n_streams} streams    : {stats.steps_per_s:,.0f} stream-steps/s "
          f"(streaming, teacher latency 3+U[0,4] ticks)")
    print(f"tick latency           : p50 {stats.tick_p50_ms:.2f} ms, "
          f"p95 {stats.tick_p95_ms:.2f} ms")
    print(f"label latency          : p50 {stats.label_latency_p50:.0f} ticks, "
          f"p95 {stats.label_latency_p95:.0f} ticks; "
          f"{stats.labels_applied}/{stats.queries_issued} queries answered, "
          f"{stats.tickets_dropped} tickets dropped")
    for s in range(n_streams):
        tr = fouts.mode_training[:, s]
        det = int(tr.argmax()) if tr.any() else -1
        prune_s = engine.stream_slice(fstate, s).prune
        print(f"  stream {s} (x{severities[s]:.1f} shift): drift at {det:4d}, "
              f"queries {int(fstate.prune.queries[s]):4d}, "
              f"comm {float(pruning.comm_volume_fraction(prune_s)):.2f}")

    # Offline comparison: the same ticks through run_fleet's chunk runner.
    ticks2, ys2 = har.drift_tick_stream(
        data, n_streams=n_streams, seed=0, calm=CALM, severities=severities
    )
    fleet_xs = on(np.stack(list(ticks2)))
    fleet_ys = on(ys2)
    # Warm-up at every chunk shape the timed run replays (on the card each
    # is captured once): the chunk and the ragged tail.
    chunk = engine.CHUNK_TICKS
    for n in {chunk, fleet_xs.shape[0] % chunk} - {0}:
        engine.run_fleet(engine.broadcast_streams(core, n_streams), fleet_xs[:n],
                         fleet_ys[:n], cfg, mode="algo1", chunk=chunk)
    _sync(device)
    t0 = time.perf_counter()
    engine.run_fleet(engine.broadcast_streams(core, n_streams), fleet_xs, fleet_ys, cfg,
                     mode="algo1", chunk=chunk)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"\noffline run_fleet      : {fleet_xs.shape[0] * n_streams / dt:,.0f} "
          f"stream-steps/s (offline, chunked)")


if __name__ == "__main__":
    main()
