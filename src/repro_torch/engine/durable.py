"""Durable sessions: cadence snapshots, resume, crash-restart smoke
(PyTorch counterpart of ``repro/engine/durable.py``).

Thin glue over ``engine/snapshot.py`` for the single-tenant case:
``run_durable`` is ``stream.run`` plus a periodic
``CheckpointManager``-published snapshot and a ``resume=True`` path that
restores the latest published snapshot and seeks the tick source to the
recorded cursor.  The multi-tenant equivalents (per-tenant snapshot
directories, ``run_supervised``, live tenant migration) live in
``engine/multiplex.py``.

This module is also the kill-and-resume proof, runnable standalone::

    PYTHONPATH=src python -m repro_torch.engine.durable --crash-smoke

spawns a child (``--smoke-child``) multiplexing two lossy tenants with
cadence snapshots, SIGKILLs it mid-stream once snapshots are published,
resumes from the snapshot directory, and asserts that every tenant
completes with the query-accounting identity intact.  Parent and child run
on the card; ``--device cpu`` runs both on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time
from typing import Iterable, Optional

import numpy as np

from repro_torch.engine import multiplex, snapshot, stream
from repro_torch.engine.types import EngineConfig, EngineState
from repro_torch.runtime.checkpoint import CheckpointManager


def run_durable(
    state: Optional[EngineState],
    ticks: Iterable,
    cfg: EngineConfig,
    teacher: stream.Teacher,
    snapshot_dir: str,
    snapshot_every: int = 1000,
    resume: bool = False,
    keep: int = 3,
    mode: str = "algo1",
    capacity: int = 64,
    backpressure: str = "drop_oldest",
    collect: bool = True,
    drain: bool = True,
    donate: Optional[bool] = None,
    device=None,
):
    """``stream.run`` with durability: every ``snapshot_every`` ticks the
    session is captured and published atomically (keep-``keep``) under
    ``snapshot_dir``.  With ``resume=True`` and a published snapshot, the
    run restores it (on ``device``: the device of ``state`` when that is
    given and ``device`` is None, else CUDA unless named); the tick source
    must then be seekable (``snapshot.ResumableTicks``).  A teacher that
    supports ``restore_snapshot`` (e.g. ``LatencyTeacher``) resumes bit for
    bit, any other teacher gets the in-flight ring re-asked.

    Returns ``(final state, outputs, stats)`` exactly like ``stream.run``.
    """
    manager = CheckpointManager(snapshot_dir, keep=keep)
    sess = None
    if resume and manager.latest_step() is not None:
        _, tree = manager.restore()
        if device is None and state is not None:
            device = state.elm.P.device
        sess = stream.StreamSession.restore(tree, teacher, cfg=cfg, device=device)
        snapshot.seek_ticks(ticks, snapshot.ticks_consumed(tree))
    if sess is None:
        if state is None:
            raise ValueError("no state and no snapshot to resume from")
        sess = stream.StreamSession(
            state, cfg, teacher, mode=mode, capacity=capacity,
            backpressure=backpressure, collect=collect, donate=donate,
        )
    last_snap = sess.t
    it = iter(ticks)
    if not sess.started():
        x0 = next(it, None)
        if x0 is not None:
            sess.start(x0)
    # A started session always has a planned tick pending (``_p``) until the
    # source is exhausted: the same double-buffered drive as ``stream.run``,
    # except that it also works for a session restored mid-stream.
    try:
        while sess._p is not None:
            nxt = next(it, None)
            sess.advance(nxt)
            if snapshot_every > 0 and sess.t - last_snap >= snapshot_every:
                manager.save_async(sess.t, sess.snapshot())
                last_snap = sess.t
    finally:
        # Settle any in-flight background write before returning OR before a
        # crash propagates: a restarted attempt must never race an orphaned
        # writer thread for the same step directory.
        manager.wait()
    return sess.finish(drain=drain)


# ---------------------------------------------------------------------------
# Kill-and-resume smoke: two lossy tenants, SIGKILL, resume, reconcile
# ---------------------------------------------------------------------------

_SMOKE_TENANTS = 2
_SMOKE_S = 8
_N_IN, _N_HIDDEN, _N_OUT = 16, 16, 4


def _smoke_cfg() -> EngineConfig:
    from repro_torch.core import drift as drift_mod
    from repro_torch.core import oselm, pruning

    return EngineConfig(
        elm=oselm.OSELMConfig(
            n_in=_N_IN, n_hidden=_N_HIDDEN, n_out=_N_OUT, variant="hash", ridge=1e-2
        ),
        prune=pruning.PruneConfig(min_trained=1_000_000),  # cold: every tick asks
        drift=drift_mod.DriftConfig(),
    )


def _smoke_data(t_len: int, seed: int):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.normal(size=(t_len, _SMOKE_S, _N_IN))).astype(np.float32)
    ys = rng.integers(0, _N_OUT, size=(t_len, _SMOKE_S)).astype(np.int32)
    return xs, ys


def _smoke_tenants(t_len: int, tick_sleep_s: float, device):
    """Fresh tenant list, deterministic across processes (seeded data and
    teachers; resumed teachers restore their RNG from the snapshot)."""
    from repro_torch.engine import fleet

    cfg = _smoke_cfg()
    tenants = []
    for i in range(_SMOKE_TENANTS):
        xs, ys = _smoke_data(t_len, seed=100 + i)

        def factory(start, xs=xs):
            for t in range(start, len(xs)):
                if tick_sleep_s > 0:
                    time.sleep(tick_sleep_s)
                yield xs[t]

        tenants.append(
            multiplex.Tenant(
                name=f"tenant{i}",
                state=fleet.init_fleet(cfg, _SMOKE_S, device),
                ticks=snapshot.ResumableTicks(factory),
                cfg=cfg,
                teacher=stream.LatencyTeacher(
                    stream.array_labels(ys), latency=2, jitter=2,
                    loss_prob=0.2, partial_prob=0.1, seed=7 + i,
                ),
                mode="train_phase",
                capacity=4,
                backpressure=("drop_oldest", "coalesce")[i % 2],
                collect=False,
            )
        )
    return tenants


def _smoke_run(snapshot_dir: str, ticks: int, snapshot_every: int,
               tick_sleep_s: float, resume: bool, device) -> dict:
    results, agg = multiplex.run(
        _smoke_tenants(ticks, tick_sleep_s, device),
        snapshot_dir=snapshot_dir,
        snapshot_every=snapshot_every,
        resume=resume,
    )
    report = {}
    for name, r in sorted(results.items()):
        s = r.stats
        report[name] = {
            "ticks": s.ticks,
            "queries_issued": s.queries_issued,
            "labels_applied": s.labels_applied,
            "queries_lost": s.queries_lost,
            "queries_dropped": s.queries_dropped,
            "queries_coalesced": s.queries_coalesced,
            "tickets_reasked": s.tickets_reasked,
            "reconciled": s.reconciled,
        }
    return report


def _crash_smoke(ticks: int, snapshot_every: int, device: Optional[str]) -> int:
    """Phase 1: a child runs slowly with cadence snapshots; the parent
    SIGKILLs it once every tenant has a published snapshot.  Phase 2: resume
    in this process from the snapshot directory, run to completion, and
    check that every tenant reconciles."""
    from repro_torch import resolve_device

    device = str(resolve_device(device))  # no card and none named: raise here
    src_root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="durable_smoke_") as d:
        child = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.engine.durable", "--smoke-child",
             "--dir", d, "--ticks", str(ticks), "--device", device,
             "--snapshot-every", str(snapshot_every), "--tick-sleep-ms", "5"],
            env=env,
        )
        try:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                published = [
                    name
                    for name in os.listdir(d)
                    if CheckpointManager(os.path.join(d, name)).latest_step() is not None
                ]
                if len(published) >= _SMOKE_TENANTS:
                    break
                if child.poll() is not None:
                    raise RuntimeError(
                        "smoke child exited before any snapshot was published "
                        f"(rc={child.returncode}): nothing to kill"
                    )
                time.sleep(0.05)
            else:
                raise RuntimeError("timed out waiting for snapshots")
            child.send_signal(signal.SIGKILL)  # crash mid-stream, mid-anything
            child.wait(timeout=30)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait(timeout=30)
        report = _smoke_run(d, ticks, snapshot_every, tick_sleep_s=0.0, resume=True,
                            device=device)
        # odlint: disable=ODL005 -- CI crash-smoke CLI prints its report
        print(json.dumps(report, indent=2))
        for name, r in report.items():
            if not r["reconciled"]:
                raise AssertionError(f"{name}: accounting broken after resume: {r}")
            if r["ticks"] != ticks:
                raise AssertionError(f"{name}: resumed run incomplete: {r}")
            if r["labels_applied"] <= 0:
                raise AssertionError(f"{name}: resumed run never trained")
    # odlint: disable=ODL005 -- CI crash-smoke CLI status line
    print(f"crash smoke OK on {device}: {_SMOKE_TENANTS} tenants killed mid-stream, "
          f"resumed from snapshots, accounting reconciled")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--crash-smoke", action="store_true",
                    help="SIGKILL a snapshotting child mid-stream, resume, "
                    "check that the accounting identity reconciles")
    ap.add_argument("--smoke-child", action="store_true",
                    help="(internal) run the lossy multi-tenant workload")
    ap.add_argument("--dir", default=None, help="snapshot directory")
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--snapshot-every", type=int, default=25)
    ap.add_argument("--tick-sleep-ms", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="device of the run (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    if args.crash_smoke:
        return _crash_smoke(args.ticks, args.snapshot_every, args.device)
    if args.smoke_child:
        if not args.dir:
            ap.error("--smoke-child needs --dir")
        report = _smoke_run(
            args.dir, args.ticks, args.snapshot_every,
            tick_sleep_s=args.tick_sleep_ms / 1000.0, resume=args.resume, device=args.device,
        )
        # odlint: disable=ODL005 -- smoke-child CLI: parent parses stdout
        print(json.dumps(report, indent=2))
        return 0
    ap.error("choose --crash-smoke or --smoke-child")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
