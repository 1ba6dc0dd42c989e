"""The port's elastic fleet (``repro_torch.runtime.worker`` and
``repro_torch.runtime.elastic``): cross-process live migration over the
snapshot wire codec, worker drain (scale-in), shape-affinity routing, and
the control wire against the JAX package's.

Mirrors the nine tests of ``tests/test_elastic.py`` at its sizes (n_in=24,
N=16, m=4, S=4, T=400), with port workers spawned on the CPU
(``device="cpu"``).  The migration lock: a tenant extracted on worker A,
shipped over the wire and admitted on worker B is **bit for bit** the same
tenant run solo, uninterrupted, in this process (final state, every
deterministic counter, the label-latency history).  Per-tick-seeded synth
features and the snapshot-carried ``LatencyTeacher`` state make that
comparable across processes.

Against the JAX package: the spec builders, the synth ticks, the shape key
and the config codec are equal (byte for byte where they are bytes); the
JAX package's ``WorkerClient`` drives a port worker; and a tenant extracted
from a JAX worker finishes on a port worker with the JAX solo run's
counters (``train_phase`` with ``min_trained`` 1e6: every stream queries
every tick, so no decision depends on rounding), the JAX solo run's state
within the ROADMAP's tolerances (integers exact, floats rtol and atol 2e-3:
P starts at I/ridge), and the state of an in-process JAX-to-port restore of
the same cut, bit for bit.

A ``decode`` tenant (one smoke-width backbone decode step per tick) moves
between two port workers and ends bit for bit as the in-process session
fed by ``launch.serve._decode_feats``: both workers draw the backbone from
the spec's seed with process-stable generators.

The port's worker runs every control command on its scheduler thread
between two rounds, so a command never waits out a tenant's run (the
reference's worker can make it, hence that file's races); the cuts below
land as asked.  Tests marked ``cuda`` run on the card and skip elsewhere:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_elastic.py
"""

import dataclasses
import importlib.util
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

# Where JAX is installed the JAX package must import (a broken reference
# fails here); on a machine without it the cross-package tests skip.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.engine import snapshot as j_snapshot
    from repro.engine import stream as j_stream
    from repro.runtime import elastic as j_elastic
    from repro.runtime import worker as j_worker

from repro_torch import engine  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.engine import multiplex, rpc, snapshot, stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime import worker as worker_mod  # noqa: E402

# Wall-clock fields (tick_ms, wall_s, tick_rate_ema, ring HWM timing) can't
# match across runs; everything here must.
DETERMINISTIC_STATS = (
    "ticks", "stream_steps", "tickets_issued", "queries_issued",
    "labels_applied", "tickets_dropped", "queries_dropped",
    "replies_orphaned", "tickets_lost", "queries_lost",
    "tickets_coalesced", "queries_coalesced", "asks_deferred",
    "tickets_reasked",
)

T_TOTAL = 400
# Migrate once every tenant has passed this tick.
CUT_AT = 40
CPU = "cpu"


def _spawn_cpu_worker(name):
    """A port worker on the CPU with one intra-op thread, as this process
    runs its solo references: a worker with a thread per core would only
    spin on these shapes and crowd the other tests running beside it."""
    return elastic.spawn_worker(
        name, quantum=1, device=CPU, env=dict(os.environ, OMP_NUM_THREADS="1")
    )


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _cfg(pkg_engine=engine, pkg_oselm=oselm, pkg_pruning=pruning, pkg_drift=drift_mod):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(
            n_in=24, n_hidden=16, n_out=4, variant="hash", ridge=1e-2
        ),
        prune=pkg_pruning.PruneConfig(min_trained=1_000_000),
        drift=pkg_drift.DriftConfig(),
    )


def _jcfg():
    return _cfg(j_engine, j_oselm, j_pruning, j_drift)


def _spec(name, policy, seed, tick_sleep_ms=3.0, pkg=worker_mod, cfg=None):
    return pkg.tenant_spec(
        name, cfg if cfg is not None else _cfg(), s=4, mode="train_phase", capacity=4,
        backpressure=policy,
        ticks=pkg.synth_ticks_spec(
            seed=seed, t_total=T_TOTAL, tick_sleep_ms=tick_sleep_ms
        ),
        teacher=pkg.latency_teacher_spec(
            n_out=4, latency=2, jitter=2, loss=0.2, partial=0.15, seed=seed
        ),
    )


def _solo_reference(spec, device=CPU):
    """The uninterrupted run the migrated tenant must reproduce, built from
    the *same spec builders* the workers use (sleep stripped: tick values
    depend only on (seed, tick))."""
    solo = dict(spec, ticks=dict(spec["ticks"], tick_sleep_ms=0.0))
    it = iter(worker_mod._build_ticks(solo))
    teacher = worker_mod._build_teacher(solo, {})
    cfg = snapshot.config_from_dict(solo["cfg"])
    sess = stream.StreamSession(
        engine.init_fleet(cfg, solo["s"], device), cfg, teacher, mode=solo["mode"],
        capacity=solo["capacity"], backpressure=solo["backpressure"],
    )
    sess.start(next(it))
    while sess._p is not None:
        sess.advance(next(it, None))
    sess.drain_replies()
    state, _, stats = sess.finish()
    return state, stats


def _assert_state_trees_equal(a, b, msg):
    fa, fb = dict(ckpt._flatten(a)), dict(ckpt._flatten(b))
    assert sorted(fa) == sorted(fb), f"{msg}: leaf sets differ"
    for path in fa:
        xa, xb = np.asarray(fa[path]), np.asarray(fb[path])
        assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes(), (
            f"{msg}: state leaf {'/'.join(path)} diverged"
        )


def _assert_stats_equal(stats_wire, solo_stats, msg):
    for f in DETERMINISTIC_STATS:
        assert stats_wire[f] == getattr(solo_stats, f), (
            f"{msg}: stats.{f} diverged: {stats_wire[f]} != {getattr(solo_stats, f)}"
        )
    assert stats_wire["label_latency_ticks"] == list(solo_stats.label_latency_ticks), (
        f"{msg}: label latency history diverged"
    )
    assert stats_wire["reconciled"], f"{msg}: accounting broke"


@pytest.fixture(scope="module")
def fleet():
    """Two port worker subprocesses on the CPU, shared by every test in this
    module (each spawn pays the worker's torch import).  quantum=1, as the
    reference's test has it."""
    workers = [_spawn_cpu_worker(f"tw{i}") for i in range(2)]
    yield workers
    for w in workers:
        w.close(shutdown=True)


def _wait_live_at(client, names, tick, timeout_s=120.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        rows = {t["name"]: t for t in client.status()["live"]}
        if any(n not in rows for n in names):
            raise AssertionError(
                f"tenant finished before the migration point: have {sorted(rows)}"
            )
        if all(rows[n]["t"] >= tick for n in names):
            return rows
        time.sleep(0.01)
    raise TimeoutError(f"{names} never reached tick {tick}")


def _migrate_all_policies(w_a, w_b, prefix, device):
    """Four tenants, one per policy, fused on ``w_a``; each extracted mid-
    stream, shipped through this process and admitted on ``w_b``; each must
    end bit for bit as its solo run on ``device``."""
    specs = {
        policy: _spec(f"{prefix}_{policy}", policy, seed=300 + i)
        for i, policy in enumerate(stream.BACKPRESSURE_POLICIES)
    }
    for spec in specs.values():
        w_a.admit(spec)
    names = [s["name"] for s in specs.values()]
    rows = _wait_live_at(w_a, names, CUT_AT)
    assert all(r["fused"] for r in rows.values()), rows

    for policy, spec in specs.items():
        sent_spec, wire = w_a.extract(spec["name"])
        # The spec crossed a JSON boundary (tuples become lists); compare
        # JSON-normalized.
        assert sent_spec == json.loads(json.dumps(spec))
        assert isinstance(wire, bytes) and len(wire) > 0
        cut = snapshot.ticks_consumed(snapshot.decode_snapshot(wire))
        assert CUT_AT <= cut < T_TOTAL, f"{policy}: cut at {cut} not mid-stream"
        reply = w_b.admit(sent_spec, wire)
        assert reply["migrated"] is True

    elastic.Router([w_a, w_b]).wait_finished(names, timeout_s=180)

    for policy, spec in specs.items():
        stats_wire, tree = w_b.result(spec["name"])
        solo_state, solo_stats = _solo_reference(spec, device)
        _assert_state_trees_equal(
            snapshot.state_to_tree(solo_state), tree["state"], f"policy {policy}"
        )
        _assert_stats_equal(stats_wire, solo_stats, f"policy {policy}")
        # Latency-teacher state rides the snapshot: nothing was re-asked.
        assert stats_wire["tickets_reasked"] == 0


def test_migrate_bit_for_bit_all_policies(fleet):
    """ALL FOUR backpressure policies, concurrently (they fuse into one
    cohort on the source worker): extract on worker A mid-stream, ship the
    wire bytes through this process, admit on worker B; final state and
    deterministic stats equal the uninterrupted solo run."""
    _migrate_all_policies(*fleet, "mig", CPU)


def test_drain_worker_to_zero_preserves_fleet_identity(fleet):
    """Scale-in: every live tenant on a 4-tenant worker migrates off (the
    worker drains to zero), and the fleet-wide query-accounting identity
    still reconciles after the moves."""
    w_extra = _spawn_cpu_worker("tw_drain")
    router = elastic.Router(list(fleet) + [w_extra])
    names = []
    try:
        for i in range(4):
            spec = _spec(f"drain{i}", "drop_oldest", seed=500 + i)
            names.append(spec["name"])
            w_extra.admit(spec)
        _wait_live_at(w_extra, names, 10)  # all mid-stream
        migrated, finished_there = router.scale_in(w_extra)
        assert sorted(migrated) == sorted(names), (
            f"drain left tenants behind: moved {migrated}"
        )
        assert w_extra not in router.workers
        assert not finished_there  # all were live when the drain started
        # The drained worker's subprocess actually exited.
        assert w_extra.proc.wait(timeout=30) == 0

        router.wait_finished(names, timeout_s=180)
        results = {
            n: s for n, s in router.fleet_results().items() if n in names
        }
        assert sorted(results) == sorted(names)
        agg = elastic.reconcile(results)
        assert agg["reconciled"], f"fleet identity broke: {agg}"
        assert all(agg["per_tenant"].values())
        assert agg["queries_issued"] > 0  # the identity wasn't vacuous
        assert agg["queries_issued"] == (
            agg["labels_applied"] + agg["queries_dropped"]
            + agg["queries_lost"] + agg["queries_coalesced"]
        )
    finally:
        if w_extra in router.workers:
            w_extra.close(shutdown=True)


def test_worker_status_reports_load_signals(fleet):
    """The router's placement inputs (tick-rate EMA, ring occupancy HWM,
    shape key) are live in the worker status while a tenant streams."""
    w_a, _ = fleet
    spec = _spec("load_probe", "drop_oldest", seed=900)
    w_a.admit(spec)
    rows = _wait_live_at(w_a, ["load_probe"], 30)
    row = rows["load_probe"]
    assert row["shape_key"] == worker_mod.spec_shape_key(spec)
    assert row["tick_rate_ema"] > 0
    assert row["ring_capacity"] == spec["capacity"]
    assert 0 <= row["ring"] <= row["ring_capacity"]
    assert row["ring_hwm"] >= 1  # train_phase mode queries every tick
    assert row["s"] == spec["s"]
    elastic.Router(list(fleet)).wait_finished(["load_probe"], timeout_s=120)


def test_unknown_tenant_errors_do_not_kill_worker(fleet):
    w_a, _ = fleet
    with pytest.raises(elastic.WorkerError):
        w_a.extract("no_such_tenant")
    with pytest.raises(elastic.WorkerError):
        w_a.result("no_such_tenant")
    assert w_a.status()["kind"] == "status_ok"  # connection still live


def _decode_solo(spec, t_total):
    """The decode tenant's uninterrupted run in this process: a session fed
    by ``launch.serve._decode_feats`` over the spec's backbone, built here."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_lib

    t = spec["ticks"]
    model_cfg = configs.get_config(t["arch"], t["variant"])
    params, prompts, state = serve_lib.build_backbone(
        model_cfg, t["batch"], t["prompt_len"], t["max_len"], t["seed"], CPU)
    feats = list(serve_lib._decode_feats(params, state, prompts, model_cfg, t_total))
    cfg = snapshot.config_from_dict(spec["cfg"])
    sess = stream.StreamSession(
        engine.init_fleet(cfg, spec["s"], CPU), cfg, worker_mod._build_teacher(spec, {}),
        mode=spec["mode"], capacity=spec["capacity"], backpressure=spec["backpressure"],
    )
    it = iter(feats)
    sess.start(next(it))
    while sess._p is not None:
        sess.advance(next(it, None))
    sess.drain_replies()
    state_out, _, stats = sess.finish()
    return state_out, stats, feats


def test_decode_ticks_run_on_a_port_worker(fleet):
    """A ``decode`` spec (``serve_fleet --fleet-ticks decode`` at smoke
    width) runs on port workers: admitted on one, migrated to the other
    mid-stream, it ends bit for bit as the in-process session fed by
    ``_decode_feats`` (state and counters: both workers build the backbone
    from the spec's seed with process-stable generators), and ``seek(k)``
    of its tick source equals the tail of the full decode."""
    from repro_torch import configs
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import model as model_lib

    w_a, w_b = fleet
    t_total, cut = 16, 4
    odl_cfg = model_lib.core_config(configs.get_config("qwen3-4b", "smoke"))
    spec = worker_mod.tenant_spec(
        "decoder", odl_cfg, s=4, mode="serve", capacity=4, backpressure="drop_oldest",
        ticks=serve_lib.decode_ticks_spec("qwen3-4b", "smoke", batch=4, seed=3,
                                          t_total=t_total, tick_sleep_ms=20.0),
        teacher=worker_mod.latency_teacher_spec(n_out=odl_cfg.elm.n_out, latency=2,
                                                jitter=1, seed=3),
    )
    w_a.admit(spec)
    _wait_live_at(w_a, ["decoder"], cut)
    sent_spec, wire = w_a.extract("decoder")
    moved_at = snapshot.ticks_consumed(snapshot.decode_snapshot(wire))
    assert cut <= moved_at < t_total
    assert w_b.admit(sent_spec, wire)["migrated"] is True
    elastic.Router([w_b]).wait_finished(["decoder"], timeout_s=120)
    stats_wire, tree = w_b.result("decoder")

    solo_state, solo_stats, feats = _decode_solo(spec, t_total)
    _assert_state_trees_equal(snapshot.state_to_tree(solo_state), tree["state"], "decode tenant")
    _assert_stats_equal(stats_wire, solo_stats, "decode tenant")
    assert stats_wire["stream_steps"] == t_total * spec["s"]

    ticks = worker_mod._build_ticks(dict(spec, ticks=dict(spec["ticks"], tick_sleep_ms=0.0)),
                                    {}, CPU)
    tail = list(ticks.seek(moved_at))
    assert len(tail) == t_total - moved_at
    for got, want in zip(tail, feats[moved_at:]):
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_worker_without_cuda_or_device_fails_to_spawn():
    """No CUDA device and no ``--device``: the worker refuses to start
    before it prints its port, so ``spawn_worker`` raises (never a silent
    CPU fallback)."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with pytest.raises(RuntimeError, match="failed to start"):
        elastic.spawn_worker("tw_nocuda", env=env)


def test_worker_metrics_scrape(fleet):
    """The ``metrics`` command: Prometheus text and registry JSON in the
    header, the span ring as Chrome trace JSON in the payload on request."""
    w_a, _ = fleet
    # A short tenant first, so the scrape has rounds and kernels to count
    # whichever tests ran before.
    spec = dict(_spec("scraped", "drop_oldest", seed=44, tick_sleep_ms=0.0),
                ticks=worker_mod.synth_ticks_spec(seed=44, t_total=8))
    w_a.admit(spec)
    elastic.Router([w_a]).wait_finished(["scraped"], timeout_s=60)
    header, payload = w_a.metrics(trace=True)
    assert header["kind"] == "metrics_ok" and header["enabled"] is True
    assert "odl_mux_rounds" in header["prometheus"]
    assert "counters" in header["metrics"] and "gauges" in header["metrics"]
    assert "traceEvents" in json.loads(payload)
    header, payload = w_a.metrics()
    assert payload == b""
    # The worker's own kernel counts: a worker on the CPU launches none.
    gauges = header["metrics"]["gauges"]
    for name in ("odl_worker_kernel_launches", "odl_worker_kernel_replays"):
        rows = {r["labels"]["kernel"]: r["value"] for r in gauges[name]}
        assert sorted(rows) == sorted(ops.launch_counts) and not any(rows.values()), name
    assert "odl_worker_kernel_shape" not in gauges
    assert "odl_worker_device_peak_bytes" not in gauges


def test_rpc_tenant_reasks_its_in_flight_tickets_on_another_worker(fleet):
    """An rpc-taught tenant cut with tickets in flight lands on a port worker
    that re-asks them over its own connection, and every ticket is
    accounted for.  A worker's own ``extract`` waits for those answers
    first, so the cut is made here, on an in-process multiplexer, with no
    quiesce: the tickets the label server (50 ms per frame) has not
    answered ride the snapshot's ring."""
    _, w_b = fleet
    cfg = _cfg()
    with rpc.loopback_server(n_out=4, delay_s=0.05) as (host, port):
        spec = worker_mod.tenant_spec(
            "rpc_move", cfg, s=4, mode="train_phase", capacity=4,
            ticks=worker_mod.synth_ticks_spec(seed=43, t_total=60),
            teacher=worker_mod.rpc_teacher_spec(host, port, timeout_s=30.0),
        )
        clients = {}
        try:
            mux = multiplex.Multiplexer([multiplex.Tenant(
                name="rpc_move", state=engine.init_fleet(cfg, 4, CPU),
                ticks=worker_mod._build_ticks(spec), cfg=cfg,
                teacher=worker_mod._build_teacher(spec, clients), mode="train_phase",
                capacity=4, collect=False, device=CPU,
            )])
            while mux.round():
                if mux.session("rpc_move").t >= 20:
                    break
            tree, _ = mux.extract("rpc_move", quiesce_ticks=0)
        finally:
            for client in clients.values():
                client.close()
        in_flight = len(tree["ring"])
        assert in_flight > 0
        assert w_b.admit(spec, snapshot.encode_snapshot(tree))["migrated"] is True
        elastic.Router([w_b]).wait_finished(["rpc_move"], timeout_s=120)
        stats_wire, _ = w_b.result("rpc_move")
    assert stats_wire["ticks"] == 60
    assert stats_wire["tickets_reasked"] == in_flight
    assert stats_wire["queries_issued"] == 60 * 4  # min_trained 1e6: every stream asks
    assert stats_wire["reconciled"], stats_wire


# ---------------------------------------------------------------------------
# Specs, ticks and stats on the wire
# ---------------------------------------------------------------------------


def test_stats_wire_round_trip():
    stats = stream.StreamStats(ticks=7, stream_steps=28, tickets_issued=5, queries_issued=9,
                               labels_applied=6, queries_lost=3, wall_s=0.25,
                               tick_rate_ema=12.5, ring_occupancy_hwm=3)
    stats.tick_ms.extend([1.5, 2.25])
    stats.label_latency_ticks.extend([2.0, 3.0, 4.0])
    wire = json.loads(json.dumps(worker_mod._stats_to_wire(stats)))
    assert wire["reconciled"] is True
    back = worker_mod.stats_from_wire(wire)
    for f in dataclasses.fields(stream.StreamStats):
        a, b = getattr(stats, f.name), getattr(back, f.name)
        if f.name in ("tick_ms", "label_latency_ticks"):
            assert list(a) == list(b) and b.maxlen == a.maxlen
        else:
            assert a == b and type(a) is type(b), f.name


def test_spec_builders_reject_unknown_kinds():
    with pytest.raises(ValueError, match="tick-source kind"):
        worker_mod.tenant_spec("x", _cfg(), s=4, ticks={"kind": "nope"},
                               teacher=worker_mod.latency_teacher_spec(n_out=4))
    with pytest.raises(ValueError, match="teacher kind"):
        worker_mod.tenant_spec("x", _cfg(), s=4, ticks=worker_mod.synth_ticks_spec(0, 4),
                               teacher={"kind": "nope"})


@pytest.mark.usefixtures("jax_ref")
def test_specs_ticks_and_keys_equal_the_reference():
    """Both packages' spec builders give equal dicts (a JSON boundary
    apart), the shape keys are the same digests, the config codec round
    trips, the stats carry the same fields, and the synth ticks are the
    same bytes, sought or not."""
    for name, policy, seed in (("a", "drop_oldest", 1), ("b", "coalesce", 7)):
        t_spec = _spec(name, policy, seed)
        j_spec = _spec(name, policy, seed, pkg=j_worker, cfg=_jcfg())
        assert json.dumps(t_spec, sort_keys=True) == json.dumps(j_spec, sort_keys=True)
        assert worker_mod.spec_shape_key(t_spec) == j_worker.spec_shape_key(j_spec)
        assert worker_mod.spec_shape_key(t_spec) == j_worker.spec_shape_key(
            json.loads(json.dumps(t_spec)))
    wide = worker_mod.tenant_spec("w", _cfg(), s=8, mode="algo1",
                                  ticks=worker_mod.synth_ticks_spec(3, 10),
                                  teacher=worker_mod.latency_teacher_spec(n_out=4))
    assert worker_mod.spec_shape_key(wide) == j_worker.spec_shape_key(wide)
    assert worker_mod.spec_shape_key(wide) != worker_mod.spec_shape_key(_spec("a", "block", 1))

    j_dict = j_snapshot.config_to_dict(_jcfg())
    assert snapshot.config_to_dict(_cfg()) == j_dict
    assert snapshot.config_to_dict(snapshot.config_from_dict(j_dict)) == j_dict
    assert snapshot.config_from_dict(json.loads(json.dumps(j_dict))) == _cfg()
    assert ([f.name for f in dataclasses.fields(stream.StreamStats)]
            == [f.name for f in dataclasses.fields(j_stream.StreamStats)])
    assert worker_mod.TICK_KINDS == j_worker.TICK_KINDS
    assert worker_mod.TEACHER_KINDS == j_worker.TEACHER_KINDS

    spec = _spec("t", "drop_oldest", 11, tick_sleep_ms=0.0)
    t_ticks, j_ticks = worker_mod._build_ticks(spec), j_worker._build_ticks(spec, {})
    for _ in range(5):
        a, b = next(t_ticks), next(j_ticks)
        assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()
    t_ticks.seek(123)
    j_ticks.seek(123)
    a, b = next(t_ticks), next(j_ticks)
    assert a.tobytes() == b.tobytes() and t_ticks.cursor == j_ticks.cursor == 124
    assert len(list(t_ticks)) == len(list(j_ticks)) == T_TOTAL - 124


@pytest.mark.usefixtures("jax_ref")
def test_latency_teachers_answer_like_the_reference():
    """The spec's latency teacher answers with the label server's rule and
    the same draws in both packages (it is what a migrated tenant's inbox
    replays)."""
    spec = _spec("t", "drop_oldest", 5)
    t_teacher = worker_mod._build_teacher(spec, {})
    j_teacher = j_worker._build_teacher(spec, {})
    feats = np.zeros((4, 24), np.float32)
    mask = np.ones(4, bool)
    for tick in range(40):
        assert t_teacher.ask(torch.as_tensor(feats), mask, tick) == j_teacher.ask(
            feats, mask, tick)
        got, want = t_teacher.poll(tick), j_teacher.poll(tick)
        assert [(r.ticket, r.labels.tolist(), r.answered.tolist()) for r in got] == [
            (r.ticket, np.asarray(r.labels).tolist(), np.asarray(r.answered).tolist())
            for r in want]


# ---------------------------------------------------------------------------
# Across the two packages' workers
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("jax_ref")
def test_reference_client_drives_a_port_worker(fleet):
    """The JAX package's ``WorkerClient`` speaks to a port worker: status,
    admit, result, report, metrics and its error frames."""
    _, w_b = fleet
    client = j_elastic.WorkerClient(w_b.host, w_b.port, name="j->t")
    try:
        spec = _spec("jclient", "block", seed=77, tick_sleep_ms=0.0, pkg=j_worker, cfg=_jcfg())
        reply = client.admit(spec)
        assert reply == {"kind": "ok", "name": "jclient", "migrated": False, "payload_len": 0}
        router = j_elastic.Router([client])
        router.wait_finished(["jclient"], timeout_s=120)
        stats_wire, tree = client.result("jclient")
        solo_state, solo_stats = _solo_reference(spec)
        _assert_state_trees_equal(snapshot.state_to_tree(solo_state), tree["state"], "jclient")
        _assert_stats_equal(stats_wire, solo_stats, "jclient")
        assert j_worker.stats_from_wire(stats_wire).reconciled
        assert client.report()["jclient"]["ticks"] == T_TOTAL
        assert client.status()["kind"] == "status_ok"
        header, _ = client.metrics()
        assert header["kind"] == "metrics_ok"
        with pytest.raises(j_elastic.WorkerError):
            client.extract("jclient")  # finished: nothing to migrate
    finally:
        client.close(shutdown=False)


@pytest.mark.usefixtures("jax_ref")
def test_tenant_from_a_jax_worker_finishes_on_a_port_worker(fleet):
    """A tenant runs on a JAX worker (in this process, its rounds driven by
    hand so the cut lands where asked), is extracted over the JAX worker's
    control socket by the JAX package's client, and admitted on a port
    worker by the port's.  It finishes with the JAX solo run's counters
    and label latencies exactly, and with the state of an in-process
    JAX-to-port restore of the same wire bytes, bit for bit."""
    _, w_b = fleet
    spec = _spec("from_jax", "coalesce", seed=41, tick_sleep_ms=0.0, pkg=j_worker, cfg=_jcfg())
    jw = j_worker.Worker(name="jw", quantum=1, telemetry=False)
    client = j_elastic.WorkerClient(jw.host, jw.port, name="jw")
    try:
        client.admit(spec)
        while True:
            with jw._lock:
                jw.mux.round()
            row = client.status()["live"][0]
            if row["t"] >= CUT_AT:
                break
        sent_spec, wire = client.extract("from_jax")
        assert client.status()["live"] == []
    finally:
        client.close(shutdown=False)
        jw.close()
    tree = snapshot.decode_snapshot(wire)
    assert snapshot.ticks_consumed(tree) == CUT_AT + 1  # the pending tick rides along

    assert w_b.admit(sent_spec, wire)["migrated"] is True
    elastic.Router([w_b]).wait_finished(["from_jax"], timeout_s=120)
    stats_wire, result = w_b.result("from_jax")

    # The JAX solo run, uninterrupted, from the JAX package's builders.
    j_it = iter(j_worker._build_ticks(spec, {}))
    j_cfg = j_snapshot.config_from_dict(spec["cfg"])
    j_sess = j_stream.StreamSession(
        j_engine.init_fleet(j_cfg, spec["s"]), j_cfg, j_worker._build_teacher(spec, {}),
        mode=spec["mode"], capacity=spec["capacity"], backpressure=spec["backpressure"])
    j_sess.start(next(j_it))
    while j_sess._p is not None:
        j_sess.advance(next(j_it, None))
    j_sess.drain_replies()
    j_state, _, j_stats = j_sess.finish()
    _assert_stats_equal(stats_wire, j_stats, "from_jax vs the JAX solo run")
    got = dict(ckpt._flatten(result["state"]))
    want = dict(ckpt._flatten(j_snapshot.state_to_tree(j_state)))
    assert sorted(got) == sorted(want), "from_jax vs the JAX solo run: leaf sets differ"
    for path, leaf in want.items():
        t, j = np.asarray(got[path]), np.asarray(leaf)
        msg = f"from_jax vs the JAX solo run: state leaf {'/'.join(path)}"
        assert t.dtype == j.dtype and t.shape == j.shape, msg
        if t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=2e-3, atol=2e-3, err_msg=msg)
        else:
            np.testing.assert_array_equal(t, j, err_msg=msg)

    # The same cut restored in this process by the port.
    ticks = worker_mod._build_ticks(sent_spec)
    snapshot.seek_ticks(ticks, snapshot.ticks_consumed(tree))
    sess = stream.StreamSession.restore(tree, worker_mod._build_teacher(sent_spec, {}),
                                        cfg=snapshot.config_from_dict(sent_spec["cfg"]),
                                        device=CPU)
    while sess._p is not None:
        sess.advance(next(ticks, None))
    sess.drain_replies()
    state, _, stats = sess.finish()
    _assert_state_trees_equal(snapshot.state_to_tree(state), result["state"],
                              "from_jax vs the in-process restore")
    _assert_stats_equal(stats_wire, stats, "from_jax vs the in-process restore")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_migrate_bit_for_bit_all_policies(cuda_device):
    """The migration test with two port workers on the card (their default
    device), against solo runs on the card in this process; each worker's
    scrape shows it launched the path's kernels."""
    workers = [elastic.spawn_worker(f"cw{i}", quantum=1) for i in range(2)]
    try:
        _migrate_all_policies(*workers, "cmig", cuda_device)
        # Each worker ran the path's kernels itself, in its own process.
        for w in workers:
            gauges = w.metrics()[0]["metrics"]["gauges"]
            ran = {}
            for name in ("odl_worker_kernel_launches", "odl_worker_kernel_replays"):
                for r in gauges[name]:
                    kernel = r["labels"]["kernel"]
                    ran[kernel] = ran.get(kernel, 0) + r["value"]
            for kernel in ("xorshift_projection", "oselm_rls_update_fleet", "plan_rows"):
                assert ran[kernel] > 0, (w.name, kernel, ran)
            assert gauges["odl_worker_device_peak_bytes"][0]["value"] > 0
    finally:
        for w in workers:
            w.close(shutdown=True)


# ---------------------------------------------------------------------------
# Router placement logic (stub workers, no subprocesses)
# ---------------------------------------------------------------------------


class _StubWorker:
    def __init__(self, name, live=()):
        self.name = name
        self.live = list(live)

    def status(self):
        return {"kind": "status_ok", "worker": self.name,
                "live": list(self.live), "finished": []}

    def admit(self, spec, snapshot_wire=b""):
        self.live.append(_row(spec["name"], worker_mod.spec_shape_key(spec),
                              s=spec["s"]))
        return {"kind": "ok", "name": spec["name"],
                "migrated": bool(snapshot_wire)}


def _row(name, key, s=4, ema=100.0, draining=False):
    return {"name": name, "t": 10, "s": s, "shape_key": key,
            "tick_rate_ema": ema, "ring": 0, "ring_hwm": 0,
            "ring_capacity": 4, "queries_issued": 0, "labels_applied": 0,
            "draining": draining, "fused": False}


def test_router_places_by_shape_affinity_under_capacity():
    """Four same-shape tenants over two capacity-2 workers split 2+2 (two
    fusable pairs), not 4+0 or 1+1+1+1 round-robin."""
    w0, w1 = _StubWorker("w0"), _StubWorker("w1")
    router = elastic.Router([w0, w1], capacity=2)
    placed = [router.admit(_spec(f"a{i}", "drop_oldest", seed=i)).name
              for i in range(4)]
    assert placed == ["w0", "w0", "w1", "w1"]


def test_router_prefers_affinity_over_emptier_worker():
    """A tenant whose shape key matches tenants on a busier (but
    under-capacity) worker goes there: cohort fusion beats spreading."""
    spec_a = _spec("x", "drop_oldest", seed=1)
    key_a = worker_mod.spec_shape_key(spec_a)
    w0 = _StubWorker("w0", [_row("t0", key_a), _row("t1", key_a)])
    w1 = _StubWorker("w1")
    router = elastic.Router([w0, w1], capacity=8)
    assert router.place(_spec("x2", "drop_oldest", seed=2)).name == "w0"
    # A different-shaped tenant prefers the empty worker instead.
    other = worker_mod.tenant_spec(
        "y", _cfg(), s=8, mode="train_phase",
        ticks=worker_mod.synth_ticks_spec(seed=3, t_total=10),
        teacher=worker_mod.latency_teacher_spec(n_out=4),
    )
    assert worker_mod.spec_shape_key(other) != key_a
    assert router.place(other).name == "w1"


def test_router_capacity_spills_before_affinity():
    """Affinity never overrides capacity: a full worker is skipped even if
    every tenant on it matches."""
    spec = _spec("z", "drop_oldest", seed=4)
    key = worker_mod.spec_shape_key(spec)
    w0 = _StubWorker("w0", [_row("t0", key), _row("t1", key)])
    w1 = _StubWorker("w1")
    router = elastic.Router([w0, w1], capacity=2)
    assert router.place(spec).name == "w1"


def test_router_draining_tenants_do_not_attract():
    """A tenant that has exhausted its ticks (draining replies) is not a
    fusion partner: placement ignores it for affinity."""
    spec = _spec("q", "drop_oldest", seed=5)
    key = worker_mod.spec_shape_key(spec)
    w0 = _StubWorker("w0", [_row("t0", key, draining=True)])
    w1 = _StubWorker("w1")
    router = elastic.Router([w0, w1], capacity=8)
    # Tie on affinity (none) -> fewest live tenants wins.
    assert router.place(spec).name == "w1"


def test_reconcile_flags_broken_identity():
    ok = {"queries_issued": 10, "labels_applied": 7, "queries_dropped": 1,
          "queries_lost": 1, "queries_coalesced": 1, "reconciled": True}
    bad = dict(ok, labels_applied=6, reconciled=False)
    agg = elastic.reconcile({"a": ok})
    assert agg["reconciled"] and agg["per_tenant"]["a"]
    agg = elastic.reconcile({"a": ok, "b": bad})
    assert not agg["reconciled"]
    assert not agg["per_tenant"]["b"]
