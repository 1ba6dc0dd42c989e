"""The port's telemetry (``repro_torch.runtime.telemetry``) and its hooks in
the stream session, snapshot and RPC layers, mirroring
``tests/test_telemetry.py``, and held against the JAX package's telemetry.

Mirrors: registry, tracer and exporter basics; the ``StreamStats`` ->
registry mirror for every backpressure policy, with the instrumented run bit
for bit the uninstrumented one; the mid-run identity with pending queries;
snapshot restore semantics (load-signal gauges ride the snapshot, the trace
ring does not); the field-list growth guard against the port's
``StreamStats``; the ``LabelServer`` wire ``stats`` scrape; the RPC
client's meters.

Across the two packages: one sequence of registry calls gives byte-equal
Prometheus text, each package's ``parse_prometheus`` reads the other's
text, the two ``TELEMETRY`` globals are separate objects, and a port session
and a reference session on the same numpy ticks and labels mirror equal
counters at a mid-run scrape, where ``check_stream_identity`` holds.

Sizes as in ``tests/test_telemetry.py``: n_in=24, N=16, m=4, S <= 4,
T <= 50, on the CPU.
"""

import dataclasses
import importlib.util
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.engine import stream as j_stream
    from repro.runtime import telemetry as j_telemetry

from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.engine import rpc, snapshot, stream  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402

N_IN, N_HIDDEN, N_OUT = 24, 16, 4


@pytest.fixture(autouse=True)
def _clean_telemetry():
    """Telemetry is a process-wide global: every test starts and ends with
    the port's (and, where present, the reference's) switched off."""
    telemetry.disable()
    if HAVE_JAX:
        j_telemetry.disable()
    yield
    telemetry.disable()
    if HAVE_JAX:
        j_telemetry.disable()


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


def _cfg(pkg_engine=engine, pkg_oselm=oselm, pkg_pruning=pruning, pkg_drift=drift_mod,
         min_trained=16):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, variant="hash",
                                  ridge=1e-2),
        prune=pkg_pruning.PruneConfig(min_trained=min_trained),
        drift=pkg_drift.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )


def _stream_data(t, s, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    ys = rng.integers(0, N_OUT, (t, s)).astype(np.int32)
    return xs, ys


def _fleet(cfg, s):
    return engine.init_fleet(cfg, s, device="cpu")


# ---------------------------------------------------------------------------
# Registry / tracer / exporter basics
# ---------------------------------------------------------------------------


def _registry_calls(tel_mod):
    """One fixed sequence of registry calls, for either package."""
    reg = tel_mod.Registry()
    reg.count("odl_mux_rounds", 3, worker="w0")
    reg.count("odl_mux_rounds", 2, worker="w0")
    reg.set_counter("odl_stream_ticks", 41, tenant="t0")
    reg.set_counter("odl_stream_ticks", 7, tenant='we"ird\\na\nme')
    reg.gauge("odl_stream_tick_rate_ema", 12.5, tenant="t0")
    reg.gauge("odl_mux_tenants", 3)
    reg.observe("odl_rpc_batch_occupancy", 3)
    reg.observe("odl_rpc_batch_occupancy", 5.25, endpoint="127.0.0.1:1")
    reg.observe("odl_rpc_batch_occupancy", 5)
    return reg


def test_registry_counters_gauges_histograms_roundtrip_prometheus():
    reg = telemetry.Registry()
    reg.count("odl_mux_rounds", 3, worker="w0")
    reg.count("odl_mux_rounds", 2, worker="w0")
    reg.set_counter("odl_stream_ticks", 41, tenant="t0")
    reg.gauge("odl_stream_tick_rate_ema", 12.5, tenant="t0")
    reg.observe("odl_rpc_batch_occupancy", 3)
    reg.observe("odl_rpc_batch_occupancy", 5)

    assert reg.get_counter("odl_mux_rounds", worker="w0") == 5
    assert reg.get_counter("odl_mux_rounds", worker="nope") == 0
    assert reg.get_gauge("odl_stream_tick_rate_ema", tenant="t0") == 12.5

    text = reg.prometheus_text()
    parsed = telemetry.parse_prometheus(text)
    assert parsed[("odl_mux_rounds", (("worker", "w0"),))] == 5
    assert parsed[("odl_stream_ticks", (("tenant", "t0"),))] == 41
    assert parsed[("odl_stream_tick_rate_ema", (("tenant", "t0"),))] == 12.5
    assert parsed[("odl_rpc_batch_occupancy_count", ())] == 2
    assert parsed[("odl_rpc_batch_occupancy_sum", ())] == 8
    assert "odl_stream_ticks{tenant=\"t0\"} 41\n" in text  # integral: no trailing .0

    snap = reg.snapshot()
    assert snap["counters"]["odl_stream_ticks"] == [{"labels": {"tenant": "t0"}, "value": 41.0}]
    assert snap["histograms"]["odl_rpc_batch_occupancy"][0]["max"] == 5.0


def test_prometheus_label_escaping_roundtrips():
    reg = telemetry.Registry()
    reg.set_counter("odl_stream_ticks", 1, tenant='we"ird\\na\nme')
    parsed = telemetry.parse_prometheus(reg.prometheus_text())
    assert parsed[("odl_stream_ticks", (("tenant", 'we"ird\\na\nme'),))] == 1


def test_parse_prometheus_rejects_malformed_lines():
    with pytest.raises(ValueError):
        telemetry.parse_prometheus("justonetoken\n")
    with pytest.raises(ValueError):
        telemetry.parse_prometheus('bad{tenant=unquoted} 1\n')


def test_tracer_spans_events_sampling_and_bounded_ring():
    tr = telemetry.SpanTracer(capacity=4, sample=2)
    for i in range(6):
        tok = tr.begin("stream.tick")
        tr.end(tok, t=i)
    tr.event("rpc.reconnect", endpoint="x:1")
    spans = tr.spans()
    assert tr.dropped == 3  # sample=2 keeps every other begin
    assert len(spans) <= 4  # capacity bounds the ring
    assert "rpc.reconnect" in {s[0] for s in spans}

    trace = tr.chrome_trace()
    phases = {ev["name"]: ev["ph"] for ev in trace["traceEvents"]}
    assert phases["rpc.reconnect"] == "i"
    assert phases.get("stream.tick", "X") == "X"
    jsonl = tr.to_jsonl()
    assert "rpc.reconnect" in jsonl and jsonl.endswith("\n")

    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_enable_is_idempotent_and_disable_resets():
    assert telemetry.get() is None
    tel = telemetry.enable()
    tel.registry.count("odl_mux_rounds")
    assert telemetry.enable() is tel
    assert tel.registry.get_counter("odl_mux_rounds") == 1
    telemetry.disable()
    assert telemetry.get() is None


def test_check_stream_identity_flags_broken_accounting():
    reg = telemetry.Registry()
    telemetry.sync_stream_stats(reg, stream.StreamStats(
        queries_issued=10, labels_applied=6, queries_dropped=2, queries_lost=1,
        queries_coalesced=0), pending=1, tenant="ok")
    telemetry.sync_stream_stats(reg, stream.StreamStats(queries_issued=10, labels_applied=6),
                                pending=0, tenant="broken")
    out = telemetry.check_stream_identity(telemetry.parse_prometheus(reg.prometheus_text()))
    assert {dict(k)["tenant"]: v for k, v in out.items()} == {"ok": True, "broken": False}
    assert telemetry.check_stream_identity({}) == {}  # an empty scrape: callers fail it


# ---------------------------------------------------------------------------
# The StreamStats mirror for every policy; telemetry never perturbs a run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", stream.BACKPRESSURE_POLICIES)
def test_registry_mirrors_stream_stats_and_never_perturbs_run(policy):
    """After a run every ``odl_stream_*`` counter equals its ``StreamStats``
    field, and the instrumented run's state and outputs are bit for bit the
    uninstrumented run's."""
    cfg = _cfg(min_trained=1)
    t_len, s_len = 50, 4
    xs, ys = _stream_data(t_len, s_len, seed=3)

    def run_once():
        # latency 7 >> capacity 3 saturates the ring, so the policy fires.
        teacher = stream.LatencyTeacher(stream.array_labels(ys), latency=7)
        return stream.run(_fleet(cfg, s_len), iter(xs), cfg, teacher, mode="train_phase",
                          capacity=3, backpressure=policy)

    st_plain, outs_plain, stats_plain = run_once()
    tel = telemetry.enable()
    st_instr, outs_instr, stats = run_once()

    a, b = convert.engine_state_to_numpy(st_plain), convert.engine_state_to_numpy(st_instr)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"telemetry perturbed {k} ({policy})")
    for f in outs_plain._fields:
        np.testing.assert_array_equal(getattr(outs_plain, f), getattr(outs_instr, f), err_msg=f)
    for f in telemetry.STREAM_COUNTER_FIELDS:
        assert getattr(stats_plain, f) == getattr(stats, f), f

    if policy in ("drop_oldest", "drop_newest"):
        assert stats.queries_dropped > 0
    elif policy == "block":
        assert stats.asks_deferred > 0
    else:
        assert stats.queries_coalesced > 0

    for f in telemetry.STREAM_COUNTER_FIELDS:
        assert tel.registry.get_counter(f"odl_stream_{f}") == getattr(stats, f), f
    for f in telemetry.STREAM_GAUGE_FIELDS:
        assert tel.registry.get_gauge(f"odl_stream_{f}") == float(getattr(stats, f)), f
    checks = telemetry.check_stream_identity(
        telemetry.parse_prometheus(tel.registry.prometheus_text()))
    assert checks and all(checks.values())
    assert tel.registry.get_gauge("odl_stream_queries_pending") == 0
    spans = tel.tracer.spans()
    ticks = [s for s in spans if s[0] == "stream.tick"]
    assert len(ticks) == t_len and [s[4]["t"] for s in ticks] == list(range(t_len))
    if policy == "drop_oldest":
        evicted = [s for s in spans if s[0] == "ring.evict"]
        assert len(evicted) == stats.tickets_dropped > 0


def test_midrun_scrape_identity_includes_pending_queries():
    """Mid-run the four terminal buckets do not cover queries_issued; the
    exported pending gauge closes the identity at any instant."""
    cfg = _cfg(min_trained=1)
    t_len, s_len = 12, 3
    xs, ys = _stream_data(t_len, s_len, seed=5)
    tel = telemetry.enable()
    sess = stream.StreamSession(_fleet(cfg, s_len), cfg,
                                stream.LatencyTeacher(stream.array_labels(ys), latency=50),
                                mode="train_phase", capacity=64)
    sess.telemetry_labels = {"tenant": "t0"}
    sess.start(xs[0])
    for t in range(1, t_len):
        sess.advance(xs[t])
    sess.sync_telemetry()
    assert sess.pending_queries() > 0
    parsed = telemetry.parse_prometheus(tel.registry.prometheus_text())
    key = (("tenant", "t0"),)
    assert telemetry.check_stream_identity(parsed)[key] is True
    assert parsed[("odl_stream_queries_pending", key)] == sess.pending_queries()
    del parsed[("odl_stream_queries_pending", key)]
    assert telemetry.check_stream_identity(parsed)[key] is False
    sess.advance(None)
    sess.finish()


def test_snapshot_restores_load_signal_gauges_but_not_trace_ring():
    cfg = _cfg(min_trained=1)
    t_len, s_len = 20, 3
    xs, ys = _stream_data(t_len, s_len, seed=9)
    tel = telemetry.enable()
    sess = stream.StreamSession(_fleet(cfg, s_len), cfg,
                                stream.LatencyTeacher(stream.array_labels(ys), latency=2),
                                mode="train_phase", capacity=8)
    sess.start(xs[0])
    for t in range(1, 12):
        sess.advance(xs[t])
    assert sess.stats.tick_rate_ema > 0 and sess.stats.ring_occupancy_hwm > 0
    tree = snapshot.capture(sess)

    meta_stats = snapshot._meta_of(tree)["stats"]
    assert meta_stats["tick_rate_ema"] == sess.stats.tick_rate_ema
    assert meta_stats["ring_occupancy_hwm"] == sess.stats.ring_occupancy_hwm
    assert "telemetry" not in tree
    assert any(s[0] == "snapshot.save" for s in tel.tracer.spans())

    # A fresh process: a new telemetry instance.
    telemetry.disable()
    tel2 = telemetry.enable()
    fresh = stream.LatencyTeacher(stream.array_labels(ys), latency=2)
    sess2 = snapshot.restore(tree, fresh, cfg=cfg, device="cpu")
    assert sess2.stats.tick_rate_ema == sess.stats.tick_rate_ema
    assert sess2.stats.ring_occupancy_hwm == sess.stats.ring_occupancy_hwm
    names = {s[0] for s in tel2.tracer.spans()}
    assert "snapshot.restore" in names and "stream.tick" not in names


def test_all_stream_stats_counters_are_mirrored():
    """Growth guard: every field of the port's ``StreamStats`` is in exactly
    one of the counter, gauge and excluded lists."""
    excluded = set(telemetry.STREAM_MIRROR_EXCLUDED) | set(telemetry.STREAM_GAUGE_FIELDS)
    fields = {f.name for f in dataclasses.fields(stream.StreamStats)}
    assert fields - excluded == set(telemetry.STREAM_COUNTER_FIELDS)
    assert set(telemetry.STREAM_GAUGE_FIELDS) < fields
    assert not set(telemetry.STREAM_MIRROR_EXCLUDED) & set(telemetry.STREAM_COUNTER_FIELDS)
    assert not set(telemetry.STREAM_MIRROR_EXCLUDED) & set(telemetry.STREAM_GAUGE_FIELDS)


# ---------------------------------------------------------------------------
# The LabelServer's counters over the wire, and the client's meters
# ---------------------------------------------------------------------------


def test_label_server_stats_scrape_over_the_wire():
    server = rpc.LabelServer(n_out=4).start()
    try:
        teacher = rpc.RpcTeacher(server.host, server.port, timeout_s=10.0)
        teacher.ask(torch.zeros((3, 4)), np.array([True, False, True]), tick=0)
        replies = []
        t0 = time.monotonic()
        while not replies and time.monotonic() - t0 < 10.0:
            replies = teacher.poll(0)
        teacher.close()
        assert replies

        stats = rpc.server_stats(server.host, server.port)
        assert stats["asks_served"] >= 1 and stats["frames_v2"] >= 1
        assert stats["frame_errors"] == 0 and stats["thread_count"] >= 0
        assert stats["n_out"] == 4
        again = rpc.server_stats(server.host, server.port)
        assert again["asks_served"] == stats["asks_served"]  # a scrape is not an ask
        assert again["connections_accepted"] > stats["connections_accepted"]
    finally:
        server.close()


def test_label_server_stats_scrape_respects_hmac_secret():
    server = rpc.LabelServer(n_out=4, secret="s3kr1t").start()
    try:
        stats = rpc.server_stats(server.host, server.port, secret="s3kr1t")
        assert stats["auth_failures"] == 0
        with pytest.raises((ConnectionError, OSError)):
            rpc.server_stats(server.host, server.port, secret="wrong", timeout_s=2.0)
        assert rpc.server_stats(server.host, server.port, secret="s3kr1t")["auth_failures"] >= 1
    finally:
        server.close()


def test_rpc_client_mirrors_wire_meters_into_registry():
    tel = telemetry.enable()
    server = rpc.LabelServer(n_out=4).start()
    try:
        client = rpc.BatchedRpcClient(server.host, server.port, timeout_s=10.0,
                                      batch_window_s=0.0)
        h = client.tenant("t0")
        h.ask(torch.zeros((2, 4)), np.array([True, True]), 0)
        t0 = time.monotonic()
        while not h.poll(0) and time.monotonic() - t0 < 10.0:
            time.sleep(1e-3)
        client.sync_telemetry()
        ep = f"{server.host}:{server.port}"
        assert tel.registry.get_counter("odl_rpc_wire_messages", endpoint=ep) > 0
        assert tel.registry.get_counter("odl_rpc_wire_bytes", endpoint=ep) > 0
        assert tel.registry.get_counter("odl_rpc_asks_sent", endpoint=ep) >= 1
        assert any(s[0] == "rpc.flush" for s in tel.tracer.spans())
        snap = tel.registry.snapshot()
        assert snap["histograms"]["odl_rpc_batch_occupancy"][0]["count"] >= 1
        client.close()
    finally:
        server.close()


# ---------------------------------------------------------------------------
# Across the two packages
# ---------------------------------------------------------------------------


def test_prometheus_text_byte_equal_and_cross_parsed():
    """One sequence of registry calls: the same bytes from both packages,
    and each package's parser reads the other's text to the same samples."""
    from repro.runtime import telemetry as ref_telemetry  # imports no JAX

    ours = _registry_calls(telemetry).prometheus_text()
    theirs = _registry_calls(ref_telemetry).prometheus_text()
    assert ours.encode() == theirs.encode()
    assert telemetry.parse_prometheus(theirs) == ref_telemetry.parse_prometheus(ours)
    assert _registry_calls(telemetry).snapshot() == _registry_calls(ref_telemetry).snapshot()
    assert set(telemetry.STREAM_COUNTER_FIELDS) == set(ref_telemetry.STREAM_COUNTER_FIELDS)
    assert telemetry.STREAM_GAUGE_FIELDS == ref_telemetry.STREAM_GAUGE_FIELDS
    assert telemetry.STREAM_MIRROR_EXCLUDED == ref_telemetry.STREAM_MIRROR_EXCLUDED


def test_the_two_telemetry_globals_are_separate():
    from repro.runtime import telemetry as ref_telemetry

    ref_telemetry.disable()
    try:
        tel = telemetry.enable()
        assert ref_telemetry.get() is None  # enabling the port's enables nothing else
        ref = ref_telemetry.enable()
        assert ref is not tel and telemetry.get() is tel
        telemetry.disable()
        assert ref_telemetry.get() is ref
    finally:
        ref_telemetry.disable()


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("policy", ["drop_oldest", "coalesce"])
def test_port_and_reference_sessions_mirror_equal_counters_midrun(policy):
    """The same numpy ticks, labels and teacher seeds through a port session
    and a reference session (converted state), each instrumented by its own
    package: at a mid-run scrape both registries hold equal counters and
    pending gauges, and the identity holds in both; at the end too."""
    jcfg = _cfg(j_engine, j_oselm, j_pruning, j_drift, min_trained=1)
    tcfg = _cfg(min_trained=1)
    t_len, s_len = 30, 4
    xs, ys = _stream_data(t_len, s_len, seed=13)
    jst0 = j_engine.init_fleet(jcfg, s_len)
    tst0 = convert.engine_state_from_numpy(convert.engine_state_to_numpy(jst0), device="cpu")
    tel, jtel = telemetry.enable(), j_telemetry.enable()
    sessions = []
    for pkg, cfg, st0 in ((j_stream, jcfg, jst0), (stream, tcfg, tst0)):
        teacher = pkg.LatencyTeacher(pkg.array_labels(ys), latency=4, jitter=3, loss_prob=0.1,
                                     seed=2)
        sess = pkg.StreamSession(st0, cfg, teacher, mode="train_phase", capacity=3,
                                 backpressure=policy)
        sess.telemetry_labels = {"tenant": "t0"}
        sessions.append(sess)
    jsess, tsess = sessions

    def scrape():
        jsess.sync_telemetry()
        tsess.sync_telemetry()
        ours = telemetry.parse_prometheus(tel.registry.prometheus_text())
        theirs = j_telemetry.parse_prometheus(jtel.registry.prometheus_text())
        key = (("tenant", "t0"),)
        for f in telemetry.STREAM_COUNTER_FIELDS:
            name = f"odl_stream_{f}"
            assert ours[(name, key)] == theirs[(name, key)], f
        name = "odl_stream_queries_pending"
        assert ours[(name, key)] == theirs[(name, key)]
        assert telemetry.check_stream_identity(ours) == {key: True}
        assert j_telemetry.check_stream_identity(theirs) == {key: True}
        return ours[(name, key)]

    for sess in sessions:
        sess.start(xs[0])
    pending_seen = 0.0
    for t in range(t_len):
        nxt = xs[t + 1] if t + 1 < t_len else None
        for sess in sessions:
            sess.advance(nxt)
        if t in (9, 19):
            pending_seen += scrape()
    assert pending_seen > 0  # the mid-run scrapes saw queries in flight
    jsess.finish()
    tsess.finish()  # finish() mirrors by itself
    assert scrape() == 0
    st = tsess.stats
    assert st.labels_applied > 0 and st.queries_dropped + st.queries_coalesced > 0


def _mux_counters(tel_mod, tel, tenants):
    """Every ``odl_mux_*`` sample, the per-tenant stream counters, and the
    count of each span and event name, from one package's telemetry."""
    parsed = tel_mod.parse_prometheus(tel.registry.prometheus_text())
    mux = {k: v for k, v in parsed.items() if k[0].startswith("odl_mux_")}
    per = {(name, f): parsed[(f"odl_stream_{f}", (("tenant", name),))]
           for name in tenants for f in tel_mod.STREAM_COUNTER_FIELDS}
    names = {}
    for s in tel.tracer.spans():
        names[s[0]] = names.get(s[0], 0) + 1
    return mux, per, names


@pytest.mark.usefixtures("jax_ref")
def test_multiplexer_hooks_match_the_reference():
    """Both packages' multiplexers over the same tenants (fused, one tenant
    extracted mid-run and admitted back from its snapshot), each
    instrumented by its own package: equal ``odl_mux_*`` meters (rounds,
    debits, admits, extracts, cohorts packed and dissolved, live units,
    tenants), equal per-tenant stream counters after ``sync_telemetry``,
    the identity for every tenant, and the same number of spans and events
    of each name (cohort ticks, snapshot save and restore, migration extract
    and admit, cohort pack and dissolve; every tick here runs fused)."""
    from repro.engine import multiplex as j_multiplex

    from repro_torch.engine import multiplex

    jcfg = _cfg(j_engine, j_oselm, j_pruning, j_drift, min_trained=1)
    tcfg = _cfg(min_trained=1)
    datas = [_stream_data(10, 2, seed=20 + i) for i in range(3)]
    names = [f"t{i}" for i in range(3)]
    out = []
    for pkg_mux, pkg_stream, tel_mod, cfg, kw in (
            (j_multiplex, j_stream, j_telemetry, jcfg, {}),
            (multiplex, stream, telemetry, tcfg, {"device": "cpu"})):
        tel = tel_mod.enable()
        tenants = []
        for name, (xs, ys) in zip(names, datas):
            st0 = j_engine.init_fleet(jcfg, 2)
            if pkg_mux is multiplex:
                st0 = convert.engine_state_from_numpy(convert.engine_state_to_numpy(st0),
                                                      device="cpu")
            teacher = pkg_stream.LatencyTeacher(pkg_stream.array_labels(ys), latency=1, seed=4)
            tenants.append(pkg_mux.Tenant(name, st0, iter(xs), cfg, teacher, mode="train_phase",
                                          capacity=4, **kw))
        mux = pkg_mux.Multiplexer(tenants, quantum=2)
        mux.round()
        tree, it = mux.extract("t0")
        fresh = pkg_stream.LatencyTeacher(pkg_stream.array_labels(datas[0][1]), latency=1, seed=4)
        mux.admit(pkg_mux.Tenant("t0", None, it, cfg, fresh, mode="train_phase", capacity=4, **kw),
                  snapshot=tree, positioned=True)
        results, agg = mux.run()
        mux.sync_telemetry()
        out.append((_mux_counters(tel_mod, tel, names), agg.rounds,
                    {n: r.stats.reconciled for n, r in results.items()}))
        checks = tel_mod.check_stream_identity(
            tel_mod.parse_prometheus(tel.registry.prometheus_text()))
        assert len(checks) == 3 and all(checks.values())
        tel_mod.disable()
    (j_mux, j_per, j_names), j_rounds, _ = out[0]
    (t_mux, t_per, t_names), t_rounds, reconciled = out[1]
    assert t_mux == j_mux and t_rounds == j_rounds
    assert t_per == j_per
    assert t_names == j_names
    assert all(reconciled.values())
    for name in ("cohort.tick", "cohort.pack", "migrate.extract", "migrate.admit",
                 "snapshot.save", "snapshot.restore", "cohort.dissolve"):
        assert t_names.get(name, 0) > 0, name
    assert t_mux[("odl_mux_admits", ())] == 4 and t_mux[("odl_mux_extracts", ())] == 1
