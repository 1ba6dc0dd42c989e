"""The port's teacher transport (``repro_torch.engine.rpc`` on
``engine/wire.py``), mirroring ``tests/test_rpc.py``, and held against the
JAX package's ``repro.engine.rpc`` on the wire.

Mirrors: the v2 codec, a non-object frame header, v1 and v2 clients on one
server, the batched client (one frame for two tenants, ``batch_max``,
batched == per-tenant bit for bit, shared-client tenants == solo runs,
accounting under loss, jitter and timeout), ``shared_rpc_teachers``, the
server's bounded thread list, untorn frames under concurrent asks, poisoned
connections and the batched client's reconnect, zlib envelopes.

Across the two packages: the codec's frames byte for byte (zlib envelope
included) and each package decoding the other's; clients of each package
against the other's server, both wires, HMAC with the right and a wrong
secret, compression negotiated; a port session and a reference session each
taught over the other package's server, T=24, S=4, tick by tick in
``train_phase`` and ``algo1``; the ask owning its copy of the features.

Every socket binds port 0 on the loopback; waits have deadlines.  The
``cuda`` tests hold the same on the card (a tensor on the card asked, and a
graphed session taught over the wire) and skip elsewhere.  Where JAX is
missing (the card's machine) the tests against the JAX package skip.
"""

import importlib.util
import io
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

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
    from repro.engine import rpc as j_rpc
    from repro.engine import stream as j_stream

from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.engine import graphs, multiplex, rpc, stream, wire  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N_IN, N_HIDDEN, N_OUT = 24, 16, 4
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _cfg(pkg_engine=engine, pkg_oselm=oselm, pkg_pruning=pruning, pkg_drift=drift_mod,
         min_trained=16, ridge=1e-2):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, variant="hash",
                                  ridge=ridge),
        prune=pkg_pruning.PruneConfig(min_trained=min_trained),
        drift=pkg_drift.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )


def _stream_data(t, s, seed=0, shift_at=None):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    if shift_at is not None:
        sev = np.linspace(2.0, 4.0, s)[None, :, None]
        xs[shift_at:] = np.clip(xs[shift_at:] * sev + 0.5 * sev, -4, 4)
    return xs


def _fleet(cfg, s, device="cpu"):
    return engine.init_fleet(cfg, s, device=device)


def _assert_state_equal(a, b, msg=""):
    a, b = convert.engine_state_to_numpy(a), convert.engine_state_to_numpy(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} leaf {k} diverged")


def _assert_reconciled(stats):
    assert stats.reconciled, stats.summary()


class _SyncTeacher:
    """Waits out each ask's reply before returning: the application
    schedule then no longer depends on the wall clock, and since the labels
    are deterministic (``expected_label``) two runs compare bit for bit."""

    def __init__(self, inner, timeout=20.0):
        self.inner = inner
        self.timeout = timeout

    def ask(self, feats, mask, tick):
        ticket = self.inner.ask(feats, mask, tick)
        deadline = time.monotonic() + self.timeout
        while self.inner.in_flight() > 0 and time.monotonic() < deadline:
            time.sleep(2e-4)
        return ticket

    def poll(self, tick):
        return self.inner.poll(tick)

    def in_flight(self):
        return self.inner.in_flight()


def _drain(teacher, timeout=10.0):
    deadline = time.monotonic() + timeout
    replies = []
    while not replies and time.monotonic() < deadline:
        replies = teacher.poll(0)
        if not replies and teacher.in_flight() == 0:
            replies = teacher.poll(0)
            break
        time.sleep(1e-3)
    return replies


@pytest.fixture()
def server():
    srv = rpc.LabelServer(n_out=4).start()
    yield srv
    srv.close()


# ---------------------------------------------------------------------------
# v2 framing codec
# ---------------------------------------------------------------------------


def _asks_and_replies(seed=0):
    rng = np.random.default_rng(seed)
    asks = [
        (7, 3, np.array([True, False, True]), rng.normal(size=(3, 5)).astype(np.float32)),
        (9, 4, np.ones(2, bool), rng.normal(size=(2, 8)).astype(np.float32)),
    ]
    replies = [
        (7, np.array([True, False, True]), np.array([1, 0, 3], np.int32)),
        (9, np.zeros(2, bool), np.zeros(2, np.int32)),
    ]
    return asks, replies


def test_codec_roundtrips_asks_and_replies():
    asks, replies = _asks_and_replies()
    frame = rpc.encode_asks(asks)
    assert frame[0] == rpc.WIRE_V2
    got = list(rpc._iter_wire(io.BufferedReader(io.BytesIO(frame))))
    assert len(got) == 1 and got[0][0] == "v2"
    decoded = rpc.decode_asks(got[0][1], got[0][2])
    assert len(decoded) == 2
    for (t0, k0, m0, f0), (t1, k1, m1, f1) in zip(asks, decoded):
        assert (t0, k0) == (t1, k1)
        np.testing.assert_array_equal(np.asarray(m0, bool), m1)
        np.testing.assert_array_equal(f0, f1)
    back = rpc.decode_replies(*list(
        rpc._iter_wire(io.BufferedReader(io.BytesIO(rpc.encode_replies(replies)))))[0][1:])
    assert [r.ticket for r in back] == [7, 9]
    np.testing.assert_array_equal(back[0].labels, [1, 0, 3])
    np.testing.assert_array_equal(back[0].answered, [True, False, True])
    assert back[0].labels.dtype == np.int32 and back[0].answered.dtype == bool


def test_non_object_frame_header_is_a_frame_error_not_a_crash(server):
    """A v2 header that is valid JSON but not an object has no knowable
    payload length: the server meters a frame error and drops the
    connection, and keeps serving others."""
    frame = bytes([rpc.WIRE_V2]) + len(b"[1,2]").to_bytes(4, "little") + b"[1,2]"
    conn = socket.create_connection(("127.0.0.1", server.port), timeout=5.0)
    try:
        conn.sendall(frame)
        deadline = time.monotonic() + 5.0
        while server.frame_errors == 0 and time.monotonic() < deadline:
            time.sleep(5e-3)
        assert server.frame_errors == 1
        assert conn.recv(1) == b""
    finally:
        conn.close()
    with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0) as teacher:
        teacher.ask(np.zeros((2, 3), np.float32), np.ones(2, bool), tick=1)
        assert _drain(teacher)


def test_v1_and_v2_clients_interoperate_on_one_server(server):
    feats = torch.zeros((3, 4))
    mask = np.ones(3, bool)
    want = [rpc.expected_label(5, s, server.n_out) for s in range(3)]
    for wire_fmt in rpc.WIRE_FORMATS:
        with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0, wire=wire_fmt) as teacher:
            teacher.ask(feats, mask, tick=5)
            replies = _drain(teacher)
            assert replies and replies[0].labels.tolist() == want, wire_fmt
            assert replies[0].answered.all()
    assert server.requests_v1 == 1 and server.frames_v2 == 1 and server.frame_errors == 0


# ---------------------------------------------------------------------------
# Batched shared-connection client
# ---------------------------------------------------------------------------


def test_batched_client_coalesces_tenants_into_one_frame(server):
    feats = np.zeros((2, 4), np.float32)
    mask = np.ones(2, bool)
    with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                              batch_window_s=0.25) as client:
        a, b = client.tenant("a"), client.tenant("b")
        ta = a.ask(feats, mask, tick=1)
        tb = b.ask(torch.from_numpy(feats), mask, tick=2)
        ra, rb = _drain(a), _drain(b)
    assert client.wire_messages == 1 and client.asks_sent == 2
    assert server.frames_v2 == 1 and server.asks_served == 2
    assert [r.ticket for r in ra] == [ta] and [r.ticket for r in rb] == [tb]
    assert ra[0].labels.tolist() == [rpc.expected_label(1, s, 4) for s in range(2)]
    assert rb[0].labels.tolist() == [rpc.expected_label(2, s, 4) for s in range(2)]


def test_batch_max_flushes_before_the_window(server):
    feats = np.zeros((1, 2), np.float32)
    mask = np.ones(1, bool)
    with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0, batch_window_s=30.0,
                              batch_max=4) as client:
        t = client.tenant()
        for k in range(4):  # reaches batch_max: flushes now, not in 30 s
            t.ask(feats, mask, tick=k)
        replies = []
        deadline = time.monotonic() + 10.0
        while len(replies) < 4 and time.monotonic() < deadline:
            replies += t.poll(0)
            time.sleep(1e-3)
    assert len(replies) == 4
    assert client.wire_messages == 1 and client.asks_sent == 4


def test_batched_vs_solo_parity_bit_for_bit(server):
    cfg = _cfg(min_trained=2)
    t_len, s_len = 8, 3
    xs = _stream_data(t_len, s_len, seed=21)

    def run_with(teacher):
        return stream.run(_fleet(cfg, s_len), iter(xs), cfg, _SyncTeacher(teacher),
                          mode="train_phase")

    with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=20.0) as solo:
        st_solo, outs_solo, stats_solo = run_with(solo)
    with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=20.0,
                              batch_window_s=1e-3) as client:
        st_b, outs_b, stats_b = run_with(client.tenant())
    _assert_state_equal(st_solo, st_b, msg="batched-vs-solo")
    for name in outs_solo._fields:
        np.testing.assert_array_equal(getattr(outs_solo, name), getattr(outs_b, name),
                                      err_msg=name)
    assert stats_b.labels_applied == stats_solo.labels_applied == t_len * s_len
    _assert_reconciled(stats_solo)
    _assert_reconciled(stats_b)


def test_multiplexed_tenants_on_shared_client_match_solo_runs(server):
    """Two fused port tenants on one ``shared_rpc_teachers`` connection each
    equal their solo per-tenant-connection run bit for bit: the demux never
    leaks a label across tenants."""
    cfg = _cfg(min_trained=2)
    datas = [_stream_data(8, 3, seed=31), _stream_data(6, 3, seed=32)]
    solo = []
    for xs in datas:
        with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=20.0) as teacher:
            solo.append(stream.run(_fleet(cfg, xs.shape[1]), iter(xs), cfg,
                                   _SyncTeacher(teacher), mode="train_phase"))
    teachers, clients = multiplex.shared_rpc_teachers(
        [("127.0.0.1", server.port)] * 2, timeout_s=20.0, batch_window_s=1e-3)
    try:
        assert len(clients) == 1
        tenants = [
            multiplex.Tenant(name=f"tenant{i}", state=_fleet(cfg, xs.shape[1]), ticks=iter(xs),
                             cfg=cfg, teacher=_SyncTeacher(teachers[i]), mode="train_phase")
            for i, xs in enumerate(datas)
        ]
        tel = telemetry.enable()
        results, _ = multiplex.run(tenants)
        assert tel.registry.get_counter("odl_mux_cohorts_packed") == 1  # they ran fused
    finally:
        telemetry.disable()
        for c in clients:
            c.close()
    for i, (st, outs, stats) in enumerate(solo):
        r = results[f"tenant{i}"]
        _assert_state_equal(st, r.state, msg=f"tenant{i}")
        for name in outs._fields:
            np.testing.assert_array_equal(getattr(outs, name), getattr(r.outputs, name),
                                          err_msg=f"tenant{i} {name}")
        assert r.stats.labels_applied == stats.labels_applied > 0
        _assert_reconciled(r.stats)


def test_batched_accounting_reconciles_under_loss_jitter_timeout():
    server = rpc.LabelServer(n_out=4, loss_prob=0.3, jitter_s=2e-3, seed=7).start()
    try:
        cfg = _cfg(min_trained=1_000_000)
        datas = [_stream_data(20, 3, seed=41), _stream_data(15, 2, seed=42)]
        with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=0.5,
                                  batch_window_s=1e-3) as client:
            tenants = [
                multiplex.Tenant(name=f"tenant{i}", state=_fleet(cfg, xs.shape[1]),
                                 ticks=iter(xs), cfg=cfg, teacher=client.tenant(f"tenant{i}"),
                                 mode="train_phase")
                for i, xs in enumerate(datas)
            ]
            results, _ = multiplex.run(tenants)
            for i, xs in enumerate(datas):
                s = results[f"tenant{i}"].stats
                assert s.queries_issued == xs.shape[0] * xs.shape[1]
                assert s.queries_lost > 0 and s.labels_applied > 0
                assert s.queries_issued == s.labels_applied + s.queries_dropped + s.queries_lost
                _assert_reconciled(s)
            assert client.timed_out > 0
    finally:
        server.close()


def test_shared_rpc_teachers_dedups_by_endpoint():
    s1 = rpc.LabelServer(n_out=4).start()
    s2 = rpc.LabelServer(n_out=4).start()
    try:
        teachers, clients = multiplex.shared_rpc_teachers(
            [("127.0.0.1", s1.port), ("127.0.0.1", s1.port), ("127.0.0.1", s2.port)],
            timeout_s=5.0)
        assert len(teachers) == 3 and len(clients) == 2
        assert teachers[0]._client is teachers[1]._client
        assert teachers[2]._client is not teachers[0]._client
        assert [t.name for t in teachers] == ["tenant0", "tenant1", "tenant2"]
        for c in clients:
            c.close()
    finally:
        s1.close()
        s2.close()


def test_shared_rpc_teachers_closes_partial_clients_on_failure():
    s1 = rpc.LabelServer(n_out=4).start()
    tmp = socket.socket()
    tmp.bind(("127.0.0.1", 0))
    dead_port = tmp.getsockname()[1]
    tmp.close()  # nothing listens here any more
    try:
        with pytest.raises(OSError):
            multiplex.shared_rpc_teachers([("127.0.0.1", s1.port), ("127.0.0.1", dead_port)],
                                          timeout_s=1.0, connect_timeout_s=1.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with s1._tlock:
                if not s1._conns:
                    break
            time.sleep(5e-3)
        with s1._tlock:
            assert not s1._conns  # the good client's connection was torn down
    finally:
        s1.close()


# ---------------------------------------------------------------------------
# The label server's thread list stays bounded
# ---------------------------------------------------------------------------


def test_burst_of_connections_keeps_server_thread_list_bounded():
    server = rpc.LabelServer(n_out=4).start()
    try:
        feats = np.zeros((1, 2), np.float32)
        mask = np.ones(1, bool)
        for _ in range(40):
            with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=5.0) as t:
                t.ask(feats, mask, tick=0)
                assert _drain(t)
            time.sleep(2e-3)
        with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=5.0):
            time.sleep(0.05)  # one more accept prunes what died above
            with server._tlock:
                n_tracked = len(server._threads)
        assert n_tracked <= 10, n_tracked
    finally:
        server.close()
    assert server.thread_count() == 0  # close() joined every worker


# ---------------------------------------------------------------------------
# Socket writes are serialized (no torn frames)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["solo", "batched"])
def test_concurrent_asks_never_tear_a_frame(server, transport):
    n_threads, n_asks, s_len = 8, 25, 3
    feats = np.zeros((s_len, 4), np.float32)
    mask = np.ones(s_len, bool)
    if transport == "solo":
        teacher = rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=30.0)
        handles = [teacher] * n_threads
        closer = teacher
    else:
        client = rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=30.0,
                                      batch_window_s=5e-4, batch_max=7)
        handles = [client.tenant(f"h{i}") for i in range(n_threads)]
        closer = client
    try:
        def worker(h):
            for k in range(n_asks):
                h.ask(feats, mask, tick=k)

        threads = [threading.Thread(target=worker, args=(h,)) for h in handles]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30.0)
        assert not any(t.is_alive() for t in threads)
        want = n_threads * n_asks
        replies = []
        deadline = time.monotonic() + 20.0
        while len(replies) < want and time.monotonic() < deadline:
            for h in set(handles):
                replies += h.poll(0)
            time.sleep(1e-3)
        assert len(replies) == want, (len(replies), want)
        for r in replies:
            assert r.labels.shape == (s_len,) and r.answered.all()
        assert server.frame_errors == 0
    finally:
        closer.close()


# ---------------------------------------------------------------------------
# A mid-frame write failure poisons the connection
# ---------------------------------------------------------------------------


class _DeadFile:
    """A write file that fails mid-frame, like a peer reset under a
    half-flushed buffer."""

    def __init__(self):
        self.write_calls = 0

    def write(self, data):
        self.write_calls += 1
        raise OSError("connection reset mid-frame")

    def flush(self):
        pass

    def close(self):
        pass


def test_write_failure_marks_solo_connection_dead(server):
    feats = np.zeros((2, 3), np.float32)
    mask = np.ones(2, bool)
    teacher = rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=0.2)
    dead = _DeadFile()
    teacher._conn.wfile = dead
    t0 = teacher.ask(feats, mask, 0)  # the write fails: poisoned
    t1 = teacher.ask(feats, mask, 1)  # must not touch the wire again
    assert teacher.broken
    assert dead.write_calls == 1
    assert t0 != t1
    assert teacher.in_flight() == 2
    time.sleep(0.25)
    assert teacher.in_flight() == 0
    assert teacher.poll(0) == []
    assert teacher.timed_out == 2
    teacher.close()


def test_write_failure_marks_batched_connection_dead():
    server = rpc.LabelServer(n_out=4).start()
    feats = np.zeros((2, 3), np.float32)
    mask = np.ones(2, bool)
    client = rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=0.2, batch_window_s=0.0)
    server.close()  # nothing left to reconnect to
    a, b = client.tenant("a"), client.tenant("b")
    dead = _DeadFile()
    client._conn.wfile = dead
    a.ask(feats, mask, 0)
    b.ask(feats, mask, 1)  # broken: the one reconnect attempt is refused
    assert client.broken
    assert client.reconnects == 0 and client.asks_reasked == 0
    assert dead.write_calls == 1
    assert not client._queue
    time.sleep(0.25)
    assert a.in_flight() == 0 and b.in_flight() == 0
    assert a.poll(0) == [] and b.poll(0) == []
    assert a.timed_out == 1 and b.timed_out == 1
    client.close()


def test_batched_client_reconnects_once_and_reasks_in_flight(server):
    feats = np.zeros((2, 3), np.float32)
    mask = np.ones(2, bool)
    client = rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0, batch_window_s=0.0)
    a, b = client.tenant("a"), client.tenant("b")
    client._conn.wfile = _DeadFile()
    ta = a.ask(feats, mask, 0)  # the write fails: poisoned, ticket pending
    tb = b.ask(feats, mask, 1)  # next flush: reconnect, re-ask both tickets
    assert not client.broken
    assert client.reconnects == 1 and client.asks_reasked == 2
    ra, rb = _drain(a), _drain(b)
    assert [r.ticket for r in ra] == [ta] and [r.ticket for r in rb] == [tb]
    assert ra[0].labels.tolist() == [rpc.expected_label(0, s, 4) for s in range(2)]
    assert rb[0].labels.tolist() == [rpc.expected_label(1, s, 4) for s in range(2)]
    assert client.timed_out == 0 and a.timed_out == 0 and b.timed_out == 0
    client._conn.wfile = _DeadFile()  # a second poisoning earns its own attempt
    tc = a.ask(feats, mask, 2)
    td = a.ask(feats, mask, 3)
    assert not client.broken
    assert client.reconnects == 2 and client.asks_reasked == 4
    replies = []
    deadline = time.monotonic() + 10.0
    while len(replies) < 2 and time.monotonic() < deadline:
        replies += a.poll(0)
        time.sleep(1e-3)
    assert sorted(r.ticket for r in replies) == sorted([tc, td])
    assert client.timed_out == 0
    client.close()


def test_stream_run_survives_a_poisoned_connection(server):
    cfg = _cfg(min_trained=1_000_000)
    xs = _stream_data(5, 2, seed=51)
    teacher = rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=0.2)
    teacher._conn.wfile = _DeadFile()
    st, outs, stats = stream.run(_fleet(cfg, 2), iter(xs), cfg, teacher, mode="train_phase")
    assert stats.labels_applied == 0
    assert stats.queries_lost == stats.queries_issued == 5 * 2
    assert int(st.elm.count.sum()) == 0
    _assert_reconciled(stats)
    teacher.close()


# ---------------------------------------------------------------------------
# zlib envelopes (0x03)
# ---------------------------------------------------------------------------


def test_compressed_roundtrip_is_answered_in_kind_and_metered(server):
    s = 32
    feats = np.zeros((s, 6), np.float32)
    with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0, compress=True) as teacher:
        ticket = teacher.ask(feats, np.ones(s, bool), tick=2)
        replies = _drain(teacher)
    assert replies and replies[0].ticket == ticket
    assert replies[0].labels.tolist() == [rpc.expected_label(2, i, server.n_out) for i in range(s)]
    assert server.frames_compressed == 1 and server.frames_v2 == 1
    assert server.raw_bytes_in > server.compressed_bytes_in > 0
    assert server.raw_bytes_out >= server.compressed_bytes_out > 0
    frame = rpc.encode_asks([(ticket, 2, np.ones(s, bool), feats)])
    assert server.compressed_bytes_in < len(frame)


def test_uncompressed_client_pays_no_compression_tax(server):
    with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0) as teacher:
        teacher.ask(np.zeros((2, 3), np.float32), np.ones(2, bool), tick=1)
        assert _drain(teacher)
    assert server.frames_compressed == 0 and server.compressed_bytes_in == 0


def test_compress_requires_v2_wire():
    with pytest.raises(ValueError, match="v2"):
        rpc.RpcTeacher("127.0.0.1", 1, wire="v1", compress=True)


def test_handshake_negotiates_compression():
    server = rpc.LabelServer(n_out=4, secret="s3").start()
    try:
        with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0, secret="s3",
                            compress=True) as teacher:
            assert teacher._conn.compress_granted
            teacher.ask(np.zeros((4, 3), np.float32), np.ones(4, bool), tick=0)
            assert _drain(teacher)
        assert server.frames_compressed == 1
    finally:
        server.close()


def test_corrupt_zlib_envelope_is_a_frame_error(server):
    bad = b"not-zlib-data"
    envelope = bytes([rpc.WIRE_V3_ZLIB]) + len(bad).to_bytes(4, "little") + bad
    conn = socket.create_connection(("127.0.0.1", server.port), timeout=5.0)
    try:
        conn.sendall(envelope)
        deadline = time.monotonic() + 5.0
        while server.frame_errors == 0 and time.monotonic() < deadline:
            time.sleep(5e-3)
        assert server.frame_errors == 1
        assert conn.recv(1) == b""
    finally:
        conn.close()


def test_batched_client_compresses_shared_frames(server):
    feats = np.zeros((8, 4), np.float32)
    mask = np.ones(8, bool)
    with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0, batch_window_s=0.2,
                              compress=True) as client:
        a, b = client.tenant("a"), client.tenant("b")
        a.ask(feats, mask, 3)
        b.ask(feats, mask, 3)
        ra, rb = _drain(a), _drain(b)
    assert ra and rb
    assert client.wire_messages == 1 and client.asks_sent == 2
    assert server.frames_compressed == 1 and server.asks_served == 2


# ---------------------------------------------------------------------------
# The ask owns its copy of the features
# ---------------------------------------------------------------------------


class _RecordingServer(rpc.LabelServer):
    """A port label server that keeps a copy of every ask's features, by
    ticket, as they came off the wire."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen: dict[int, np.ndarray] = {}

    def _answer(self, asks, rng):
        with self._tlock:
            for ticket, _tick, _mask, feats in asks:
                if feats is not None:
                    self.seen[ticket] = np.array(feats)
        return super()._answer(asks, rng)


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_ask_copies_features_before_returning(kind):
    """The caller rewrites its features right after ``ask`` returns (a
    session's ping-pong buffers, a cohort's stacked tick): the wire still
    carries the values at ask time, through the batched client's flush
    window and through its re-ask after a reconnect."""
    server = _RecordingServer(n_out=4).start()
    rng = np.random.default_rng(3)
    orig = [rng.normal(size=(3, 5)).astype(np.float32) for _ in range(4)]
    bufs = [torch.from_numpy(o.copy()) if kind == "tensor" else o.copy() for o in orig]
    mask = np.ones(3, bool)

    def scribble(buf):
        buf[...] = 7.0  # in place: a tensor and its numpy alias alike

    try:
        with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0) as solo:
            t_solo = solo.ask(bufs[0], mask, tick=0)
            scribble(bufs[0])
            assert _drain(solo)
        with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                  batch_window_s=0.3) as client:
            h = client.tenant("a")
            t_window = h.ask(bufs[1], mask, tick=1)
            scribble(bufs[1])  # before the flusher frames it
            assert _drain(h)
        with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                  batch_window_s=0.0) as client:
            h = client.tenant("b")
            client._conn.wfile = _DeadFile()
            t_lost = h.ask(bufs[2], mask, tick=2)  # poisons the connection
            scribble(bufs[2])
            t_next = h.ask(bufs[3], mask, tick=3)  # reconnects, re-asks both
            scribble(bufs[3])
            assert client.asks_reasked == 2
            replies = []
            deadline = time.monotonic() + 10.0
            while len(replies) < 2 and time.monotonic() < deadline:
                replies += h.poll(0)
                time.sleep(1e-3)
            assert len(replies) == 2
        with server._tlock:
            seen = dict(server.seen)
    finally:
        server.close()
    # Tickets count per connection: the solo's and each client's start at 0.
    assert t_solo == t_window == t_lost == 0 and t_next == 1
    np.testing.assert_array_equal(seen[0], orig[2])  # the last ticket 0: the re-asked one
    np.testing.assert_array_equal(seen[1], orig[3])
    assert not any((v == 7.0).all() for v in seen.values())


# ---------------------------------------------------------------------------
# Against the JAX package: the codec, both wires, HMAC, compression
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("jax_ref")
def test_codec_frames_byte_equal_to_reference_and_cross_decoded():
    rng = np.random.default_rng(17)
    asks = [(int(t), int(k), rng.uniform(size=s) < 0.6,
             rng.normal(size=(s, d)).astype(np.float32))
            for t, k, s, d in ((0, 3, 5, 7), (41, 9, 16, 561), (7, 0, 1, 1), (8, 2, 0, 0))]
    replies = [(int(t), rng.uniform(size=s) < 0.5, rng.integers(0, 6, s).astype(np.int32))
               for t, s in ((0, 5), (41, 16), (7, 1))]
    ours, theirs = wire.encode_asks(asks), j_rpc.encode_asks(asks)
    assert ours == theirs
    assert wire._compress_frame(ours) == j_rpc._compress_frame(theirs)
    assert wire.encode_replies(replies) == j_rpc.encode_replies(replies)
    assert (wire._encode_frame({"kind": "stats", "payload_len": 0})
            == j_rpc._encode_frame({"kind": "stats", "payload_len": 0}, b""))
    # Each package decodes the other's frames, plain and enveloped.
    for frame, reader, decode in (
        (theirs, wire._iter_wire, wire.decode_asks),
        (j_rpc._compress_frame(theirs), wire._iter_wire, wire.decode_asks),
        (ours, j_rpc._iter_wire, j_rpc.decode_asks),
        (wire._compress_frame(ours), j_rpc._iter_wire, j_rpc.decode_asks),
    ):
        (kind, header, payload), = list(reader(io.BufferedReader(io.BytesIO(frame))))
        assert kind == "v2"
        header.pop("_z", None)
        got = decode(header, payload)
        for (t0, k0, m0, f0), (t1, k1, m1, f1) in zip(asks, got, strict=True):
            assert (t0, k0) == (t1, k1)
            np.testing.assert_array_equal(m0, m1)
            np.testing.assert_array_equal(f0, f1)
    for frame, reader, decode in (
        (j_rpc.encode_replies(replies), wire._iter_wire, wire.decode_replies),
        (wire.encode_replies(replies), j_rpc._iter_wire, j_rpc.decode_replies),
    ):
        (_, header, payload), = list(reader(io.BufferedReader(io.BytesIO(frame))))
        got = decode(header, payload)
        assert [r.ticket for r in got] == [t for t, _, _ in replies]
        for r, (_, a, lab) in zip(got, replies):
            np.testing.assert_array_equal(r.answered, a)
            np.testing.assert_array_equal(r.labels, lab)


def _servers(direction, **kw):
    """(server, client module) for one direction of the interop."""
    if direction == "port_client_ref_server":
        return j_rpc.LabelServer(**kw).start(), rpc
    return rpc.LabelServer(**kw).start(), j_rpc


DIRECTIONS = ["port_client_ref_server", "ref_client_port_server"]


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_clients_and_servers_interoperate_across_packages(direction):
    """Both wires, compressed envelopes and the batched client, each answered
    in kind with exact labels by the other package's server."""
    server, client_mod = _servers(direction, n_out=5)
    feats = np.linspace(-1, 1, 6 * 4, dtype=np.float32).reshape(6, 4)
    mask = np.array([True, False, True, True, False, True])
    try:
        for wire_fmt, compress in (("v1", False), ("v2", False), ("v2", True)):
            with client_mod.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0, wire=wire_fmt,
                                       compress=compress) as teacher:
                ticket = teacher.ask(feats, mask, tick=9)
                replies = _drain(teacher)
            assert [r.ticket for r in replies] == [ticket], (wire_fmt, compress)
            assert replies[0].labels.tolist() == [rpc.expected_label(9, s, 5) for s in range(6)]
            np.testing.assert_array_equal(replies[0].answered, mask)
        with client_mod.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                         batch_window_s=0.25) as client:
            a, b = client.tenant("a"), client.tenant("b")
            a.ask(feats, mask, 1)
            b.ask(feats[:2], mask[:2], 2)
            ra, rb = _drain(a), _drain(b)
        assert ra[0].labels.tolist() == [rpc.expected_label(1, s, 5) for s in range(6)]
        assert rb[0].labels.tolist() == [rpc.expected_label(2, s, 5) for s in range(2)]
        assert client.wire_messages == 1
        stats = server.stats()
        assert stats["requests_v1"] == 1 and stats["frames_v2"] == 3
        assert stats["frames_compressed"] == 1 and stats["asks_served"] == 5
        assert stats["frame_errors"] == 0
        # The wire scrape of the stats, across packages too.
        assert client_mod.server_stats("127.0.0.1", server.port)["asks_served"] == 5
    finally:
        server.close()


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_hmac_and_compression_negotiated_across_packages(direction):
    server, client_mod = _servers(direction, n_out=4, secret="k3y")
    try:
        with client_mod.RpcTeacher("127.0.0.1", server.port, timeout_s=10.0, secret="k3y",
                                   compress=True) as teacher:
            assert teacher._conn.compress_granted
            teacher.ask(np.zeros((3, 2), np.float32), np.ones(3, bool), tick=4)
            replies = _drain(teacher)
        assert replies[0].labels.tolist() == [rpc.expected_label(4, s, 4) for s in range(3)]
        with client_mod.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                         secret="k3y", batch_window_s=0.0) as client:
            h = client.tenant()
            h.ask(np.zeros((3, 2), np.float32), np.ones(3, bool), tick=5)
            assert _drain(h)[0].labels.tolist() == [rpc.expected_label(5, s, 4)
                                                    for s in range(3)]
        with pytest.raises(ConnectionError):
            client_mod.RpcTeacher("127.0.0.1", server.port, timeout_s=1.0, secret="wrong",
                                  connect_timeout_s=2.0)
        # No secret at all: the server closes the connection, nothing comes back.
        with client_mod.RpcTeacher("127.0.0.1", server.port, timeout_s=0.3) as teacher:
            teacher.ask(np.zeros((3, 2), np.float32), np.ones(3, bool), tick=6)
            time.sleep(0.4)
            assert teacher.poll(6) == [] and teacher.in_flight() == 0
        deadline = time.monotonic() + 5.0
        while server.auth_failures < 2 and time.monotonic() < deadline:
            time.sleep(5e-3)
        assert server.auth_failures == 2
        assert server.frames_compressed == 1  # the RpcTeacher's; the batched client asked none
    finally:
        server.close()


# ---------------------------------------------------------------------------
# The slice end to end: each package's session over the other's server
# ---------------------------------------------------------------------------


def _tick_columns(sess):
    """The collected columns of the session's last advanced tick."""
    return {k: np.asarray(v[-1]) for k, v in sess._cols.items()}


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("mode", ["train_phase", "algo1"])
def test_port_and_reference_sessions_over_each_others_servers(mode):
    """A port session (CPU) taught by a port ``RpcTeacher`` against a
    reference ``LabelServer``, beside a reference session taught by a
    reference ``RpcTeacher`` against a port ``LabelServer``, both behind the
    sync wrapper.  Per tick: decisions and counters exact, outputs within
    1e-5, P within 2e-5 and beta within 2e-4 (ridge 1: P starts at I); then
    the reference state is fed into the port session, so each tick starts
    equal.  The end-of-run accounting is identical."""
    t_len, s_len = 24, 4
    shift_at = 18 if mode == "algo1" else None
    xs = _stream_data(t_len, s_len, seed=61, shift_at=shift_at)
    min_trained = 1_000_000 if mode == "train_phase" else 16
    jcfg = _cfg(j_engine, j_oselm, j_pruning, j_drift, min_trained=min_trained, ridge=1.0)
    tcfg = _cfg(min_trained=min_trained, ridge=1.0)
    jst0 = j_engine.init_fleet(jcfg, s_len)
    ref_server, port_server = j_rpc.LabelServer(n_out=N_OUT).start(), \
        rpc.LabelServer(n_out=N_OUT).start()
    t_teacher = rpc.RpcTeacher("127.0.0.1", ref_server.port, timeout_s=20.0)
    j_teacher = j_rpc.RpcTeacher("127.0.0.1", port_server.port, timeout_s=20.0)
    try:
        jsess = j_stream.StreamSession(jst0, jcfg, _SyncTeacher(j_teacher), mode=mode)
        tsess = stream.StreamSession(
            convert.engine_state_from_numpy(convert.engine_state_to_numpy(jst0), device="cpu"),
            tcfg, _SyncTeacher(t_teacher), mode=mode)
        for sess in (jsess, tsess):
            sess.start(xs[0])
        for t in range(t_len):
            nxt = xs[t + 1] if t + 1 < t_len else None
            jsess.advance(nxt)
            tsess.advance(nxt)
            tc, jc = _tick_columns(tsess), _tick_columns(jsess)
            for k in ("pred", "queried", "theta", "mode_training"):
                np.testing.assert_array_equal(tc[k], jc[k], err_msg=f"tick {t}: {k}")
            for k in ("outputs", "confidence"):
                np.testing.assert_allclose(tc[k], jc[k], rtol=1e-5, atol=1e-5,
                                           err_msg=f"tick {t}: {k}")
            for k in COUNTERS:
                assert getattr(tsess.stats, k) == getattr(jsess.stats, k), (t, k)
            ts = convert.engine_state_to_numpy(tsess.state)
            js = convert.engine_state_to_numpy(jsess.state)
            for k in ts:
                assert ts[k].dtype == js[k].dtype, k
                if k == "elm.P":
                    np.testing.assert_allclose(ts[k], js[k], atol=2e-5, err_msg=f"tick {t}: P")
                elif k == "elm.beta":
                    np.testing.assert_allclose(ts[k], js[k], atol=2e-4, err_msg=f"tick {t}: beta")
                elif ts[k].dtype == np.float32:
                    np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6,
                                               err_msg=f"tick {t}: {k}")
                else:
                    np.testing.assert_array_equal(ts[k], js[k], err_msg=f"tick {t}: {k}")
            tsess.state = convert.engine_state_from_numpy(js, device="cpu")
        jst, jouts, jstats = jsess.finish()
        tst, touts, tstats = tsess.finish()
    finally:
        t_teacher.close()
        j_teacher.close()
        ref_server.close()
        port_server.close()
    for k in COUNTERS:
        assert getattr(tstats, k) == getattr(jstats, k), k
    assert tstats.reconciled and jstats.reconciled
    assert list(tstats.label_latency_ticks) == list(jstats.label_latency_ticks)
    np.testing.assert_array_equal(touts.trained, np.asarray(jouts.trained))
    assert tstats.labels_applied == int(touts.queried.sum()) > 0
    if mode == "algo1":
        assert touts.mode_training.any() and not touts.mode_training[:shift_at].any()
    # Each server answered every ask of the other package's client.
    assert port_server.asks_served == jstats.tickets_issued
    assert ref_server.asks_served == tstats.tickets_issued
    assert ref_server.frame_errors == port_server.frame_errors == 0


# ---------------------------------------------------------------------------
# The CLI and the loopback subprocess
# ---------------------------------------------------------------------------


def test_selftest_cli_exits_zero():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "repro_torch.engine.rpc", "--selftest",
                          "--device", "cpu"], capture_output=True, text=True, timeout=60,
                         env=env)
    assert out.returncode == 0, out.stderr
    assert "rpc selftest OK on cpu" in out.stdout


@pytest.mark.usefixtures("jax_ref")
def test_reference_client_against_port_loopback_subprocess():
    """The port's ``loopback_server`` child (``python -m
    repro_torch.engine.rpc``) answers a reference client, with loss and a
    secret, and its counters scrape over the wire."""
    with rpc.loopback_server(n_out=6, secret="z", loss_prob=0.5) as (host, port):
        with j_rpc.RpcTeacher(host, port, timeout_s=0.5, secret="z") as teacher:
            tickets = [teacher.ask(np.zeros((3, 2), np.float32), np.ones(3, bool), tick=k)
                       for k in range(12)]
            time.sleep(0.6)
            replies = teacher.poll(0)
            assert teacher.in_flight() == 0
        assert 0 < len(replies) < len(tickets)  # loss 0.5 over 12 asks, seed 0
        for r in replies:
            assert r.labels.tolist() == [rpc.expected_label(r.ticket, s, 6) for s in range(3)]
        stats = rpc.server_stats(host, port, secret="z")
        assert stats["asks_served"] == 12 and stats["loss_prob"] == 0.5


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_ask_copies_card_features_to_host(cuda_device):
    server = _RecordingServer(n_out=4).start()
    try:
        x = torch.randn(64, 33, device=cuda_device)
        want = x.cpu().numpy()
        with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                  batch_window_s=0.2) as client:
            h = client.tenant()
            ticket = h.ask(x, np.ones(64, bool), tick=0)
            x.fill_(7.0)  # the session's buffer is rewritten after the ask
            torch.cuda.synchronize()
            assert _drain(h)
        np.testing.assert_array_equal(server.seen[ticket], want)
    finally:
        server.close()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train_phase", "algo1"])
def test_cuda_graphed_session_over_rpc_equals_latency_teacher(cuda_device, mode):
    """A graphed session on the card taught over the wire (sync wrapper) is
    bit for bit the same session taught by ``LatencyTeacher(latency=0)`` with
    ``expected_label``: state, outputs and counters; and the kernels ran."""
    cfg = _cfg(min_trained=1_000_000 if mode == "train_phase" else 16)
    t_len, s_len = 40, 32
    xs = _stream_data(t_len, s_len, seed=71, shift_at=24 if mode == "algo1" else None)
    labels = stream.LatencyTeacher(lambda t, _f: rpc.expected_labels(t, s_len, N_OUT))
    st_l, outs_l, stats_l = stream.run(_fleet(cfg, s_len, cuda_device), iter(xs), cfg, labels,
                                       mode=mode)
    server = rpc.LabelServer(n_out=N_OUT).start()
    try:
        graphs.reset_replay_counts()
        ops.reset_launch_counts()
        with rpc.RpcTeacher("127.0.0.1", server.port, timeout_s=20.0) as teacher:
            st_r, outs_r, stats_r = stream.run(_fleet(cfg, s_len, cuda_device), iter(xs), cfg,
                                               _SyncTeacher(teacher), mode=mode)
    finally:
        server.close()
    _assert_state_equal(st_l, st_r, msg=mode)
    for name in outs_l._fields:
        np.testing.assert_array_equal(getattr(outs_l, name), getattr(outs_r, name), err_msg=name)
    for k in COUNTERS:
        assert getattr(stats_l, k) == getattr(stats_r, k), k
    assert stats_r.labels_applied > 0
    for name in ("xorshift_projection", "oselm_rls_update_fleet", "readout"):
        assert graphs.kernel_replays[name] + ops.launch_counts[name] > 0, name


def test_rpc_bench_rows_reconcile_on_the_cpu():
    """The port's ``rpc_bench`` at a tiny size: every transport's wire counts
    and the faults pass (the bench raises when an identity fails)."""
    from repro_torch.benchmarks import rpc_bench

    lines = []
    (row,) = rpc_bench.bench("cpu", tenant_counts=(2,), s=4, t=10, iters=1, log=lines.append)
    assert set(row["transports"]) == set(rpc_bench.TRANSPORTS)
    for d in row["transports"].values():
        assert d["labels_applied"] == 2 * 4 * 10 and d["wire_messages"] > 0
    # v1 carries JSON floats: more bytes per query than the v2 frame.
    assert (row["transports"]["per_tenant_v1"]["bytes_per_query"]
            > row["transports"]["per_tenant"]["bytes_per_query"])
    for per in row["faults"].values():
        assert all(v["reconciled"] for v in per["tenants"].values())
    assert len(lines) == 4


@pytest.mark.parametrize("transport", ["batched", "per_tenant"])
def test_rpc_bench_run_once_subprocess_server_compress_and_wrap(transport):
    """``rpc_bench.run_once`` against a ``loopback_server`` child with zlib
    envelopes and a wrapped teacher per tenant: every tenant reconciles,
    every label passes through its wrapper, and the counters scraped from
    the child show the compressed frames."""
    from repro_torch.benchmarks import rpc_bench

    cfg = rpc_bench._cfg()
    data = [rpc_bench._data(6, 4, seed=i) for i in range(2)]
    wrapped = []

    class Counting:
        def __init__(self, inner):
            self.inner, self.labels = inner, 0
            wrapped.append(self)

        def ask(self, feats, mask, tick):
            return self.inner.ask(feats, mask, tick)

        def poll(self, tick):
            replies = self.inner.poll(tick)
            self.labels += sum(int(r.answered.sum()) for r in replies)
            return replies

        def in_flight(self):
            return self.inner.in_flight()

    _, results, msgs, nbytes, server = rpc_bench.run_once(
        transport, cfg, data, "cpu", timeout_s=10.0, compress=True, wrap=Counting,
        subprocess_server=True)
    assert len(wrapped) == 2
    applied = sum(r.stats.labels_applied for r in results.values())
    assert applied == 2 * 4 * 6 == sum(w.labels for w in wrapped)
    assert all(r.stats.reconciled for r in results.values())
    assert server["frames_compressed"] == msgs > 0 and server["frame_errors"] == 0
    assert server["compressed_bytes_in"] == nbytes < server["raw_bytes_in"]
