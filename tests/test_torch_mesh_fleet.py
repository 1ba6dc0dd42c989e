"""The port's sharded fleet (``repro_torch.engine.split_fleet`` /
``run_fleet_shards`` / ``shard_fleet`` / ``run_fleet_sharded`` and
``stream.run_sharded``), mirroring ``tests/test_mesh_fleet.py`` in process
on a CPU mesh (``make_fleet_mesh(devices=["cpu"] * 8)``: one device, eight
entries), with the reference's small config (n_in=12, N=16, m=4,
``min_trained=2``).

Inside the port every sharded run equals the unsharded one bit for bit:
divisible and padded S, a block that straddles live and dead rows, latency
0 and 3, shards wholly made of padding; and the query accounting
reconciles per shard.  Against the JAX package (in process, on its one
default CPU device) the same numpy inputs go through
``repro.engine.split_fleet``/``run_fleet_shards`` and
``repro.engine.stream.run_sharded``: integer and boolean outputs,
per-shard counters and ``aggregate_stats`` match exactly, beta within
2e-4, and P within 2e-5 in units of its start I/ridge (``P * ridge``): P
starts at 100·I, where the JAX engine's einsum RLS and the port's Pallas
numerics drift apart by up to ~3e-4 absolute over a few ticks (ROADMAP:
rtol 2e-3 where P starts at I/ridge).

The ``cuda`` test runs the blocked path on the card (skips elsewhere):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_mesh_fleet.py
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.engine import stream as j_stream

from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.engine import rpc, stream  # noqa: E402
from repro_torch.engine.types import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_fleet_mesh  # noqa: E402

N_IN, N_HIDDEN, N_OUT = 12, 16, 4
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")


def _cfg(pkg_engine, pkg_oselm, pkg_pruning, pkg_drift):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, variant="hash",
                                  ridge=1e-2),
        prune=pkg_pruning.PruneConfig(min_trained=2),
        drift=pkg_drift.DriftConfig(),
    )


CFG = _cfg(engine, oselm, pruning, drift_mod)


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")
    return _cfg(j_engine, j_oselm, j_pruning, j_drift)


@pytest.fixture
def mesh():
    return make_fleet_mesh(devices=["cpu"] * 8)


def _data(t, s, seed):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    ys = rng.integers(0, N_OUT, (t, s)).astype(np.int32)
    return xs, ys


def _fleet(s, device="cpu"):
    return engine.init_fleet(CFG, s, device)


def _assert_states_equal(a, b, where=""):
    a, b = convert.engine_state_to_numpy(a), convert.engine_state_to_numpy(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where}: state leaf {k}")


def _assert_outputs_equal(a, b, where=""):
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        x = x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        y = y.cpu().numpy() if torch.is_tensor(y) else np.asarray(y)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f"{where}: output {f}")


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,block", [(512, None), (1020, 32)])
def test_fleet_sharded_modes_bitwise_parity(mesh, s, block):
    """Both layouts == the single-device ``run_fleet``, bit for bit.  S=512
    divides the 8-entry mesh; S=1020 pads to 1024 (width 128, 4 dead tail
    rows) and block=32 makes the last block straddle live and dead rows."""
    t = 4
    xs, ys = _data(t, s, seed=s)
    ref, ref_out = engine.run_fleet(_fleet(s), xs, ys, CFG, mode="train_phase")
    with sharding.activate(mesh):
        placed, n_pad = engine.shard_fleet(_fleet(s), CFG)
        assert n_pad == (-s) % 8
        assert placed.elm.P.shape[0] == s + n_pad
        st, out = engine.run_fleet_sharded(placed, xs, ys, CFG, mode="train_phase")
        assert st.elm.P.shape[0] == s + n_pad
        _assert_states_equal(ref, engine.slice_streams(st, 0, s), "shard_fleet")
        _assert_outputs_equal(ref_out, out, "run_fleet_sharded")

        sh = engine.split_fleet(_fleet(s), CFG, block=block)
        width = (s + n_pad) // 8
        assert sh.n_pad == n_pad
        assert len(sh.states) == 8 * -(-width // (block or engine.DEFAULT_STREAM_BLOCK))
        sh, out = engine.run_fleet_shards(sh, xs, ys, CFG, mode="train_phase")
        merged = engine.merge_fleet(sh)
    assert merged.elm.beta.shape[0] == s  # padding stripped
    assert merged.elm.P.device.type == "cpu"
    _assert_states_equal(ref, merged, "split_fleet")
    _assert_outputs_equal(ref_out, out, "run_fleet_shards")


@pytest.mark.parametrize("mode", ["algo1", "train_phase"])
def test_run_fleet_shards_outside_mesh_scope(mode):
    """The blocked path with no mesh current (an explicit device list), and
    a ``teacher_available`` mask gating the learns."""
    t, s = 3, 256
    xs, ys = _data(t, s, seed=7)
    avail = np.random.default_rng(9).uniform(size=(t, s)) < 0.5
    assert sharding.mesh_or_none() is None
    ref, ref_out = engine.run_fleet(_fleet(s), xs, ys, CFG, mode=mode, teacher_available=avail)
    sh = engine.split_fleet(_fleet(s), CFG, n_shards=4, devices=["cpu"] * 4)
    assert [hi - lo for lo, hi in sh.bounds] == [64] * 4
    sh, out = engine.run_fleet_shards(sh, xs, ys, CFG, mode=mode, teacher_available=avail)
    _assert_states_equal(ref, engine.merge_fleet(sh))
    _assert_outputs_equal(ref_out, out)


def test_split_fleet_places_owned_blocks_and_checks_devices():
    """Each block owns its tensors (no view of the caller's fleet), the
    caller's fleet is left as it was, and more shards than devices
    raise."""
    st0 = _fleet(10)
    before = convert.engine_state_to_numpy(st0)
    sh = engine.split_fleet(st0, CFG, n_shards=3, block=2)
    assert sh.n_pad == 2 and sh.bounds == ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 12))
    for blk in sh.states:
        for leaf in tree_leaves(blk):
            assert leaf.untyped_storage().data_ptr() != st0.elm.P.untyped_storage().data_ptr()
    sh.states[0].elm.P.fill_(0.0)
    _assert_states_equal(convert.engine_state_from_numpy(before, "cpu"), st0)
    with pytest.raises(ValueError, match="3 shards > 2 devices"):
        engine.split_fleet(st0, CFG, n_shards=3, devices=["cpu"] * 2)


def test_gspmd_layout_needs_one_device_per_mesh():
    """``shard_fleet``/``run_fleet_sharded`` partition one dispatch, which
    one torch process cannot do over distinct devices: they raise, naming
    the explicit path.  No mesh: the identity."""
    st = _fleet(8)
    assert engine.shard_fleet(st, CFG) == (st, 0)
    distinct = sharding.FleetMesh(("cpu", "meta"))
    with pytest.raises(NotImplementedError, match="split_fleet and run_fleet_shards"):
        engine.shard_fleet(st, CFG, mesh=distinct)
    xs, ys = _data(1, 8, seed=0)
    with sharding.activate(distinct), pytest.raises(NotImplementedError):
        engine.run_fleet_sharded(st, xs, ys, CFG)


def _array_teachers(ys, s, n, latency, **kw):
    width = (s + (-s) % n) // n
    ys_pad = np.pad(ys, ((0, 0), (0, (-s) % n)))
    return lambda k: stream.LatencyTeacher(
        stream.array_labels(ys_pad[:, k * width:(k + 1) * width]), latency=latency, **kw)


@pytest.mark.parametrize("s", [64, 60, 9])
@pytest.mark.parametrize("latency", [0, 3])
def test_stream_run_sharded_bitwise_parity_and_shard_local_accounting(mesh, s, latency):
    """Sharded sessions == the solo ``stream.run``, bit for bit, and every
    shard's query accounting reconciles on its own.  S=60 pads a tail shard
    with live and dead rows; S=9 over 8 shards (width 2) leaves three
    shards wholly dead."""
    t, n = 8, 8
    xs, ys = _data(t, s, seed=s)
    solo, solo_out, solo_stats = stream.run(
        _fleet(s), iter(xs), CFG, stream.LatencyTeacher(stream.array_labels(ys), latency=latency),
        mode="train_phase", capacity=16)
    with sharding.activate(mesh):
        assert sharding.fleet_axis_size() == n
        st, out, stats_list = stream.run_sharded(
            _fleet(s), iter(xs), CFG, _array_teachers(ys, s, n, latency), mode="train_phase",
            capacity=16)
    assert st.elm.beta.shape[0] == s  # padding stripped
    _assert_states_equal(solo, st)
    _assert_outputs_equal(solo_out, out)
    agg = stream.aggregate_stats(stats_list, padded_streams=(-s) % n)
    assert agg["n_shards"] == n and agg["padded_streams"] == (-s) % n
    assert agg["queries_reconciled"]
    assert agg["stream_steps"] == t * s  # dead rows excluded
    assert agg["queries_issued"] == solo_stats.queries_issued
    assert agg["labels_applied"] == solo_stats.labels_applied > 0
    per = agg["per_shard"]
    assert len(per) == n and all(p["queries_reconciled"] for p in per)
    for k in ("queries_issued", "labels_applied", "stream_steps"):
        assert sum(p[k] for p in per) == agg[k]


def test_sharded_session_labels_and_summary(mesh):
    """Each shard's session carries its telemetry label; ``stats_summary``
    is ``aggregate_stats`` of the live sessions; a teacher list of the
    wrong length and a mesh smaller than the shard count raise."""
    s, t = 20, 4
    xs, ys = _data(t, s, seed=3)
    with sharding.activate(mesh):
        sess = stream.ShardedStreamSession(_fleet(s), CFG, _array_teachers(ys, s, 8, 1),
                                           mode="train_phase")
        assert [x.telemetry_labels for x in sess.sessions] == [{"shard": str(k)} for k in range(8)]
        assert sess.n_pad == 4 and sess.width == 3
        sess.start(xs[0])
        for x in list(xs[1:]) + [None]:
            sess.advance(x)
        summary = sess.stats_summary()
        sess.finish()
    assert summary["n_shards"] == 8 and summary["ticks"] == t
    assert summary["stream_steps"] == t * s
    with pytest.raises(ValueError, match="one teacher per shard"):
        stream.ShardedStreamSession(_fleet(s), CFG, [None] * 3, n_shards=4)
    with pytest.raises(ValueError, match="5 shards > 4 devices"):
        stream.ShardedStreamSession(_fleet(s), CFG, _array_teachers(ys, s, 5, 0), n_shards=5,
                                    devices=["cpu"] * 4)


def test_shared_batched_client_hands_each_shard_a_tenant(mesh):
    """A ``BatchedRpcClient`` as ``teachers``: each shard asks through its
    own handle ``shard<k>`` on the one connection, and after the drain
    every shard's accounting reconciles with every query answered."""
    s, t, n = 32, 6, 4
    xs, _ = _data(t, s, seed=4)
    server = rpc.LabelServer(n_out=N_OUT).start()
    try:
        with rpc.BatchedRpcClient("127.0.0.1", server.port, timeout_s=10.0,
                                  batch_window_s=2e-3) as client:
            sess = stream.ShardedStreamSession(_fleet(s), CFG, client, n_shards=n,
                                               mode="train_phase")
            assert [x.teacher.name for x in sess.sessions] == [f"shard{k}" for k in range(n)]
            sess.start(xs[0])
            for x in list(xs[1:]) + [None]:
                sess.advance(x)
            _, _, stats_list = sess.finish()
    finally:
        server.close()
    agg = stream.aggregate_stats(stats_list)
    assert agg["queries_reconciled"]
    assert agg["queries_issued"] == agg["labels_applied"] == t * s  # train_phase: all ask
    assert all(st.labels_applied == t * s // n for st in stats_list)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_close(tstate, jstate, where):
    t, j = convert.engine_state_to_numpy(tstate), convert.engine_state_to_numpy(jstate)
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        if k == "elm.P":
            np.testing.assert_allclose(t[k] * CFG.elm.ridge, j[k] * CFG.elm.ridge, atol=2e-5,
                                       err_msg=f"{where}: {k} in units of I/ridge")
        elif k == "elm.beta":
            np.testing.assert_allclose(t[k], j[k], atol=2e-4, err_msg=f"{where}: {k}")
        elif t[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=2e-3, atol=2e-3, err_msg=f"{where}: {k}")
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{where}: {k}")


def _jax_outputs_match(tout, jout, where):
    for f in ("pred", "queried", "trained", "mode_training", "theta"):
        a = getattr(tout, f)
        a = a.numpy() if torch.is_tensor(a) else a
        np.testing.assert_array_equal(a, np.asarray(getattr(jout, f)), err_msg=f"{where}: {f}")
    for f in ("outputs", "confidence"):
        a = getattr(tout, f)
        a = a.numpy() if torch.is_tensor(a) else a
        np.testing.assert_allclose(a, np.asarray(getattr(jout, f)), rtol=2e-3, atol=2e-3,
                                   err_msg=f"{where}: {f}")


def test_run_fleet_shards_matches_jax(jax_ref):
    """``split_fleet(n_shards=4, block=32)`` + ``run_fleet_shards`` in both
    packages on the same inputs.  S=250 pads to 252 (width 63: blocks of
    32 and 31, the last straddling two dead rows).  The JAX package's
    ``FleetShards`` comes over through ``convert.fleet_shards_from_numpy``:
    its layout equals the port's, and each block ends within tolerance."""
    jcfg, mode = jax_ref, "train_phase"
    t, s = 6, 250
    xs, ys = _data(t, s, seed=11)
    jsh = j_engine.split_fleet(j_engine.init_fleet(jcfg, s), jcfg, n_shards=4, block=32)
    tsh = engine.split_fleet(_fleet(s), CFG, n_shards=4, block=32)
    conv = convert.fleet_shards_from_numpy(jsh, "cpu")
    assert conv.bounds == tsh.bounds and conv.n_pad == tsh.n_pad == 2
    for a, b in zip(conv.states, tsh.states):
        _assert_states_equal(a, b, "split")
    jsh, jout = j_engine.run_fleet_shards(jsh, xs, ys, jcfg, mode=mode)
    tsh, tout = engine.run_fleet_shards(tsh, xs, ys, CFG, mode=mode)
    _jax_outputs_match(tout, jout, mode)
    for k, (a, b) in enumerate(zip(tsh.states, convert.fleet_shards_from_numpy(jsh, "cpu").states)):
        _jax_close(a, b, f"{mode} block {k}")
    _jax_close(engine.merge_fleet(tsh), j_engine.merge_fleet(jsh), f"{mode} merged")


def test_run_sharded_matches_jax(jax_ref):
    """``stream.run_sharded(n_shards=4)`` in both packages with a late,
    lossy, jittery teacher per shard (seeded per shard): per-shard counters,
    label latencies and every integer key of ``aggregate_stats`` exact; the
    same keys in both summaries; states within tolerance."""
    jcfg = jax_ref
    t, s, n = 24, 30, 4
    xs, ys = _data(t, s, seed=12)
    width = (s + (-s) % n) // n
    ys_pad = np.pad(ys, ((0, 0), (0, (-s) % n)))

    def teachers(pkg):
        return lambda k: pkg.LatencyTeacher(
            pkg.array_labels(ys_pad[:, k * width:(k + 1) * width]), latency=2, jitter=2,
            loss_prob=0.1, partial_prob=0.1, seed=5 + k)

    jst, jout, jstats = j_stream.run_sharded(
        j_engine.init_fleet(jcfg, s), iter(xs), jcfg, teachers(j_stream), n_shards=n,
        mode="train_phase", capacity=4)
    tst, tout, tstats = stream.run_sharded(
        _fleet(s), iter(xs), CFG, teachers(stream), n_shards=n, mode="train_phase", capacity=4)
    for k, (a, b) in enumerate(zip(tstats, jstats)):
        for c in COUNTERS:
            assert getattr(a, c) == getattr(b, c), f"shard {k}: {c}"
        assert list(a.label_latency_ticks) == list(b.label_latency_ticks), k
        assert a.reconciled and b.reconciled
    tagg = stream.aggregate_stats(tstats, padded_streams=(-s) % n)
    jagg = j_stream.aggregate_stats(jstats, padded_streams=(-s) % n)
    assert set(tagg) == set(jagg)
    for key, v in jagg.items():
        if isinstance(v, (bool, int)) and not isinstance(v, float):
            assert tagg[key] == v, key
    assert tagg["queries_reconciled"] and tagg["labels_applied"] > 0
    assert tagg["queries_lost"] > 0  # the teacher's loss reached the accounting
    assert set(tagg["per_shard"][0]) == set(jagg["per_shard"][0])
    _jax_outputs_match(tout, jout, "run_sharded")
    _jax_close(tst, jst, "run_sharded")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["train_phase", "algo1"])
def test_cuda_blocked_shards_equal_run_fleet(cuda_device, mode):
    """Phase 6j (a) of ``chip_smoke.py`` at a small S: ``split_fleet`` over
    ``[cuda:0] * 4`` with one block per shard, and the 512-stream default
    block, == ``run_fleet`` on the card, bit for bit, through the kernels
    (each block's ticks replayed as a CUDA graph, after a one-tick eager
    warm-up at its first capture)."""
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    t, s = 6, 2048
    cfg = engine.EngineConfig(elm=oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT),
                              prune=pruning.PruneConfig(min_trained=2))
    xs, ys = _data(t, s, seed=21)
    xs_d, ys_d = torch.as_tensor(xs, device=cuda_device), torch.as_tensor(ys, device=cuda_device)
    ref, ref_out = engine.run_fleet(engine.init_fleet(cfg, s, cuda_device), xs_d, ys_d, cfg,
                                    mode=mode)
    mesh = make_fleet_mesh(4, devices=[cuda_device] * 4)
    for block in (s // 4, None):
        with sharding.activate(mesh):
            ops.reset_launch_counts()
            graphs.reset_replay_counts()
            sh = engine.split_fleet(engine.init_fleet(cfg, s, cuda_device), cfg, block=block)
            assert all(st.elm.P.is_cuda for st in sh.states)
            sh, out = engine.run_fleet_shards(sh, xs_d, ys_d, cfg, mode=mode)
        n_blocks = len(sh.states)
        assert n_blocks == (4 if block else s // engine.DEFAULT_STREAM_BLOCK)
        for name in ("xorshift_projection", "oselm_rls_update_fleet", "plan_rows"):
            assert ops.launch_counts[name] + graphs.kernel_replays[name] >= t * n_blocks, name
        _assert_states_equal(ref, engine.merge_fleet(sh), f"block={block}")
        _assert_outputs_equal(ref_out, out, f"block={block}")

