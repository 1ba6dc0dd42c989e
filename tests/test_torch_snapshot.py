"""Durable sessions in the port (``repro_torch.engine.snapshot``,
``engine/durable.py`` and the multiplexer's durability), mirroring
``tests/test_snapshot.py`` function for function: bit-for-bit
snapshot/restore parity for every backpressure policy, the re-ask and drop
policies for a teacher that cannot be snapshot, kill-mid-write recovery,
multiplexer resume, crash-restart supervision and live tenant migration.

Sizes as there: n_in=24, N=16, m=4, S=2-4, T <= 40.  Inputs come from numpy
with a seed.  Everything here holds the port against itself, bit for bit:
a restored run against the uninterrupted one (state leaves, collected
outputs, every deterministic ``StreamStats`` counter and the label
latencies).  The package-to-package checks are in
``tests/test_torch_snapshot_interop.py``.

On the CPU the sessions run their tick functions eagerly, and a capture
copies every leaf (``tensor.numpy()`` would alias the session's buffers).
Tests marked ``cuda`` restore onto the card, where a capture copies the
ping-pong buffers after the replay that wrote them and a restored session
captures its own graphs; they skip elsewhere and need no JAX:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_snapshot.py
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.engine import durable, multiplex, snapshot, stream  # noqa: E402
from repro_torch.engine.types import tree_leaves  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402

# Deterministic stats fields a resumed run must reproduce exactly (the
# wall-clock ones, wall_s and tick_ms, cannot match).
DETERMINISTIC_STATS = (
    "ticks", "stream_steps", "tickets_issued", "queries_issued",
    "labels_applied", "tickets_dropped", "queries_dropped",
    "replies_orphaned", "tickets_lost", "queries_lost",
    "tickets_coalesced", "queries_coalesced", "asks_deferred",
)
CPU = "cpu"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _cfg(n_in=24, n_hidden=16, n_out=4, min_trained=1_000_000):
    return engine.EngineConfig(
        elm=oselm.OSELMConfig(n_in=n_in, n_hidden=n_hidden, n_out=n_out, variant="hash",
                              ridge=1e-2),
        prune=pruning.PruneConfig(min_trained=min_trained),
        drift=drift_mod.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )


def _stream_data(cfg, t, s, seed=0):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, cfg.elm.n_in))).astype(np.float32)
    ys = rng.integers(0, cfg.elm.n_out, (t, s)).astype(np.int32)
    return xs, ys


def _assert_state_equal(a, b, msg=""):
    a, b = convert.engine_state_to_numpy(a), convert.engine_state_to_numpy(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, f"{msg} leaf {k} dtype"
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} leaf {k} diverged")


def _assert_stats_equal(a, b, msg=""):
    for f in DETERMINISTIC_STATS:
        assert getattr(a, f) == getattr(b, f), (
            f"{msg}: stats.{f} diverged: {getattr(a, f)} != {getattr(b, f)}"
        )
    assert list(a.label_latency_ticks) == list(b.label_latency_ticks), msg


def _assert_outputs_equal(a, b, msg=""):
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                      err_msg=f"{msg}: output {name!r} diverged")


def _lossy_teacher(ys):
    return stream.LatencyTeacher(
        stream.array_labels(ys), latency=2, jitter=3, loss_prob=0.2,
        partial_prob=0.2, seed=11,
    )


def _drive(sess, xs, start):
    """The stream.run drive loop from tick ``start`` (resume-aware)."""
    it = (xs[i] for i in range(start, len(xs)))
    if not sess.started():
        x0 = next(it, None)
        if x0 is not None:
            sess.start(x0)
    while sess._p is not None:
        sess.advance(next(it, None))
    return sess.finish()


def _fleet(cfg, s, device=CPU):
    return engine.init_fleet(cfg, s, device)


def _flat(tree):
    """{path: numpy leaf} of a snapshot tree."""
    from repro_torch.runtime import checkpoint

    return {"/".join(p): np.asarray(v) for p, v in checkpoint._flatten(tree)}


# ---------------------------------------------------------------------------
# Tentpole: bit-for-bit resume parity, every backpressure policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", stream.BACKPRESSURE_POLICIES)
def test_resume_parity_bit_for_bit(policy, tmp_path):
    """A session snapshotted at tick k, published through CheckpointManager
    and restored into a fresh session with a fresh (state-restored) teacher
    reproduces the uninterrupted run's final state, outputs and
    deterministic stats exactly, under latency, jitter, loss and partial
    answers, for every backpressure policy."""
    cfg = _cfg()
    t_len, s_len, k = 40, 4, 17
    xs, ys = _stream_data(cfg, t_len, s_len, seed=7)

    ref_state, ref_outs, ref_stats = stream.run(
        _fleet(cfg, s_len), (x for x in xs), cfg, _lossy_teacher(ys),
        mode="train_phase", capacity=3, backpressure=policy,
    )

    sess = stream.StreamSession(
        _fleet(cfg, s_len), cfg, _lossy_teacher(ys),
        mode="train_phase", capacity=3, backpressure=policy,
    )
    it = iter(xs)
    sess.start(next(it))
    for _ in range(k):
        sess.advance(next(it, None))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(sess.t, sess.snapshot())
    consumed = snapshot.ticks_consumed(mgr.restore()[1])
    assert consumed == k + 1
    del sess, it  # the "crashed process"

    step, tree = mgr.restore()
    assert step == k
    fresh_teacher = _lossy_teacher(ys)  # state overwritten by the restore
    sess2 = stream.StreamSession.restore(tree, fresh_teacher, cfg=cfg, device=CPU)
    st2, outs2, stats2 = _drive(sess2, xs, consumed)

    _assert_state_equal(ref_state, st2, msg=policy)
    _assert_stats_equal(ref_stats, stats2, msg=policy)
    assert stats2.reconciled, stats2.summary()
    assert stats2.tickets_reasked == 0  # the teacher state came along
    _assert_outputs_equal(ref_outs, outs2, msg=policy)


def test_restore_without_teacher_state_reasks_in_flight(tmp_path):
    """A teacher that cannot be snapshot: restore re-asks every in-flight
    ring entry through the fresh teacher (metered, original ticket order
    kept), and the accounting identity still reconciles; ``pending="drop"``
    makes them terminal losses instead."""
    cfg = _cfg()
    t_len, s_len = 12, 3
    xs, ys = _stream_data(cfg, t_len, s_len, seed=8)

    class NoSnapshotTeacher:
        """LatencyTeacher minus the snapshot support."""

        def __init__(self):
            self.inner = stream.LatencyTeacher(stream.array_labels(ys), latency=4)

        def ask(self, feats, mask, tick):
            return self.inner.ask(feats, mask, tick)

        def poll(self, tick):
            return self.inner.poll(tick)

        def in_flight(self):
            return self.inner.in_flight()

    sess = stream.StreamSession(
        _fleet(cfg, s_len), cfg, NoSnapshotTeacher(), mode="train_phase", capacity=8,
    )
    it = iter(xs)
    sess.start(next(it))
    for _ in range(5):
        sess.advance(next(it, None))
    tree = sess.snapshot()
    in_flight = len(sess.ring)
    assert in_flight > 0  # latency 4 > ticks run: queries still pending
    issued_before = sess.stats.tickets_issued

    fresh = NoSnapshotTeacher()
    sess2 = stream.StreamSession.restore(tree, fresh, cfg=cfg, device=CPU)
    assert sess2.stats.tickets_reasked == in_flight
    assert sess2.stats.tickets_issued == issued_before + in_flight
    assert fresh.in_flight() == in_flight  # the re-asks actually hit the wire
    st2, outs2, stats2 = _drive(sess2, xs, snapshot.ticks_consumed(tree))
    assert stats2.reconciled, stats2.summary()
    assert stats2.labels_applied == stats2.queries_issued == t_len * s_len
    assert outs2.trained.all()  # every re-asked query eventually trained

    sess3 = stream.StreamSession.restore(tree, NoSnapshotTeacher(), cfg=cfg, pending="drop",
                                         device=CPU)
    assert sess3.stats.tickets_reasked == 0
    assert sess3.stats.queries_lost >= in_flight
    st3, _, stats3 = _drive(sess3, xs, snapshot.ticks_consumed(tree))
    assert stats3.reconciled, stats3.summary()


def test_kill_mid_write_recovers_previous_good_snapshot(tmp_path):
    """A crash mid-snapshot-write leaves a .tmp staging dir; restore falls
    back to the previous published step and resumes losslessly."""
    cfg = _cfg()
    t_len, s_len = 30, 3
    xs, ys = _stream_data(cfg, t_len, s_len, seed=9)

    ref_state, _, ref_stats = stream.run(
        _fleet(cfg, s_len), (x for x in xs), cfg, _lossy_teacher(ys),
        mode="train_phase", capacity=4,
    )

    sess = stream.StreamSession(
        _fleet(cfg, s_len), cfg, _lossy_teacher(ys), mode="train_phase", capacity=4,
    )
    it = iter(xs)
    sess.start(next(it))
    mgr = CheckpointManager(str(tmp_path), keep=3)
    for _ in range(10):
        sess.advance(next(it, None))
    mgr.save(sess.t, sess.snapshot())  # the good snapshot (tick 10)
    for _ in range(5):
        sess.advance(next(it, None))
    # The crashed write: a later step staged but never atomically renamed.
    crashed = tmp_path / "step_000000015.tmp"
    os.makedirs(crashed)
    (crashed / "MANIFEST.json").write_text("{\"step\": 15}")
    (crashed / "meta.npy").write_bytes(b"truncated garbage")
    del sess

    assert mgr.latest_step() == 10  # the .tmp is invisible
    step, tree = mgr.restore()
    sess2 = stream.StreamSession.restore(tree, _lossy_teacher(ys), cfg=cfg, device=CPU)
    st2, _, stats2 = _drive(sess2, xs, snapshot.ticks_consumed(tree))
    _assert_state_equal(ref_state, st2, msg="kill-mid-write")
    _assert_stats_equal(ref_stats, stats2, msg="kill-mid-write")
    assert stats2.reconciled


# ---------------------------------------------------------------------------
# Multiplexer durability: cadence snapshots, resume, supervision
# ---------------------------------------------------------------------------


def _tenants(cfg, datas, make_teacher, **kw):
    return [
        multiplex.Tenant(
            name=f"tenant{i}",
            state=_fleet(cfg, xs.shape[1]),
            ticks=snapshot.array_ticks(xs),
            cfg=cfg,
            teacher=make_teacher(i),
            mode="train_phase",
            capacity=4,
            collect=False,
            **kw,
        )
        for i, (xs, ys) in enumerate(datas)
    ]


def test_multiplex_resume_matches_uninterrupted(tmp_path):
    """Abandon the multiplexer after some rounds; a resumed run restores every
    tenant from its latest published snapshot and finishes with exactly the
    states an uninterrupted multiplexed run produces."""
    cfg = _cfg()
    datas = [_stream_data(cfg, 40, 3, seed=20), _stream_data(cfg, 30, 2, seed=21)]

    def make_teacher(i, datas=datas):
        return stream.LatencyTeacher(
            stream.array_labels(datas[i][1]), latency=2, jitter=2, loss_prob=0.2, seed=30 + i,
        )

    ref, _ = multiplex.run(_tenants(cfg, datas, make_teacher))

    snap_dir = str(tmp_path / "snaps")
    mux = multiplex.Multiplexer(
        _tenants(cfg, datas, make_teacher), snapshot_dir=snap_dir, snapshot_every=6,
    )
    for _ in range(4):  # run a few rounds, then "crash" (abandon the object)
        mux.round()
    for name in ("tenant0", "tenant1"):
        latest = CheckpointManager(os.path.join(snap_dir, name)).latest_step()
        assert latest is not None and latest > 0, name
    for s in mux._slots:
        s.manager.wait()  # the abandoned process's writes have landed
    del mux

    results, agg = multiplex.run(
        _tenants(cfg, datas, make_teacher), snapshot_dir=snap_dir, snapshot_every=6,
        resume=True,
    )
    for name in ref:
        _assert_state_equal(ref[name].state, results[name].state, msg=name)
        _assert_stats_equal(ref[name].stats, results[name].stats, msg=name)
        assert results[name].stats.reconciled
    assert agg.snapshots > 0


def test_run_supervised_crash_restart(tmp_path):
    """The restart supervisor around the durable multiplexer: an injected
    mid-run crash restarts the attempt (exactly once), which resumes from
    the published snapshots and still matches the uninterrupted run bit for
    bit."""
    cfg = _cfg()
    datas = [_stream_data(cfg, 36, 3, seed=22), _stream_data(cfg, 24, 2, seed=23)]
    crash = {"armed": True}
    attempts = []

    class CrashingTeacher:
        """Delegates to a LatencyTeacher; raises once at tick >= 20."""

        def __init__(self, i):
            self.inner = stream.LatencyTeacher(
                stream.array_labels(datas[i][1]), latency=1, jitter=1, loss_prob=0.1,
                seed=40 + i,
            )

        def ask(self, feats, mask, tick):
            if crash["armed"] and tick >= 20:
                crash["armed"] = False
                raise RuntimeError("injected node failure")
            return self.inner.ask(feats, mask, tick)

        def poll(self, tick):
            return self.inner.poll(tick)

        def in_flight(self):
            return self.inner.in_flight()

        def snapshot_state(self):
            return self.inner.snapshot_state()

        def restore_snapshot(self, tree):
            self.inner.restore_snapshot(tree)

    def make_plain(i):
        return stream.LatencyTeacher(
            stream.array_labels(datas[i][1]), latency=1, jitter=1, loss_prob=0.1, seed=40 + i,
        )

    def make_tenants():
        attempts.append(1)
        return _tenants(cfg, datas, CrashingTeacher)

    ref, _ = multiplex.run(_tenants(cfg, datas, make_plain))

    results, agg = multiplex.run_supervised(
        make_tenants, snapshot_dir=str(tmp_path / "snaps"), snapshot_every=5, max_restarts=2,
    )
    assert not crash["armed"]  # the crash really fired
    assert len(attempts) == 2  # one restart for the one injected crash
    for name in ref:
        _assert_state_equal(ref[name].state, results[name].state, msg=name)
        _assert_stats_equal(ref[name].stats, results[name].stats, msg=name)
        assert results[name].stats.reconciled


# ---------------------------------------------------------------------------
# Live tenant migration
# ---------------------------------------------------------------------------


def test_live_migration_preserves_accounting_identity(tmp_path):
    """Extract a tenant mid-stream and restore it into a second multiplexer
    behind a FRESH teacher (quiesce disabled, so in-flight tickets must be
    re-asked): the migrated tenant completes and the accounting identity
    reconciles across the move; the tenant left behind is untouched (bit
    for bit against its solo run)."""
    cfg = _cfg()
    datas = [_stream_data(cfg, 30, 3, seed=24), _stream_data(cfg, 30, 2, seed=25)]

    def make_teacher(i):
        return stream.LatencyTeacher(stream.array_labels(datas[i][1]), latency=3, seed=50 + i)

    solo1_state, _, solo1_stats = stream.run(
        _fleet(cfg, 2), (x for x in datas[1][0]), cfg, make_teacher(1),
        mode="train_phase", capacity=4, collect=False,
    )

    mux = multiplex.Multiplexer(_tenants(cfg, datas, make_teacher))
    while mux.round():
        if mux.session("tenant0").t >= 15:
            break
    tree, rest_ticks = mux.extract("tenant0", quiesce_ticks=0)
    in_flight = len(tree["ring"])
    assert in_flight > 0
    results_a, _ = mux.run()

    # pending="reask": the new host's teacher starts fresh, so in-flight
    # tickets re-ask.
    mux_b = multiplex.Multiplexer([], pending="reask")
    fresh = stream.LatencyTeacher(stream.array_labels(datas[0][1]), latency=3, seed=99)
    mux_b.admit(
        multiplex.Tenant(
            name="tenant0", state=None, ticks=rest_ticks, cfg=cfg, teacher=fresh,
            mode="train_phase", capacity=4, collect=False, device=CPU,
        ),
        snapshot=tree,
    )
    results_b, _ = mux_b.run()

    mig = results_b["tenant0"].stats
    assert mig.ticks == 30
    assert mig.tickets_reasked == in_flight
    assert mig.queries_issued == 30 * 3
    assert mig.reconciled, mig.summary()
    _assert_state_equal(solo1_state, results_a["tenant1"].state, msg="tenant1")
    _assert_stats_equal(solo1_stats, results_a["tenant1"].stats, msg="tenant1")


def test_migration_with_restorable_teacher_is_bit_for_bit(tmp_path):
    """When the destination teacher can restore the snapshot state,
    migration is invisible: the migrated tenant finishes exactly like an
    unmigrated solo run."""
    cfg = _cfg()
    t_len, s_len = 30, 3
    xs, ys = _stream_data(cfg, t_len, s_len, seed=26)

    def make_teacher():
        return stream.LatencyTeacher(
            stream.array_labels(ys), latency=2, jitter=2, loss_prob=0.2, seed=60
        )

    ref_state, _, ref_stats = stream.run(
        _fleet(cfg, s_len), (x for x in xs), cfg, make_teacher(),
        mode="train_phase", capacity=4, collect=False,
    )

    mux = multiplex.Multiplexer([
        multiplex.Tenant(
            name="t", state=_fleet(cfg, s_len), ticks=snapshot.array_ticks(xs), cfg=cfg,
            teacher=make_teacher(), mode="train_phase", capacity=4, collect=False,
        )
    ])
    while mux.round():
        if mux.session("t").t >= 13:
            break
    tree, rest = mux.extract("t", quiesce_ticks=0)

    mux_b = multiplex.Multiplexer([])
    mux_b.admit(
        multiplex.Tenant(
            name="t", state=None, ticks=rest, cfg=cfg, teacher=make_teacher(),
            mode="train_phase", capacity=4, collect=False, device=CPU,
        ),
        snapshot=tree,
    )
    results, _ = mux_b.run()
    _assert_state_equal(ref_state, results["t"].state, msg="migrated")
    _assert_stats_equal(ref_stats, results["t"].stats, msg="migrated")
    assert results["t"].stats.tickets_reasked == 0


# ---------------------------------------------------------------------------
# Durable single-session runs + misc contracts
# ---------------------------------------------------------------------------


def test_run_durable_resume_parity(tmp_path):
    """run_durable: a run whose source dies mid-stream (after several
    snapshots were published), resumed, matches the full run bit for bit."""
    cfg = _cfg()
    t_len, s_len = 32, 3
    xs, ys = _stream_data(cfg, t_len, s_len, seed=27)

    def teacher():
        return stream.LatencyTeacher(
            stream.array_labels(ys), latency=1, jitter=2, loss_prob=0.1, seed=70
        )

    ref_state, ref_outs, ref_stats = stream.run(
        _fleet(cfg, s_len), (x for x in xs), cfg, teacher(), mode="train_phase", capacity=4,
    )

    d = str(tmp_path / "snaps")

    def dying(start):
        for t in range(start, t_len):
            if t == 19:
                raise RuntimeError("simulated ingest crash")
            yield xs[t]

    with pytest.raises(RuntimeError, match="ingest crash"):
        durable.run_durable(
            _fleet(cfg, s_len), snapshot.ResumableTicks(dying), cfg, teacher(),
            snapshot_dir=d, snapshot_every=5, mode="train_phase", capacity=4,
        )
    mgr = CheckpointManager(d)
    assert (mgr.latest_step() or 0) >= 5

    st2, outs2, stats2 = durable.run_durable(
        None, snapshot.array_ticks(xs), cfg, teacher(), snapshot_dir=d, snapshot_every=5,
        resume=True, mode="train_phase", capacity=4, device=CPU,
    )
    _assert_state_equal(ref_state, st2, msg="run_durable")
    _assert_stats_equal(ref_stats, stats2, msg="run_durable")
    _assert_outputs_equal(ref_outs, outs2, msg="run_durable")


def test_resume_requires_seekable_ticks(tmp_path):
    cfg = _cfg()
    xs, ys = _stream_data(cfg, 8, 2, seed=28)
    d = str(tmp_path / "snaps")
    durable.run_durable(
        _fleet(cfg, 2), snapshot.array_ticks(xs), cfg,
        stream.LatencyTeacher(stream.array_labels(ys), latency=0),
        snapshot_dir=d, snapshot_every=3, mode="train_phase",
    )
    with pytest.raises(ValueError, match="seekable"):
        durable.run_durable(
            None, (x for x in xs), cfg,
            stream.LatencyTeacher(stream.array_labels(ys), latency=0),
            snapshot_dir=d, snapshot_every=3, resume=True, mode="train_phase", device=CPU,
        )


def test_snapshot_contract_validation(monkeypatch):
    """An unknown pending policy is refused; a finished session cannot be
    snapshot; and a restore that names no device, on a machine without a
    CUDA device, raises instead of landing on the CPU."""
    cfg = _cfg()
    xs, ys = _stream_data(cfg, 4, 2, seed=29)
    sess = stream.StreamSession(
        _fleet(cfg, 2), cfg, stream.LatencyTeacher(stream.array_labels(ys), latency=0),
        mode="train_phase",
    )
    it = iter(xs)
    sess.start(next(it))
    sess.advance(next(it))
    tree = sess.snapshot()
    with pytest.raises(ValueError, match="pending"):
        stream.StreamSession.restore(
            tree, stream.LatencyTeacher(stream.array_labels(ys)), pending="yolo", device=CPU,
        )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.StreamSession.restore(tree, stream.LatencyTeacher(stream.array_labels(ys)))
    monkeypatch.undo()
    while sess._p is not None:
        sess.advance(next(it, None))
    sess.finish()
    with pytest.raises(RuntimeError, match="finished"):
        sess.snapshot()


# ---------------------------------------------------------------------------
# The port's own hazards: aliasing, cohort members, the crash smoke
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", stream.BACKPRESSURE_POLICIES)
def test_capture_owns_its_bytes(policy):
    """A captured tree shares no memory with the session: ticks after the
    capture (which write the session's buffers and ring) leave every leaf
    as it was, and the tree's state leaves equal the state at capture time
    with the JAX package's dtypes."""
    cfg = _cfg()
    xs, ys = _stream_data(cfg, 20, 3, seed=31)
    xs_t = torch.as_tensor(xs)  # tensor ticks: the ring holds CPU tensors
    sess = stream.StreamSession(_fleet(cfg, 3), cfg, _lossy_teacher(ys), mode="train_phase",
                                capacity=3, backpressure=policy)
    sess.start(xs_t[0])
    for t in range(1, 10):
        sess.advance(xs_t[t])
    want_state = {k: v.copy() for k, v in convert.engine_state_to_numpy(sess.state).items()}
    tree = sess.snapshot()
    frozen = copy.deepcopy(_flat(tree))
    assert len(tree["ring"]) > 0
    for t in range(10, 20):
        sess.advance(xs_t[t])
    sess.advance(None)
    for path, leaf in _flat(tree).items():
        np.testing.assert_array_equal(leaf, frozen[path], err_msg=f"leaf {path} changed")
    for g in ("elm", "prune", "drift", "meter"):
        for k, v in tree["state"][g].items():
            assert v.dtype == want_state[f"{g}.{k}"].dtype
            np.testing.assert_array_equal(v, want_state[f"{g}.{k}"], err_msg=f"{g}.{k}")
    assert tree["state"]["prune"]["level"].dtype == np.int32
    assert tree["state"]["drift"]["active"].dtype == np.bool_
    assert tree["state"]["meter"]["up_bytes"].dtype == np.float32


def test_fused_member_capture_materializes_its_rows():
    """A cohort member's plans are ``PlanSlice`` row views of the cohort's
    full-width plan; its snapshot (after ``refresh``) holds exactly its own
    rows, equal to the snapshot of the same tenant run solo."""
    from repro_torch.engine import cohort

    cfg = _cfg()
    datas = [_stream_data(cfg, 12, 3, seed=40 + i) for i in range(3)]
    teachers = [stream.LatencyTeacher(stream.array_labels(ys), latency=2, jitter=1, seed=i)
                for i, (_, ys) in enumerate(datas)]
    members = [stream.StreamSession(_fleet(cfg, 3), cfg, t, mode="train_phase", capacity=4)
               for t in teachers]
    coh = cohort.CohortSession(members)
    for t in range(8):
        coh.tick([xs[t] for xs, _ in datas])
    assert isinstance(members[1]._p, stream.PlanSlice)
    coh.refresh(members[1])
    fused = _flat(members[1].snapshot())

    xs, ys = datas[1]
    solo = stream.StreamSession(_fleet(cfg, 3), cfg,
                                stream.LatencyTeacher(stream.array_labels(ys), latency=2,
                                                      jitter=1, seed=1),
                                mode="train_phase", capacity=4)
    solo.start(xs[0])
    for t in range(1, 8):
        solo.advance(xs[t])
    want = _flat(solo.snapshot())
    assert sorted(fused) == sorted(want)
    for path in want:
        if path in ("meta", "stats/tick_ms"):
            continue  # wall-clock: wall_s and the tick times differ
        assert fused[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(fused[path], want[path], err_msg=path)
    assert fused["pending/plan/h"].shape == (3, cfg.elm.n_hidden)


def test_crash_smoke_on_cpu(capsys):
    """``python -m repro_torch.engine.durable --crash-smoke`` on the CPU: a
    child process SIGKILLed mid-stream once snapshots are published, resumed
    here, every tenant reconciled."""
    rc = durable.main(["--crash-smoke", "--device", "cpu", "--ticks", "60",
                       "--snapshot-every", "10"])
    assert rc == 0
    assert "crash smoke OK on cpu" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("policy", stream.BACKPRESSURE_POLICIES)
def test_cuda_resume_parity_bit_for_bit(cuda_device, policy, tmp_path):
    """Graphed sessions on the card: snapshot at tick k (through the disk),
    restore onto the card with fresh buffers and graphs, run to the end:
    bit for bit the uninterrupted graphed run."""
    cfg = _cfg()
    t_len, s_len, k = 40, 64, 17
    xs, ys = _stream_data(cfg, t_len, s_len, seed=7)
    ref_state, ref_outs, ref_stats = stream.run(
        _fleet(cfg, s_len, cuda_device), (x for x in xs), cfg, _lossy_teacher(ys),
        mode="train_phase", capacity=3, backpressure=policy,
    )
    sess = stream.StreamSession(_fleet(cfg, s_len, cuda_device), cfg, _lossy_teacher(ys),
                                mode="train_phase", capacity=3, backpressure=policy)
    it = iter(xs)
    sess.start(next(it))
    for _ in range(k):
        sess.advance(next(it, None))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(sess.t, sess.snapshot())
    for _ in range(3):  # the session keeps running while the writer writes
        sess.advance(next(it, None))
    mgr.wait()
    del sess, it
    _, tree = mgr.restore()
    sess2 = stream.StreamSession.restore(tree, _lossy_teacher(ys), cfg=cfg)
    assert sess2.device.type == "cuda"
    for ent in sess2.ring.entries():
        assert ent.plan.h.device.type == "cuda" and ent.x.device.type == "cuda"
    st2, outs2, stats2 = _drive(sess2, xs, snapshot.ticks_consumed(tree))
    _assert_state_equal(ref_state, st2, msg=policy)
    _assert_stats_equal(ref_stats, stats2, msg=policy)
    _assert_outputs_equal(ref_outs, outs2, msg=policy)
    assert stats2.reconciled


@pytest.mark.cuda
def test_cuda_restore_puts_state_and_plans_on_the_card(cuda_device):
    """A CPU capture restores onto the card with the same leaf dtypes, and
    its re-capture there gives the same bytes."""
    cfg = _cfg()
    xs, ys = _stream_data(cfg, 12, 4, seed=5)
    sess = stream.StreamSession(_fleet(cfg, 4), cfg, _lossy_teacher(ys), mode="train_phase",
                                capacity=4)
    sess.start(xs[0])
    for t in range(1, 9):
        sess.advance(xs[t])
    tree = sess.snapshot()
    on_card = stream.StreamSession.restore(tree, _lossy_teacher(ys))
    for leaf in tree_leaves(on_card.state):
        assert leaf.device.type == "cuda"
    for f in on_card._p._fields:
        assert getattr(on_card._p, f).device.type == "cuda"
        assert getattr(on_card._p, f).dtype == getattr(sess._p, f).dtype
    again, want = _flat(on_card.snapshot()), _flat(tree)
    for path in want:
        if path != "meta":
            np.testing.assert_array_equal(again[path], want[path], err_msg=path)


@pytest.mark.cuda
def test_cuda_extract_from_16x1024_cohort_is_bit_for_bit(cuda_device):
    """16 tenants of 1024 streams fused on the card: extract one mid-run,
    admit it into a second multiplexer beside a fresh companion (it lands
    in a cohort slot), and every tenant equals its solo run bit for bit."""
    cfg = _cfg()
    n, s, t_len = 16, 1024, 24
    datas = [_stream_data(cfg, t_len, s, seed=300 + i) for i in range(n + 1)]

    def teacher(i):
        return stream.LatencyTeacher(stream.array_labels(datas[i][1]), latency=2, jitter=2,
                                     loss_prob=0.1, seed=60 + i)

    def tenant(i, ticks):
        return multiplex.Tenant(name=f"t{i:02d}", state=_fleet(cfg, s, cuda_device),
                                ticks=ticks, cfg=cfg, teacher=teacher(i), mode="train_phase",
                                capacity=4)

    solo = [stream.run(_fleet(cfg, s, cuda_device), iter(xs), cfg, teacher(i),
                       mode="train_phase", capacity=4) for i, (xs, _) in enumerate(datas)]
    mux = multiplex.Multiplexer([tenant(i, iter(datas[i][0])) for i in range(n)])
    while mux.round():
        if mux.session("t00").t >= 10:
            break
    assert mux._slot("t00").unit is not None
    tree, rest = mux.extract("t00")
    results_a, _ = mux.run()
    mux_b = multiplex.Multiplexer([tenant(n, iter(datas[n][0]))])
    mux_b.admit(multiplex.Tenant(name="t00", state=None, ticks=rest, cfg=cfg, teacher=teacher(0),
                                 mode="train_phase", capacity=4),
                snapshot=tree, positioned=True)
    assert mux_b.round()
    assert mux_b._slot("t00").unit is not None
    results_b, _ = mux_b.run()
    got = {**results_a, **results_b}
    for i, (st, outs, stats) in enumerate(solo):
        r = got[f"t{i:02d}"]
        _assert_state_equal(st, r.state, msg=r.name)
        _assert_outputs_equal(outs, r.outputs, msg=r.name)
        _assert_stats_equal(stats, r.stats, msg=r.name)
        assert r.stats.reconciled
