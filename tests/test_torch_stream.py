"""The port's streaming runtime (``repro_torch.engine.stream``) against its
own ``run_fleet`` and against the JAX package's ``repro.engine.stream``.

Sizes as in ``tests/test_stream.py``: n_in=24, N=16, m=4, S=2-4, T <= 90.
Inputs come from numpy with a seed; both packages get the same arrays and
the same ``LatencyTeacher`` seeds, and the port's state comes in through
``repro_torch.convert``.  On the CPU the port runs its tick functions
eagerly and the kernels' plain versions.

Across packages, everything the teacher and the backpressure policy decide
must match exactly: queried and trained rows, every ``StreamStats``
counter, ``reconciled`` and ``pending_queries()`` after every tick.  Floats
meet the ROADMAP tolerance for runs where P starts at I/ridge (rtol and
atol 2e-3); the port's RLS follows the Pallas numerics, the JAX engine's
default its einsum path.  Inside the port, zero latency equals
``run_fleet`` bit for bit.

Tests marked ``cuda`` replay the runners as CUDA graphs on the card and
skip elsewhere.  They need no JAX, so the file also runs on the card's
machine, which has none (the tests against the JAX package skip there):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_stream.py
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

# Where JAX is installed the JAX package must import (a broken reference
# fails here); only a machine without JAX runs the port-only tests alone.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.engine import stream as j_stream

from repro_torch import convert  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.core import drift as t_drift  # noqa: E402
from repro_torch.core import oselm as t_oselm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.engine import graphs  # noqa: E402
from repro_torch.engine import stream  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N_IN, N_HIDDEN, N_OUT = 24, 16, 4
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")


def _cfg(pkg_engine, pkg_oselm, pkg_pruning, pkg_drift, min_trained):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, variant="hash",
                                  ridge=1e-2),
        prune=pkg_pruning.PruneConfig(min_trained=min_trained),
        drift=pkg_drift.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )


def _cfgs(min_trained=16):
    """(JAX config or None where JAX is missing, the port's config)."""
    tcfg = _cfg(t_engine, t_oselm, t_pruning, t_drift, min_trained)
    if not HAVE_JAX:
        return None, tcfg
    return _cfg(j_engine, j_oselm, j_pruning, j_drift, min_trained), tcfg


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


def _data(t, s, seed, shift_at=None, sticky=False):
    """Ticks and labels; ``sticky`` labels are mostly each stream's own
    class, so heads learn them, the ladder steps down and queries skip."""
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    if shift_at is not None:
        sev = np.linspace(2.0, 4.0, s)[None, :, None]
        xs[shift_at:] = np.clip(xs[shift_at:] * sev + 0.5 * sev, -4, 4)
    ys = rng.integers(0, N_OUT, (t, s)).astype(np.int32)
    if sticky:
        own = np.broadcast_to(np.arange(s) % N_OUT, (t, s))
        ys = np.where(rng.uniform(size=(t, s)) < 0.9, own, ys).astype(np.int32)
    return xs, ys


def _port_fleet(cfg, s, device="cpu"):
    return t_engine.init_fleet(cfg, s, device=device)


def _state_arrays(state):
    return convert.engine_state_to_numpy(state)


def _assert_states_equal(a, b):
    a, b = _state_arrays(a), _state_arrays(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"state leaf {k} diverged")


def _assert_counters_equal(tstats, jstats, where=""):
    for k in COUNTERS:
        assert getattr(tstats, k) == getattr(jstats, k), f"{where}: counter {k}"
    assert tstats.reconciled == jstats.reconciled
    assert list(tstats.label_latency_ticks) == list(jstats.label_latency_ticks), where


def _assert_close_to_jax(tstate, touts, jstate, jouts):
    """Decisions exact; floats within rtol and atol 2e-3 (P starts at
    I/ridge)."""
    for f in ("pred", "queried", "trained", "theta", "mode_training"):
        np.testing.assert_array_equal(getattr(touts, f), np.asarray(getattr(jouts, f)),
                                      err_msg=f)
    for f in ("outputs", "confidence"):
        np.testing.assert_allclose(getattr(touts, f), np.asarray(getattr(jouts, f)),
                                   rtol=2e-3, atol=2e-3, err_msg=f)
    t, j = _state_arrays(tstate), _state_arrays(jstate)
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        if t[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=2e-3, atol=2e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["algo1", "train_phase"])
def test_zero_latency_matches_run_fleet_bit_for_bit(mode):
    """``stream.run`` with an instant teacher is ``run_fleet``: every output
    field and every state leaf equal bit for bit."""
    _, cfg = _cfgs()
    t_len, s_len = 90, 3
    xs, ys = _data(t_len, s_len, seed=1, shift_at=40)
    st_f, out_f = t_engine.run_fleet(_port_fleet(cfg, s_len), xs, ys, cfg, mode=mode)
    teacher = stream.LatencyTeacher(stream.array_labels(ys), latency=0)
    st_s, out_s, stats = stream.run(_port_fleet(cfg, s_len), (xs[t] for t in range(t_len)),
                                    cfg, teacher, mode=mode)
    for name in out_f._fields:
        a, b = getattr(out_f, name).numpy(), getattr(out_s, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=f"output field {name!r} diverged")
    _assert_states_equal(st_f, st_s)
    assert stats.ticks == t_len
    assert stats.labels_applied == stats.queries_issued > 0
    assert stats.tickets_dropped == stats.tickets_lost == stats.replies_orphaned == 0
    assert stats.label_latency_p95 == 0.0


@pytest.mark.parametrize("donate", [True, False])
def test_callers_state_survives_the_run(donate):
    _, cfg = _cfgs(min_trained=1)
    xs, ys = _data(12, 3, seed=2)
    st0 = _port_fleet(cfg, 3)
    before = _state_arrays(st0)
    teacher = stream.LatencyTeacher(stream.array_labels(ys), latency=2, jitter=1, seed=1)
    st, _, stats = stream.run(st0, iter(xs), cfg, teacher, mode="train_phase", donate=donate)
    assert stats.labels_applied > 0
    after = _state_arrays(st0)
    for k in before:
        np.testing.assert_array_equal(before[k], after[k], err_msg=k)
    assert not np.array_equal(_state_arrays(st)["elm.P"], before["elm.P"])


# ---------------------------------------------------------------------------
# Against the JAX package, tick by tick
# ---------------------------------------------------------------------------

SCENARIOS = {
    # name: (mode, min_trained, latency, jitter, loss, partial, outage, capacity, policy)
    "clean": ("train_phase", 1_000_000, 0, 0, 0.0, 0.0, None, 64, "drop_oldest"),
    "loss_jitter_overflow": ("train_phase", 1_000_000, 2, 5, 0.3, 0.0, None, 4, "drop_oldest"),
    "partial": ("train_phase", 1_000_000, 3, 2, 0.2, 0.3, None, 2, "drop_oldest"),
    "drop_newest": ("train_phase", 1_000_000, 5, 0, 0.0, 0.5, None, 2, "drop_newest"),
    "block": ("train_phase", 1_000_000, 3, 4, 0.2, 0.2, None, 2, "block"),
    "coalesce": ("train_phase", 1_000_000, 4, 3, 0.1, 0.25, None, 3, "coalesce"),
    "outage": ("train_phase", 1_000_000, 1, 0, 0.0, 0.0, 5, 8, "drop_oldest"),
    "warm_heads_block": ("train_phase", 16, 2, 3, 0.1, 0.2, None, 3, "block"),
    "algo1_drift_coalesce": ("algo1", 16, 2, 2, 0.05, 0.1, None, 4, "coalesce"),
    # Learnable labels: the ladder steps down and confident heads skip.
    "skipping_heads": ("sticky", 4, 1, 1, 0.1, 0.0, None, 8, "drop_oldest"),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
@pytest.mark.usefixtures("jax_ref")
def test_matches_jax_stream_tick_by_tick(name):
    """Both packages' sessions driven tick by tick on the same inputs and
    teacher seeds: counters and pending queries equal after every tick,
    decisions equal, floats within tolerance at the end."""
    mode, min_trained, latency, jitter, loss, partial, outage, capacity, policy = SCENARIOS[name]
    sticky = mode == "sticky"
    mode = "train_phase" if sticky else mode
    jcfg, tcfg = _cfgs(min_trained)
    t_len, s_len = {"algo1": (60, 3), "train_phase": (40, 4)}[mode] if not sticky else (90, 3)
    xs, ys = _data(t_len, s_len, seed=7, shift_at=36 if mode == "algo1" else None, sticky=sticky)
    jst0 = j_engine.init_fleet(jcfg, s_len)
    sessions = []
    for pkg, cfg, st0 in ((j_stream, jcfg, jst0),
                          (stream, tcfg, convert.engine_state_from_numpy(
                              convert.engine_state_to_numpy(jst0), device="cpu"))):
        teacher = pkg.LatencyTeacher(pkg.array_labels(ys), latency=latency, jitter=jitter,
                                     loss_prob=loss, partial_prob=partial, outage_after=outage,
                                     seed=11)
        sessions.append(pkg.StreamSession(st0, cfg, teacher, mode=mode, capacity=capacity,
                                          backpressure=policy))
    jsess, tsess = sessions
    for sess in sessions:
        sess.start(xs[0])
    for t in range(t_len):
        nxt = xs[t + 1] if t + 1 < t_len else None
        for sess in sessions:
            sess.advance(nxt)
        _assert_counters_equal(tsess.stats, jsess.stats, f"tick {t}")
        assert tsess.pending_queries() == jsess.pending_queries(), f"tick {t}"
        assert (tsess.stats.queries_issued == tsess.stats.labels_applied
                + tsess.stats.queries_dropped + tsess.stats.queries_lost
                + tsess.stats.queries_coalesced + tsess.pending_queries())
    jst, jouts, jstats = jsess.finish()
    tst, touts, tstats = tsess.finish()
    _assert_counters_equal(tstats, jstats, "finish")
    assert tstats.reconciled
    _assert_close_to_jax(tst, touts, jst, jouts)
    if mode == "algo1":
        assert touts.mode_training.any() and not touts.mode_training[:36].any()
    if sticky:
        assert int(tst.prune.skips.sum()) > 0  # decisions on conf > theta were exercised


@pytest.mark.usefixtures("jax_ref")
def test_quiesce_mid_stream_matches_jax():
    """``quiesce`` between ticks applies every in-flight answer without
    moving the tick clock, in both packages alike; the run then goes on."""
    jcfg, tcfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(12, 3, seed=14)
    jst0 = j_engine.init_fleet(jcfg, 3)
    sessions = [
        pkg.StreamSession(st0, cfg, pkg.LatencyTeacher(pkg.array_labels(ys), latency=3,
                                                       jitter=1, seed=2),
                          mode="train_phase", capacity=8)
        for pkg, cfg, st0 in ((j_stream, jcfg, jst0),
                              (stream, tcfg, convert.engine_state_from_numpy(
                                  convert.engine_state_to_numpy(jst0), device="cpu")))]
    for sess in sessions:
        sess.start(xs[0])
        for t in range(6):
            sess.advance(xs[t + 1])
    jsess, tsess = sessions
    assert tsess.pending_queries() == jsess.pending_queries() > 0
    assert tsess.quiesce() and jsess.quiesce()
    assert tsess.t == jsess.t == 6 and tsess.pending_queries() == 0
    _assert_counters_equal(tsess.stats, jsess.stats, "after quiesce")
    for sess in sessions:
        for t in range(6, 12):
            sess.advance(xs[t + 1] if t + 1 < 12 else None)
    jst, jouts, jstats = jsess.finish()
    tst, touts, tstats = tsess.finish()
    _assert_counters_equal(tstats, jstats, "finish")
    _assert_close_to_jax(tst, touts, jst, jouts)


@pytest.mark.usefixtures("jax_ref")
def test_teacher_draws_and_snapshot_match_jax():
    """Same seed, same asks: both teachers answer the same tickets at the
    same ticks with the same masks; a snapshot taken midway and restored
    into a fresh teacher resumes the same draws."""
    ys = np.random.default_rng(0).integers(0, N_OUT, (30, 5)).astype(np.int32)
    kw = dict(latency=2, jitter=3, loss_prob=0.2, partial_prob=0.3, seed=4)
    teachers = [pkg.LatencyTeacher(pkg.array_labels(ys), **kw) for pkg in (stream, j_stream)]
    mask = np.ones(5, bool)
    for t in range(15):
        got = []
        for teacher in teachers:
            teacher.ask(None, mask, t)
            got.append([(r.ticket, r.labels.tolist(), r.answered.tolist())
                        for r in teacher.poll(t)])
        assert got[0] == got[1], t
    snap = teachers[0].snapshot_state()
    resumed = stream.LatencyTeacher(stream.array_labels(ys), **kw)
    resumed.restore_snapshot(snap)
    assert resumed.snapshot_state()["meta"].item() == snap["meta"].item()
    assert resumed.in_flight() == teachers[0].in_flight()
    for t in range(15, 30):
        got = []
        for teacher in (resumed, teachers[1]):
            teacher.ask(None, mask, t)
            got.append([(r.ticket, r.labels.tolist(), r.answered.tolist())
                        for r in teacher.poll(t)])
        assert got[0] == got[1], t


# ---------------------------------------------------------------------------
# Mirrors of tests/test_stream.py and the policy cases of tests/test_multiplex.py
# ---------------------------------------------------------------------------


def _run(cfg, xs, ys, mode="train_phase", **kw):
    s_len = xs.shape[1]
    teacher_kw = {k: kw.pop(k) for k in ("latency", "jitter", "outage_after", "seed") if k in kw}
    teacher = stream.LatencyTeacher(stream.array_labels(ys), **teacher_kw)
    st, outs, stats = stream.run(_port_fleet(cfg, s_len), iter(xs), cfg, teacher, mode=mode,
                                 **kw)
    return st, outs, stats, teacher


def test_deferred_out_of_order_labels_train_on_query_time_features():
    """Jittered answers arrive out of order; each trains on the features
    planned at query time: the final state equals a replay of the same
    claims through ``learn`` with each tick's own plan."""
    _, cfg = _cfgs(min_trained=1)
    xs, ys = _data(40, 4, seed=2)
    st, outs, stats, teacher = _run(cfg, xs, ys, latency=2, jitter=5, seed=3)
    assert stats.labels_applied > 0
    assert stats.labels_applied == int(st.elm.count.sum())
    assert stats.labels_applied == int(outs.trained.sum())
    assert not np.any(outs.trained & ~outs.queried)
    lat = np.asarray(stats.label_latency_ticks)
    assert lat.min() >= 2 and lat.max() > lat.min()
    assert stats.tickets_lost == 0 and teacher.in_flight() == 0
    # Query-time features: every trained row's h, recomputed from its own
    # tick, reproduces the final weights when applied in claim order.
    sess = stream.StreamSession(_port_fleet(cfg, 4), cfg,
                                stream.LatencyTeacher(stream.array_labels(ys), latency=2,
                                                      jitter=5, seed=3), mode="train_phase")
    applied = []
    orig = sess._build_learn_args

    def spy(ent, reply, mask):
        applied.append((ent.tick, ent.plan.h.clone(), mask.copy()))
        return orig(ent, reply, mask)

    sess._build_learn_args = spy
    sess.start(xs[0])
    for t in range(40):
        sess.advance(xs[t + 1] if t + 1 < 40 else None)
    sess.finish()
    for tick, h, _ in applied:
        want = t_engine.plan(_port_fleet(cfg, 4), torch.as_tensor(xs[tick]), cfg)[1].h
        np.testing.assert_array_equal(h.numpy(), want.numpy())
    assert [a[0] for a in applied] != sorted(a[0] for a in applied)  # out of order


def test_ring_overflow_drops_oldest_and_meters_it():
    _, cfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(6, 3, seed=4)
    st, outs, stats, _ = _run(cfg, xs, ys, latency=50, capacity=2)
    assert stats.tickets_issued == 6
    assert stats.tickets_dropped == 4 and stats.queries_dropped == 12
    assert stats.labels_applied == 6 and stats.replies_orphaned == 4
    assert stats.tickets_lost == 0
    np.testing.assert_array_equal(outs.trained.sum(axis=0), [2, 2, 2])
    np.testing.assert_array_equal(outs.trained[-2:], np.ones((2, 3), bool))


def test_permanent_outage_leaves_heads_identical_to_never_queried():
    _, cfg = _cfgs(min_trained=1)
    xs, ys = _data(30, 3, seed=5)
    st_out, outs_out, stats, _ = _run(cfg, xs, ys, latency=0, outage_after=0)
    st_ref, outs_ref = t_engine.run_fleet(_port_fleet(cfg, 3), xs, ys, cfg, mode="train_phase",
                                          teacher_available=np.zeros((30, 3), bool))
    for a, b in zip(st_out.elm, st_ref.elm):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(outs_out.pred, outs_ref.pred.numpy())
    assert stats.labels_applied == 0 and not outs_out.trained.any()
    assert stats.tickets_lost == stats.tickets_issued > 0
    assert stats.queries_issued > 0 and float(st_out.meter.total.sum()) > 0


def test_deferred_ladder_judges_against_query_time_theta():
    cfg = t_pruning.PruneConfig()
    st = t_pruning.init_fleet(1, device="cpu")._replace(level=torch.tensor([2], dtype=torch.int32))
    conf = torch.tensor([0.5])
    q, disagree = torch.tensor([True]), torch.tensor([False])
    assert int(t_pruning.update(st, q, disagree, conf, cfg).level[0]) == 2
    deferred = t_pruning.update(st, q, disagree, conf, cfg, theta=torch.tensor([0.64]))
    assert int(deferred.level[0]) == 1


def test_drop_newest_keeps_oldest_tickets():
    _, cfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(6, 3, seed=10)
    _, outs, stats, _ = _run(cfg, xs, ys, latency=50, capacity=2, backpressure="drop_newest")
    assert stats.tickets_issued == 2
    assert stats.tickets_dropped == 4 and stats.queries_dropped == 12
    assert stats.labels_applied == 6 and stats.replies_orphaned == 0
    np.testing.assert_array_equal(outs.trained[:2], np.ones((2, 3), bool))
    assert not outs.trained[2:].any() and stats.reconciled


def test_block_defers_asks_in_fifo_order():
    _, cfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(12, 3, seed=11)
    asked = []

    class Recording(stream.LatencyTeacher):
        def ask(self, feats, mask, tick):
            asked.append(tick)
            return super().ask(feats, mask, tick)

    teacher = Recording(stream.array_labels(ys), latency=3)
    st, outs, stats = stream.run(_port_fleet(cfg, 3), iter(xs), cfg, teacher,
                                 mode="train_phase", capacity=2, backpressure="block")
    assert asked == list(range(12))  # every ask, in origin-tick order
    assert stats.asks_deferred > 0 and stats.queries_dropped == 0
    assert stats.labels_applied == stats.queries_issued == 36
    assert outs.trained.all() and stats.reconciled


def test_coalesce_credits_merged_queries():
    _, cfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(6, 3, seed=12)
    _, outs, stats, _ = _run(cfg, xs, ys, latency=50, capacity=4, backpressure="coalesce")
    assert stats.tickets_issued == 1
    assert stats.tickets_coalesced == 5 and stats.queries_coalesced == 15
    assert stats.labels_applied == 3
    assert stats.queries_dropped == 0 and stats.replies_orphaned == 0
    np.testing.assert_array_equal(outs.trained[0], np.ones(3, bool))
    assert not outs.trained[1:].any() and stats.reconciled


def test_coalesce_does_not_credit_a_ticket_it_evicts():
    _, cfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(3, 2, seed=22)
    sess = stream.StreamSession(_port_fleet(cfg, 2), cfg,
                                stream.LatencyTeacher(stream.array_labels(ys), latency=50),
                                mode="train_phase", capacity=1, backpressure="coalesce")
    sess.stats.queries_issued += 1
    sess._submit(xs[0], np.array([True, False]), None, 0)
    sess.stats.queries_issued += 2
    sess._submit(xs[1], np.array([True, True]), None, 1)
    assert sess.stats.queries_coalesced == 0
    assert sess.stats.tickets_dropped == 1 and sess.stats.queries_dropped == 1
    (ent,) = sess.ring.entries()
    np.testing.assert_array_equal(ent.queried, [True, True])


def test_runner_caches_are_bounded_with_counters():
    """Mirrors ``tests/test_stream.py``'s cache test."""
    info = stream.cache_stats()
    for name in ("plan_runner", "learn_runner", "learn_plan_runner", "plan_avail_runner",
                 "learn_plan_avail_runner"):
        assert info[name]["maxsize"] == t_engine.fleet.RUNNER_CACHE_SIZE == 32
        assert {"hits", "misses", "size"} <= set(info[name])
    _, cfg = _cfgs()
    xs, ys = _data(4, 2, seed=6)
    before = stream.cache_stats()
    for _ in range(2):
        _run(cfg, xs, ys, latency=1)
    after = stream.cache_stats()
    assert after["plan_runner"]["misses"] >= before["plan_runner"]["misses"]
    assert after["plan_runner"]["hits"] > before["plan_runner"]["hits"]
    assert after["learn_runner"]["hits"] > before["learn_runner"]["hits"]
    assert stream.StreamStats().summary()["caches"].keys() == after.keys()


def test_live_rows_plan_unavailable():
    """``live`` < S: the dead tail never queries or learns and is left out
    of ``stream_steps`` (the avail runners)."""
    _, cfg = _cfgs(min_trained=1_000_000)
    xs, ys = _data(8, 4, seed=13)
    sess = stream.StreamSession(_port_fleet(cfg, 4), cfg,
                                stream.LatencyTeacher(stream.array_labels(ys), latency=1),
                                mode="train_phase", live=3)
    sess.start(xs[0])
    for t in range(8):
        sess.advance(xs[t + 1] if t + 1 < 8 else None)
    st, outs, stats = sess.finish()
    assert not outs.queried[:, 3].any() and outs.queried[:, :3].all()
    assert stats.stream_steps == 8 * 3 and stats.labels_applied == 8 * 3
    assert int(st.elm.count[3]) == 0
    assert stream.cache_stats()["learn_plan_avail_runner"]["size"] >= 1


# ---------------------------------------------------------------------------
# On the card: the runners replayed as CUDA graphs.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _drive(cfg, xs, ys, device, **kw):
    teacher = stream.LatencyTeacher(stream.array_labels(ys), latency=kw.pop("latency", 0),
                                    jitter=kw.pop("jitter", 0), seed=5)
    return stream.run(_port_fleet(cfg, xs.shape[1], device), iter(xs), cfg, teacher, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["algo1", "train_phase"])
def test_cuda_zero_latency_graphed_stream_equals_eager_run_fleet(cuda_device, mode):
    _, cfg = _cfgs()
    xs, ys = _data(60, 8, seed=1, shift_at=30)
    st_f, out_f = t_engine.run_fleet(_port_fleet(cfg, 8, cuda_device), xs, ys, cfg, mode=mode)
    graphs.reset_replay_counts()
    st_s, out_s, _ = _drive(cfg, xs, ys, cuda_device, mode=mode)
    for name in out_f._fields:
        np.testing.assert_array_equal(getattr(out_f, name).cpu().numpy(), getattr(out_s, name),
                                      err_msg=name)
    _assert_states_equal(st_f, st_s)
    # Every tick is planned once; every tick with a query learns once (its
    # zero-latency reply), by graph replays.
    assert graphs.kernel_replays["xorshift_projection"] == 60
    assert graphs.kernel_replays["oselm_rls_update_fleet"] == int(out_s.queried.any(1).sum())


@pytest.mark.cuda
def test_cuda_graphed_fused_ticks_with_latency_match_the_cpu_session(cuda_device):
    """latency 3, jitter 2, capacity 4: each reply trains on the plan of
    its own tick.  Aliasing a graph's static buffers in the ring would
    train on the last replay's features and show here."""
    _, cfg = _cfgs(min_trained=8)
    xs, ys = _data(48, 8, seed=3)
    kw = dict(mode="train_phase", latency=3, jitter=2, capacity=4)
    st_c, out_c, stats_c = _drive(cfg, xs, ys, cuda_device, **kw)
    st_h, out_h, stats_h = _drive(cfg, xs, ys, "cpu", **kw)
    _assert_counters_equal(stats_c, stats_h, "card vs cpu")
    for f in ("queried", "trained", "theta", "mode_training"):
        np.testing.assert_array_equal(getattr(out_c, f), getattr(out_h, f), err_msg=f)
    a, b = _state_arrays(st_c), _state_arrays(st_h)
    for k in a:
        if a[k].dtype == np.float32:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-3, atol=2e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.cuda
def test_cuda_finished_state_outlives_its_session(cuda_device):
    import gc

    _, cfg = _cfgs(min_trained=8)
    xs, ys = _data(20, 8, seed=4)
    st, _, _ = _drive(cfg, xs, ys, cuda_device, mode="train_phase", latency=2)
    want = _state_arrays(st)
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << 20,), float("nan"), device=cuda_device) for _ in range(8)]
    torch.cuda.synchronize()
    _assert_states_equal(st, convert.engine_state_from_numpy(want, device=cuda_device))
    del junk


@pytest.mark.cuda
def test_cuda_failed_capture_raises(cuda_device):
    """No eager fallback: a tick function that syncs the host cannot be
    captured, and the call raises."""
    def syncs(src, dst, x):
        return (x * float(x.sum().item()),)

    x = torch.ones(4, device=cuda_device)
    launches = dict(ops.launch_counts)
    with pytest.raises(RuntimeError):
        graphs.run({}, "k", "syncs", syncs, (None, None), (x,))
    assert ops.launch_counts == launches
