"""The port's multi-tenant multiplexer (``repro_torch.engine.multiplex``),
inside the port and against the JAX package's ``repro.engine.multiplex``.

Mirrors the multiplexer cases of ``tests/test_multiplex.py`` at its sizes
(n_in=24, N=16 or 32, m=4, S=2-16, T <= 40).  Inputs come from numpy with a
seed; both packages get the same arrays and teacher seeds, and the port's
states come in through ``repro_torch.convert``.  Inside the port a
multiplexed tenant equals its solo ``stream.run`` bit for bit.  Against the
JAX package, decisions and counters are exactly equal and floats meet the
ROADMAP tolerance for runs where P starts at I/ridge (rtol and atol 2e-3):
the JAX engine runs its einsum RLS path, the port follows the Pallas
numerics (no symmetrisation, beta from P'·W).

The durability cases of ``tests/test_multiplex.py`` (cadence snapshots,
resume, ``extract``) and the RPC teachers wait for their own ports.

Tests marked ``cuda`` run on the card and skip elsewhere:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_multiplex.py
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
    from repro.engine import multiplex as j_multiplex
    from repro.engine import stream as j_stream

from repro_torch import convert  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.core import drift as t_drift  # noqa: E402
from repro_torch.core import oselm as t_oselm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.engine import graphs, multiplex, stream  # noqa: E402

N_IN, N_OUT = 24, 4
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")


def _cfg(pkg_engine, pkg_oselm, pkg_pruning, pkg_drift, n_hidden=16, min_trained=16):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=N_IN, n_hidden=n_hidden, n_out=N_OUT, variant="hash",
                                  ridge=1e-2),
        prune=pkg_pruning.PruneConfig(min_trained=min_trained),
        drift=pkg_drift.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )


def _tcfg(**kw):
    return _cfg(t_engine, t_oselm, t_pruning, t_drift, **kw)


def _jcfg(**kw):
    return _cfg(j_engine, j_oselm, j_pruning, j_drift, **kw)


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _data(t, s, seed):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    ys = rng.integers(0, N_OUT, (t, s)).astype(np.int32)
    return xs, ys


def _tenant(name, cfg, xs, teacher, device="cpu", **kw):
    return multiplex.Tenant(name=name, state=t_engine.init_fleet(cfg, xs.shape[1], device),
                            ticks=iter(xs), cfg=cfg, teacher=teacher, mode="train_phase", **kw)


def _silent():
    return stream.LatencyTeacher(lambda t_, f: np.zeros(2, np.int32))


def _instant(ys):
    return stream.LatencyTeacher(stream.array_labels(ys), latency=0)


def _assert_state_equal(a, b, msg=""):
    a, b = convert.engine_state_to_numpy(a), convert.engine_state_to_numpy(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} leaf {k} diverged")


def _assert_outputs_equal(a, b, msg=""):
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                      err_msg=f"{msg} output {name!r} diverged")


def _assert_reconciled(stats, policy="drop_oldest"):
    assert stats.reconciled, stats.summary()
    if policy != "coalesce":
        assert stats.queries_coalesced == 0
        assert stats.queries_issued == (stats.labels_applied + stats.queries_dropped
                                        + stats.queries_lost), stats.summary()


# ---------------------------------------------------------------------------
# Inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantum", [1, 3])
def test_two_tenants_bit_for_bit_vs_two_solo_runs(quantum):
    """Two tenants with different configs (so they never fuse) end in
    exactly the states and outputs of two ``stream.run`` calls."""
    cfgs = [_tcfg(n_hidden=16, min_trained=4), _tcfg(n_hidden=32, min_trained=8)]
    datas = [_data(40, 3, seed=1), _data(25, 2, seed=2)]
    solo = [stream.run(t_engine.init_fleet(cfg, xs.shape[1], "cpu"), iter(xs), cfg, _instant(ys),
                       mode="train_phase") for cfg, (xs, ys) in zip(cfgs, datas)]
    tenants = [_tenant(f"tenant{i}", cfg, xs, _instant(ys))
               for i, (cfg, (xs, ys)) in enumerate(zip(cfgs, datas))]
    results, agg = multiplex.run(tenants, quantum=quantum)
    assert agg.n_tenants == 2
    assert agg.stream_steps == sum(s[2].stream_steps for s in solo)
    for i, (st, outs, stats) in enumerate(solo):
        r = results[f"tenant{i}"]
        _assert_state_equal(st, r.state, f"tenant{i}")
        _assert_outputs_equal(outs, r.outputs, f"tenant{i}")
        assert r.stats.queries_issued == stats.queries_issued > 0
        assert r.stats.labels_applied == stats.labels_applied
        _assert_reconciled(r.stats)


def test_tenants_with_equal_configs_share_runner_factories():
    """Tenants whose (cfg, mode, donate) hash equal reuse the same tick
    functions (cache hits), never a second one (a miss), fused or not."""
    cfg = _tcfg(n_hidden=16, min_trained=4)
    xs, ys = _data(6, 2, seed=3)
    multiplex.run([_tenant("warm", cfg, xs, _instant(ys))])
    for fuse in (False, True):
        before = multiplex.cache_stats()
        multiplex.run([_tenant(n, cfg, xs, _instant(ys)) for n in "abc"], fuse=fuse)
        after = multiplex.cache_stats()
        for runner in ("plan_runner", "learn_runner", "learn_plan_runner"):
            assert after[runner]["misses"] == before[runner]["misses"], (fuse, runner)
        assert after["plan_runner"]["hits"] >= before["plan_runner"]["hits"] + 3


def test_multiplex_mixed_policies_and_faults_reconcile_per_tenant():
    cfg_a = _tcfg(n_hidden=16, min_trained=1_000_000)
    cfg_b = _tcfg(n_hidden=32, min_trained=1_000_000)
    xs_a, ys_a = _data(30, 3, seed=16)
    xs_b, ys_b = _data(20, 2, seed=17)
    tenants = [
        _tenant("lossy", cfg_a, xs_a, stream.LatencyTeacher(
            stream.array_labels(ys_a), latency=2, jitter=3, loss_prob=0.3, partial_prob=0.2,
            seed=18), capacity=3, backpressure="drop_oldest"),
        _tenant("coalescing", cfg_b, xs_b, stream.LatencyTeacher(
            stream.array_labels(ys_b), latency=6, seed=19), capacity=2, backpressure="coalesce"),
    ]
    results, agg = multiplex.run(tenants)
    assert results["lossy"].stats.queries_issued == 30 * 3
    assert results["coalescing"].stats.queries_coalesced > 0
    for name, policy in (("lossy", "drop_oldest"), ("coalescing", "coalesce")):
        _assert_reconciled(results[name].stats, policy)
    assert agg.stream_steps == 30 * 3 + 20 * 2


def test_multiplex_rejects_duplicate_names_and_empty():
    cfg = _tcfg()
    with pytest.raises(ValueError, match="at least one"):
        multiplex.run([])
    t = multiplex.Tenant(name="dup", state=t_engine.init_fleet(cfg, 2, "cpu"), ticks=iter(()),
                         cfg=cfg, teacher=_silent())
    with pytest.raises(ValueError, match="unique"):
        multiplex.run([t, t])
    mux = multiplex.Multiplexer([t])
    with pytest.raises(ValueError, match="already admitted"):
        mux.admit(t)


def test_drr_is_bit_for_bit_and_does_not_let_big_tenants_starve_small():
    """DRR charges a tick its stream count: while the small tenant is live
    the big one advances at most two ticks a round, and per-tenant results
    equal rr's bit for bit."""
    cfg = _tcfg(n_hidden=16, min_trained=4)
    t_len = 24
    xs_s, ys_s = _data(t_len, 2, seed=30)
    xs_b, ys_b = _data(t_len, 16, seed=31)

    def tenants():
        return [_tenant("small", cfg, xs_s, _instant(ys_s)),
                _tenant("big", cfg, xs_b, _instant(ys_b))]

    res_rr, agg_rr = multiplex.run(tenants(), sched="rr")
    mux = multiplex.Multiplexer(tenants(), sched="drr")
    big_while_small_live = []
    while mux.round():
        if mux._slot("small").result is None:
            big_while_small_live.append(mux._slot("big").last_ticks)
    res_drr, agg_drr = mux.results()
    for name in ("small", "big"):
        _assert_state_equal(res_rr[name].state, res_drr[name].state, name)
        _assert_outputs_equal(res_rr[name].outputs, res_drr[name].outputs, name)
        _assert_reconciled(res_drr[name].stats)
    assert agg_drr.stream_steps == agg_rr.stream_steps
    assert big_while_small_live, "small tenant never observed live"
    assert max(big_while_small_live) <= 2, big_while_small_live
    assert agg_drr.rounds >= agg_rr.rounds


def test_scheduler_and_quantum_are_validated():
    cfg = _tcfg()
    t = multiplex.Tenant(name="t", state=t_engine.init_fleet(cfg, 2, "cpu"), ticks=iter(()),
                         cfg=cfg, teacher=_silent())
    with pytest.raises(ValueError, match="scheduler"):
        multiplex.run([t], sched="fifo")
    with pytest.raises(ValueError, match="quantum"):
        multiplex.run([t], quantum=0)


def test_drain_false_settles_in_flight_tickets_as_lost():
    """``drain=False`` finishes each tenant as soon as its ticks end: what is
    still in flight is lost, exactly as a solo ``stream.run(drain=False)``."""
    cfg = _tcfg(min_trained=1_000_000)
    datas = [_data(10, 3, seed=40 + i) for i in range(2)]

    def teacher(ys, i):
        return stream.LatencyTeacher(stream.array_labels(ys), latency=4, seed=i)

    solo = [stream.run(t_engine.init_fleet(cfg, 3, "cpu"), iter(xs), cfg, teacher(ys, i),
                       mode="train_phase", drain=False) for i, (xs, ys) in enumerate(datas)]
    for fuse in (False, True):
        results, _ = multiplex.run([_tenant(f"t{i}", cfg, xs, teacher(ys, i))
                                    for i, (xs, ys) in enumerate(datas)], drain=False, fuse=fuse)
        for i, (st, _, stats) in enumerate(solo):
            r = results[f"t{i}"].stats
            assert r.tickets_lost == stats.tickets_lost > 0 and r.reconciled
            _assert_state_equal(st, results[f"t{i}"].state, f"t{i} fuse={fuse}")


def test_finished_results_and_live_tenants_while_running():
    cfg = _tcfg()
    datas = [_data(t, 2, seed=50 + t) for t in (4, 20)]
    mux = multiplex.Multiplexer([_tenant(f"t{t}", cfg, xs, _instant(ys))
                                 for t, (xs, ys) in zip((4, 20), datas)], quantum=5, fuse=False)
    assert mux.live_tenants() == ["t4", "t20"]
    mux.round()
    mux.round()
    assert mux.finished("t4") and not mux.finished("t20")
    assert list(mux.finished_results()) == ["t4"] and mux.live_tenants() == ["t20"]
    assert mux.session("t20").t > 0
    with pytest.raises(RuntimeError):
        mux.results()
    with pytest.raises(KeyError):
        mux.session("nobody")
    mux.run()
    assert mux.agg.summary()["stream_steps"] == 4 * 2 + 20 * 2


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["rr", "drr"])
@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.usefixtures("jax_ref")
def test_matches_jax_multiplexer_per_tenant(sched, fuse):
    """Both packages' multiplexers on the same tenants (two configs, two
    widths, every policy, lossy teachers, unequal lengths): per tenant,
    decisions and every counter are exactly equal, floats within tolerance,
    and the aggregate counts agree."""
    mixes = [("a", 3, 30, "drop_oldest"), ("a", 3, 24, "drop_newest"), ("b", 2, 20, "block"),
             ("b", 2, 16, "coalesce"), ("a", 3, 12, "coalesce")]
    cfgs = {"a": (_jcfg(min_trained=1_000_000), _tcfg(min_trained=1_000_000)),
            "b": (_jcfg(n_hidden=32, min_trained=1_000_000),
                  _tcfg(n_hidden=32, min_trained=1_000_000))}
    jt, tt = [], []
    for i, (key, s, t_len, policy) in enumerate(mixes):
        xs, ys = _data(t_len, s, seed=60 + i)
        jcfg, tcfg = cfgs[key]
        jst = j_engine.init_fleet(jcfg, s)
        kw = dict(mode="train_phase", capacity=3, backpressure=policy)
        teach = dict(latency=2, jitter=3, loss_prob=0.2, partial_prob=0.2, seed=70 + i)
        jt.append(j_multiplex.Tenant(f"t{i}", jst, iter(xs), jcfg,
                                     j_stream.LatencyTeacher(j_stream.array_labels(ys), **teach),
                                     **kw))
        tt.append(multiplex.Tenant(f"t{i}", convert.engine_state_from_numpy(
            convert.engine_state_to_numpy(jst), device="cpu"), iter(xs), tcfg,
            stream.LatencyTeacher(stream.array_labels(ys), **teach), **kw))
    jres, jagg = j_multiplex.run(jt, sched=sched, quantum=3, fuse=fuse)
    tres, tagg = multiplex.run(tt, sched=sched, quantum=3, fuse=fuse)
    assert (tagg.n_tenants, tagg.rounds, tagg.ticks, tagg.stream_steps) == \
        (jagg.n_tenants, jagg.rounds, jagg.ticks, jagg.stream_steps)
    for name, j in jres.items():
        t = tres[name]
        for f in COUNTERS:
            assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)
        assert t.stats.reconciled and j.stats.reconciled
        assert list(t.stats.label_latency_ticks) == list(j.stats.label_latency_ticks)
        for f in ("pred", "queried", "trained", "theta", "mode_training"):
            np.testing.assert_array_equal(getattr(t.outputs, f), np.asarray(getattr(j.outputs, f)),
                                          err_msg=f"{name} {f}")
        np.testing.assert_allclose(t.outputs.outputs, np.asarray(j.outputs.outputs), rtol=2e-3,
                                   atol=2e-3)
        ts, js = convert.engine_state_to_numpy(t.state), convert.engine_state_to_numpy(j.state)
        for k in ts:
            if ts[k].dtype == np.float32:
                np.testing.assert_allclose(ts[k], js[k], rtol=2e-3, atol=2e-3, err_msg=k)
            else:
                np.testing.assert_array_equal(ts[k], js[k], err_msg=k)


@pytest.mark.usefixtures("jax_ref")
def test_summary_keys_match_jax_without_durability():
    """``MultiplexStats.summary()`` carries the JAX keys, less the snapshot
    count (durability is not ported), and the same runner cache names."""
    want = set(j_multiplex.MultiplexStats().summary()) - {"snapshots"}
    assert set(multiplex.MultiplexStats().summary()) == want
    assert multiplex.SCHEDULERS == j_multiplex.SCHEDULERS
    assert multiplex.DEFAULT_QUANTUM == j_multiplex.DEFAULT_QUANTUM


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_cuda_tenants_equal_their_solo_runs(cuda_device, fuse):
    """Three tenants with lossy teachers on the card, fused or not, equal
    their solo ``stream.run`` on the card bit for bit; every runner replays
    as a graph (no eager launch of the projection)."""
    cfg = _tcfg(min_trained=4)
    datas = [_data(t, 8, seed=80 + i) for i, t in enumerate((24, 24, 16))]

    def teacher(ys, i):
        return stream.LatencyTeacher(stream.array_labels(ys), latency=2, jitter=2,
                                     loss_prob=0.1, partial_prob=0.1, seed=90 + i)

    solo = [stream.run(t_engine.init_fleet(cfg, 8, cuda_device), iter(xs), cfg, teacher(ys, i),
                       mode="train_phase", capacity=4) for i, (xs, ys) in enumerate(datas)]
    graphs.reset_replay_counts()
    results, agg = multiplex.run([_tenant(f"t{i}", cfg, xs, teacher(ys, i), cuda_device,
                                          capacity=4) for i, (xs, ys) in enumerate(datas)],
                                 fuse=fuse)
    for i, (st, outs, stats) in enumerate(solo):
        _assert_state_equal(st, results[f"t{i}"].state, f"t{i}")
        _assert_outputs_equal(outs, results[f"t{i}"].outputs, f"t{i}")
        assert results[f"t{i}"].stats.labels_applied == stats.labels_applied
    cohort_replays = sum(n for k, n in graphs.replay_counts.items() if k.startswith("cohort."))
    assert (cohort_replays > 0) == fuse
    assert agg.steps_per_s > 0
