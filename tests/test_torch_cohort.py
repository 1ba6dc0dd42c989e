"""Cohort fusion in the port (``repro_torch.engine.cohort``), inside the port
and against the JAX package's ``repro.engine.cohort``.

Mirrors ``tests/test_cohort.py`` at its sizes: n_in=24, N=16, m=4, S=2-8,
T <= 90.  Inputs come from numpy with a seed; both packages get the same
arrays and the same ``LatencyTeacher`` seeds, and the port's states come in
through ``repro_torch.convert``.  On the CPU the port runs its tick
functions eagerly and the kernels' plain versions.

Inside the port everything is bit for bit: fused == unfused == solo
``stream.run`` for every tenant (state leaves, collected outputs, every
``StreamStats`` counter, the label latencies), because every op of a tick
computes a row in an order that does not depend on how many rows share the
dispatch (``test_stacked_rows_equal_solo_rows`` locks that per op).

Against the JAX package, for the same tenants through
``repro.engine.multiplex``: decisions, counters and the cohort membership
as it changes are exactly equal; floats meet the ROADMAP tolerance for runs
where P starts at I/ridge (rtol and atol 2e-3).  The JAX engine runs its
einsum RLS path, the port follows the Pallas numerics (no symmetrisation,
beta from P'·W).

The migration test of ``tests/test_cohort.py`` (extract out of a fused
cohort, restore into a cohort slot) waits for the port of durability.

Tests marked ``cuda`` replay the cohort's runners as CUDA graphs on the card
and skip elsewhere; they need no JAX:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_cohort.py
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
from repro_torch.engine import cohort, fleet, graphs, multiplex, stream  # noqa: E402
from repro_torch.engine.types import tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

N_IN, N_OUT = 24, 4
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")
POLICIES = stream.BACKPRESSURE_POLICIES


def _cfg(pkg_engine, pkg_oselm, pkg_pruning, pkg_drift, n_hidden=16, min_trained=4,
         n_in=N_IN, n_out=N_OUT):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=n_in, n_hidden=n_hidden, n_out=n_out, variant="hash",
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


def _data(t, s, seed, n_in=N_IN, n_out=N_OUT):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, n_in))).astype(np.float32)
    ys = rng.integers(0, n_out, (t, s)).astype(np.int32)
    return xs, ys


def _lossy(pkg, ys, seed):
    return pkg.LatencyTeacher(pkg.array_labels(ys), latency=2, jitter=2, loss_prob=0.15,
                              partial_prob=0.15, seed=seed)


def _solo(cfg, xs, teacher, device="cpu", **kw):
    return stream.run(t_engine.init_fleet(cfg, xs.shape[1], device), iter(xs), cfg, teacher,
                      mode="train_phase", **kw)


def _tenant(name, cfg, xs, teacher, device="cpu", **kw):
    return multiplex.Tenant(name=name, state=t_engine.init_fleet(cfg, xs.shape[1], device),
                            ticks=iter(xs), cfg=cfg, teacher=teacher, mode="train_phase", **kw)


def _assert_state_equal(a, b, msg=""):
    a, b = convert.engine_state_to_numpy(a), convert.engine_state_to_numpy(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} leaf {k} diverged")


def _assert_outputs_equal(a, b, msg=""):
    for name in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                                      err_msg=f"{msg} output {name!r} diverged")


def _assert_stats_equal(a, b, msg=""):
    for f in COUNTERS:
        assert getattr(a, f) == getattr(b, f), \
            f"{msg}: stats.{f} {getattr(a, f)} != {getattr(b, f)}"
    assert a.reconciled == b.reconciled
    assert list(a.label_latency_ticks) == list(b.label_latency_ticks), msg


def _assert_result_equal(want, got, msg):
    st, outs, stats = want
    _assert_state_equal(st, got.state, msg)
    _assert_outputs_equal(outs, got.outputs, msg)
    _assert_stats_equal(stats, got.stats, msg)
    assert got.stats.reconciled, got.stats.summary()


def _membership(mux):
    """Live cohorts as sorted lists of tenant names, and which tenants are fused."""
    cohorts = sorted(sorted(s.tenant.name for s in u.slots) for u in mux._cohorts.values()
                     if u.slots)
    fused = sorted(s.tenant.name for s in mux._slots if s.unit is not None)
    return cohorts, fused


# ---------------------------------------------------------------------------
# Inside the port: fused == unfused == solo, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sched", ["rr", "drr"])
@pytest.mark.parametrize("quantum", [1, 3])
def test_fused_matches_unfused_and_solo_bit_for_bit(sched, quantum):
    """Four same-shaped tenants, one per backpressure policy, under lossy
    teachers and with unequal stream lengths (members exhaust and detach
    mid-run, the cohort restacks and finally dissolves): the fused
    multiplexer reproduces the unfused one and four solo runs exactly."""
    cfg = _tcfg()
    lens = [30, 30, 22, 14]
    datas = [_data(t, 4, seed=70 + i) for i, t in enumerate(lens)]
    solo = [_solo(cfg, xs, _lossy(stream, ys, 80 + i), capacity=4, backpressure=POLICIES[i])
            for i, (xs, ys) in enumerate(datas)]

    def tenants():
        return [_tenant(f"tenant{i}", cfg, xs, _lossy(stream, ys, 80 + i), capacity=4,
                        backpressure=POLICIES[i]) for i, (xs, ys) in enumerate(datas)]

    unfused, _ = multiplex.run(tenants(), sched=sched, quantum=quantum, fuse=False)
    mux = multiplex.Multiplexer(tenants(), sched=sched, quantum=quantum, fuse=True)
    assert mux.round()
    assert _membership(mux)[0] == [[f"tenant{i}" for i in range(4)]], "the four must fuse"
    fused, agg = mux.run()
    assert agg.n_tenants == 4
    assert agg.stream_steps == sum(s[2].stream_steps for s in solo)
    for i, want in enumerate(solo):
        for label, results in (("fused", fused), ("unfused", unfused)):
            _assert_result_equal(want, results[f"tenant{i}"], f"{label} tenant{i}")


def test_mixed_shapes_pack_into_separate_cohorts():
    """Different configs land in different cohorts; a tenant with another
    stream width joins neither.  Everyone still matches solo."""
    cfg_a, cfg_b = _tcfg(n_hidden=16), _tcfg(n_hidden=32)
    specs = [("a0", cfg_a, 3), ("a1", cfg_a, 3), ("b0", cfg_b, 3), ("b1", cfg_b, 3),
             ("w", cfg_a, 2)]
    datas = {name: _data(18, s, seed=110 + i) for i, (name, _, s) in enumerate(specs)}
    solo = {name: _solo(c, datas[name][0], _lossy(stream, datas[name][1], 5))
            for name, c, _ in specs}
    mux = multiplex.Multiplexer([_tenant(name, c, datas[name][0],
                                         _lossy(stream, datas[name][1], 5))
                                 for name, c, _ in specs], fuse=True)
    assert mux.round()
    cohorts, fused = _membership(mux)
    assert cohorts == [["a0", "a1"], ["b0", "b1"]] and fused == ["a0", "a1", "b0", "b1"]
    results, _ = mux.run()
    for name, _, _ in specs:
        _assert_result_equal(solo[name], results[name], name)


def test_admit_into_running_fused_mux_joins_cohort_and_matches_solo():
    """A tenant admitted mid-run joins the running cohort; the members'
    tickets asked before the resize learn through the patch path."""
    cfg = _tcfg()
    datas = [_data(24, 3, seed=100 + i) for i in range(3)]
    solo = [_solo(cfg, xs, _lossy(stream, ys, 50 + i)) for i, (xs, ys) in enumerate(datas)]
    mux = multiplex.Multiplexer([_tenant(f"t{i}", cfg, datas[i][0],
                                         _lossy(stream, datas[i][1], 50 + i))
                                 for i in range(2)], fuse=True, quantum=2)
    for _ in range(4):
        assert mux.round()
    patches = fleet.runner_cache_info()["patch_learn_runner"]
    mux.admit(_tenant("t2", cfg, datas[2][0], _lossy(stream, datas[2][1], 52)))
    assert mux.round()
    assert mux._slot("t2").unit is not None, "the late tenant must join the cohort"
    after = fleet.runner_cache_info()["patch_learn_runner"]
    assert after["hits"] + after["misses"] > patches["hits"] + patches["misses"], \
        "the resize must send in-flight tickets through the patch path"
    results, _ = mux.run()
    for i, want in enumerate(solo):
        _assert_result_equal(want, results[f"t{i}"], f"t{i}")


def test_patch_learn_runner_is_bitwise_solo_learn_on_the_slice():
    """``fleet._patch_learn_runner(cfg, lo, hi)`` == the solo session's learn
    runner on the slice, written back; rows outside [lo, hi) are untouched,
    and the result lands in the current buffers, not the spare ones."""
    cfg = _tcfg(min_trained=1)
    total, lo, hi = 7, 2, 5
    x = torch.as_tensor(np.tanh(np.random.default_rng(3).standard_normal((total, N_IN)))
                        .astype(np.float32))
    state, p = fleet.plan(t_engine.init_fleet(cfg, total, "cpu"), x, cfg, mode="train_phase")
    labels = torch.as_tensor(np.arange(total) % N_OUT, dtype=torch.int32)
    mask = torch.tensor([True, False, True])
    args = (p.h[lo:hi], labels[lo:hi], p.pred[lo:hi], p.confidence[lo:hi], mask,
            p.controller_on[lo:hi], p.theta[lo:hi])

    sub = fleet.slice_streams(state, lo, hi)
    sub_dst = tree_map(torch.empty_like, sub)
    stream._learn_runner(cfg, False)(tree_map(torch.clone, sub), sub_dst, *args)
    want = tree_map(torch.clone, state)
    for d, n in zip(tree_leaves(fleet.slice_streams(want, lo, hi)), tree_leaves(sub_dst)):
        d.copy_(n)

    buf = stream._StateBuffers(tree_map(torch.clone, state))
    spare_before = [t.clone() for t in tree_leaves(buf.spare)]
    fleet._patch_learn_runner(cfg, lo, hi, False)(buf.state, buf.spare, *args)
    _assert_state_equal(want, buf.state, "patch-learn")
    for side in ((0, lo), (hi, total)):
        _assert_state_equal(fleet.slice_streams(state, *side),
                            fleet.slice_streams(buf.state, *side), f"rows {side}")
    # Only the spare set's window was used as scratch.
    for a, b in zip(spare_before, tree_leaves(buf.spare)):
        assert torch.equal(torch.cat([a[:lo], a[hi:]]), torch.cat([b[:lo], b[hi:]]))


def test_cohort_rejects_mismatched_members():
    cfg_a, cfg_b = _tcfg(n_hidden=16), _tcfg(n_hidden=32)
    _, ys = _data(4, 2, seed=1)

    def sess(cfg, mode="train_phase", **kw):
        return stream.StreamSession(t_engine.init_fleet(cfg, 2, "cpu"), cfg,
                                    stream.LatencyTeacher(stream.array_labels(ys)), mode=mode,
                                    **kw)

    with pytest.raises(ValueError):
        cohort.CohortSession([sess(cfg_a), sess(cfg_b)])
    with pytest.raises(ValueError):
        cohort.CohortSession([sess(cfg_a), sess(cfg_a, mode="serve")])
    with pytest.raises(ValueError):
        cohort.CohortSession([sess(cfg_a), sess(cfg_a, donate=False)])
    with pytest.raises(ValueError):
        cohort.CohortSession([sess(cfg_a), sess(cfg_a, live=1)])
    with pytest.raises(ValueError):
        cohort.CohortSession([])


def test_detach_writes_rows_back_and_restacks():
    """``detach`` copies the member's rows into its session's current
    buffers (the session keeps its buffers and graphs) and drops them from
    the stacked state; ``refresh`` writes rows back without detaching."""
    cfg = _tcfg()
    xs = [_data(3, w, seed=120 + i)[0] for i, w in enumerate((2, 3, 2))]
    sessions = [stream.StreamSession(t_engine.init_fleet(cfg, x.shape[1], "cpu"), cfg,
                                     stream.LatencyTeacher(stream.array_labels(
                                         np.zeros((3, x.shape[1]), np.int32))),
                                     mode="train_phase")
                for x in xs]
    bufs = [s._buf for s in sessions]
    coh = cohort.CohortSession(sessions)
    assert coh.bounds == [(0, 2), (2, 5), (5, 7)]
    coh.tick([x[0] for x in xs])
    coh.tick([x[1] for x in xs])
    stacked = convert.engine_state_to_numpy(coh.state)
    coh.refresh(sessions[0])
    got = convert.engine_state_to_numpy(sessions[0].state)
    for k in got:
        np.testing.assert_array_equal(got[k], stacked[k][0:2], err_msg=k)
    coh.detach(sessions[1])
    assert coh.bounds == [(0, 2), (2, 4)] and coh.total == 4
    got = convert.engine_state_to_numpy(sessions[1].state)
    rest = convert.engine_state_to_numpy(coh.state)
    for k in got:
        np.testing.assert_array_equal(got[k], stacked[k][2:5], err_msg=k)
        np.testing.assert_array_equal(rest[k], np.concatenate([stacked[k][:2], stacked[k][5:]]),
                                      err_msg=k)
    assert isinstance(sessions[1]._p, fleet.PlanOutput)  # materialized solo plan
    assert [s._buf for s in sessions] == bufs
    with pytest.raises(ValueError):
        sessions[0].state = fleet.slice_streams(coh.state, 0, 1)  # wrong width


def test_plan_slice_reads_rows_of_the_full_plan():
    cfg = _tcfg()
    x = torch.as_tensor(_data(1, 6, seed=3)[0][0])
    _, p = fleet.plan(t_engine.init_fleet(cfg, 6, "cpu"), x, cfg, mode="train_phase")
    ps = stream.PlanSlice(p, 2, 5)
    for k, v in ps._asdict().items():
        assert torch.equal(v, getattr(p, k)[2:5]) and torch.equal(getattr(ps, k), v)
    solo = ps.materialize()
    assert isinstance(solo, fleet.PlanOutput)
    assert solo.h.data_ptr() != p.h[2:5].data_ptr() and torch.equal(solo.h, p.h[2:5])
    with pytest.raises(AttributeError):
        ps.not_a_field  # noqa: B018


# ---------------------------------------------------------------------------
# Row independence: the claim the cohort's guarantee rests on, per width
# ---------------------------------------------------------------------------


def _stacked_vs_solo(cfg, width, n_members, device, seed, mode="algo1"):
    """One plan and one learn on a stack of members and on each member
    alone; returns the names of the fields and leaves that differ."""
    n_in, m = cfg.elm.n_in, cfg.elm.n_out
    total = width * n_members
    rng = np.random.default_rng(seed)
    st = t_engine.init_fleet(cfg, total, device)
    for _ in range(2):  # warm heads: two learns, so beta and P are not at their start
        xr = torch.as_tensor(rng.standard_normal((total, n_in)).astype(np.float32), device=device)
        st, p = fleet.plan(st, xr, cfg, mode="train_phase")
        lab = torch.as_tensor(rng.integers(0, m, total).astype(np.int32), device=device)
        st = fleet.learn(st, p.h, lab, p.pred, p.confidence, p.queried, p.controller_on, cfg,
                         theta=p.theta)
    x = torch.as_tensor(2 * np.tanh(rng.standard_normal((total, n_in))).astype(np.float32),
                        device=device)
    lab = torch.as_tensor(rng.integers(0, m, total).astype(np.int32), device=device)
    mask = torch.as_tensor(rng.uniform(size=total) < 0.7, device=device)
    new, p = fleet.plan(st, x, cfg, mode=mode)
    after = fleet.learn(new, p.h, lab, p.pred, p.confidence, mask, p.controller_on, cfg,
                        theta=p.theta)
    differ = set()
    for i in range(n_members):
        lo, hi = i * width, (i + 1) * width
        own = tree_map(lambda a: a[lo:hi].clone(), st)
        new_i, p_i = fleet.plan(own, x[lo:hi].clone(), cfg, mode=mode)
        after_i = fleet.learn(new_i, p_i.h, lab[lo:hi].clone(), p_i.pred, p_i.confidence,
                              mask[lo:hi].clone(), p_i.controller_on, cfg, theta=p_i.theta)
        differ |= {f"plan.{f}" for f in p._fields
                   if not torch.equal(getattr(p, f)[lo:hi], getattr(p_i, f))}
        names = list(convert.engine_state_to_numpy(new))
        differ |= {f"learn.{k}" for k, a, b in zip(names, tree_leaves(after), tree_leaves(after_i))
                   if not torch.equal(a[lo:hi], b)}
    return sorted(differ)


@pytest.mark.parametrize("width,n_members,full_width", [
    (1, 16, False), (2, 8, False), (3, 16, False), (5, 4, False), (8, 4, False),
    (1, 16, True), (3, 16, True),
])
def test_stacked_rows_equal_solo_rows(width, n_members, full_width):
    """Row r of a stacked plan and learn is bit for bit row r of the member's
    own, at the test widths and at the full width (n=561, N=128, m=6) with
    member widths 1 and 3 stacked 16 times.  Torch's CPU routines pick a
    different summation for few rows (a product of one to four rows, a
    batch of one) and finish a tensor's tail in scalar code; the plain
    versions in ``kernels/ops`` avoid both."""
    cfg = (_tcfg(n_in=561, n_hidden=128, n_out=6) if full_width else _tcfg())
    assert _stacked_vs_solo(cfg, width, n_members, "cpu", seed=width) == []


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _both_tenants(specs, jcfgs, tcfgs, teacher_kw, **tenant_kw):
    """The same tenants for both packages: (JAX tenants, port tenants)."""
    jt, tt = [], []
    for name, key, xs, ys, seed, extra in specs:
        jst = j_engine.init_fleet(jcfgs[key], xs.shape[1])
        kw = {**tenant_kw, **extra}
        jt.append(j_multiplex.Tenant(name=name, state=jst, ticks=iter(xs), cfg=jcfgs[key],
                                     teacher=j_stream.LatencyTeacher(
                                         j_stream.array_labels(ys), seed=seed, **teacher_kw),
                                     mode="train_phase", **kw))
        tt.append(multiplex.Tenant(name=name, state=convert.engine_state_from_numpy(
                                       convert.engine_state_to_numpy(jst), device="cpu"),
                                   ticks=iter(xs), cfg=tcfgs[key],
                                   teacher=stream.LatencyTeacher(stream.array_labels(ys),
                                                                 seed=seed, **teacher_kw),
                                   mode="train_phase", **kw))
    return jt, tt


def _assert_close_to_jax(tres, jres, msg):
    """Decisions and counters exact; floats within rtol and atol 2e-3 (P
    starts at I/ridge; JAX einsum RLS against the port's Pallas numerics)."""
    _assert_stats_equal(tres.stats, jres.stats, msg)
    assert tres.stats.reconciled and jres.stats.reconciled
    for f in ("pred", "queried", "trained", "theta", "mode_training"):
        np.testing.assert_array_equal(getattr(tres.outputs, f),
                                      np.asarray(getattr(jres.outputs, f)), err_msg=f"{msg} {f}")
    for f in ("outputs", "confidence"):
        np.testing.assert_allclose(getattr(tres.outputs, f), np.asarray(getattr(jres.outputs, f)),
                                   rtol=2e-3, atol=2e-3, err_msg=f"{msg} {f}")
    t, j = convert.engine_state_to_numpy(tres.state), convert.engine_state_to_numpy(jres.state)
    for k in t:
        if t[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=2e-3, atol=2e-3, err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{msg} {k}")


@pytest.mark.parametrize("sched", ["rr", "drr"])
@pytest.mark.usefixtures("jax_ref")
def test_fused_multiplexer_matches_jax_round_by_round(sched):
    """Both packages' fused multiplexers on the same tenants (every policy,
    lossy teachers, unequal lengths, a late admission after round 2): the
    cohort membership equals after every round, and each tenant's decisions
    and counters equal at the end, floats within tolerance."""
    jcfgs = {"a": _jcfg(min_trained=1_000_000)}
    tcfgs = {"a": _tcfg(min_trained=1_000_000)}
    lens = [26, 26, 20, 12, 18]
    datas = [_data(t, 3, seed=130 + i) for i, t in enumerate(lens)]
    specs = [(f"t{i}", "a", xs, ys, 140 + i, {"backpressure": POLICIES[i % 4]})
             for i, (xs, ys) in enumerate(datas)]
    teacher_kw = dict(latency=2, jitter=2, loss_prob=0.15, partial_prob=0.15)
    jt, tt = _both_tenants(specs, jcfgs, tcfgs, teacher_kw, capacity=4)
    jmux = j_multiplex.Multiplexer(jt[:4], sched=sched, quantum=3, fuse=True)
    tmux = multiplex.Multiplexer(tt[:4], sched=sched, quantum=3, fuse=True)
    rounds = 0
    seen = set()
    while True:
        if rounds == 2:
            jmux.admit(jt[4])
            tmux.admit(tt[4])
        jlive, tlive = jmux.round(), tmux.round()
        rounds += 1
        assert tlive == jlive, f"round {rounds}"
        assert _membership(tmux) == _membership(jmux), f"round {rounds}"
        assert tmux.live_tenants() == jmux.live_tenants(), f"round {rounds}"
        seen.add(tuple(map(tuple, _membership(tmux)[0])))
        if not tlive:
            break
    assert (("t0", "t1", "t2", "t3", "t4"),) in seen, "the late tenant must have been fused"
    tres, tagg = tmux.results()
    jres, jagg = jmux.results()
    assert (tagg.rounds, tagg.ticks, tagg.stream_steps) == (jagg.rounds, jagg.ticks,
                                                            jagg.stream_steps)
    for name in jres:
        _assert_close_to_jax(tres[name], jres[name], name)


@pytest.mark.usefixtures("jax_ref")
def test_shape_key_and_load_report_match_jax():
    """``shape_key`` digests equal the JAX package's for the same config,
    mode, donate and width (a router packs by them), and a fused
    multiplexer's load report reads the same mid-run."""
    cases = [(dict(), "algo1", None, 4), (dict(n_hidden=32), "train_phase", True, 3),
             (dict(min_trained=9), "serve", False, 1024)]
    for kw, mode, donate, s in cases:
        assert multiplex.shape_key(_tcfg(**kw), mode, donate, s) == \
            j_multiplex.shape_key(_jcfg(**kw), mode, donate, s)
    assert multiplex.shape_key(_tcfg(), "algo1", None, 4) != \
        multiplex.shape_key(_tcfg(), "algo1", None, 5)
    datas = [_data(12, 2, seed=150 + i) for i in range(3)]
    specs = [(f"t{i}", "a", xs, ys, 160 + i, {}) for i, (xs, ys) in enumerate(datas)]
    jt, tt = _both_tenants(specs, {"a": _jcfg()}, {"a": _tcfg()}, dict(latency=1), capacity=4)
    jmux = j_multiplex.Multiplexer(jt, quantum=2)
    tmux = multiplex.Multiplexer(tt, quantum=2)
    for _ in range(2):
        jmux.round()
        tmux.round()
    keys = ("name", "t", "s", "shape_key", "ring", "ring_hwm", "ring_capacity",
            "queries_issued", "labels_applied", "draining", "fused")
    assert [{k: r[k] for k in keys} for r in tmux.load_report()] == \
        [{k: r[k] for k in keys} for r in jmux.load_report()]
    assert all(r["fused"] for r in tmux.load_report())


# ---------------------------------------------------------------------------
# On the card: the cohort's runners replayed as CUDA graphs.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["rr", "drr"])
def test_cuda_fused_matches_unfused_and_solo_with_graphs(cuda_device, sched):
    """On the card, with every runner a graph replay: fused == unfused ==
    solo bit for bit, and the cohort's runners replayed as ``cohort.``
    graphs, one projection per stacked plan."""
    cfg = _tcfg()
    lens = [30, 30, 22, 14]
    datas = [_data(t, 8, seed=170 + i) for i, t in enumerate(lens)]
    solo = [_solo(cfg, xs, _lossy(stream, ys, 180 + i), cuda_device, capacity=4,
                  backpressure=POLICIES[i]) for i, (xs, ys) in enumerate(datas)]

    def tenants():
        return [_tenant(f"t{i}", cfg, xs, _lossy(stream, ys, 180 + i), cuda_device, capacity=4,
                        backpressure=POLICIES[i]) for i, (xs, ys) in enumerate(datas)]

    unfused, _ = multiplex.run(tenants(), sched=sched, quantum=3, fuse=False)
    graphs.reset_replay_counts()
    fused, _ = multiplex.run(tenants(), sched=sched, quantum=3, fuse=True)
    for i, want in enumerate(solo):
        _assert_result_equal(want, fused[f"t{i}"], f"fused t{i}")
        _assert_result_equal(want, unfused[f"t{i}"], f"unfused t{i}")
    cohort_runs = {k: v for k, v in graphs.replay_counts.items() if k.startswith("cohort.")}
    assert cohort_runs.get("cohort.learn_plan_runner", 0) > 0, graphs.replay_counts
    plans = cohort_runs.get("cohort.plan_runner", 0) + cohort_runs["cohort.learn_plan_runner"]
    proj = sum(graphs.runner_kernel_replays[k].get("xorshift_projection", 0) for k in cohort_runs)
    assert proj == plans
    assert sum(n for k, n in graphs.capture_counts.items() if k.startswith("cohort.")) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("width,n_members", [(1, 16), (3, 16), (1024, 16)])
def test_cuda_stacked_rows_equal_solo_rows(cuda_device, width, n_members):
    """At the full width (n=561, N=128, m=6) on the card: one plan and one
    learn on 16 stacked members equal each member's own bit for bit (the
    readout and feature-mean kernels give every row one warp)."""
    cfg = _tcfg(n_in=561, n_hidden=128, n_out=6)
    ops.reset_launch_counts()
    assert _stacked_vs_solo(cfg, width, n_members, cuda_device, seed=width) == []
    assert ops.launch_counts["readout"] > 0 and ops.launch_counts["row_abs_mean"] > 0


@pytest.mark.cuda
def test_cuda_patch_learn_touches_only_its_window(cuda_device):
    cfg = _tcfg(min_trained=1)
    total, lo, hi = 12, 4, 8
    x = torch.as_tensor(np.tanh(np.random.default_rng(5).standard_normal((total, N_IN)))
                        .astype(np.float32), device=cuda_device)
    state, p = fleet.plan(t_engine.init_fleet(cfg, total, cuda_device), x, cfg,
                          mode="train_phase")
    labels = torch.arange(total, device=cuda_device, dtype=torch.int32) % N_OUT
    args = (p.h[lo:hi], labels[lo:hi], p.pred[lo:hi], p.confidence[lo:hi],
            torch.ones(hi - lo, dtype=torch.bool, device=cuda_device), p.controller_on[lo:hi],
            p.theta[lo:hi])
    buf = stream._StateBuffers(tree_map(torch.clone, state))
    fleet._patch_learn_runner(cfg, lo, hi, True)(buf.state, buf.spare, *args)
    want = fleet.learn(fleet.slice_streams(state, lo, hi), *args[:5], args[5], cfg, theta=args[6])
    _assert_state_equal(want, fleet.slice_streams(buf.state, lo, hi), "window")
    for side in ((0, lo), (hi, total)):
        _assert_state_equal(fleet.slice_streams(state, *side),
                            fleet.slice_streams(buf.state, *side), f"rows {side}")


@pytest.mark.cuda
def test_cuda_session_graphs_survive_fusion(cuda_device):
    """A session captures its graphs solo, is fused into a cohort and
    detached again: its graph objects are the same ones, and the run still
    equals the solo run."""
    cfg = _tcfg()
    datas = [_data(16, 8, seed=190 + i) for i in range(2)]
    solo = [_solo(cfg, xs, _lossy(stream, ys, 200 + i), cuda_device)
            for i, (xs, ys) in enumerate(datas)]
    sessions = [stream.StreamSession(t_engine.init_fleet(cfg, 8, cuda_device), cfg,
                                     _lossy(stream, ys, 200 + i), mode="train_phase")
                for i, (_, ys) in enumerate(datas)]
    for sess, (xs, _) in zip(sessions, datas):
        sess.start(xs[0])
        for t in range(1, 4):
            sess.advance(xs[t])
    captured = [dict(s._buf.graphs) for s in sessions]
    assert all(captured)
    coh = cohort.CohortSession(sessions)
    for t in range(4, 10):
        coh.tick([xs[t] for xs, _ in datas])
    for sess in sessions:
        coh.detach(sess)
    for sess, (xs, _) in zip(sessions, datas):
        for t in range(10, 16):
            sess.advance(xs[t])
        sess.advance(None)
    for sess, graphs_before in zip(sessions, captured):
        assert all(sess._buf.graphs[k] is g for k, g in graphs_before.items())
    for i, (sess, want) in enumerate(zip(sessions, solo)):
        got = multiplex.TenantResult(f"t{i}", *sess.finish())
        _assert_result_equal(want, got, f"t{i}")
