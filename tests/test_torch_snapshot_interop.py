"""Snapshots across the two packages: a tree captured by the JAX package
(``repro.engine.snapshot``) restores in the port (``repro_torch.engine.
snapshot``) and the other way round, the wire frames are the same bytes,
and each package's ``CheckpointManager`` reads the other's directories.

Sizes as in ``tests/test_snapshot.py``: n_in=24, N=16, m=4, S=3-4.  Inputs
from numpy with a seed; the teachers are ``LatencyTeacher``s with one seed
in both packages (numpy PCG64, so their draws are equal).

What must be exact: every leaf of a re-capture right after a cross-package
restore (dtype, shape and bytes), the meta JSON apart from the wall clock
(``stats.wall_s``), the frame bytes, and the restored checkpoint leaves.
One tick after a cross-package restore is held to the north-star
tolerances: the new plan's projection ``h`` within 1e-5; decisions, ladder
and counters exact; P within 2e-5 and beta within 2e-4 of the JAX
package's *Pallas numerics* (``fleet_rank1_update_h(use_kernel=True)``,
interpret mode: no symmetrisation, beta from P'·W), which the port follows;
and, against the JAX session's own next tick, which runs its *einsum path*
(P' symmetrised, beta from the pre-update gain), P and beta within rtol
and atol 2e-3 (P starts at I/ridge: the ROADMAP's rule for that case).
That test runs at ridge 1 (P starts at I), where absolute tolerances set
for entries of order one apply.
"""

import importlib.util
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

# Where JAX is installed the JAX package must import (a broken reference
# fails here); on a machine without it every test here skips.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp

    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.engine import snapshot as j_snapshot
    from repro.engine import stream as j_stream
    from repro.runtime import checkpoint as j_checkpoint

from repro_torch import convert  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.core import drift as t_drift  # noqa: E402
from repro_torch.core import oselm as t_oselm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.engine import snapshot as t_snapshot  # noqa: E402
from repro_torch.engine import stream as t_stream  # noqa: E402
from repro_torch.runtime import checkpoint as t_checkpoint  # noqa: E402

N_IN, N_HIDDEN, N_OUT = 24, 16, 4
CPU = "cpu"


@pytest.fixture(autouse=True)
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


def _cfg(pkg_engine, pkg_oselm, pkg_pruning, pkg_drift, ridge=1e-2):
    return pkg_engine.EngineConfig(
        elm=pkg_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, variant="hash",
                                  ridge=ridge),
        prune=pkg_pruning.PruneConfig(min_trained=1_000_000),
        drift=pkg_drift.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )


def _jcfg(**kw):
    return _cfg(j_engine, j_oselm, j_pruning, j_drift, **kw)


def _tcfg(**kw):
    return _cfg(t_engine, t_oselm, t_pruning, t_drift, **kw)


def _data(t, s, seed):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    ys = rng.integers(0, N_OUT, (t, s)).astype(np.int32)
    return xs, ys


def _teacher(pkg, ys, **kw):
    kw = {"latency": 2, "jitter": 3, "loss_prob": 0.2, "partial_prob": 0.2, "seed": 11, **kw}
    return pkg.LatencyTeacher(pkg.array_labels(ys), **kw)


def _j_session(xs, ys, ticks, policy, ridge=1e-2, **teacher_kw):
    """A JAX session driven ``ticks`` advances into the stream."""
    cfg = _jcfg(ridge=ridge)
    sess = j_stream.StreamSession(j_engine.init_fleet(cfg, xs.shape[1]), cfg,
                                  _teacher(j_stream, ys, **teacher_kw), mode="train_phase",
                                  capacity=3, backpressure=policy)
    sess.start(xs[0])
    for t in range(1, ticks + 1):
        sess.advance(xs[t])
    return sess


def _t_session(xs, ys, ticks, policy, ridge=1e-2, **teacher_kw):
    cfg = _tcfg(ridge=ridge)
    sess = t_stream.StreamSession(t_engine.init_fleet(cfg, xs.shape[1], CPU), cfg,
                                  _teacher(t_stream, ys, **teacher_kw), mode="train_phase",
                                  capacity=3, backpressure=policy)
    sess.start(xs[0])
    for t in range(1, ticks + 1):
        sess.advance(xs[t])
    return sess


def _flat(tree):
    return {"/".join(p): np.asarray(v) for p, v in t_checkpoint._flatten(tree)}


def _assert_same_tree(a, b):
    """Every leaf equal in dtype, shape and bytes; the meta JSON equal but
    for the wall clock."""
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for path in fa:
        if path == "meta":
            ma, mb = json.loads(fa[path].item()), json.loads(fb[path].item())
            assert ma["stats"].pop("wall_s") >= 0.0 and mb["stats"].pop("wall_s") >= 0.0
            assert ma == mb
            continue
        if path == "stats/tick_ms":
            continue  # wall-clock
        assert fa[path].dtype == fb[path].dtype, path
        assert fa[path].shape == fb[path].shape, path
        assert fa[path].tobytes() == fb[path].tobytes(), path


@pytest.mark.parametrize("policy", t_stream.BACKPRESSURE_POLICIES)
def test_jax_capture_restores_in_port_and_recaptures_byte_equal(policy):
    xs, ys = _data(30, 4, seed=3)
    tree = _j_session(xs, ys, 14, policy).snapshot()
    assert len(tree["ring"]) > 0
    sess = t_stream.StreamSession.restore(tree, _teacher(t_stream, ys), device=CPU)
    assert sess.cfg == _tcfg()
    _assert_same_tree(tree, sess.snapshot())
    # The meta JSON is the same string up to the wall clock, key order and all.
    ma, mb = str(tree["meta"]), str(sess.snapshot()["meta"])
    assert ma.split('"wall_s"')[0] == mb.split('"wall_s"')[0]


@pytest.mark.parametrize("policy", t_stream.BACKPRESSURE_POLICIES)
def test_port_capture_restores_in_jax_and_recaptures_byte_equal(policy):
    xs, ys = _data(30, 4, seed=4)
    tree = _t_session(xs, ys, 14, policy).snapshot()
    assert len(tree["ring"]) > 0
    sess = j_stream.StreamSession.restore(tree, _teacher(j_stream, ys))
    _assert_same_tree(tree, sess.snapshot())


def test_encode_snapshot_bytes_identical_in_both_packages():
    xs, ys = _data(30, 4, seed=5)
    for tree in (_j_session(xs, ys, 14, "coalesce").snapshot(),
                 _t_session(xs, ys, 14, "block").snapshot()):
        frame = t_snapshot.encode_snapshot(tree)
        assert frame == j_snapshot.encode_snapshot(tree)
        _assert_same_tree(tree, j_snapshot.decode_snapshot(frame))
        _assert_same_tree(tree, t_snapshot.decode_snapshot(frame))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_directories_read_both_ways(writer, tmp_path):
    """A full save and a delta save by one package's manager, read back by
    the other's: the same steps, kinds and leaves."""
    xs, ys = _data(30, 3, seed=6)
    j_sess = _j_session(xs, ys, 8, "drop_oldest")
    first = j_sess.snapshot()
    for t in range(9, 14):
        j_sess.advance(xs[t])
    second = j_sess.snapshot()
    managers = {"jax": j_checkpoint.CheckpointManager, "port": t_checkpoint.CheckpointManager}
    w = managers[writer](str(tmp_path), keep=4, full_every=2)
    w.save(8, first)
    w.save(13, second)
    r = managers["port" if writer == "jax" else "jax"](str(tmp_path))
    assert r.all_steps() == [8, 13]
    assert [r._manifest(s)["kind"] for s in (8, 13)] == ["full", "delta"]
    for step, tree in ((8, first), (13, second)):
        got_step, got = r.restore(step=step)
        assert got_step == step
        fa, fb = _flat(tree), _flat(got)
        assert sorted(fa) == sorted(fb)
        for path in fa:
            # np.save writes 0-d leaves through ascontiguousarray (1-d)
            # in both packages: compare values, dtypes and bytes.
            assert fa[path].dtype == fb[path].dtype, path
            assert fa[path].tobytes() == fb[path].tobytes(), path
    # The delta wrote only what changed (the meta and the stats always do).
    j_step = j_checkpoint.CheckpointManager(str(tmp_path))
    assert sorted(j_step._leaves_in(13)) == sorted(r._leaves_in(13))


def _one_tick_after_cross_restore(direction):
    """Restore a snapshot of one package in the other, then advance both
    the restored session and an uninterrupted one of the capturing package
    by one tick (instant teacher, train_phase: tick k's labels learn, tick
    k+1 plans).  Ridge 1, so P starts at I: the absolute P and beta
    tolerances are set for entries of order one (``tests/test_kernels.py``'s
    inputs); at ridge 1e-2 P's entries reach ~30, where 2e-5 is a few ulp.
    Returns (port session, JAX session, the state before the tick, the plan
    that learned, its labels)."""
    xs, ys = _data(20, 4, seed=8)
    k = 12
    instant = {"latency": 0, "jitter": 0, "loss_prob": 0.0, "partial_prob": 0.0}
    if direction == "jax_to_port":
        j_sess = _j_session(xs, ys, k, "drop_oldest", ridge=1.0, **instant)
        tree = j_sess.snapshot()
        t_sess = t_stream.StreamSession.restore(tree, _teacher(t_stream, ys, **instant),
                                                device=CPU)
    else:
        t_sess = _t_session(xs, ys, k, "drop_oldest", ridge=1.0, **instant)
        tree = t_sess.snapshot()
        j_sess = j_stream.StreamSession.restore(tree, _teacher(j_stream, ys, **instant))
    before = tree["state"]
    learned = tree["pending"]["plan"]
    j_sess.advance(xs[k + 1])
    t_sess.advance(xs[k + 1])
    return t_sess, j_sess, before, learned, ys[k]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_one_tick_after_cross_restore_within_tolerance(direction):
    t_sess, j_sess, before, learned, labels = _one_tick_after_cross_restore(direction)
    tp, jp = t_sess._p, j_sess._p
    np.testing.assert_allclose(tp.h.numpy(), np.asarray(jp.h), atol=1e-5, err_msg="projection h")
    for f in ("pred", "queried", "controller_on", "mode_training", "theta"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                      err_msg=f)
    t_state = convert.engine_state_to_numpy(t_sess.state)
    j_state = convert.engine_state_to_numpy(j_sess.state)
    for k, v in t_state.items():
        assert v.dtype == j_state[k].dtype, k
        if k in ("elm.P", "elm.beta"):
            continue
        if v.dtype == np.float32:
            np.testing.assert_allclose(v, j_state[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, j_state[k], err_msg=k)
    # Pallas numerics (the port's): the JAX fleet kernel path on the
    # restored state and the learned plan, interpret mode.
    jcfg = _jcfg(ridge=1.0)
    elm = j_oselm.OSELMState(*(jnp.asarray(before["elm"][f]) for f in ("beta", "P", "count")))
    y = np.eye(N_OUT, dtype=np.float32)[labels]
    want = j_oselm.fleet_rank1_update_h(
        elm, jnp.asarray(learned["h"]), jnp.asarray(y), jcfg.elm,
        mask=jnp.asarray(learned["queried"], jnp.float32), use_kernel=True)
    assert bool(np.asarray(learned["queried"]).all())  # everyone learned this tick
    np.testing.assert_allclose(t_state["elm.P"], np.asarray(want.P), atol=2e-5,
                               err_msg="P vs Pallas numerics")
    np.testing.assert_allclose(t_state["elm.beta"], np.asarray(want.beta), atol=2e-4,
                               err_msg="beta vs Pallas numerics")
    # The JAX session's own tick (einsum path), P from I/ridge.
    for k in ("elm.P", "elm.beta"):
        np.testing.assert_allclose(t_state[k], j_state[k], rtol=2e-3, atol=2e-3, err_msg=k)
