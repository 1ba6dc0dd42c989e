"""Parity of the port's OS-ELM core, controllers and fleet engine with the
JAX package, one tick at a time.

Both packages get the same state (the JAX state carried across through
``repro_torch.convert``) and the same numpy inputs.  Integers and booleans
must match exactly.  Floats: h to 1e-5; outputs and confidence to 1e-4
relative (the readout sums in another order); P and beta to 1e-4, or rtol
2e-3 where P starts at I/ridge.  The port's RLS follows the Pallas numerics
(no symmetrisation, beta' from P' @ W); the JAX engine's default is its
einsum path, so weights are compared at those looser bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro import engine as j_engine  # noqa: E402
from repro.core import drift as j_drift  # noqa: E402
from repro.core import oselm as j_oselm  # noqa: E402
from repro.core import pruning as j_pruning  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.core import drift as t_drift  # noqa: E402
from repro_torch.core import oselm as t_oselm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402

S, N_IN, N_HIDDEN, N_OUT = 6, 24, 16, 4


def _cfgs():
    jcfg = j_engine.EngineConfig(
        elm=j_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, ridge=1e-2),
        prune=j_pruning.PruneConfig(min_trained=16),
        drift=j_drift.DriftConfig(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=16),
    )
    return jcfg, convert.engine_config_from_dict(dataclasses.asdict(jcfg))


def _ticks(t, seed, shift_at=None):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, S, N_IN))).astype(np.float32)
    if shift_at is not None:
        sev = np.linspace(2.0, 4.0, S)[None, :, None]
        xs[shift_at:] = np.clip(xs[shift_at:] * sev + 0.5 * sev, -4, 4)
    ys = rng.integers(0, N_OUT, (t, S)).astype(np.int32)
    return xs, ys


@pytest.fixture(scope="module")
def trained():
    """A JAX fleet after 40 algo1 ticks with a mid-run shift: armed drift
    detectors, streams in and out of training, trained heads."""
    jcfg, tcfg = _cfgs()
    xs, ys = _ticks(40, seed=1, shift_at=24)
    st, _ = j_engine.run_fleet(j_engine.init_fleet(jcfg, S), jnp.asarray(xs), jnp.asarray(ys),
                               jcfg, mode="algo1")
    return jcfg, tcfg, convert.engine_state_to_numpy(st)


def _jax_state(arrays):
    from repro.core.labels import CommMeter

    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    return j_engine.EngineState(
        elm=j_oselm.OSELMState(j["elm.beta"], j["elm.P"], j["elm.count"]),
        prune=j_pruning.PruneState(*(j[f"prune.{f}"] for f in j_pruning.PruneState._fields)),
        drift=j_drift.DriftState(*(j[f"drift.{f}"] for f in j_drift.DriftState._fields)),
        meter=CommMeter(j["meter.up_bytes"], j["meter.down_bytes"]),
    )


def _assert_state_close(tstate, jstate, weights_rtol=0.0, weights_atol=1e-4):
    t = convert.engine_state_to_numpy(tstate)
    j = convert.engine_state_to_numpy(jstate)
    assert t.keys() == j.keys()
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        if k in ("elm.P", "elm.beta"):
            np.testing.assert_allclose(t[k], j[k], rtol=weights_rtol, atol=weights_atol, err_msg=k)
        elif t[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def _assert_out_close(tout, jout):
    for f in tout._fields:
        t = getattr(tout, f).numpy()
        j = np.asarray(getattr(jout, f))
        if f == "h":
            np.testing.assert_allclose(t, j, atol=1e-5, err_msg=f)
        elif t.dtype == np.float32:
            np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(t, j, err_msg=f)


@pytest.mark.parametrize("mode", ["algo1", "train_phase", "serve"])
def test_one_tick_plan_learn_fleet_step(trained, mode):
    jcfg, tcfg, arrays = trained
    xs, ys = _ticks(1, seed=7, shift_at=0)
    x, y = xs[0], ys[0]
    avail = np.array([True, True, False, True, True, True])
    jst = _jax_state(arrays)
    tst = convert.engine_state_from_numpy(arrays, device="cpu")

    jp_state, jp = j_engine.plan(jst, jnp.asarray(x), jcfg, mode=mode,
                                 teacher_available=jnp.asarray(avail))
    tp_state, tp = t_engine.plan(tst, torch.as_tensor(x), tcfg, mode=mode,
                                 teacher_available=torch.as_tensor(avail))
    _assert_out_close(tp, jp)
    _assert_state_close(tp_state, jp_state)

    jl = j_engine.learn(jp_state, jp.h, jnp.asarray(y), jp.pred, jp.confidence, jp.queried,
                        jp.controller_on, jcfg, theta=jp.theta)
    tl = t_engine.learn(tp_state, tp.h, torch.as_tensor(y), tp.pred, tp.confidence, tp.queried,
                        tp.controller_on, tcfg, theta=tp.theta)
    _assert_state_close(tl, jl)

    js, jo = j_engine.fleet_step(jst, jnp.asarray(x), jnp.asarray(y), jcfg, mode=mode,
                                 teacher_available=jnp.asarray(avail))
    ts, to = t_engine.fleet_step(tst, torch.as_tensor(x), torch.as_tensor(y), tcfg, mode=mode,
                                 teacher_available=torch.as_tensor(avail))
    _assert_out_close(to, jo)
    _assert_state_close(ts, js)


def test_gate_and_apply_labels(trained):
    jcfg, tcfg, arrays = trained
    xs, ys = _ticks(1, seed=8)
    mask = np.array([True, False, True, True, False, True])
    jst = _jax_state(arrays)
    tst = convert.engine_state_from_numpy(arrays, device="cpu")
    jg_state, jg = j_engine.gate(jst, jnp.asarray(xs[0]), jcfg)
    tg_state, tg = t_engine.gate(tst, torch.as_tensor(xs[0]), tcfg)
    _assert_out_close(tg, jg)
    _assert_state_close(tg_state, jg_state)
    ja = j_engine.apply_labels(jg_state, jg, jnp.asarray(ys[0]), jnp.asarray(mask), jcfg)
    ta = t_engine.apply_labels(tg_state, tg, torch.as_tensor(ys[0]), torch.as_tensor(mask), tcfg)
    _assert_state_close(ta, ja)
    with pytest.raises(TypeError):
        t_engine.apply_labels(tg_state, tg.feats, torch.as_tensor(ys[0]),
                              torch.as_tensor(mask), tcfg)


def test_cold_fleet_tick_from_init(trained):
    """From ``init_fleet`` (P = I/ridge): weights at rtol 2e-3."""
    jcfg, tcfg, _ = trained
    xs, ys = _ticks(1, seed=9)
    js, jo = j_engine.fleet_step(j_engine.init_fleet(jcfg, S), jnp.asarray(xs[0]),
                                 jnp.asarray(ys[0]), jcfg, mode="train_phase")
    ts, to = t_engine.fleet_step(t_engine.init_fleet(tcfg, S, device="cpu"),
                                 torch.as_tensor(xs[0]), torch.as_tensor(ys[0]), tcfg,
                                 mode="train_phase")
    _assert_out_close(to, jo)
    _assert_state_close(ts, js, weights_rtol=2e-3, weights_atol=2e-3)


def test_fleet_rank1_matches_pallas_numerics(trained):
    """``fleet_rank1_update_h`` against the JAX fleet kernel path
    (``use_kernel=True``, Pallas interpret): P 2e-5, beta 2e-4."""
    _, _, arrays = trained
    jcfg = j_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT)
    tcfg = t_oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT)
    rng = np.random.default_rng(3)
    h = (1 / (1 + np.exp(-rng.standard_normal((S, N_HIDDEN))))).astype(np.float32)
    y = np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, S)]
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32)
    jst = j_oselm.OSELMState(*(jnp.asarray(arrays[f"elm.{f}"]) for f in ("beta", "P", "count")))
    tst = t_oselm.OSELMState(*(torch.tensor(arrays[f"elm.{f}"]) for f in ("beta", "P", "count")))
    want = j_oselm.fleet_rank1_update_h(jst, jnp.asarray(h), jnp.asarray(y), jcfg,
                                        mask=jnp.asarray(mask), use_kernel=True)
    got = t_oselm.fleet_rank1_update_h(tst, torch.as_tensor(h), torch.as_tensor(y), tcfg,
                                       mask=torch.as_tensor(mask))
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), atol=2e-5)
    np.testing.assert_allclose(got.beta.numpy(), np.asarray(want.beta), atol=2e-4)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(want.count))


def test_oselm_batch_boot_sequential_and_closed_form():
    # ridge 1: a well-conditioned Gram, so the two Cholesky factorisations
    # (upper in JAX, lower here) agree to f32 rounding.
    jcfg = j_oselm.OSELMConfig(n_in=48, n_hidden=32, n_out=5, seed=3, ridge=1.0)
    tcfg = t_oselm.OSELMConfig(n_in=48, n_hidden=32, n_out=5, seed=3, ridge=1.0)
    rng = np.random.default_rng(0)
    x0 = np.tanh(rng.standard_normal((200, 48))).astype(np.float32)
    y0 = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 200)]
    x1 = np.tanh(rng.standard_normal((8, 48))).astype(np.float32)
    y1 = np.eye(5, dtype=np.float32)[np.arange(8) % 5]
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)

    jst = j_oselm.init_state_batch(jcfg, jnp.asarray(x0), jnp.asarray(y0))
    tst = t_oselm.init_state_batch(tcfg, torch.as_tensor(x0), torch.as_tensor(y0))
    np.testing.assert_allclose(tst.P.numpy(), np.asarray(jst.P), atol=1e-5)
    np.testing.assert_allclose(tst.beta.numpy(), np.asarray(jst.beta), atol=1e-4)
    assert int(tst.count) == int(jst.count) and tst.count.dtype == torch.int32

    # Rank-k masked update: the JAX kernel path is the port's numerics.
    jk = j_oselm.sequential_update(jst, jnp.asarray(x1), jnp.asarray(y1), jcfg,
                                   mask=jnp.asarray(mask), use_kernel=True)
    tk = t_oselm.sequential_update(tst, torch.as_tensor(x1), torch.as_tensor(y1), tcfg,
                                   mask=torch.as_tensor(mask))
    np.testing.assert_allclose(tk.P.numpy(), np.asarray(jk.P), atol=2e-5)
    np.testing.assert_allclose(tk.beta.numpy(), np.asarray(jk.beta), atol=2e-4)
    assert int(tk.count) == int(jk.count) == 200 + 6

    np.testing.assert_allclose(
        t_oselm.fit_closed_form(tcfg, torch.as_tensor(x0), torch.as_tensor(y0)).numpy(),
        np.asarray(j_oselm.fit_closed_form(jcfg, jnp.asarray(x0), jnp.asarray(y0))),
        atol=1e-4,
    )
    pred_t, out_t = t_oselm.predict(tk, torch.as_tensor(x1), tcfg)
    pred_j, out_j = j_oselm.predict(jk, jnp.asarray(x1), jcfg)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-4, atol=1e-4)


def test_base_variant_takes_alpha_from_numpy():
    alpha = np.random.default_rng(4).uniform(-1, 1, (24, 16)).astype(np.float32)
    jcfg = j_oselm.OSELMConfig(n_in=24, n_hidden=16, variant="base", activation="relu")
    tcfg = t_oselm.OSELMConfig(n_in=24, n_hidden=16, variant="base", activation="relu")
    x = np.tanh(np.random.default_rng(5).standard_normal((7, 24))).astype(np.float32)
    want = j_oselm.hidden(jnp.asarray(x), jcfg, jnp.asarray(alpha))
    got = t_oselm.hidden(torch.as_tensor(x), tcfg, torch.as_tensor(alpha))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="alpha"):
        t_oselm.hidden(torch.as_tensor(x), tcfg)


def test_pruning_and_drift_transitions():
    """Controller transitions elementwise over many random states."""
    rng = np.random.default_rng(6)
    n = 512
    cfg_j, cfg_t = j_pruning.PruneConfig(min_trained=10), t_pruning.PruneConfig(min_trained=10)
    fields = {
        "level": rng.integers(0, 5, n), "streak": rng.integers(0, 12, n),
        "queries": rng.integers(0, 50, n), "skips": rng.integers(0, 50, n),
        "phase_trained": rng.integers(0, 20, n),
    }
    fields = {k: v.astype(np.int32) for k, v in fields.items()}
    outputs = rng.uniform(-0.2, 1.2, (n, 6)).astype(np.float32)
    count = rng.integers(0, 20, n).astype(np.int32)
    drift_on = rng.uniform(size=n) < 0.3
    queried = rng.uniform(size=n) < 0.5
    agree = rng.uniform(size=n) < 0.5
    jst = j_pruning.PruneState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tst = t_pruning.PruneState(**{k: torch.as_tensor(v) for k, v in fields.items()})
    conf_j = j_pruning.confidence(jnp.asarray(outputs))
    conf_t = t_pruning.confidence(torch.as_tensor(outputs))
    np.testing.assert_array_equal(conf_t.numpy(), np.asarray(conf_j))
    np.testing.assert_array_equal(
        t_pruning.should_query(tst, torch.as_tensor(outputs), torch.as_tensor(count),
                               torch.as_tensor(drift_on), cfg_t).numpy(),
        np.asarray(j_pruning.should_query(jst, jnp.asarray(outputs), jnp.asarray(count),
                                          jnp.asarray(drift_on), cfg_j)),
    )
    ju = j_pruning.update(jst, jnp.asarray(queried), jnp.asarray(agree), conf_j, cfg_j)
    tu = t_pruning.update(tst, torch.as_tensor(queried), torch.as_tensor(agree), conf_t, cfg_t)
    for f in j_pruning.PruneState._fields:
        np.testing.assert_array_equal(getattr(tu, f).numpy(), np.asarray(getattr(ju, f)), f)
        assert getattr(tu, f).dtype == torch.int32
    np.testing.assert_allclose(t_pruning.comm_volume_fraction(tu).numpy(),
                               np.asarray(j_pruning.comm_volume_fraction(ju)), rtol=1e-6)

    dcfg_j, dcfg_t = j_drift.DriftConfig(warmup=8), t_drift.DriftConfig(warmup=8)
    dj, dt = j_drift.init_fleet(n), t_drift.init_fleet(n, device="cpu")
    j_score = jax.jit(lambda x, o: j_drift.score(x, o, dcfg_j))
    j_update = jax.jit(lambda st, s: j_drift.update(st, s, dcfg_j))
    for step in range(40):
        x = (np.tanh(rng.standard_normal((n, 12))) * (1 + 3 * (step >= 30))).astype(np.float32)
        o = rng.uniform(0, 1, (n, 6)).astype(np.float32)
        sj = j_score(jnp.asarray(x), jnp.asarray(o))
        st = t_drift.score(torch.as_tensor(x), torch.as_tensor(o), dcfg_t)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6, atol=1e-7)
        dj = j_update(dj, sj)
        dt = t_drift.update(dt, torch.as_tensor(np.asarray(sj)), dcfg_t)
        for f in ("steps", "hits", "calm", "active"):
            np.testing.assert_array_equal(getattr(dt, f).numpy(), np.asarray(getattr(dj, f)), f)
        np.testing.assert_allclose(dt.mean.numpy(), np.asarray(dj.mean), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(dt.var.numpy(), np.asarray(dj.var), rtol=1e-5, atol=1e-9)
    assert bool(dt.active.any())


def test_run_fleet_ignores_chunk_and_keeps_masked_streams(trained):
    _, tcfg, _ = trained
    xs, ys = _ticks(12, seed=10)
    avail = np.zeros((12, S), bool)
    avail[:, ::2] = True
    st0 = t_engine.init_fleet(tcfg, S, device="cpu")
    a, oa = t_engine.run_fleet(st0, xs, ys, tcfg, mode="train_phase", teacher_available=avail)
    b, ob = t_engine.run_fleet(st0, xs, ys, tcfg, mode="train_phase", teacher_available=avail,
                               chunk=5, donate=True)
    for x, y in zip(convert.engine_state_to_numpy(a).values(),
                    convert.engine_state_to_numpy(b).values()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(oa.queried.numpy(), ob.queried.numpy())
    dead = np.arange(S)[1::2]
    np.testing.assert_array_equal(a.elm.beta[dead].numpy(), st0.elm.beta[dead].numpy())
    assert not bool(oa.queried[:, dead].any()) and bool(oa.queried[:, ::2].any())
    assert float(a.meter.total[dead].sum()) == 0.0
    empty_state, empty = t_engine.run_fleet(st0, xs[:0], ys[:0], tcfg)
    assert empty.outputs.shape == (0, S, N_OUT) and empty_state is st0


def test_convert_roundtrip_and_slices(trained):
    _, tcfg, arrays = trained
    tst = convert.engine_state_from_numpy(arrays, device="cpu")
    back = convert.engine_state_to_numpy(tst)
    assert back.keys() == arrays.keys()
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype, k
        np.testing.assert_array_equal(back[k], arrays[k])
    one = t_engine.stream_slice(tst, 2)
    assert one.elm.P.shape == (N_HIDDEN, N_HIDDEN)
    again = t_engine.broadcast_streams(one, 3)
    np.testing.assert_array_equal(again.drift.active.numpy(), np.repeat(arrays["drift.active"][2], 3))
    with pytest.raises(KeyError):
        convert.engine_state_from_numpy({k: v for k, v in arrays.items() if k != "elm.P"}, "cpu")


def test_entry_points_put_state_on_cuda_or_raise():
    """No silent CPU fallback: without CUDA an entry point given no device raises."""
    _, tcfg = _cfgs()
    if torch.cuda.is_available():
        assert t_engine.init_fleet(tcfg, 2).elm.P.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_engine.init_fleet(tcfg, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_engine.init_state(tcfg)
    assert t_engine.init_fleet(tcfg, 2, device="cpu").elm.P.device.type == "cpu"


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert jax.default_backend() == "cpu"
