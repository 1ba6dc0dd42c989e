"""The plan's per-stream pass (``ops.plan_rows``: ``csrc/plan_rows.cu`` on
the card, ``ref.plan_rows_ref`` on the CPU) after the projection.

* On the CPU, ``fleet.plan``, ``fleet.gate`` and ``ref.plan_rows_ref`` equal,
  bit for bit, the composite of torch ops ``plan`` and ``gate`` were before
  the pass was fused (kept below as ``_plan_composite``/``_gate_composite``),
  over hypothesis-drawn states at the controllers' edges: the detector's
  warm-up and boot steps, its enter and exit hysteresis, the ladder's ends,
  ``count`` at ``min_trained``, tied outputs, a partly available teacher,
  pruning off, one drift score term off.
* On the CPU, the port's ``plan`` and ``gate`` against the JAX package's at
  such states: integers and booleans exact, floats within the ROADMAP
  tolerances (outputs 1e-4 relative, state floats 1e-5).
* On the card (``cuda``): the kernel equals its plain version bit for bit in
  every output and leaf when the plain version is fed the kernel's own
  readout and feature mean; a row's result does not depend on its
  neighbours, its index or its alignment; what it does not take raises.

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_plan_epilogue.py
"""

import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # degrade gracefully: only @given tests skip
    from _hypothesis_stub import given, settings, st

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp

    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.core.labels import CommMeter as JCommMeter

from repro_torch import convert  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.engine import fleet  # noqa: E402
from repro_torch.engine.types import EngineConfig, EngineState, tree_leaves, tree_map  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

MODES = ("algo1", "serve", "train_phase")
N_IN, N_HIDDEN, N_OUT = 24, 16, 4


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# -- the composite the pass replaced, as fleet.py had it --------------------


def _tree_where(cond, a, b):
    return tree_map(
        lambda x, y: torch.where(cond.reshape(cond.shape + (1,) * (x.dim() - cond.dim())), x, y),
        a, b)


def _plan_composite(state, x, cfg, mode="algo1", teacher_available=None, drift_active=None):
    n_streams = x.shape[0]
    dev = x.device
    if teacher_available is None:
        teacher_available = torch.ones((n_streams,), dtype=torch.bool, device=dev)
    off = torch.zeros((n_streams,), dtype=torch.bool, device=dev)
    h, c, o = fleet._predict(state, x, cfg)
    conf = pruning.confidence(o)
    if mode == "serve":
        s = drift_mod.score(x, o, cfg.drift)
        new_drift = drift_mod.update(state.drift, s, cfg.drift)
        training = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        prune_st = state.prune
        want = pruning.should_query(prune_st, o, state.elm.count, new_drift.active, cfg.prune)
        queried = want & teacher_available
        controller_on = teacher_available
    elif mode == "algo1":
        s = drift_mod.score(x, o, cfg.drift)
        new_drift = drift_mod.update(state.drift, s, cfg.drift)
        training = new_drift.active
        entering = training & ~state.drift.active
        prune_st = _tree_where(entering, pruning.reset_phase(state.prune), state.prune)
        want = pruning.should_query(prune_st, o, state.elm.count, off, cfg.prune)
        queried = training & want & teacher_available
        controller_on = training & teacher_available
    else:
        if drift_active is None:
            drift_active = off
        new_drift = state.drift
        training = torch.ones((n_streams,), dtype=torch.bool, device=dev)
        prune_st = state.prune
        want = pruning.should_query(prune_st, o, state.elm.count, drift_active, cfg.prune)
        queried = want & teacher_available
        controller_on = teacher_available
    theta = pruning.theta_of(prune_st, cfg.prune)
    meter = state.meter.charge_query(x.shape[-1], queried)
    new_prune = _tree_where(controller_on & ~queried,
                            pruning.update(prune_st, off, off, conf, cfg.prune), prune_st)
    new_state = EngineState(elm=state.elm, prune=new_prune, drift=new_drift, meter=meter)
    return new_state, fleet.PlanOutput(h=h, pred=c, outputs=o, confidence=conf, queried=queried,
                                       controller_on=controller_on, theta=theta,
                                       mode_training=training)


def _gate_composite(state, x, cfg):
    h, c, o = fleet._predict(state, x, cfg)
    conf = pruning.confidence(o)
    s = drift_mod.score(x, o, cfg.drift)
    new_drift = drift_mod.update(state.drift, s, cfg.drift)
    query_mask = pruning.should_query(state.prune, o, state.elm.count, new_drift.active,
                                      cfg.prune)
    theta = pruning.theta_of(state.prune, cfg.prune)
    meter = state.meter.charge_query(x.shape[-1], query_mask)
    off = torch.zeros_like(query_mask)
    new_prune = _tree_where(~query_mask, pruning.update(state.prune, off, off, conf, cfg.prune),
                            state.prune)
    return state._replace(drift=new_drift, meter=meter, prune=new_prune), fleet.GateOutput(
        h=h, pred=c, outputs=o, confidence=conf, queried=query_mask, theta=theta, feats=x,
        drift_active=new_drift.active)


# -- states at the controllers' edges ---------------------------------------

CFG_VARIANTS = {
    "default": {},
    "no_pruning": {"prune": {"enabled": False}},
    "confidence_only": {"drift": {"use_features": False}},
    "features_only": {"drift": {"use_confidence": False, "ewma_decay": 0.9}},
    "one_rung": {"prune": {"ladder": (0.5,), "x_consec": 1}},
    "eight_rungs": {"prune": {"ladder": (1.0, 0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3), "x_consec": 2}},
}


def _cfg(variant="default", n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT):
    over = CFG_VARIANTS[variant]
    prune = dict(min_trained=16, **over.get("prune", {}))
    drift = dict(warmup=16, k_sigma=3.0, enter_hits=2, exit_calm=4, **over.get("drift", {}))
    return EngineConfig(elm=oselm.OSELMConfig(n_in=n_in, n_hidden=n_hidden, n_out=n_out),
                        prune=pruning.PruneConfig(**prune), drift=drift_mod.DriftConfig(**drift))


def _edge_arrays(cfg, s, seed):
    """A fleet state (flat ``{"group.leaf": array}``) and features whose
    streams sit at the controllers' edges, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n_in, n, m = cfg.elm.n_in, cfg.elm.n_hidden, cfg.elm.n_out
    pc, dc = cfg.prune, cfg.drift
    beta = (rng.standard_normal((s, n, m)) * rng.choice([0.01, 0.3, 3.0], (s, 1, 1)))
    tied = rng.random(s) < 0.2  # two equal largest outputs
    beta[tied, :, 1] = beta[tied, :, 0]
    beta[rng.random(s) < 0.05] = 0.0  # all outputs tied at 0
    lv = len(pc.ladder)
    arrays = {
        "elm.beta": beta.astype(np.float32),
        "elm.P": np.broadcast_to(np.eye(n, dtype=np.float32), (s, n, n)).copy(),
        "elm.count": rng.choice([0, pc.min_trained - 1, pc.min_trained, 10 ** 6], s),
        "prune.level": rng.integers(-1, lv + 1, s),  # clamped at both ends
        "prune.streak": rng.integers(0, pc.x_consec + 1, s),
        "prune.queries": rng.integers(0, 500, s),
        "prune.skips": rng.integers(0, 500, s),
        "prune.phase_trained": rng.integers(0, 400, s),
        "drift.mean": rng.standard_normal(s) * rng.choice([0.0, 1e-6, 1.0], s),
        "drift.var": np.abs(rng.standard_normal(s)) * rng.choice([1e-14, 1e-3, 1.0], s),
        "drift.steps": rng.choice([0, 1, 7, 8, 9, dc.warmup - 1, dc.warmup, 10 ** 4], s),
        "drift.hits": rng.integers(0, dc.enter_hits + 1, s),
        "drift.calm": rng.integers(0, dc.exit_calm + 1, s),
        "drift.active": rng.random(s) < 0.4,
        "meter.up_bytes": rng.integers(0, 1000, s) * float(n_in * 4),
        "meter.down_bytes": rng.integers(0, 1000, s).astype(np.float64),
    }
    for k, v in arrays.items():
        if k != "drift.active":
            arrays[k] = v.astype(np.float32 if k in ("elm.beta", "elm.P", "drift.mean",
                                                     "drift.var", "meter.up_bytes",
                                                     "meter.down_bytes") else np.int32)
    x = (rng.standard_normal((s, n_in)) * rng.choice([0.1, 1.0, 6.0], (s, 1))).astype(np.float32)
    avail = rng.random(s) < 0.75
    drift_active = rng.random(s) < 0.3
    return arrays, x, avail, drift_active


def _assert_equal_trees(got, want, what):
    for i, (g, w) in enumerate(zip(tree_leaves(got), tree_leaves(want), strict=True)):
        assert g.dtype == w.dtype and torch.equal(g, w), f"{what}: leaf {i} differs"


# -- CPU: bit for bit against the composite ---------------------------------


@pytest.mark.parametrize("mode", MODES)
@settings(max_examples=24, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), variant=st.sampled_from(sorted(CFG_VARIANTS)),
       width=st.sampled_from([1, 3, 37]), with_avail=st.booleans())
def test_plan_equals_the_composite_bit_for_bit(mode, seed, variant, width, with_avail):
    cfg = _cfg(variant)
    arrays, x, avail, drift_active = _edge_arrays(cfg, width, seed)
    state = convert.engine_state_from_numpy(arrays, device="cpu")
    x, avail = torch.as_tensor(x), torch.as_tensor(avail) if with_avail else None
    da = torch.as_tensor(drift_active)
    want_state, want = _plan_composite(state, x, cfg, mode, avail, da)
    got_state, got = fleet.plan(state, x, cfg, mode, avail, da)
    _assert_equal_trees(got_state, want_state, f"{mode} state")
    _assert_equal_trees(got, want, f"{mode} plan")
    # The plain version alone, with the readout and feature mean given.
    r = ref.plan_rows_ref(got.h, state.elm.beta, x, state.elm.count, state.prune, state.drift,
                          state.meter, cfg, mode, avail, da, o=want.outputs,
                          a=ref.row_abs_mean_ref(x))
    _assert_equal_trees((r.outputs, r.pred, r.confidence, r.queried, r.controller_on, r.theta,
                         r.mode_training, r.prune, r.drift, r.meter),
                        (want.outputs, want.pred, want.confidence, want.queried,
                         want.controller_on, want.theta, want.mode_training, want_state.prune,
                         want_state.drift, want_state.meter), f"{mode} plan_rows_ref")
    if mode == "serve":
        want_state, want = _gate_composite(state, x, cfg)
        got_state, got = fleet.gate(state, x, cfg)
        _assert_equal_trees(got_state, want_state, "gate state")
        _assert_equal_trees(got, want, "gate")


@pytest.mark.parametrize("mode", MODES)
def test_plan_writes_the_new_leaves_into_out(mode):
    """``plan(out=)`` writes the new prune, drift and meter leaves into the
    given state's buffers (the stream runners' other buffer set) and
    returns those buffers, with the values ``plan`` gives without it."""
    cfg = _cfg()
    arrays, x, avail, _ = _edge_arrays(cfg, 9, seed=3)
    state = convert.engine_state_from_numpy(arrays, device="cpu")
    x, avail = torch.as_tensor(x), torch.as_tensor(avail)
    want_state, want = fleet.plan(state, x, cfg, mode, avail)
    dst = tree_map(torch.empty_like, state)
    got_state, got = fleet.plan(state, x, cfg, mode, avail, out=dst)
    _assert_equal_trees(got_state, want_state, mode)
    _assert_equal_trees(got, want, mode)
    for group in ("prune", "drift", "meter"):
        for g, d in zip(getattr(got_state, group), getattr(dst, group)):
            assert g is d
    if mode == "train_phase":  # the detector is not stepped: passed through
        _assert_equal_trees(got_state.drift, state.drift, "train_phase drift")


def test_plan_rows_kernel_wrapper_takes_only_card_tensors():
    """The kernel's wrapper raises on a CPU tensor (the CPU path is
    ``ops``', which goes to the plain version)."""
    from repro_torch.kernels import plan_rows

    cfg = _cfg()
    arrays, x, _, _ = _edge_arrays(cfg, 4, seed=1)
    st_ = convert.engine_state_from_numpy(arrays, device="cpu")
    h = torch.rand(4, N_HIDDEN)
    with pytest.raises(ValueError):
        plan_rows.plan_rows(h, st_.elm.beta, torch.as_tensor(x), st_.elm.count, st_.prune,
                            st_.drift, st_.meter, cfg, "algo1")
    with pytest.raises(ValueError):
        plan_rows.plan_rows(h, st_.elm.beta, torch.as_tensor(x), st_.elm.count, st_.prune,
                            st_.drift, st_.meter, cfg, "predict")


# -- CPU: against the JAX package -------------------------------------------


def _jax_cfg(cfg):
    return j_engine.EngineConfig(elm=j_oselm.OSELMConfig(**dataclasses.asdict(cfg.elm)),
                                 prune=j_pruning.PruneConfig(**dataclasses.asdict(cfg.prune)),
                                 drift=j_drift.DriftConfig(**dataclasses.asdict(cfg.drift)))


def _jax_state(arrays):
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    return j_engine.EngineState(
        elm=j_oselm.OSELMState(j["elm.beta"], j["elm.P"], j["elm.count"]),
        prune=j_pruning.PruneState(*(j[f"prune.{f}"] for f in j_pruning.PruneState._fields)),
        drift=j_drift.DriftState(*(j[f"drift.{f}"] for f in j_drift.DriftState._fields)),
        meter=JCommMeter(j["meter.up_bytes"], j["meter.down_bytes"]),
    )


def _assert_close_to_jax(tstate, tout, jstate, jout, what):
    t, j = convert.engine_state_to_numpy(tstate), convert.engine_state_to_numpy(jstate)
    for k in t:
        assert t[k].dtype == j[k].dtype, (what, k)
        if t[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-5, atol=1e-6, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"{what} {k}")
    for f in tout._fields:
        a, b = getattr(tout, f).numpy(), np.asarray(getattr(jout, f))
        if f in ("h", "feats"):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f"{what} {f}")
        elif a.dtype == np.float32:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6, err_msg=f"{what} {f}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {f}")


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("variant", ["default", "no_pruning", "confidence_only",
                                     "features_only", "eight_rungs"])
@pytest.mark.parametrize("mode", MODES + ("gate",))
def test_plan_and_gate_match_jax_at_the_edges(mode, variant):
    cfg = _cfg(variant)
    arrays, x, avail, drift_active = _edge_arrays(cfg, 48, seed=11 + len(variant))
    tst = convert.engine_state_from_numpy(arrays, device="cpu")
    jst, jcfg = _jax_state(arrays), _jax_cfg(cfg)
    if mode == "gate":
        ts, to = fleet.gate(tst, torch.as_tensor(x), cfg)
        js, jo = j_engine.gate(jst, jnp.asarray(x), jcfg)
    else:
        da = drift_active if mode == "train_phase" else None
        ts, to = fleet.plan(tst, torch.as_tensor(x), cfg, mode, torch.as_tensor(avail),
                            None if da is None else torch.as_tensor(da))
        js, jo = j_engine.plan(jst, jnp.asarray(x), jcfg, mode, jnp.asarray(avail),
                               None if da is None else jnp.asarray(da))
    _assert_close_to_jax(ts, to, js, jo, f"{mode}/{variant}")


# -- the card ---------------------------------------------------------------


def _card_inputs(cfg, s, seed, device):
    arrays, x, avail, drift_active = _edge_arrays(cfg, s, seed)
    state = convert.engine_state_from_numpy(arrays, device=device)
    rng = np.random.default_rng(seed + 1)
    h = torch.as_tensor(rng.random((s, cfg.elm.n_hidden), dtype=np.float32), device=device)
    return (state, h, torch.as_tensor(x, device=device), torch.as_tensor(avail, device=device),
            torch.as_tensor(drift_active, device=device))


def _kernel_vs_plain(cfg, mode, s, seed, device, with_avail=True):
    from repro_torch.kernels import plan_rows

    state, h, x, avail, da = _card_inputs(cfg, s, seed, device)
    avail = avail if with_avail else None
    stepped = mode != "train_phase" and cfg.drift.use_features
    a = torch.empty((s,), dtype=torch.float32, device=device) if stepped else None
    got = plan_rows.plan_rows(h, state.elm.beta, x, state.elm.count, state.prune, state.drift,
                              state.meter, cfg, mode, avail, da, feature_mean=a)
    want = ref.plan_rows_ref(h, state.elm.beta, x, state.elm.count, state.prune, state.drift,
                             state.meter, cfg, mode, avail, da, o=got.outputs, a=a)
    _assert_equal_trees(got, want, f"{mode} kernel vs plain")
    # f32 sums in another order: within 1e-5 of the terms' magnitudes (beta
    # reaches 3 here, so outputs cancel), plus 1e-5.
    scale = (h.abs()[:, :, None] * state.elm.beta.abs()).sum(1)
    assert bool(((got.outputs - ref.readout_ref(h, state.elm.beta)).abs()
                 <= 1e-5 * (1 + scale)).all())
    if stepped:
        torch.testing.assert_close(a, ref.row_abs_mean_ref(x), rtol=1e-5, atol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(CFG_VARIANTS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("n_in,n_hidden,n_out,s", [(24, 16, 4, 37), (561, 128, 6, 4096),
                                                   (561, 33, 7, 130), (64, 64, 6, 256)])
def test_cuda_kernel_equals_its_plain_version(cuda_device, mode, variant, n_in, n_hidden,
                                              n_out, s):
    cfg = _cfg(variant, n_in=n_in, n_hidden=n_hidden, n_out=n_out)
    for with_avail in (True, False):
        _kernel_vs_plain(cfg, mode, s, seed=s + n_in, device=cuda_device, with_avail=with_avail)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_rows_do_not_depend_on_neighbours_index_or_alignment(cuda_device, mode):
    """Every row again with one row put in front (each row moves by one
    position, and its beta, h and x rows to another 16-byte alignment, as
    N·m = 231 and n_in = 561 are odd): the same bits."""
    from repro_torch.kernels import plan_rows

    cfg = _cfg(n_in=561, n_hidden=33, n_out=7)
    s = 64
    state, h, x, avail, da = _card_inputs(cfg, s + 1, seed=5, device=cuda_device)

    def run(lo):
        sl = tree_map(lambda t: t[lo:lo + s].clone() if lo == 0 else t[lo:lo + s], state)
        return plan_rows.plan_rows(h[lo:lo + s], sl.elm.beta, x[lo:lo + s], sl.elm.count,
                                   sl.prune, sl.drift, sl.meter, cfg, mode, avail[lo:lo + s],
                                   da[lo:lo + s])

    base = run(0)
    moved = run(1)
    for name, a, b in zip(base._fields, base, moved):
        for i, (ta, tb) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
            assert torch.equal(ta[1:], tb[:-1]), f"{name}[{i}] depends on the row's position"
    # A row computed alone equals the same row inside the launch.
    alone = plan_rows.plan_rows(h[5:6].clone(), state.elm.beta[5:6].clone(), x[5:6].clone(),
                                state.elm.count[5:6].clone(),
                                tree_map(lambda t: t[5:6].clone(), state.prune),
                                tree_map(lambda t: t[5:6].clone(), state.drift),
                                tree_map(lambda t: t[5:6].clone(), state.meter), cfg, mode,
                                avail[5:6].clone(), da[5:6].clone())
    for name, a, b in zip(base._fields, base, alone):
        for ta, tb in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(ta[5:6], tb), f"{name}: a lone row differs"


@pytest.mark.cuda
def test_cuda_plan_launches_only_the_projection_and_the_pass(cuda_device):
    cfg = _cfg(n_in=561, n_hidden=128, n_out=6)
    state, _, x, avail, _ = _card_inputs(cfg, 64, seed=2, device=cuda_device)
    for mode in MODES:
        ops.reset_launch_counts()
        fleet.plan(state, x, cfg, mode, avail)
        assert {k: v for k, v in ops.launch_counts.items() if v} == {
            "xorshift_projection": 1, "plan_rows": 1}, mode
    ops.reset_launch_counts()
    fleet.gate(state, x, cfg)
    assert {k: v for k, v in ops.launch_counts.items() if v} == {
        "xorshift_projection": 1, "plan_rows": 1}


@pytest.mark.cuda
def test_cuda_plan_rows_rejects_what_it_does_not_take(cuda_device):
    from repro_torch.kernels import plan_rows

    cfg = _cfg()
    state, h, x, avail, da = _card_inputs(cfg, 8, seed=4, device=cuda_device)
    args = (state.elm.count, state.prune, state.drift, state.meter)

    def call(h_=h, beta=state.elm.beta, x_=x, cfg_=cfg, mode="algo1", avail_=avail):
        return plan_rows.plan_rows(h_, beta, x_, *args, cfg_, mode, avail_)

    call()
    for m in (1, plan_rows.MAX_M + 1):  # top-2 needs m >= 2; at most MAX_M columns
        with pytest.raises(ValueError):
            call(beta=torch.zeros(8, N_HIDDEN, m, device=cuda_device))
    with pytest.raises(ValueError):  # a ladder of more than eight rungs
        call(cfg_=dataclasses.replace(
            cfg, prune=dataclasses.replace(cfg.prune, ladder=tuple(np.linspace(1, 0.1, 9)))))
    with pytest.raises(ValueError):
        call(h_=h.double())
    with pytest.raises(ValueError):
        call(h_=h[:4])
    with pytest.raises(ValueError):
        call(x_=x[:, ::2])
    with pytest.raises(ValueError):
        call(avail_=avail.to(torch.int32))
    with pytest.raises(ValueError):
        call(mode="predict")
    with pytest.raises(ValueError):  # one stream's rows beyond a block's shared memory
        call(h_=torch.zeros(8, 20000, device=cuda_device),
             beta=torch.zeros(8, 20000, 6, device=cuda_device))
