"""The port's chunk runner (``engine/fleet.py``'s ``_chunk_runner``) and
the ``run_fleet`` that walks T ticks through it, against itself and
against the JAX package.

On the CPU the runner runs its ticks eagerly over two buffer sets; on the
card it replays one CUDA graph per chunk shape.  Either way a chunked run
must equal the unchunked one bit for bit, donation must keep or reuse the
caller's buffers as ``run_fleet``'s docstring says, and the runner cache's
counters must move as the JAX package's do.  Against the JAX package's
``run_fleet(chunk=12)``: P within 2e-5 in units of I/ridge, beta within
2e-4, decisions exact (the inputs are the same f32 numbers).

The tests marked ``cuda`` need the card and skip elsewhere.
"""

import dataclasses
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import convert  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.core import drift, oselm, pruning  # noqa: E402
from repro_torch.engine import fleet, graphs  # noqa: E402
from repro_torch.engine.types import tree_leaves  # noqa: E402

HAVE_JAX = importlib.util.find_spec("jax") is not None

T, S, N_IN, N_HIDDEN, N_OUT = 48, 6, 20, 12, 4
CFG = engine.EngineConfig(
    elm=oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, ridge=1e-2),
    prune=pruning.PruneConfig(min_trained=12),
    drift=drift.DriftConfig(warmup=12, k_sigma=3.0, enter_hits=2, exit_calm=12),
)


def _data(t=T, s=S, seed=0, shift_at=30):
    rng = np.random.default_rng(seed)
    xs = np.tanh(rng.standard_normal((t, s, N_IN))).astype(np.float32)
    sev = np.linspace(2.0, 4.0, s)[None, :, None]
    xs[shift_at:] = np.clip(xs[shift_at:] * sev + 0.5 * sev, -4, 4)
    ys = rng.integers(0, N_OUT, (t, s)).astype(np.int32)
    return xs, ys


def _masked(t=T, s=S):
    avail = np.ones((t, s), bool)
    avail[:, 1::2] = False
    avail[::5, 0] = False
    return avail


def _assert_states_equal(a, b, where=""):
    for k, (x, y) in enumerate(zip(tree_leaves(a), tree_leaves(b))):
        assert x.dtype == y.dtype, f"{where}: leaf {k}"
        assert torch.equal(x.cpu(), y.cpu()), f"{where}: leaf {k} differs"


def _assert_outputs_equal(a, b, where=""):
    for name in a._fields:
        assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), f"{where}: {name}"


def _eager(state, xs, ys, mode, avail=None):
    """The ticks as a plain loop of ``fleet_step`` (no runner)."""
    xs, ys = torch.as_tensor(xs), torch.as_tensor(ys)
    outs = []
    for t in range(xs.shape[0]):
        av = None if avail is None else torch.as_tensor(avail[t])
        state, out = engine.fleet_step(state, xs[t], ys[t], CFG, mode=mode, teacher_available=av)
        outs.append(out)
    return state, engine.types.tree_map(lambda *a: torch.stack(a), *outs)


# ---------------------------------------------------------------------------
# Chunked == unchunked, with donation either way
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("chunk", [1, 12, 48, 7])
@pytest.mark.parametrize("masked", [False, True])
def test_chunked_equals_unchunked_bit_for_bit(chunk, donate, masked):
    xs, ys = _data(seed=1)
    avail = _masked() if masked else None
    ref, ref_out = engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG,
                                    teacher_available=avail)
    st, out = engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG,
                               teacher_available=avail, chunk=chunk, donate=donate)
    _assert_states_equal(ref, st, f"chunk={chunk}")
    _assert_outputs_equal(ref_out, out, f"chunk={chunk}")
    assert out.pred.shape == (T, S)
    assert bool(out.mode_training[30:].any()), "no stream entered training"


@pytest.mark.parametrize("mode", ["algo1", "train_phase"])
def test_runner_equals_the_plain_fleet_step_loop(mode):
    """The runner's ticks (``plan``/``learn`` writing into the other buffer
    set) are ``fleet_step``'s, bit for bit."""
    xs, ys = _data(seed=2)
    avail = _masked()
    want, want_out = _eager(engine.init_fleet(CFG, S, "cpu"), xs, ys, mode, avail)
    got, got_out = engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG, mode=mode,
                                    teacher_available=avail, chunk=7)
    _assert_states_equal(want, got, mode)
    _assert_outputs_equal(want_out, got_out, mode)


def test_donation_keeps_or_reuses_the_callers_buffers():
    xs, ys = _data(seed=3)
    st0 = engine.init_fleet(CFG, S, "cpu")
    before = [a.clone() for a in tree_leaves(st0)]
    kept, _ = engine.run_fleet(st0, xs, ys, CFG, chunk=12, donate=False)
    for a, b in zip(tree_leaves(st0), before):
        assert torch.equal(a, b), "donate=False changed the caller's state"
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(tree_leaves(kept),
                                                               tree_leaves(st0)))
    # donate=True: the result lands in the caller's own buffers, an odd
    # (ragged) last chunk included.
    for chunk in (12, 7):
        st = engine.init_fleet(CFG, S, "cpu")
        ptrs = [a.data_ptr() for a in tree_leaves(st)]
        got, _ = engine.run_fleet(st, xs, ys, CFG, chunk=chunk, donate=True)
        assert [a.data_ptr() for a in tree_leaves(got)] == ptrs
        _assert_states_equal(got, kept, f"donated chunk={chunk}")
        _assert_states_equal(st, kept, f"the passed state after chunk={chunk}")
    # The default on the CPU is the JAX package's: no donation.
    st = engine.init_fleet(CFG, S, "cpu")
    engine.run_fleet(st, xs, ys, CFG, chunk=12)
    for a, b in zip(tree_leaves(st), before):
        assert torch.equal(a, b)


def test_cache_size_counts_chunk_shapes():
    """``tests/test_engine.py``'s no-recompile test: 4 chunks of 12 hold one
    shape, a second run adds none, a ragged tail adds exactly one."""
    xs, ys = _data(seed=3)
    fleet._chunk_runner.cache_clear()
    engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG, mode="train_phase",
                     chunk=12)
    runner = fleet._chunk_runner(CFG, "train_phase", False)
    assert runner._cache_size() == 1
    engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG, mode="train_phase",
                     chunk=12)
    assert runner._cache_size() == 1
    engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs[:44], ys[:44], CFG,
                     mode="train_phase", chunk=12)
    assert runner._cache_size() == 2
    info = fleet.runner_cache_info()["chunk_runner"]
    assert info == {"hits": 3, "misses": 1, "size": 1, "maxsize": fleet.RUNNER_CACHE_SIZE}


def test_cpu_runs_hold_no_chunk_graph():
    """On the CPU the ticks run eagerly: the card's graph store stays empty."""
    fleet.release_chunk_graphs()
    xs, ys = _data(t=12, seed=3)
    engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG, chunk=5, donate=True)
    assert not fleet._chunk_graphs


def test_runner_rejects_mismatched_shapes():
    runner = fleet._chunk_runner(CFG, "algo1", False)
    st = engine.init_fleet(CFG, S, "cpu")
    xs, ys = (torch.as_tensor(a) for a in _data(t=4, seed=4))
    ok = torch.ones((4, S), dtype=torch.bool)
    with pytest.raises(ValueError, match="disagree"):
        runner(st, xs, ys[:, :-1], ok)
    with pytest.raises(ValueError, match="disagree"):
        runner(engine.init_fleet(CFG, S + 1, "cpu"), xs, ys, ok)


def test_sharded_paths_through_the_runner_equal_the_unsharded_run():
    xs, ys = _data(t=24, s=40, seed=5)
    ref, ref_out = engine.run_fleet(engine.init_fleet(CFG, 40, "cpu"), xs, ys, CFG,
                                    mode="train_phase")
    sh = engine.split_fleet(engine.init_fleet(CFG, 40, "cpu"), CFG, n_shards=3, block=8)
    sh, out = engine.run_fleet_shards(sh, xs, ys, CFG, mode="train_phase", chunk=10)
    _assert_states_equal(ref, engine.merge_fleet(sh), "run_fleet_shards")
    _assert_outputs_equal(ref_out, out, "run_fleet_shards")


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_cfg():
    if not HAVE_JAX:
        pytest.skip("needs the JAX package (the reference)")
    from repro import engine as j_engine
    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning

    return j_engine.EngineConfig(
        elm=j_oselm.OSELMConfig(**dataclasses.asdict(CFG.elm)),
        prune=j_pruning.PruneConfig(**dataclasses.asdict(CFG.prune)),
        drift=j_drift.DriftConfig(**dataclasses.asdict(CFG.drift)),
    )


def test_cache_counters_equal_the_reference(jax_cfg):
    """The same sequence of calls in both packages, both caches cleared
    first: the ``chunk_runner`` entries agree field for field."""
    import jax.numpy as jnp

    from repro.engine import fleet as j_fleet

    xs, ys = _data(seed=6)
    fleet._chunk_runner.cache_clear()
    j_fleet._chunk_runner.cache_clear()
    calls = (("train_phase", 12, None), ("train_phase", 12, None), ("algo1", 7, None),
             ("algo1", None, True), ("train_phase", 12, True))
    for mode, chunk, donate in calls:
        engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG, mode=mode, chunk=chunk,
                         donate=donate)
        j_fleet.run_fleet(j_fleet.init_fleet(jax_cfg, S), jnp.asarray(xs), jnp.asarray(ys),
                          jax_cfg, mode=mode, chunk=chunk, donate=donate)
        assert (fleet.runner_cache_info()["chunk_runner"]
                == j_fleet.runner_cache_info()["chunk_runner"]), (mode, chunk, donate)
    assert fleet.runner_cache_info()["chunk_runner"]["misses"] == 4


@pytest.mark.parametrize("mode", ["train_phase", "algo1"])
def test_chunked_run_matches_the_reference(jax_cfg, mode):
    import jax.numpy as jnp

    from repro.engine import fleet as j_fleet

    xs, ys = _data(seed=7)
    avail = _masked()
    jst, jout = j_fleet.run_fleet(j_fleet.init_fleet(jax_cfg, S), jnp.asarray(xs),
                                  jnp.asarray(ys), jax_cfg, mode=mode,
                                  teacher_available=jnp.asarray(avail), chunk=12)
    tst, tout = engine.run_fleet(engine.init_fleet(CFG, S, "cpu"), xs, ys, CFG, mode=mode,
                                 teacher_available=avail, chunk=12)
    for f in ("pred", "queried", "trained", "mode_training", "theta"):
        np.testing.assert_array_equal(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                      err_msg=f)
    t, j = convert.engine_state_to_numpy(tst), convert.engine_state_to_numpy(jst)
    for k in t:
        assert t[k].dtype == j[k].dtype, k
        if k == "elm.P":
            np.testing.assert_allclose(t[k] * CFG.elm.ridge, j[k] * CFG.elm.ridge, atol=2e-5,
                                       err_msg=k)
        elif k == "elm.beta":
            np.testing.assert_allclose(t[k], j[k], atol=2e-4, err_msg=k)
        elif t[k].dtype == np.float32:
            np.testing.assert_allclose(t[k], j[k], rtol=2e-3, atol=2e-3, err_msg=k)
        else:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["algo1", "train_phase"])
def test_cuda_graphed_chunks_equal_the_eager_loop(cuda_device, mode):
    xs, ys = (torch.as_tensor(a, device=cuda_device) for a in _data(seed=8))
    avail = torch.as_tensor(_masked(), device=cuda_device)
    want, want_out = _eager(engine.init_fleet(CFG, S, cuda_device), xs, ys, mode, avail)
    for chunk in (12, 7):
        got, got_out = engine.run_fleet(engine.init_fleet(CFG, S, cuda_device), xs, ys, CFG,
                                        mode=mode, teacher_available=avail, chunk=chunk)
        _assert_states_equal(want, got, f"chunk={chunk}")
        _assert_outputs_equal(want_out, got_out, f"chunk={chunk}")


@pytest.mark.cuda
def test_cuda_one_capture_per_shape_and_replays_count_the_kernels(cuda_device):
    xs, ys = (torch.as_tensor(a, device=cuda_device) for a in _data(seed=9))
    fleet.release_chunk_graphs()
    graphs.reset_replay_counts()
    st = engine.init_fleet(CFG, S, cuda_device)
    ptr = st.elm.P.data_ptr()
    got, _ = engine.run_fleet(st, xs, ys, CFG, mode="train_phase", chunk=12)
    assert got.elm.P.data_ptr() == ptr  # donated by default on the card
    engine.run_fleet(engine.init_fleet(CFG, S, cuda_device), xs[:44], ys[:44], CFG,
                     mode="train_phase", chunk=12)
    assert graphs.capture_counts["chunk_runner"] == 2  # 12 and the ragged 8
    assert graphs.replay_counts["chunk_runner"] == 4 + 4
    for name in ("xorshift_projection", "plan_rows", "oselm_rls_update_fleet"):
        assert graphs.kernel_replays[name] == 48 + 44, name


@pytest.mark.cuda
def test_cuda_chunk_graphs_are_shared_across_donation_and_bounded(cuda_device):
    """Both donate variants replay one graph a shape; the card keeps at
    most ``CHUNK_GRAPHS``, the least recently used going first."""
    xs, ys = (torch.as_tensor(a, device=cuda_device) for a in _data(seed=12))
    want, want_out = _eager(engine.init_fleet(CFG, S, cuda_device), xs, ys, "train_phase")
    fleet.release_chunk_graphs()
    graphs.reset_replay_counts()

    def run(t, **kw):
        return engine.run_fleet(engine.init_fleet(CFG, S, cuda_device), xs[:t], ys[:t], CFG,
                                mode="train_phase", chunk=12, **kw)

    run(T)
    got, got_out = run(T, donate=False)
    _assert_states_equal(want, got, "donate=False")
    _assert_outputs_equal(want_out, got_out, "donate=False")
    assert graphs.capture_counts["chunk_runner"] == 1
    for t in range(1, fleet.CHUNK_GRAPHS + 1):  # shapes 1..4: the 12-tick graph goes
        run(t)
    assert len(fleet._chunk_graphs) == fleet.CHUNK_GRAPHS
    got, got_out = run(T)
    assert graphs.capture_counts["chunk_runner"] == 2 + fleet.CHUNK_GRAPHS
    _assert_states_equal(want, got, "recaptured")
    _assert_outputs_equal(want_out, got_out, "recaptured")
    fleet.release_chunk_graphs()
    assert not fleet._chunk_graphs


@pytest.mark.cuda
def test_cuda_runner_rejects_a_bad_input_shape(cuda_device):
    runner = fleet._chunk_runner(CFG, "algo1", True)
    xs, ys = (torch.as_tensor(a, device=cuda_device) for a in _data(t=4, seed=10))
    ok = torch.ones((4, S), dtype=torch.bool, device=cuda_device)
    st = engine.init_fleet(CFG, S, cuda_device)
    runner(st, xs, ys, ok)
    bad = st._replace(elm=st.elm._replace(count=st.elm.count.to(torch.int64)))
    with pytest.raises(ValueError, match="does not match the captured"):
        runner(bad, xs, ys, ok)
    with pytest.raises(ValueError, match="disagree"):
        runner(engine.init_fleet(CFG, S, cuda_device), xs, ys[:, :-1], ok)


@pytest.mark.cuda
def test_cuda_one_stream_view_keeps_the_callers_head(cuda_device):
    """``run_training_phase`` runs a one-stream ``run_fleet``, which donates
    on the card: the fleet it donates is a copy, so the caller's head is
    left as it was (the JAX package's ``_expand`` makes new arrays too)."""
    head = engine.init_state(CFG, cuda_device)
    kept = [a.clone() for a in tree_leaves(head)]
    xs, ys = _data(t=12, s=1, seed=11)
    new, _ = engine.run_training_phase(head, xs[:, 0], ys[:, 0], CFG)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(head), kept))
    assert int(new.elm.count) == int(head.elm.count) + 12
