"""The port's checkpointing and fault tolerance (``repro_torch.runtime.
checkpoint`` / ``fault``), mirroring ``tests/test_checkpoint.py`` test for
test on trees of torch tensors (``test_token_stream_determinism_and_sharding``
runs on the port's copy of ``data/tokens.py``).  Reading the JAX package's
directories and the reverse is checked in
``tests/test_torch_snapshot_interop.py``.

The ``cuda`` test saves tensors on the card (skips elsewhere):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_checkpoint.py
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.runtime import fault  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402


def _tree(x=1.0, device="cpu"):
    return {
        "params": {"w": torch.full((4, 4), x, device=device),
                   "b": torch.zeros((4,), device=device)},
        "opt": (torch.tensor(3, dtype=torch.int32, device=device),
                [torch.ones((2,), device=device)]),
    }


def _bump(tree):
    """Every float leaf + 1 (the int32 leaf stays)."""
    def f(a):
        return a + 1 if a.dtype != torch.int32 else a

    return {"params": {k: f(v) for k, v in tree["params"].items()},
            "opt": (f(tree["opt"][0]), [f(v) for v in tree["opt"][1]])}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(7, _tree(2.5))
    step, tree = mgr.restore()
    assert step == 7
    np.testing.assert_allclose(tree["params"]["w"], 2.5)
    assert isinstance(tree["opt"], tuple)
    assert int(tree["opt"][0]) == 3 and tree["opt"][0].dtype == np.int32


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    assert mgr.all_steps() == [3, 4]


def test_async_save_is_atomic(tmp_path):
    """``save_async`` copies the tensors to the host before it returns: the
    caller may write them in place at once, and the write still carries
    the values at the call."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    tree = _tree(5.0)
    mgr.save_async(5, tree)
    tree["params"]["w"].fill_(-1.0)  # the caller keeps stepping in place
    mgr.wait()
    step, restored = mgr.restore()
    assert step == 5
    np.testing.assert_allclose(restored["params"]["w"], 5.0)
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def test_partial_checkpoint_is_ignored(tmp_path):
    """A crash mid-write must not corrupt restore (atomic publish)."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1.0))
    os.makedirs(tmp_path / "step_000000002.tmp")
    (tmp_path / "step_000000002.tmp" / "garbage.npy").write_bytes(b"junk")
    assert mgr.latest_step() == 1
    step, _ = mgr.restore()
    assert step == 1


def test_crashed_tmp_with_full_contents_is_skipped(tmp_path):
    """A kill between the last leaf write and the atomic rename leaves a
    complete-looking .tmp (MANIFEST included): latest_step still falls back
    to the previous published step, and a later save of the same step
    replaces the stale staging dir."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(3, _tree(3.0))
    mgr.save(4, _tree(4.0))
    os.rename(tmp_path / "step_000000004", tmp_path / "step_000000004.tmp")
    assert mgr.all_steps() == [3]
    assert mgr.latest_step() == 3
    step, tree = mgr.restore()
    assert step == 3
    np.testing.assert_allclose(tree["params"]["w"], 3.0)
    mgr.save(4, _tree(4.5))
    assert mgr.latest_step() == 4
    assert not (tmp_path / "step_000000004.tmp").exists()
    np.testing.assert_allclose(mgr.restore()[1]["params"]["w"], 4.5)


def test_keep_k_gc_ignores_crashed_tmp_and_restores_explicit_step(tmp_path):
    """GC counts only published steps (a crashed .tmp neither takes a keep
    slot nor comes back), and restore(step=) reaches any surviving step."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2):
        mgr.save(s, _tree(float(s)))
    os.makedirs(tmp_path / "step_000000099.tmp")  # crashed write, never published
    mgr.save(3, _tree(3.0))  # triggers GC
    assert mgr.all_steps() == [2, 3]
    assert not (tmp_path / "step_000000001").exists()
    assert (tmp_path / "step_000000099.tmp").exists()  # GC leaves staging alone
    step, tree = mgr.restore(step=2)
    assert step == 2
    np.testing.assert_allclose(tree["params"]["w"], 2.0)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


def test_save_async_overlapping_saves_serialize(tmp_path):
    """save_async waits out the previous write before copying the next tree:
    back-to-back async saves all publish, in order."""
    mgr = CheckpointManager(str(tmp_path), keep=10)
    for s in range(5):
        mgr.save_async(s, _tree(float(s)))
    mgr.wait()
    assert mgr.all_steps() == [0, 1, 2, 3, 4]
    for s in (0, 4):
        np.testing.assert_allclose(mgr.restore(step=s)[1]["params"]["w"], float(s))


def test_nan_guard_rolls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(10, _tree(1.0))
    guard = fault.NaNGuard(mgr)
    state = _tree(9.9)
    new_state, step, rolled = guard.check(11, {"loss": torch.tensor(float("nan"))}, state)
    assert rolled and step == 10
    np.testing.assert_allclose(new_state["params"]["w"], 1.0)
    st2, step2, rolled2 = guard.check(12, {"loss": torch.tensor(1.0)}, state)
    assert not rolled2 and st2 is state


def test_deadline_teacher_skips_on_outage():
    def teacher(idx, x):
        return torch.tensor(3)

    lat = iter([0.0, 1.0, 1.0, 0.0])  # ok, slow, slow, ok
    dt = fault.DeadlineTeacher(teacher, deadline_s=0.5, max_retries=0,
                               latency_fn=lambda: next(lat))
    out, ok = dt(0, None)
    assert ok and int(out) == 3
    out, ok = dt(1, None)
    assert not ok and out is None  # outage -> skip (the paper's policy)
    assert dt.outages == 1


def test_run_with_restarts_resumes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    attempts = {"n": 0}

    def run(state, start_step):
        state = {"params": {k: torch.as_tensor(v) for k, v in state["params"].items()},
                 "opt": (torch.as_tensor(state["opt"][0]),
                         [torch.as_tensor(v) for v in state["opt"][1]])}
        for step in range(start_step + 1, 6):
            state = _bump(state)
            mgr.save(step, state)
            if step == 3 and attempts["n"] == 0:
                attempts["n"] += 1
                raise RuntimeError("simulated node failure")
        return state, 5

    state, last = fault.run_with_restarts(lambda: _tree(0.0), run, mgr, max_restarts=2)
    assert last == 5
    assert attempts["n"] == 1
    # Work after the restart continued from step 3's checkpoint.
    np.testing.assert_allclose(state["params"]["w"], 5.0)


# ---------------------------------------------------------------------------
# Incremental (delta) checkpoints
# ---------------------------------------------------------------------------


def _npy_names(tmp_path, step):
    d = tmp_path / f"step_{step:09d}"
    return sorted(n for n in os.listdir(d) if n.endswith(".npy"))


def test_delta_save_writes_only_changed_leaves(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=4, full_every=4)
    t1 = _tree(1.0)
    mgr.save(1, t1)
    assert len(_npy_names(tmp_path, 1)) == 4  # first save of a process: full
    t2 = {"params": dict(t1["params"]), "opt": t1["opt"]}
    t2["params"]["b"] = torch.ones((4,))
    mgr.save(2, t2)
    assert _npy_names(tmp_path, 2) == ["params__b.npy"]
    step, tree = mgr.restore()
    assert step == 2
    np.testing.assert_allclose(tree["params"]["b"], 1.0)
    np.testing.assert_allclose(tree["params"]["w"], 1.0)
    assert isinstance(tree["opt"], tuple)


def test_delta_chain_and_periodic_full(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=10, full_every=3)
    tree = _tree(0.0)
    for s in range(1, 7):
        tree = _bump(tree)
        mgr.save(s, tree)
    kinds = [mgr._manifest(s)["kind"] for s in range(1, 7)]
    assert kinds == ["full", "delta", "delta", "full", "delta", "delta"]
    for s in range(1, 7):
        step, t = mgr.restore(step=s)
        np.testing.assert_allclose(t["params"]["w"], float(s))


def test_delta_gc_protects_base_chain(tmp_path):
    """keep-k never collects a base a kept delta still needs."""
    mgr = CheckpointManager(str(tmp_path), keep=2, full_every=10)
    tree = _tree(0.0)
    for s in range(1, 6):
        tree = _bump(tree)
        mgr.save(s, tree)
    assert mgr.all_steps() == [1, 2, 3, 4, 5]
    step, t = mgr.restore()
    assert step == 5
    np.testing.assert_allclose(t["params"]["w"], 5.0)


def test_delta_rewind_forces_full(tmp_path):
    """Re-saving an already-published step must not become its own base."""
    mgr = CheckpointManager(str(tmp_path), keep=3, full_every=8)
    mgr.save(1, _tree(1.0))
    mgr.save(2, _tree(2.0))
    assert mgr._manifest(2)["kind"] == "delta"
    mgr.save(2, _tree(3.0))  # rewind/re-save
    assert mgr._manifest(2)["kind"] == "full"
    step, t = mgr.restore()
    np.testing.assert_allclose(t["params"]["w"], 3.0)


def test_unchanged_tree_delta_is_manifest_only(tmp_path):
    """Nothing learned since the last save: the cadence snapshot ships zero
    leaf bytes."""
    mgr = CheckpointManager(str(tmp_path), keep=4, full_every=4)
    t = _tree(1.0)
    mgr.save(1, t)
    mgr.save(2, t)
    assert _npy_names(tmp_path, 2) == []
    step, tree = mgr.restore()
    assert step == 2
    np.testing.assert_allclose(tree["params"]["w"], 1.0)


def test_restore_places_leaves_by_shardings(tmp_path):
    """``restore(shardings=)``: a tree of the saved structure whose leaves
    are a device or None; each leaf becomes a tensor on its device (None
    keeps the numpy leaf).  A tree of another structure raises."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(1.5))
    shardings = {"params": {"w": torch.device("cpu"), "b": None},
                 "opt": (torch.device("cpu"), ["cpu"])}
    step, tree = mgr.restore(shardings=shardings)
    assert step == 3
    w, b = tree["params"]["w"], tree["params"]["b"]
    assert torch.is_tensor(w) and w.device.type == "cpu" and float(w[0, 0]) == 1.5
    assert isinstance(b, np.ndarray)
    assert tree["opt"][0].dtype == torch.int32 and torch.is_tensor(tree["opt"][1][0])
    assert isinstance(tree["opt"], tuple) and isinstance(tree["opt"][1], list)
    with pytest.raises(ValueError, match="shardings keys"):
        mgr.restore(shardings={"params": {"w": None}, "opt": (None, [None])})
    with pytest.raises(ValueError):
        mgr.restore(shardings={"params": {"w": None, "b": None}, "opt": (None,)})


def test_fleet_rescales_from_four_shards_to_two(tmp_path):
    """The fleet's N -> M rescale: a fleet run on 4 shards is merged, saved,
    restored with ``shardings`` and split into 2 shards; the last ticks on
    the new layout end bit for bit as the uninterrupted unsharded run."""
    from repro_torch import engine
    from repro_torch.core import oselm, pruning
    from repro_torch.engine import snapshot
    from repro_torch.engine.types import EngineState

    cfg = engine.EngineConfig(elm=oselm.OSELMConfig(n_in=12, n_hidden=16, n_out=4),
                              prune=pruning.PruneConfig(min_trained=2))
    t, s, cut = 8, 30, 4
    rng = np.random.default_rng(0)
    xs = np.tanh(rng.standard_normal((t, s, 12))).astype(np.float32)
    ys = rng.integers(0, 4, (t, s)).astype(np.int32)
    ref, _ = engine.run_fleet(engine.init_fleet(cfg, s, "cpu"), xs, ys, cfg, mode="train_phase")

    sh = engine.split_fleet(engine.init_fleet(cfg, s, "cpu"), cfg, n_shards=4,
                            devices=["cpu"] * 4)
    sh, _ = engine.run_fleet_shards(sh, xs[:cut], ys[:cut], cfg, mode="train_phase")
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(cut, snapshot.state_to_tree(engine.merge_fleet(sh)))
    tree = snapshot.state_to_tree(engine.init_fleet(cfg, 1, "cpu"))
    shardings = {g: {k: torch.device("cpu") for k in leaves} for g, leaves in tree.items()}
    step, restored = mgr.restore(shardings=shardings)
    assert step == cut
    state = EngineState(*(type(getattr(ref, g))(**restored[g]) for g in EngineState._fields))
    sh2 = engine.split_fleet(state, cfg, n_shards=2, devices=["cpu"] * 2)
    assert sh2.bounds == ((0, 15), (15, 30))
    sh2, _ = engine.run_fleet_shards(sh2, xs[cut:], ys[cut:], cfg, mode="train_phase")
    got = engine.merge_fleet(sh2)
    for g in EngineState._fields:
        for a, b in zip(getattr(got, g), getattr(ref, g)):
            assert a.dtype == b.dtype and torch.equal(a, b), g


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_tensors_save_after_the_queued_work(cuda_device, tmp_path):
    """Tensors on the card are copied to the host after the work queued on
    the current stream has written them, and a delta of card tensors
    diffs by their bytes."""
    mgr = CheckpointManager(str(tmp_path), keep=4, full_every=4)
    big = torch.zeros((4096, 4096), device="cuda")
    big.add_(1.0)  # queued; save must see it
    mgr.save_async(1, {"big": big, "small": torch.ones(3, device="cuda")})
    big.add_(1.0)
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore()[1]["big"], 1.0)
    mgr.save(2, {"big": big, "small": torch.ones(3, device="cuda")})
    assert _npy_names(tmp_path, 2) == ["big.npy"]
    np.testing.assert_array_equal(mgr.restore()[1]["big"], 2.0)


def test_token_stream_determinism_and_sharding():
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig

    cfg = TokenStreamConfig(vocab_size=128, seq_len=16, global_batch=8)
    a = TokenStream(cfg).batch(3)
    b = TokenStream(cfg).batch(3)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])  # seekable/deterministic
    assert a["tokens"].shape == (8, 16)
    assert (a["labels"][:, :-1] == a["tokens"][:, 1:]).all()

    # Host sharding: two hosts' batches differ, shapes halve.
    h0 = TokenStream(TokenStreamConfig(128, 16, 8, n_hosts=2, host=0)).batch(3)
    h1 = TokenStream(TokenStreamConfig(128, 16, 8, n_hosts=2, host=1)).batch(3)
    assert h0["tokens"].shape == (4, 16)
    assert not (h0["tokens"] == h1["tokens"]).all()
