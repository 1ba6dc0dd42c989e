"""The SSD and hybrid RG-LRU stacks in the port: mamba2-780m (the Mamba-2
SSD mixer alone) and recurrentgemma-9b (Griffin's (rec, rec, attn) groups
plus a tail, the local attention on a ring of ``sliding_window`` slots) at
smoke width, against the JAX package and through the serving path.

The stack, for each arch, takes one numpy params tree through
``convert.lm_params_from_numpy`` and the same numpy tokens in both
packages: ``lm_hidden`` and its logits, ``lm_prefill`` (hidden and every
leaf of the nested cache tree, with its dtype: f32 SSD and RG-LRU leaves,
bf16 K and V) and decode steps fed the same tokens from the JAX package's
own prefill, under ``tests/test_torch_models.py``'s stack bounds (worst
seen: Frobenius 0.015, max abs 0.09; logits and caches 2.7 % of their
largest magnitude).  mamba2's prompts are a multiple of its smoke chunk
(16) or under it; recurrentgemma's 20-token prompt overfills its 16-slot
ring, and 8 decodes wrap it again.

These trees are drawn at the port's init scale (``Leaf.std``: 1/sqrt of the
dims a weight contracts with).  At the reference's (1/sqrt(n_layers) = 0.71
for every stacked leaf at smoke depth 2) mamba2's dt reaches ~17 and
(C . B) sums cancel, so one bf16 ulp of a layer's input moves a
position-0 output by O(10): the JAX package's compiled block against its
own eager block moves it as far, and the port's eager block equals the
eager reference there bit for bit.

Serving: ``launch.serve`` (two tenants, ``--mesh-fleet 4`` on a CPU mesh),
the graphed decode tick over the nested cache tree (two sets of the
recurrent leaves, read and written in turns), the loaders of ``convert``,
decode against prefill inside the port, a recurrentgemma-9b ``decode``
tenant migrated between two port workers on the CPU, bit for bit its solo
run, and the training entry points raising on what cannot be trained on.
Tests marked ``cuda`` run on the card and skip elsewhere:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_recurrent_serve.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.engine import snapshot  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime import worker as worker_mod  # noqa: E402

from test_torch_elastic import (  # noqa: E402
    _assert_state_trees_equal, _assert_stats_equal, _decode_solo, _spawn_cpu_worker,
    _wait_live_at)
from test_torch_models import (  # noqa: E402
    _j_params, _np32, _np_tree, _scaled_close, _stats_close, numpy_params)

CPU = "cpu"
ARCHS = ("mamba2-780m", "recurrentgemma-9b")
TOKENS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _jax():
    return pytest.importorskip("jax")


def _port_std(arch):
    leaves = dict(layers._iter_leaves(model_lib.build_schema(configs.get_config(arch, "smoke"))))
    return lambda path: leaves[path].std


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# The stack against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,s,max_len,n_decode", [
    ("mamba2-780m", 32, 40, 2),  # two chunks of 16
    ("mamba2-780m", 12, 20, 2),  # one chunk, shorter than 16
    ("recurrentgemma-9b", 20, 32, 8),  # overfills and wraps the 16-slot ring
])
def test_stack_against_the_reference(arch, s, max_len, n_decode):
    jax = _jax()
    import jax.numpy as jnp
    from repro import engine as j_engine
    from repro.models import model as j_model
    from repro.models import transformer as j_tr

    j_cfg, j_params = _j_params(arch, std_of=_port_std(arch))
    cfg = configs.get_config(arch, "smoke")
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    b = 2
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (n_decode, b, 1)).astype(np.int32)

    j_h, _ = jax.jit(lambda p, t: j_tr.lm_hidden(p, t, j_cfg, remat=False))(
        j_params, jnp.asarray(toks))
    h, aux = transformer.lm_hidden(params, torch.as_tensor(toks), cfg)
    assert h.dtype == torch.bfloat16 and aux == 0.0
    _stats_close(h, j_h, f"{arch} lm_hidden")
    _scaled_close(transformer.lm_logits(params, h, cfg),
                  j_tr.lm_logits(j_params, j_h, j_cfg), f"{arch} lm_logits")

    j_hp, j_caches, j_pos = jax.jit(
        lambda p, t: j_tr.lm_prefill(p, t, j_cfg, max_len=max_len))(j_params, jnp.asarray(toks))
    hp, caches, pos = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, max_len=max_len)
    _stats_close(hp, j_hp, f"{arch} lm_prefill hidden")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    want = dict(_leaves(j_caches))
    got = dict(_leaves(caches))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        assert tuple(got[path].shape) == tuple(leaf.shape), path
        assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), path
        _scaled_close(got[path], leaf, f"{arch} cache {'/'.join(path)}")

    st = convert.serve_state_from_numpy(
        j_model.ServeState(caches=j_caches, pos=j_pos,
                           odl=j_engine.init_fleet(j_model.core_config(j_cfg), b)), CPU)
    j_step = jax.jit(lambda p, t, c, q: j_tr.lm_decode_hidden(p, t, c, q, j_cfg))
    jc, jq, tc, tq = j_caches, j_pos, st.caches, st.pos
    for i in range(n_decode):
        j_hd, jc = j_step(j_params, jnp.asarray(feed[i]), jc, jq)
        hd, tc = transformer.lm_decode_hidden(params, torch.as_tensor(feed[i]), tc, tq, cfg)
        jq, tq = jq + 1, tq + 1
        _stats_close(hd, j_hd, f"{arch} decode step {i}")
    for path, leaf in _leaves(jc):
        _scaled_close(_at(tc, path), leaf, f"{arch} decoded cache {'/'.join(path)}")


def unit_logits(params, cfg, logits):
    """Logits at the unit scale the reference's decode-against-prefill bound
    is set for (its dense check's untied lm_head drawn at 1/sqrt(d)):
    divided by sqrt(d) times the output matrix's rms, which is ~1 for such
    a head and sqrt(d) for mamba2's tied embedding drawn at std 1 (8 at
    smoke width, 39 at full width)."""
    w = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    scale = float(w.float().pow(2).mean().sqrt()) * cfg.d_model ** 0.5
    return logits.float() / scale


@pytest.mark.parametrize("arch,s", [("mamba2-780m", 16), ("recurrentgemma-9b", 20)])
def test_decode_matches_prefill(arch, s):
    """Decode of token S-1 after a prefill of S-1 tokens gives lm_hidden's
    hidden state and logits at S-1 within atol 0.15, rtol 0.05, the logits
    at unit scale (``unit_logits``: mamba2's tied logits reach ~35 at smoke
    width, and its worst difference, 0.36, is 0.045 at unit scale);
    recurrentgemma's ring of 16 slots is full and wraps at this step."""
    cfg = configs.get_config(arch, "smoke")
    params = model_lib.build_params(cfg, seed=1, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (3, s)))
    hidden_all, _ = transformer.lm_hidden(params, toks, cfg)
    full = transformer.lm_logits(params, hidden_all, cfg)[:, -1]
    _, st = model_lib.prefill(params, toks[:, :-1], cfg, max_len=32)
    hidden, _ = transformer.lm_decode_hidden(params, toks[:, -1:], _clone(st.caches), st.pos,
                                             cfg)
    np.testing.assert_allclose(_np32(hidden[:, 0]), _np32(hidden_all[:, -1]), atol=0.15,
                               rtol=0.05)
    logits, st2, odl = model_lib.serve_step(params, st, toks[:, -1:], cfg)
    np.testing.assert_allclose(_np32(unit_logits(params, cfg, logits)),
                               _np32(unit_logits(params, cfg, full)), atol=0.15, rtol=0.05)
    assert odl.queried.shape == (3,) and int(st2.pos[0]) == s


def test_init_caches_structure_and_dtypes():
    """The nested trees and dtypes of the reference's ``init_caches``."""
    _jax()
    from repro import configs as j_configs
    from repro.models import transformer as j_tr

    for arch in ARCHS:
        got = dict(_leaves(transformer.init_caches(configs.get_config(arch, "smoke"), 3, 40,
                                                   device=CPU)))
        want = dict(_leaves(j_tr.init_caches(j_configs.get_config(arch, "smoke"), 3, 40)))
        assert {p: (tuple(t.shape), str(t.dtype).split(".")[-1]) for p, t in got.items()} == \
            {p: (tuple(a.shape), str(a.dtype)) for p, a in want.items()}


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_two_tenants_reconcile(arch, capsys):
    queries, skips = serve_lib.serve(arch, "smoke", batch=4, gen_tokens=TOKENS, tenants=2,
                                     teacher_latency=2, teacher_jitter=1, device=CPU)
    assert queries + skips == 2 * TOKENS * 4
    out = capsys.readouterr().out
    assert out.count("accounting ok") == 2 and "BROKEN" not in out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_fleet_on_a_cpu_mesh_reconciles_per_shard(arch, capsys):
    queries, skips = serve_lib.serve(arch, "smoke", batch=6, gen_tokens=TOKENS, mesh_fleet=4,
                                     teacher_latency=1, device=CPU)
    assert queries + skips == TOKENS * 6
    out = capsys.readouterr().out
    assert out.count("accounting ok") == 4 and "mesh aggregate: 4 shard(s)" in out


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_feats_replay_and_follow_the_serve_step(arch):
    """``_decode_feats`` (the graphed tick on the card, eager here) over the
    nested cache tree, its recurrent leaves read and written in turns: two
    calls from one prefill are bit for bit, the prefill's caches are left
    as they were, and each tick's features are the in-place
    ``decode_step``'s on the same greedy tokens."""
    cfg = configs.get_config(arch, "smoke")
    params, prompts, state = serve_lib.build_backbone(cfg, 3, 16, 32, 5, CPU)
    before = _clone(state.caches)
    a = list(serve_lib._decode_feats(params, state, prompts, cfg, 6))
    b = list(serve_lib._decode_feats(params, state, prompts, cfg, 6))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == 6
    for path, leaf in _leaves(before):
        assert torch.equal(leaf, _at(state.caches, path)), path
    st = model_lib.ServeState(caches=_clone(before), pos=state.pos, odl=state.odl)
    token = prompts[:, -1:]
    for want in a:
        logits, feats, st = model_lib.decode_step(params, st, token, cfg)
        assert torch.equal(feats, want)
        token = torch.argmax(logits, -1)[:, None]


def test_decode_tick_is_the_same_run_twice():
    """A graph's warm-up runs the tick once before its capture: reading one
    set of recurrent leaves and writing the other, a second call on the
    same inputs writes the same values."""
    cfg = configs.get_config("mamba2-780m", "smoke")
    params, prompts, state = serve_lib.build_backbone(cfg, 2, 16, 32, 3, CPU)
    paths, leaves = zip(*serve_lib._cache_leaves(state.caches))
    read = tuple(a.clone() for a in leaves)
    written = tuple(torch.empty_like(a) for a in leaves)
    tick = serve_lib._decode_tick(params, cfg, paths)
    first = tick(*read, *written, state.pos, prompts[:, -1:])
    snap = [w.clone() for w in written]
    second = tick(*read, *written, state.pos, prompts[:, -1:])
    assert torch.equal(first.feats, second.feats)
    assert all(torch.equal(x, y) for x, y in zip(snap, written))
    assert all(torch.equal(x, y) for x, y in zip(read, leaves))


def test_convert_loads_recurrent_leaves_and_caches():
    """``lm_params_from_numpy`` walks the SSD and hybrid schemas (the
    constant-init leaves in f32, the matmul weights in bf16);
    ``serve_state_from_numpy`` of the JAX package's prefill caches keeps
    every leaf's dtype: f32 SSD and RG-LRU leaves, bf16 K and V."""
    jax = _jax()
    import jax.numpy as jnp
    from repro import engine as j_engine
    from repro.models import model as j_model
    from repro.models import transformer as j_tr

    for arch in ARCHS:
        cfg = configs.get_config(arch, "smoke")
        tree = numpy_params(model_lib.build_schema(cfg), layers._iter_leaves, 6)
        params = convert.lm_params_from_numpy(tree, cfg, CPU)
        for path, leaf in layers._iter_leaves(model_lib.build_schema(cfg)):
            assert _at(params, path).dtype == layers.serving_dtype(leaf), path
        j_cfg, j_params = _j_params(arch)
        toks = jnp.zeros((2, 16), jnp.int32)
        _, j_caches, j_pos = jax.jit(lambda p, t: j_tr.lm_prefill(p, t, j_cfg, max_len=24))(
            j_params, toks)
        st = convert.serve_state_from_numpy(
            j_model.ServeState(caches=j_caches, pos=j_pos,
                               odl=j_engine.init_fleet(j_model.core_config(j_cfg), 2)), CPU)
        for path, leaf in _leaves(j_caches):
            got = _at(st.caches, path)
            assert str(got.dtype).split(".")[-1] == str(leaf.dtype), path
            np.testing.assert_array_equal(_np32(got), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_training_entry_points_raise(arch):
    """Both stacks train (``tests/test_torch_train_families.py`` holds their
    gradients): the entry points build a TrainState and take a finite loss
    and gradient, and raise only on what cannot be trained on: a checkpoint
    tree whose recurrent leaf is misshapen, and for mamba2 a sequence that
    its chunked scan cannot split (the reference asserts it)."""
    cfg = configs.get_config(arch, "smoke")
    state = model_lib.init_train_state(cfg, device=CPU)
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int64),
             "labels": torch.zeros((2, 16), dtype=torch.int64)}
    loss, feats, grads = model_lib.loss_and_grads(state.params, batch, cfg)
    assert torch.isfinite(loss) and tuple(feats.shape) == (2, cfg.d_model)
    assert grads.keys() == state.params.keys()
    bad = convert.train_state_to_numpy(state)
    leaf = "layers/ssd/conv_w" if cfg.family == "ssm" else "groups/b0_rec/rec/w_r"
    sub = bad.params
    for k in leaf.split("/")[:-1]:
        sub = sub[k]
    sub[leaf.split("/")[-1]] = sub[leaf.split("/")[-1]][..., :-1]
    with pytest.raises(ValueError, match=leaf):
        convert.train_state_from_numpy(bad, cfg, CPU)
    if cfg.family == "ssm":
        short = {k: torch.zeros((2, cfg.ssm_chunk + 4), dtype=torch.int64) for k in batch}
        with pytest.raises(ValueError, match="not divisible by chunk"):
            model_lib.loss_and_grads(state.params, short, cfg)


def test_hybrid_decode_tenant_migrates_between_port_workers():
    """A recurrentgemma-9b ``decode`` tenant (the nested hybrid cache)
    admitted on one CPU port worker, moved to another past tick 4, ends bit
    for bit as the in-process session fed by ``_decode_feats`` (state,
    counters, label latencies)."""
    t_total, cut = 16, 4
    odl_cfg = model_lib.core_config(configs.get_config("recurrentgemma-9b", "smoke"))
    spec = worker_mod.tenant_spec(
        "hybrid_decoder", odl_cfg, s=4, mode="serve", capacity=4, backpressure="drop_oldest",
        ticks=serve_lib.decode_ticks_spec("recurrentgemma-9b", "smoke", batch=4, seed=3,
                                          t_total=t_total, tick_sleep_ms=20.0),
        teacher=worker_mod.latency_teacher_spec(n_out=odl_cfg.elm.n_out, latency=2,
                                                jitter=1, seed=3),
    )
    workers = [_spawn_cpu_worker(f"hyb{i}") for i in range(2)]
    try:
        w_a, w_b = workers
        w_a.admit(spec)
        _wait_live_at(w_a, ["hybrid_decoder"], cut)
        sent_spec, wire = w_a.extract("hybrid_decoder")
        moved_at = snapshot.ticks_consumed(snapshot.decode_snapshot(wire))
        assert cut <= moved_at < t_total
        assert w_b.admit(sent_spec, wire)["migrated"] is True
        elastic.Router([w_b]).wait_finished(["hybrid_decoder"], timeout_s=120)
        stats_wire, tree = w_b.result("hybrid_decoder")
    finally:
        for w in workers:
            w.close(shutdown=True)
    solo_state, solo_stats, _ = _decode_solo(spec, t_total)
    _assert_state_trees_equal(snapshot.state_to_tree(solo_state), tree["state"], "hybrid tenant")
    _assert_stats_equal(stats_wire, solo_stats, "hybrid tenant")
    assert stats_wire["stream_steps"] == t_total * spec["s"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_decode_matches_the_cpu_on_the_same_weights(arch, cuda_device):
    """The same weights (built on the CPU, copied to the card): each
    device's decode equals its own prefill within the reference's bounds
    (logits at unit scale, as ``test_decode_matches_prefill``), and the
    card's logits are the CPU's within the stack bounds."""
    cfg = configs.get_config(arch, "smoke")
    cpu_params = model_lib.build_params(cfg, seed=1, device=CPU)
    card_params = _to(cpu_params, cuda_device)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16)))
    outs = {}
    for dev, p in ((CPU, cpu_params), (cuda_device, card_params)):
        t = toks.to(dev)
        _, st = model_lib.prefill(p, t[:, :15], cfg, max_len=32)
        logits, _, _ = model_lib.serve_step(p, st, t[:, 15:], cfg)
        h_all, _ = transformer.lm_hidden(p, t, cfg)
        full = transformer.lm_logits(p, h_all, cfg)[:, -1]
        np.testing.assert_allclose(_np32(unit_logits(p, cfg, logits)),
                                   _np32(unit_logits(p, cfg, full)), atol=0.15, rtol=0.05)
        outs[str(dev)] = logits
    _scaled_close(outs[str(cuda_device)], outs[CPU], f"{arch} card vs cpu logits")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_two_card_decodes_bit_for_bit(arch, cuda_device):
    """Two decodes of 8 tokens from one prefill on the card, each step one
    CUDA graph replay (``_decode_feats``, two graphs: one per set of
    recurrent leaves read): bit for bit, and equal to the eager in-place
    decode within the stack bounds."""
    cfg = configs.get_config(arch, "smoke")
    params, prompts, state = serve_lib.build_backbone(cfg, 4, 16, 64, 0, cuda_device)
    a = list(serve_lib._decode_feats(params, state, prompts, cfg, 8))
    b = list(serve_lib._decode_feats(params, state, prompts, cfg, 8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    st = model_lib.ServeState(caches=_clone(state.caches), pos=state.pos, odl=state.odl)
    token = prompts[:, -1:]
    for want in a:
        logits, feats, st = model_lib.decode_step(params, st, token, cfg)
        _stats_close(feats, want, f"{arch} graphed against eager decode")
        token = torch.argmax(logits, -1)[:, None]
