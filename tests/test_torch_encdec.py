"""whisper-small's encoder-decoder in the port (``models/encdec.py``,
``attention.cross_schema`` / ``cross_attention``, ``model.encdec_prefill``),
held against the JAX package's on the CPU at smoke width (2 encoder and 2
decoder layers, d_model 64, 4 heads).

One numpy params tree (``test_torch_models.numpy_params``) goes into both
packages, the port's through ``convert.lm_params_from_numpy``.  It is drawn
at the port's init scale (``Leaf.std``: 1/sqrt of the dims a weight
contracts with); the reference's scale is 1/sqrt(n_layers) = 0.71 for every
stacked leaf at smoke depth, which saturates every softmax.  The same numpy
frames and tokens go into both packages, and each result is held to
``tests/test_torch_models.py``'s stack bounds (bf16 results of two
frameworks whose matmuls round differently): hidden states within
Frobenius 3e-2 and max abs 0.15; logits and cache leaves (not at unit
scale) within Frobenius 3e-2 and 10 % of their largest magnitude.

* ``cross_schema`` and ``encdec_schema`` leaf for leaf (path, shape, axes,
  init, scale) at smoke and full width;
* ``cross_attention`` on layer 0's params, with and without ``src_valid``;
* ``encode``, ``decode_train`` and ``logits``;
* ``init_caches`` from the same encoder states, leaf by leaf;
* 8 ``decode_step``s from the JAX package's own prefill, fed the same
  tokens, and the self-attention caches after them;
* in the port alone: decode against ``decode_train``'s teacher-forced
  hidden (the reference's decode-against-prefill bounds, atol 0.15 and
  rtol 0.05), ``encdec_prefill``'s shapes and finite values (as
  ``tests/test_arch_smoke.py::test_whisper_prefill_decode``), the
  decoder-only entry points raising for whisper and pointing to
  ``encdec_prefill``, and ``convert`` carrying a whisper tree;
* the training loop's frames byte-equal to the reference's draw.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import attention, encdec, layers, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

from test_torch_models import (  # noqa: E402
    _j_params, _np32, _np_tree, _scaled_close, _stats_close)

CPU = "cpu"
ARCH = "whisper-small"
B, T, S, DECODE = 2, 24, 12, 8


def _jax():
    return pytest.importorskip("jax")


def _port_std():
    leaves = dict(layers._iter_leaves(model_lib.build_schema(configs.get_config(ARCH, "smoke"))))
    return lambda path: leaves[path].std


def _leaf_tuples(schema, iter_leaves):
    return [(p, leaf.shape, leaf.axes, leaf.init, leaf.scale) for p, leaf in iter_leaves(schema)]


@pytest.fixture(scope="module")
def pair():
    """The JAX package's config and params, the port's from the same numpy
    tree, and numpy frames (B, T, d) and tokens (B, S)."""
    _jax()
    j_cfg, j_params = _j_params(ARCH, std_of=_port_std())
    cfg = configs.get_config(ARCH, "smoke")
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    rng = np.random.default_rng(21)
    frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return j_cfg, j_params, cfg, params, frames, toks


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_cross_and_encdec_schemas_equal_the_reference(variant):
    _jax()
    from repro import configs as j_configs
    from repro.models import attention as j_attn
    from repro.models import encdec as j_encdec
    from repro.models import layers as j_layers

    cfg, j_cfg = configs.get_config(ARCH, variant), j_configs.get_config(ARCH, variant)
    assert _leaf_tuples(attention.cross_schema(cfg), layers._iter_leaves) == \
        _leaf_tuples(j_attn.cross_schema(j_cfg), j_layers._iter_leaves)
    assert _leaf_tuples(encdec.encdec_schema(cfg), layers._iter_leaves) == \
        _leaf_tuples(j_encdec.encdec_schema(j_cfg), j_layers._iter_leaves)
    assert model_lib.build_schema(cfg).keys() == j_encdec.encdec_schema(j_cfg).keys()


@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "src_valid"])
def test_cross_attention_against_the_reference(pair, masked):
    import jax.numpy as jnp
    from repro.models import attention as j_attn

    _, j_params, cfg, params, _, _ = pair
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    valid = None
    if masked:
        valid = rng.uniform(size=(B, T)) < 0.6
        valid[:, 0] = True
    j_p = {k: v[0] for k, v in j_params["dec_layers"]["cross"].items()}
    p = transformer._layer(params["dec_layers"], 0)["cross"]
    want = j_attn.cross_attention(jnp.asarray(x, jnp.bfloat16), j_p,
                                  jnp.asarray(ctx, jnp.bfloat16),
                                  None if valid is None else jnp.asarray(valid))
    got = attention.cross_attention(torch.as_tensor(x).bfloat16(), p,
                                    torch.as_tensor(ctx).bfloat16(),
                                    None if valid is None else torch.as_tensor(valid))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, S, cfg.d_model)
    _stats_close(got, want, f"cross_attention ({'src_valid' if masked else 'unmasked'})")
    if masked:  # the mask matters: without it the result moves
        free = attention.cross_attention(torch.as_tensor(x).bfloat16(), p,
                                         torch.as_tensor(ctx).bfloat16())
        assert not torch.equal(free, got)


def test_encode_decode_train_and_logits_against_the_reference(pair):
    import jax.numpy as jnp
    from repro.models import encdec as j_encdec

    j_cfg, j_params, cfg, params, frames, toks = pair
    j_enc = j_encdec.encode(j_params, jnp.asarray(frames), j_cfg, remat=False)
    enc = encdec.encode(params, torch.as_tensor(frames), cfg)
    assert enc.dtype == torch.bfloat16 and tuple(enc.shape) == (B, T, cfg.d_model)
    _stats_close(enc, j_enc, "encode")
    j_h = j_encdec.decode_train(j_params, jnp.asarray(toks), j_enc, j_cfg, remat=False)
    h = encdec.decode_train(params, torch.as_tensor(toks), enc, cfg)
    assert h.dtype == torch.bfloat16 and tuple(h.shape) == (B, S, cfg.d_model)
    _stats_close(h, j_h, "decode_train")
    _scaled_close(encdec.logits(params, h), j_encdec.logits(j_params, j_h), "logits")
    # The decoder alone, on the reference's encoder states.
    h2 = encdec.decode_train(params, torch.as_tensor(toks),
                             torch.as_tensor(_np32(j_enc)).bfloat16(), cfg)
    _stats_close(h2, j_h, "decode_train on the reference's encoder states")


def test_init_caches_against_the_reference(pair):
    import jax.numpy as jnp
    from repro.models import encdec as j_encdec

    j_cfg, j_params, cfg, params, frames, _ = pair
    j_enc = j_encdec.encode(j_params, jnp.asarray(frames), j_cfg, remat=False)
    want = j_encdec.init_caches(j_params, j_enc, j_cfg, max_len=S + DECODE)
    got = encdec.init_caches(params, torch.as_tensor(_np32(j_enc)).bfloat16(), cfg,
                             max_len=S + DECODE)
    assert got.keys() == want.keys() and got["self"].keys() == want["self"].keys()
    for name in ("k", "v"):
        w, g = want["self"][name], got["self"][name]
        assert tuple(g.shape) == tuple(w.shape) and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any() and not np.asarray(w, np.float32).any()
    for name in ("cross_k", "cross_v"):
        w, g = want[name], got[name]
        assert tuple(g.shape) == tuple(w.shape) == (cfg.n_layers, B, T, cfg.n_heads,
                                                    cfg.resolved_head_dim)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        _scaled_close(g, w, name)


def test_decode_steps_against_the_reference(pair):
    jax = _jax()
    import jax.numpy as jnp
    from repro.models import encdec as j_encdec
    from repro.models import model as j_model

    j_cfg, j_params, cfg, params, frames, toks = pair
    j_enc, j_caches = jax.jit(lambda p, f: j_model.encdec_prefill(p, f, j_cfg, S + DECODE))(
        j_params, jnp.asarray(frames))
    caches = {"self": {k: torch.as_tensor(_np32(v)).bfloat16()
                       for k, v in j_caches["self"].items()},
              "cross_k": torch.as_tensor(_np32(j_caches["cross_k"])).bfloat16(),
              "cross_v": torch.as_tensor(_np32(j_caches["cross_v"])).bfloat16()}
    j_step = jax.jit(lambda p, t, c, q: j_encdec.decode_step(p, t, c, q, j_cfg))
    jc, jq = j_caches, jnp.zeros((B,), jnp.int32)
    tq = torch.zeros((B,), dtype=torch.int32)
    for i in range(DECODE):
        tok = toks[:, i:i + 1]
        j_h, jc = j_step(j_params, jnp.asarray(tok), jc, jq)
        h, out = encdec.decode_step(params, torch.as_tensor(tok), caches, tq, cfg)
        assert out is caches and tuple(h.shape) == (B, 1, cfg.d_model)
        _stats_close(h, j_h, f"decode step {i}")
        jq, tq = jq + 1, tq + 1
    for name in ("k", "v"):
        _scaled_close(caches["self"][name], jc["self"][name], f"decoded self cache {name}")


def test_decode_matches_decode_train():
    """The port's own check: each decoded position's hidden equals the
    teacher-forced hidden there, within the reference's decode-against-
    prefill bounds."""
    cfg = configs.get_config(ARCH, "smoke")
    params = model_lib.build_params(cfg, seed=1, device=CPU)
    rng = np.random.default_rng(5)
    frames = torch.as_tensor(rng.standard_normal((B, T, cfg.d_model)).astype(np.float32))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)))
    enc, caches = model_lib.encdec_prefill(params, frames, cfg, max_len=S)
    want = encdec.decode_train(params, toks, enc, cfg)
    pos = torch.zeros((B,), dtype=torch.int32)
    for i in range(S):
        h, caches = encdec.decode_step(params, toks[:, i:i + 1], caches, pos, cfg)
        np.testing.assert_allclose(_np32(h[:, 0]), _np32(want[:, i]), atol=0.15, rtol=0.05,
                                   err_msg=f"position {i}")
        pos = pos + 1


def test_encdec_prefill_shapes_and_finite_values():
    cfg = configs.get_config(ARCH, "smoke")
    params = model_lib.build_params(cfg, seed=1, device=CPU)
    frames = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    enc, caches = model_lib.encdec_prefill(params, frames, cfg, max_len=16)
    assert tuple(enc.shape) == (B, S, cfg.d_model) and torch.isfinite(enc.float()).all()
    assert tuple(caches["self"]["k"].shape) == (cfg.n_layers, B, 16, cfg.n_kv_heads,
                                                cfg.resolved_head_dim)
    h, caches2 = encdec.decode_step(params, torch.full((B, 1), 5), caches,
                                    torch.zeros((B,), dtype=torch.int32), cfg)
    logits = encdec.logits(params, h)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    assert torch.isfinite(logits.float()).all()
    assert caches2["self"]["k"][:, :, 0].any() and not caches2["self"]["k"][:, :, 1:].any()


def test_decoder_only_entry_points_raise_for_whisper():
    """``lm_prefill`` and ``serve_step`` have no enc-dec branch (nor has the
    reference's ``serve_step``): they raise and name the enc-dec's own."""
    cfg = configs.get_config(ARCH, "smoke")
    params = model_lib.build_params(cfg, seed=0, device=CPU)
    toks = torch.zeros((B, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="encdec_prefill"):
        transformer.lm_prefill(params, toks, cfg)
    with pytest.raises(NotImplementedError, match="encdec_prefill"):
        model_lib.prefill(params, toks, cfg)
    state = model_lib.ServeState(caches={}, pos=torch.zeros((B,), dtype=torch.int32), odl=None)
    with pytest.raises(NotImplementedError, match="encdec_prefill"):
        model_lib.serve_step(params, state, toks[:, :1], cfg)
    with pytest.raises(NotImplementedError, match="encdec_prefill"):
        model_lib.init_serve_state(cfg, B, 8, device=CPU)


def test_convert_carries_a_whisper_tree(tmp_path):
    from repro_torch.runtime.checkpoint import CheckpointManager

    from test_torch_models import numpy_params

    cfg = configs.get_config(ARCH, "smoke")
    tree = numpy_params(model_lib.build_schema(cfg), layers._iter_leaves, 4)
    params = convert.lm_params_from_numpy(tree, cfg, CPU)
    assert params["dec_layers"]["cross"]["wk"].dtype == torch.bfloat16
    assert params["enc_norm"]["w"].dtype == torch.float32
    assert params["dec_layers"]["ln3"]["b"].dtype == torch.float32
    torch.testing.assert_close(params["adapter"], torch.as_tensor(tree["adapter"]).bfloat16())
    state = model_lib.init_train_state(cfg, 0, device=CPU)
    again = convert.train_state_from_numpy(convert.train_state_to_numpy(state), cfg, CPU)
    for a, b in zip(_walk(state.params), _walk(again.params), strict=True):
        assert b.dtype == torch.float32 and torch.equal(a, b)
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, state)
    _, restored = mgr.restore()
    back = convert.train_state_from_numpy(restored, cfg, CPU)
    for a, b in zip(_walk(state.params), _walk(back.params), strict=True):
        assert torch.equal(a, b)
    bad = convert.train_state_to_numpy(state)
    bad.params["dec_layers"]["cross"]["wk"] = bad.params["dec_layers"]["cross"]["wk"][:, :-1]
    with pytest.raises(ValueError, match="dec_layers/cross/wk"):
        convert.train_state_from_numpy(bad, cfg, CPU)


def _walk(tree):
    for k in tree:
        if isinstance(tree[k], dict):
            yield from _walk(tree[k])
        else:
            yield tree[k]


def test_train_frames_equal_the_reference_draw(monkeypatch):
    """Both packages' training loops, their steps replaced by a recorder:
    the frames each hands its step are the same bytes."""
    _jax()
    from repro.launch import train as j_train

    def recorder(into):
        def make_step(cfg, tcfg):
            def step(state, batch):
                into.append(np.asarray(_np32(batch["frames"])
                                       if torch.is_tensor(batch["frames"])
                                       else batch["frames"]))
                zero = {k: 0.0 for k in ("loss", "odl_query_frac", "odl_acc", "odl_theta",
                                         "grad_norm")}
                return state, zero
            return step
        return make_step

    got, want = [], []
    monkeypatch.setattr(j_train, "make_step", recorder(want))
    j_train.train(ARCH, "smoke", steps=3, batch=2, seq=8, log_every=100)
    monkeypatch.setattr(train_mod, "make_step", recorder(got))
    train_mod.train(ARCH, "smoke", steps=3, batch=2, seq=8, log_every=100, device=CPU)
    assert len(got) == len(want) == 3
    for step, (g, w) in enumerate(zip(got, want), start=1):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape == (2, 8, 64)
        assert g.tobytes() == w.tobytes() == train_mod.frames(step, 2, 8, 64).tobytes(), step
