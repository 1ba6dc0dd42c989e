"""The port's backbones (``repro_torch.configs``, ``repro_torch.models``),
held against the JAX package's (``repro.configs``, ``repro.models``).

Configs are data: ``ARCH_IDS`` and every field of every arch's full and
smoke config are equal, and the five dense archs count the reference's
parameters.  Layers take the same numpy inputs in both packages: f32
results within 1e-6, bf16 results within one bf16 ulp of the reference's
(relative 2^-8 of the value, plus 2^-8 of the row's scale for values that
cancel).  Attention: the port's naive and chunked algorithms against each
other over the reference's grid (``tests/test_attention_impl.py``, atol
2e-5, rtol 1e-4, f32 inputs) and each against the JAX function, and
``gqa_decode`` in ``onehot``, ``dus`` and ``ring`` mode against it.

The stack, for each dense arch at smoke width, takes the JAX package's
params through ``convert.lm_params_from_numpy`` and the same numpy tokens
in both packages: ``lm_hidden``, ``lm_prefill`` (hidden and every cache
leaf) and 8 tokens of ``lm_decode_hidden`` fed the same tokens (never each
package's own argmax: a near-tie in bf16 logits would send the two down
different paths).  Hidden states and logits are bf16 results of two
frameworks whose matmuls round differently, held as the reference holds
its own naive-against-chunked check: Frobenius relative error < 3e-2 and
max abs < 0.15 (worst seen over the five archs, with one thread and four:
0.016 and 0.133).  Logits (up to ~5) and cache leaves (K and V before any
norm, rms ~5) are not at unit scale: the same Frobenius bound, and a worst
difference under 10 % of the array's largest magnitude (worst seen: 3.0 %
for the logits, 1.0 % for the cache leaves).  Both packages take one
params tree drawn with numpy per leaf from a seed (``numpy_params``): the
JAX package's ``init_params`` seeds leaves with the salted ``hash()`` and
differs from process to process.  The port's decode of token S-1 equals its prefill over S tokens
within the reference's own bounds (atol 0.15, rtol 0.05).

Tests marked ``cuda`` run on the card and skip elsewhere:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_models.py
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import labels  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
DENSE = ("qwen3-4b", "h2o-danube-1.8b", "mistral-nemo-12b", "deepseek-coder-33b",
         "chameleon-34b")
# The JAX package's layers.count_params(build_schema(get_config(a))).
FULL_PARAMS = {
    "qwen3-4b": 4_411_424_256,
    "h2o-danube-1.8b": 1_831_201_280,
    "mistral-nemo-12b": 12_247_782_400,
    "deepseek-coder-33b": 33_342_991_360,
    "chameleon-34b": 34_293_436_416,
}
FRO_REL, MAX_ABS = 3e-2, 0.15  # bf16 stack against the JAX package (see above)
# Logits and cache leaves: worst seen 3.0 % of the array's largest
# magnitude (cache leaves 1.0 %, two bf16 ulps at their largest value).
SCALED_MAX_REL = 0.1
BF16_ULP = 2.0 ** -8


def _jax():
    return pytest.importorskip("jax")


def _np32(a):
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _bf16_close(got, want, what):
    """Within one bf16 ulp of the reference's value (relative 2^-8), plus
    2^-8 of the array's scale where a value cancels towards 0."""
    got, want = _np32(got), _np32(want)
    tol = BF16_ULP * (np.abs(want) + np.abs(want).max())
    bad = np.abs(got - want) > tol
    assert not bad.any(), f"{what}: {bad.sum()} values beyond one bf16 ulp"


def _stats_close(got, want, what, fro=FRO_REL, max_abs=MAX_ABS):
    a, b = _np32(want), _np32(got)
    rel = np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30)
    worst = np.abs(a - b).max()
    assert rel < fro, f"{what}: Frobenius relative error {rel:.4f}"
    assert worst < max_abs, f"{what}: max abs diff {worst:.4f}"


def _scaled_close(got, want, what):
    """Logits and cache leaves (K and V before any norm) are not at the
    hidden states' unit scale (logits reach ~5, K and V an rms of ~5):
    Frobenius relative error < 3e-2, and the worst difference under
    SCALED_MAX_REL of the array's largest magnitude."""
    a, b = _np32(want), _np32(got)
    _stats_close(got, want, what, max_abs=np.inf)
    worst = np.abs(a - b).max() / np.abs(a).max()
    assert worst < SCALED_MAX_REL, f"{what}: max abs diff {worst:.4f} of the array's max"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


def test_arch_ids_equal_the_reference():
    _jax()
    from repro import configs as j_configs

    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    for a in configs.ARCH_IDS:
        assert [(s.name, ok) for s, ok, _ in configs.cells(a)] == \
            [(s.name, ok) for s, ok, _ in j_configs.cells(a)]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_config_field_equals_the_reference(arch):
    _jax()
    from repro import configs as j_configs

    for variant in ("full", "smoke"):
        got = dataclasses.asdict(configs.get_config(arch, variant))
        want = dataclasses.asdict(j_configs.get_config(arch, variant))
        assert got == want, (arch, variant)
        assert configs.get_config(arch, variant).resolved_head_dim == \
            j_configs.get_config(arch, variant).resolved_head_dim


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_param_counts(arch):
    cfg = configs.get_config(arch, "full")
    assert layers.count_params(model_lib.build_schema(cfg)) == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b", "mamba2-780m",
                                  "recurrentgemma-9b", "whisper-small"])
def test_families_not_ported_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 6"):
        model_lib.build_schema(configs.get_config(arch, "smoke"))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _rng_arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_against_the_reference(dtype):
    _jax()
    import jax.numpy as jnp
    from repro.models import layers as j_layers

    x, w, b = _rng_arrays(0, (3, 5, 64), (64,), (64,))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    for name, got, want in (
        ("rmsnorm", layers.rmsnorm(tx, torch.as_tensor(w)), j_layers.rmsnorm(jx, jnp.asarray(w))),
        ("layernorm", layers.layernorm(tx, torch.as_tensor(w), torch.as_tensor(b)),
         j_layers.layernorm(jx, jnp.asarray(w), jnp.asarray(b))),
    ):
        assert got.dtype == tx.dtype
        if dtype == "float32":
            np.testing.assert_allclose(_np32(got), _np32(want), atol=1e-6, rtol=1e-6, err_msg=name)
        else:
            _bf16_close(got, want, name)


def test_mlps_against_the_reference():
    _jax()
    import jax.numpy as jnp
    from repro.models import layers as j_layers

    x, wg, wu, wd = _rng_arrays(1, (2, 4, 64), (64, 128), (64, 128), (128, 64))
    wg, wu, wd = (a / 8.0 for a in (wg, wu, wd))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.as_tensor(x).bfloat16()
    t = [torch.as_tensor(a) for a in (wg, wu, wd)]
    j = [jnp.asarray(a) for a in (wg, wu, wd)]
    _bf16_close(layers.swiglu(tx, *t), j_layers.swiglu(jx, *j), "swiglu")
    _bf16_close(layers.gelu_mlp(tx, t[0], t[2]), j_layers.gelu_mlp(jx, j[0], j[2]), "gelu_mlp")


def test_rope_embedding_and_loss_against_the_reference():
    _jax()
    import jax.numpy as jnp
    from repro.models import layers as j_layers

    (x,) = _rng_arrays(2, (2, 7, 4, 16))
    pos = np.random.default_rng(3).integers(0, 1000, (2, 7)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            _np32(layers.rope_frequencies(16, theta)), _np32(j_layers.rope_frequencies(16, theta)),
            rtol=1e-6, atol=0)
        got = layers.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
        want = j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        # cos/sin of angles up to ~1000 rad: the two libraries' f32 argument
        # reductions differ by an ulp of the angle.
        np.testing.assert_allclose(_np32(got), _np32(want), atol=2e-4, rtol=0)
        _bf16_close(layers.apply_rope(torch.as_tensor(x).bfloat16(), torch.as_tensor(pos), theta),
                    j_layers.apply_rope(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                                        theta), "apply_rope bf16")
    np.testing.assert_array_equal(_np32(layers.sinusoidal_embedding(33, 16, CPU)),
                                  _np32(j_layers.sinusoidal_embedding(33, 16)))
    (logits,) = _rng_arrays(4, (3, 5, 50))
    lab = np.random.default_rng(5).integers(0, 50, (3, 5)).astype(np.int32)
    np.testing.assert_allclose(
        float(layers.softmax_cross_entropy(torch.as_tensor(logits), torch.as_tensor(lab))),
        float(j_layers.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab))),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _qkv_rand(seed, b, sq, sk, kv, g, hd):
    return _rng_arrays(seed, (b, sq, kv, g, hd), (b, sk, kv, hd), (b, sk, kv, hd))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_chunked_matches_naive_and_the_reference(causal, window, chunk):
    b, s, kv, g, hd = 2, 64, 2, 2, 16
    q, k, v = _qkv_rand(0, b, s, s, kv, g, hd)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    tq, tk, tv, tp = (torch.as_tensor(a) for a in (q, k, v, pos))
    bias = attention._mask_bias(tp, tp, causal, window)
    naive = attention._grouped_attention(tq, tk, tv, bias)
    chunked = attention._chunked_grouped_attention(tq, tk, tv, tp, tp, causal, window, chunk)
    np.testing.assert_allclose(_np32(chunked), _np32(naive), atol=2e-5, rtol=1e-4)

    _jax()
    import jax.numpy as jnp
    from repro.models import attention as j_attn

    jq, jk, jv, jp = (jnp.asarray(a) for a in (q, k, v, pos))
    np.testing.assert_array_equal(_np32(bias), _np32(j_attn._mask_bias(jp, jp, causal, window)))
    want = j_attn._grouped_attention(jq, jk, jv, j_attn._mask_bias(jp, jp, causal, window))
    np.testing.assert_allclose(_np32(naive), _np32(want), atol=2e-5, rtol=1e-4)
    want_c = j_attn._chunked_grouped_attention(jq, jk, jv, jp, jp, causal, window, chunk)
    np.testing.assert_allclose(_np32(chunked), _np32(want_c), atol=2e-5, rtol=1e-4)


def numpy_params(schema, iter_leaves, seed):
    """A params tree of numpy f32 arrays for a schema of either package, drawn
    per leaf from ``seed`` and the leaf's path: matmul and embedding weights
    at their init scale, norm weights small and nonzero (so ``1 + w`` is
    exercised).  The JAX package's ``init_params`` seeds leaves with the
    salted ``hash()`` and so differs from process to process; these do not."""
    out = {}
    for path, leaf in iter_leaves(schema):
        sub = out
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        rng = np.random.default_rng([seed, *map(ord, "/".join(path))])
        if leaf.init in ("zeros", "ones"):
            std = 0.1
        elif leaf.init == "embed":
            std = 1.0
        else:
            std = leaf.scale or 1.0 / np.sqrt(max(leaf.shape[0] if len(leaf.shape) > 1
                                                  else leaf.shape[-1], 1))
        sub[path[-1]] = (rng.standard_normal(leaf.shape) * std).astype(np.float32)
    return out


def _j_params(arch, seed=1):
    """The JAX package's config and params (numpy, see ``numpy_params``)."""
    import jax.numpy as jnp

    from repro import configs as j_configs
    from repro.models import model as j_model

    cfg = j_configs.get_config(arch, "smoke")
    tree = numpy_params(j_model.build_schema(cfg), j_model.layers._iter_leaves, seed)

    def to_jax(t):
        return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in t.items()}

    return cfg, to_jax(tree)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("arch,cache_update", [("qwen3-4b", "onehot"), ("qwen3-4b", "dus"),
                                               ("h2o-danube-1.8b", "onehot")])
def test_gqa_decode_against_the_reference(arch, cache_update):
    """One decode step of layer 0's attention, in ``onehot``, ``dus`` and
    ``ring`` (h2o-danube's 16-slot window) mode: the output and both cache
    leaves against the JAX package's."""
    _jax()
    import jax.numpy as jnp
    from repro.models import attention as j_attn

    j_cfg, j_params = _j_params(arch)
    j_cfg = j_cfg.replace(cache_update=cache_update)
    cfg = configs.get_config(arch, "smoke").replace(cache_update=cache_update)
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    ring = cfg.sliding_window is not None
    b, slots, d = 3, 16, cfg.d_model
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, 1, d)).astype(np.float32)
    k0, v0 = _rng_arrays(8, (b, slots, cfg.n_kv_heads, cfg.resolved_head_dim),
                         (b, slots, cfg.n_kv_heads, cfg.resolved_head_dim))
    # Ring: positions past the window wrap; full cache: positions inside it
    # (dus writes every stream at the first stream's position).
    pos = np.array([21, 21, 21] if cache_update == "dus" else ([5, 19, 40] if ring else [0, 7, 15]),
                   np.int32)
    j_lp = {k: v[0] for k, v in j_params["layers"]["attn"].items()}
    lp = transformer._layer(params["layers"], 0)["attn"]
    j_out, j_cache = j_attn.gqa_decode(
        jnp.asarray(x).astype(jnp.bfloat16), j_lp, j_cfg,
        {"k": jnp.asarray(k0).astype(jnp.bfloat16), "v": jnp.asarray(v0).astype(jnp.bfloat16)},
        jnp.asarray(pos), ring=ring)
    cache = {"k": torch.as_tensor(k0).bfloat16(), "v": torch.as_tensor(v0).bfloat16()}
    out, new_cache = attention.gqa_decode(torch.as_tensor(x).bfloat16(), lp, cfg, cache,
                                          torch.as_tensor(pos), ring=ring)
    assert new_cache["k"] is cache["k"]  # written in place
    _stats_close(out, j_out, "gqa_decode out")
    for leaf in ("k", "v"):
        _bf16_close(new_cache[leaf], j_cache[leaf], f"cache {leaf}")


# ---------------------------------------------------------------------------
# The stack against the JAX package
# ---------------------------------------------------------------------------

B, S, DECODE = 2, 24, 8


@pytest.mark.parametrize("arch", DENSE)
def test_stack_against_the_reference(arch):
    """lm_hidden, lm_prefill (hidden + every cache leaf) and 8 decode steps
    fed the same tokens, each against the JAX package."""
    jax = _jax()
    import jax.numpy as jnp
    from repro import engine as j_engine
    from repro.models import model as j_model
    from repro.models import transformer as j_tr

    j_cfg, j_params = _j_params(arch)
    cfg = configs.get_config(arch, "smoke")
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (DECODE, B, 1)).astype(np.int32)
    max_len = S + DECODE

    j_h, _ = j_tr.lm_hidden(j_params, jnp.asarray(toks), j_cfg, remat=False)
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
    for leaf in ("k", "v"):
        assert tuple(caches["layers"][leaf].shape) == tuple(j_caches["layers"][leaf].shape)
        _scaled_close(caches["layers"][leaf], j_caches["layers"][leaf], f"{arch} cache {leaf}")

    # Decode from the JAX package's own prefill state (converted), so each
    # step compares the decode alone.
    st = convert.serve_state_from_numpy(
        j_model.ServeState(caches=j_caches, pos=j_pos,
                           odl=j_engine.init_fleet(j_model.core_config(j_cfg), B)), CPU)
    j_step = jax.jit(lambda p, t, c, q: j_tr.lm_decode_hidden(p, t, c, q, j_cfg))
    jc, jq = j_caches, j_pos
    tc, tq = st.caches, st.pos
    for i in range(DECODE):
        j_hd, jc = j_step(j_params, jnp.asarray(feed[i]), jc, jq)
        hd, tc = transformer.lm_decode_hidden(params, torch.as_tensor(feed[i]), tc, tq, cfg)
        jq, tq = jq + 1, tq + 1
        _stats_close(hd, j_hd, f"{arch} decode step {i}")
    for leaf in ("k", "v"):
        _scaled_close(tc["layers"][leaf], jc["layers"][leaf], f"{arch} decoded cache {leaf}")


@pytest.mark.parametrize("arch", ["qwen3-4b", "h2o-danube-1.8b"])
def test_decode_matches_prefill(arch):
    """The port's own check (``tests/test_arch_smoke.py``'s): decode of token
    S-1 after a prefill of S-1 tokens gives lm_hidden's logits at S-1."""
    cfg = configs.get_config(arch, "smoke")
    params = model_lib.build_params(cfg, seed=1, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 32)))
    hidden_all, _ = transformer.lm_hidden(params, toks, cfg)
    full = transformer.lm_logits(params, hidden_all, cfg)[:, -1]
    _, st = model_lib.prefill(params, toks[:, :31], cfg, max_len=32)
    logits, st2, odl = model_lib.serve_step(params, st, toks[:, 31:], cfg)
    np.testing.assert_allclose(_np32(logits), _np32(full), atol=0.15, rtol=0.05)
    assert logits.shape == (B, cfg.vocab_size)
    assert odl.queried.shape == (B,) and int(st2.pos[0]) == 32


def test_chunked_attention_in_the_stack():
    """Naive against chunked attention through the whole smoke model: the
    reference's ``test_full_model_naive_vs_chunked`` bounds."""
    cfg = configs.get_config("qwen3-4b", "smoke").replace(attention_impl="chunked",
                                                          attention_chunk=16)
    params = model_lib.build_params(cfg, seed=0, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32)))
    h1, _ = transformer.lm_hidden(params, toks, cfg.replace(attention_impl="naive"))
    h2, _ = transformer.lm_hidden(params, toks, cfg)
    _stats_close(h2, h1, "naive vs chunked")


def test_chunked_divergence_with_depth_matches_the_reference(capsys):
    """Naive and chunked attention round the softmax at different points
    (normalized probabilities in bf16, against unnormalized ones divided at
    the end), and the difference compounds with depth: through 36 layers
    (qwen3-4b's depth at smoke width, 512 tokens, chunk 128) the JAX
    package's own two algorithms differ by a Frobenius relative error of
    ~0.049 (max abs ~0.86), beyond the 2-layer bounds above.  The port's
    two algorithms must differ as the reference's do: Frobenius within
    1.25x and max abs within 2x of the JAX package's on the same params and
    tokens (measured: 0.0492 against 0.0485, 0.50 against 0.86)."""
    jax = _jax()
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.models import model as j_model
    from repro.models import transformer as j_tr

    j_cfg = j_configs.get_config("qwen3-4b", "smoke").replace(n_layers=36)
    cfg = configs.get_config("qwen3-4b", "smoke").replace(n_layers=36)
    tree = numpy_params(j_model.build_schema(j_cfg), j_model.layers._iter_leaves, 3)
    params = convert.lm_params_from_numpy(tree, cfg, CPU)
    j_params = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 512)).astype(np.int32)
    chunked = dict(attention_impl="chunked", attention_chunk=128)
    j_fn = jax.jit(lambda p, t, c: j_tr.lm_hidden(p, t, c, remat=False)[0], static_argnums=2)
    j_naive = _np32(j_fn(j_params, jnp.asarray(toks), j_cfg))
    j_chunk = _np32(j_fn(j_params, jnp.asarray(toks), j_cfg.replace(**chunked)))
    naive = _np32(transformer.lm_hidden(params, torch.as_tensor(toks), cfg)[0])
    chunk = _np32(transformer.lm_hidden(params, torch.as_tensor(toks), cfg.replace(**chunked))[0])

    def div(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(a), np.abs(a - b).max()

    (j_fro, j_max), (fro, worst) = div(j_naive, j_chunk), div(naive, chunk)
    with capsys.disabled():
        print(f"\nnaive vs chunked through 36 layers: JAX Frobenius {j_fro:.4f} max {j_max:.4f}; "
              f"port Frobenius {fro:.4f} max {worst:.4f}")
    assert j_fro > 3e-2  # the reference's own algorithms part beyond the 2-layer bound
    assert fro < 1.25 * j_fro and worst < 2 * j_max


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_DIGEST = """
import hashlib, sys
sys.path.insert(0, {src!r})
import torch
from repro_torch import configs
from repro_torch.models import layers, model
p = layers.init_params(model.build_schema(configs.get_config("qwen3-4b", "smoke")), 7, "cpu")
h = hashlib.sha256()
for path, _ in layers._iter_leaves(model.build_schema(configs.get_config("qwen3-4b", "smoke"))):
    t = p
    for k in path:
        t = t[k]
    h.update(t.numpy().tobytes())
print(h.hexdigest())
"""


def test_init_params_is_the_same_in_two_processes():
    """Per-leaf generators seeded from the path's CRC, never the salted
    ``hash()``: two processes (different hash salts) draw the same bits."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = []
    for salt in ("1", "2"):
        env["PYTHONHASHSEED"] = salt
        r = subprocess.run([sys.executable, "-c", _DIGEST.format(src=str(ROOT / "src"))],
                           capture_output=True, text=True, timeout=120, env=env)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip())
    assert outs[0] == outs[1]


def test_init_params_leaf_statistics():
    cfg = configs.get_config("qwen3-4b", "smoke").replace(vocab_size=4096)
    schema = model_lib.build_schema(cfg)
    params = layers.init_params(schema, 3, CPU)
    for path, leaf in layers._iter_leaves(schema):
        t = params
        for k in path:
            t = t[k]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        if leaf.std is None:
            assert bool((t == (1.0 if leaf.init == "ones" else 0.0)).all()), path
            continue
        n = t.numel()
        assert abs(float(t.mean())) < 5 * leaf.std / np.sqrt(n), path
        assert abs(float(t.std()) / leaf.std - 1) < 5 / np.sqrt(n) + 0.01, path
    served = model_lib.build_params(cfg, 3, CPU)
    assert served["embed"].dtype == torch.bfloat16
    assert served["layers"]["ln1"].dtype == torch.float32
    assert torch.equal(served["embed"], params["embed"].bfloat16())


# ---------------------------------------------------------------------------
# Labels and tokens
# ---------------------------------------------------------------------------


def test_teachers_and_acquire_against_the_reference():
    _jax()
    import jax.numpy as jnp
    from repro.core import labels as j_labels

    lab = np.array([3, 1, 4, 1, 5, 2], np.int32)
    idx = np.array([5, 0, 2], np.int32)
    (x,) = _rng_arrays(9, (3, 6))
    q = np.array([True, False, True])
    t_arr = labels.ArrayTeacher(torch.as_tensor(lab))
    j_arr = j_labels.ArrayTeacher(jnp.asarray(lab))
    t_mod = labels.ModelTeacher(lambda f: torch.argmax(f, -1))
    j_mod = j_labels.ModelTeacher(lambda f: jnp.argmax(f, -1))
    for t_teacher, j_teacher in ((t_arr, j_arr), (t_mod, j_mod)):
        t, y, meter = labels.acquire(t_teacher, torch.as_tensor(idx), torch.as_tensor(x),
                                     torch.as_tensor(q), 6, labels.CommMeter.zero(CPU))
        jt, jy, jmeter = j_labels.acquire(j_teacher, jnp.asarray(idx), jnp.asarray(x),
                                          jnp.asarray(q), 6, j_labels.CommMeter.zero())
        np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(meter.up_bytes.numpy(), np.asarray(jmeter.up_bytes))
        np.testing.assert_array_equal(meter.down_bytes.numpy(), np.asarray(jmeter.down_bytes))


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_token_stream_batches_equal_the_reference(host, n_hosts):
    _jax()
    from repro.data import tokens as j_tokens

    kw = dict(vocab_size=300, seq_len=12, global_batch=4, n_domains=6, seed=5,
              n_hosts=n_hosts, host=host)
    mine = tokens.TokenStream(tokens.TokenStreamConfig(**kw))
    ref = j_tokens.TokenStream(j_tokens.TokenStreamConfig(**kw))
    assert mine._tables.tobytes() == ref._tables.tobytes()
    for step in (0, 3):
        a, b = mine.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_decode_matches_the_cpu_on_the_same_weights(cuda_device):
    """The same weights (built once on the CPU, copied to the card) decode
    within the bf16 stack bounds on both devices, and the card's decode
    equals its own prefill (6k (b) at smoke width)."""
    cfg = configs.get_config("qwen3-4b", "smoke")
    cpu_params = model_lib.build_params(cfg, seed=1, device=CPU)
    card_params = _to(cpu_params, cuda_device)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16)))
    outs = {}
    for dev, p in ((CPU, cpu_params), (cuda_device, card_params)):
        t = toks.to(dev)
        _, st = model_lib.prefill(p, t[:, :15], cfg, max_len=32)
        logits, st2, odl = model_lib.serve_step(p, st, t[:, 15:], cfg)
        h_all, _ = transformer.lm_hidden(p, t, cfg)
        full = transformer.lm_logits(p, h_all, cfg)[:, -1]
        np.testing.assert_allclose(_np32(logits), _np32(full), atol=0.15, rtol=0.05)
        outs[str(dev)] = logits
    _stats_close(outs[str(cuda_device)], outs[CPU], "card vs cpu logits")


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
