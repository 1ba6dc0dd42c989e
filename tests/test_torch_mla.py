"""The port's multi-head latent attention (``repro_torch.models.attention``,
MLA half) held against the JAX package's, on the same numpy inputs and one
numpy params tree (``test_torch_models.numpy_params``) at deepseek-v2-236b's
smoke width.

``mla_schema`` leaf for leaf; ``mla_attention`` and its ``return_kv``
latent (``ckv``, ``k_rope``) against the JAX function; ``mla_decode`` in
``onehot`` and ``dus`` mode against it, as ``gqa_decode`` is held in
``tests/test_torch_models.py``: the output within the bf16 stack bounds
(Frobenius < 3e-2, max abs < 0.15), the latent cache leaves within one
bf16 ulp, written in place.  The latent cache of a whole prefill is held in
``tests/test_torch_moe.py``'s stack test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402

from test_torch_models import (  # noqa: E402
    _bf16_close, _j_params, _np_tree, _rng_arrays, _stats_close)

CPU = "cpu"
ARCH = "deepseek-v2-236b"


def _jax():
    return pytest.importorskip("jax")


def test_mla_schema_equals_the_reference():
    _jax()
    from repro import configs as j_configs
    from repro.models import attention as j_attn
    from repro.models import layers as j_layers

    for variant in ("smoke", "full"):
        got = list(layers._iter_leaves(attention.mla_schema(configs.get_config(ARCH, variant))))
        want = list(j_layers._iter_leaves(j_attn.mla_schema(j_configs.get_config(ARCH, variant))))
        assert [(p, leaf.shape, leaf.axes, leaf.init, leaf.scale) for p, leaf in got] == \
            [(p, leaf.shape, leaf.axes, leaf.init, leaf.scale) for p, leaf in want]


def _layer0(j_params, params):
    j_lp = {k: v[0] for k, v in j_params["layers"]["attn"].items()}
    return j_lp, transformer._layer(params["layers"], 0)["attn"]


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_against_the_reference(causal):
    _jax()
    import jax.numpy as jnp
    from repro.models import attention as j_attn

    j_cfg, j_params = _j_params(ARCH)
    cfg = configs.get_config(ARCH, "smoke")
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    j_lp, lp = _layer0(j_params, params)
    b, s = 3, 20
    (x,) = _rng_arrays(12, (b, s, cfg.d_model))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.as_tensor(x).bfloat16()
    j_out, (j_ckv, j_rope) = j_attn.mla_attention(jx, j_lp, j_cfg, jnp.asarray(pos), causal,
                                                  return_kv=True)
    out, (ckv, k_rope) = attention.mla_attention(tx, lp, cfg, torch.as_tensor(pos), causal,
                                                 return_kv=True)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, cfg.d_model)
    assert ckv.shape == (b, s, cfg.kv_lora_rank) and k_rope.shape == (b, s, cfg.qk_rope_dim)
    _stats_close(out, j_out, "mla_attention out")
    _bf16_close(ckv, j_ckv, "mla_attention ckv")
    _bf16_close(k_rope, j_rope, "mla_attention k_rope")
    alone = attention.mla_attention(tx, lp, cfg, torch.as_tensor(pos), causal)
    assert torch.equal(alone, out)


@pytest.mark.parametrize("cache_update", ["onehot", "dus"])
def test_mla_decode_against_the_reference(cache_update):
    """One decode step of layer 0's MLA over a 16-slot latent cache: the
    output and both cache leaves against the JAX package's (``dus`` writes
    every stream at the first stream's position)."""
    _jax()
    import jax.numpy as jnp
    from repro.models import attention as j_attn

    j_cfg, j_params = _j_params(ARCH)
    j_cfg = j_cfg.replace(cache_update=cache_update)
    cfg = configs.get_config(ARCH, "smoke").replace(cache_update=cache_update)
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    j_lp, lp = _layer0(j_params, params)
    b, slots = 3, 16
    x, c0, r0 = _rng_arrays(13, (b, 1, cfg.d_model), (b, slots, cfg.kv_lora_rank),
                            (b, slots, cfg.qk_rope_dim))
    pos = np.array([9, 9, 9] if cache_update == "dus" else [0, 7, 15], np.int32)
    j_out, j_cache = j_attn.mla_decode(
        jnp.asarray(x).astype(jnp.bfloat16), j_lp, j_cfg,
        {"ckv": jnp.asarray(c0).astype(jnp.bfloat16),
         "k_rope": jnp.asarray(r0).astype(jnp.bfloat16)}, jnp.asarray(pos))
    cache = {"ckv": torch.as_tensor(c0).bfloat16(), "k_rope": torch.as_tensor(r0).bfloat16()}
    out, new_cache = attention.mla_decode(torch.as_tensor(x).bfloat16(), lp, cfg, cache,
                                          torch.as_tensor(pos))
    assert new_cache["ckv"] is cache["ckv"] and new_cache["k_rope"] is cache["k_rope"]
    _stats_close(out, j_out, f"mla_decode out ({cache_update})")
    for leaf in ("ckv", "k_rope"):
        _bf16_close(new_cache[leaf], j_cache[leaf], f"mla cache {leaf} ({cache_update})")


def test_mla_init_cache_and_decode_bias():
    """The latent cache's shapes and dtype equal the reference's, and a
    step's shared bias (``decode_bias``, made once for every layer) gives
    the output the per-call mask gives."""
    _jax()
    from repro import configs as j_configs
    from repro.models import attention as j_attn

    cfg = configs.get_config(ARCH, "smoke")
    got = attention.mla_init_cache(cfg, 5, 12, device=CPU)
    want = j_attn.mla_init_cache(j_configs.get_config(ARCH, "smoke"), 5, 12)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in got.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    params = layers.init_params(attention.mla_schema(cfg), 2, CPU, dtype=layers.serving_dtype)
    pos = torch.tensor([3, 5, 0, 11, 7], dtype=torch.int32)
    x = torch.randn((5, 1, cfg.d_model), generator=torch.Generator().manual_seed(4)).bfloat16()
    outs = []
    for bias in (None, attention.decode_bias(pos, 12, ring=False)):
        cache = attention.mla_init_cache(cfg, 5, 12, device=CPU)
        outs.append(attention.mla_decode(x, params, cfg, cache, pos, bias=bias)[0])
    assert torch.equal(outs[0], outs[1])


def test_mla_decode_ignores_the_sliding_window():
    """MLA decode masks causally only, whatever ``cfg.sliding_window`` is, as
    the reference's does: with a window of 8 and positions past it, one
    step of layer 0's MLA against the JAX package's, and the stack's decode
    step (one shared bias for every layer) bit for bit as without the
    window."""
    _jax()
    import jax.numpy as jnp
    from repro.models import attention as j_attn
    from repro_torch.models import model as model_lib

    j_cfg, j_params = _j_params(ARCH)
    j_cfg = j_cfg.replace(sliding_window=8)
    cfg = configs.get_config(ARCH, "smoke").replace(sliding_window=8)
    params = convert.lm_params_from_numpy(_np_tree(j_params), cfg, CPU)
    j_lp, lp = _layer0(j_params, params)
    b, slots = 3, 16
    x, c0, r0 = _rng_arrays(14, (b, 1, cfg.d_model), (b, slots, cfg.kv_lora_rank),
                            (b, slots, cfg.qk_rope_dim))
    pos = np.array([9, 12, 15], np.int32)
    j_out, _ = j_attn.mla_decode(
        jnp.asarray(x).astype(jnp.bfloat16), j_lp, j_cfg,
        {"ckv": jnp.asarray(c0).astype(jnp.bfloat16),
         "k_rope": jnp.asarray(r0).astype(jnp.bfloat16)}, jnp.asarray(pos))
    cache = {"ckv": torch.as_tensor(c0).bfloat16(), "k_rope": torch.as_tensor(r0).bfloat16()}
    out, _ = attention.mla_decode(torch.as_tensor(x).bfloat16(), lp, cfg, cache,
                                  torch.as_tensor(pos))
    _stats_close(out, j_out, "mla_decode out with a sliding window set")

    toks = torch.as_tensor(np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 12)))
    logits = []
    for c in (cfg, cfg.replace(sliding_window=None)):
        _, st = model_lib.prefill(params, toks, c, max_len=16)
        logits.append(model_lib.decode_step(params, st, toks[:, -1:], c)[0])
    assert torch.equal(logits[0], logits[1])
