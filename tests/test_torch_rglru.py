"""The port's RG-LRU block (``repro_torch.models.rglru``) held against the
JAX package's (``repro.models.rglru``) on the same numpy inputs.

- ``rglru_schema``: leaf for leaf at smoke and full width.
- ``gelu_tanh`` and ``sigmoid`` in bf16: bit for bit against
  ``jax.nn.gelu(approximate=True)`` and ``jax.nn.sigmoid`` (each step
  rounded in bf16, the constants too).
- ``_gates`` on bf16 inputs: ``a`` and ``gated`` within rtol 1e-2 of the
  reference run op by op (worst seen: 5.7e-7 for ``a``, 1.2e-7 for
  ``gated``).  Under ``jax.jit`` XLA's CPU fusion rewrites the gate chain
  and the reference moves by up to 1.2e-2 against its own eager run, so
  the jitted reference is held at the stack level only.
- ``rglru_block`` (output and cache) and three ``rglru_decode`` steps in
  bf16 against the jitted reference, under the stack bounds of
  ``tests/test_torch_models.py``.
- The doubling scan against a plain step loop, within 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs  # noqa: E402
from repro_torch.models import layers, rglru  # noqa: E402

from test_torch_models import _np32, _scaled_close, _stats_close  # noqa: E402
from test_torch_ssm import _leaf_tuple, module_params  # noqa: E402

CPU = "cpu"
ARCH = "recurrentgemma-9b"
GATES_RTOL = 1e-2


def _jax():
    return pytest.importorskip("jax")


def _params(seed=3):
    from repro import configs as j_configs
    from repro.models import rglru as j_rglru

    cfg = configs.get_config(ARCH, "smoke")
    j_cfg = j_configs.get_config(ARCH, "smoke")
    j_p, p = module_params(j_rglru.rglru_schema(j_cfg), rglru.rglru_schema(cfg), seed)
    return cfg, j_cfg, j_p, p


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_rglru_schema_equals_the_reference(variant):
    _jax()
    from repro import configs as j_configs
    from repro.models import layers as j_layers
    from repro.models import rglru as j_rglru

    mine = dict(layers._iter_leaves(rglru.rglru_schema(configs.get_config(ARCH, variant))))
    ref = dict(j_layers._iter_leaves(j_rglru.rglru_schema(j_configs.get_config(ARCH, variant))))
    assert mine.keys() == ref.keys()
    for path in ref:
        assert _leaf_tuple(mine[path]) == _leaf_tuple(ref[path]), path


def test_activations_bit_for_bit():
    jax = _jax()
    import jax.numpy as jnp

    x = (3 * np.random.default_rng(0).standard_normal(50_000)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).bfloat16()
    np.testing.assert_array_equal(
        _np32(rglru.gelu_tanh(tx)), _np32(jax.jit(lambda v: jax.nn.gelu(v, approximate=True))(jx)))
    np.testing.assert_array_equal(_np32(rglru.sigmoid(tx)), _np32(jax.jit(jax.nn.sigmoid)(jx)))


def test_gates_against_the_reference():
    _jax()
    import jax.numpy as jnp
    from repro.models import rglru as j_rglru

    cfg, _, j_p, p = _params()
    xw = np.random.default_rng(1).standard_normal((3, 20, cfg.lru_width)).astype(np.float32)
    ja, jg = j_rglru._gates(jnp.asarray(xw).astype(jnp.bfloat16), j_p)
    ta, tg = rglru._gates(torch.as_tensor(xw).bfloat16(), p)
    assert ta.dtype == tg.dtype == torch.float32
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=GATES_RTOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GATES_RTOL)


@pytest.mark.parametrize("s", [1, 5, 16, 37])
def test_linear_scan_against_a_step_loop(s):
    g = torch.Generator().manual_seed(s)
    a = torch.rand((3, s, 7), generator=g)
    b = torch.randn((3, s, 7), generator=g)
    h, want = torch.zeros((3, 7)), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1), rtol=1e-5,
                               atol=1e-5)


def test_rglru_block_and_decode_against_the_reference():
    """The block over 20 tokens with its cache, then three decode steps from
    the reference's cache, in bf16."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.models import rglru as j_rglru

    cfg, j_cfg, j_p, p = _params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20, cfg.d_model)).astype(np.float32)
    steps = rng.standard_normal((3, 3, 1, cfg.d_model)).astype(np.float32)
    j_out, j_cache = jax.jit(
        lambda p_, x_: j_rglru.rglru_block(x_, p_, j_cfg, return_cache=True))(
        j_p, jnp.asarray(x).astype(jnp.bfloat16))
    out, cache = rglru.rglru_block(torch.as_tensor(x).bfloat16(), p, cfg, return_cache=True)
    assert out.dtype == torch.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in j_cache.items()}
    _stats_close(out, j_out, "rglru_block out")
    for leaf in ("h", "conv"):
        _scaled_close(cache[leaf], j_cache[leaf], f"rglru_block cache {leaf}")

    j_step = jax.jit(lambda p_, x_, c_: j_rglru.rglru_decode(x_, p_, j_cfg, c_))
    tc = {k: torch.as_tensor(np.array(v)) for k, v in j_cache.items()}
    jc = j_cache
    for i in range(3):
        j_y, jc = j_step(j_p, jnp.asarray(steps[i]).astype(jnp.bfloat16), jc)
        y, new = rglru.rglru_decode(torch.as_tensor(steps[i]).bfloat16(), p, cfg, tc)
        assert new["h"] is tc["h"] and new["conv"] is tc["conv"]  # in place
        _stats_close(y, j_y, f"rglru_decode step {i}")
        for leaf in ("h", "conv"):
            _scaled_close(tc[leaf], jc[leaf], f"rglru_decode step {i} cache {leaf}")


def test_rglru_decode_into_a_second_cache_and_short_prompts():
    cfg = configs.get_config(ARCH, "smoke")
    p = layers.init_params(rglru.rglru_schema(cfg), 1, CPU, dtype=layers.serving_dtype)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    _, cache = rglru.rglru_block(x, p, cfg, return_cache=True)
    before = {k: v.clone() for k, v in cache.items()}
    out = {k: torch.empty_like(v) for k, v in cache.items()}
    y_out, got = rglru.rglru_decode(x[:, -1:], p, cfg, cache, out)
    assert got is out and all(torch.equal(cache[k], before[k]) for k in cache)
    y_in, _ = rglru.rglru_decode(x[:, -1:], p, cfg, cache)
    assert torch.equal(y_in, y_out) and all(torch.equal(cache[k], out[k]) for k in cache)
    with pytest.raises(ValueError, match="shorter than the RG-LRU conv's 3-token cache"):
        rglru.rglru_block(x[:, :2], p, cfg, return_cache=True)
