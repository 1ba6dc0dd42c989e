"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) held against
the JAX package's (``repro.models.ssm``) on the same numpy inputs.

- ``ssd_schema``: leaf for leaf (shape, axes, init, scale) at smoke and
  full width.
- ``_causal_conv`` in bf16: bit for bit (the taps summed one by one in
  bf16, then the bias, then silu's steps, each rounded in bf16, as the
  reference's jitted conv rounds them on the CPU).
- ``ssd_scan`` in f32 at one chunk and at four: outputs and final state
  within rtol 1e-4, atol 1e-5 of the reference (worst seen: 1.4e-5 abs on
  outputs of magnitude ~23, 3.1e-6 on states of ~4).  Inside the port the
  scan at chunk q equals, within the same tolerance, itself at chunk 1 and
  a step loop of ``ssd_decode``'s recurrence.
- ``ssd_block`` (output and cache) and three ``ssd_decode`` steps in bf16,
  under the stack bounds of ``tests/test_torch_models.py``.
- A sequence that is not a multiple of the chunk raises, as the
  reference's ``assert``; so does a prompt shorter than the conv's cache.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402

from test_torch_models import (  # noqa: E402
    _np32, _scaled_close, _stats_close, numpy_params)

CPU = "cpu"
ARCH = "mamba2-780m"
SCAN_RTOL, SCAN_ATOL = 1e-4, 1e-5


def _jax():
    return pytest.importorskip("jax")


def _leaf_tuple(leaf):
    return (tuple(leaf.shape), tuple(leaf.axes), leaf.init, leaf.scale)


def module_params(j_schema, schema, seed):
    """One numpy tree drawn from the reference's schema (``numpy_params``):
    the JAX package's params as f32 arrays (it casts at use), the port's in
    its serving dtypes (bf16 matmul weights, f32 constant-init leaves)."""
    import jax.numpy as jnp
    from repro.models import layers as j_layers

    tree = numpy_params(j_schema, j_layers._iter_leaves, seed)
    flat = dict(layers._iter_leaves(schema))
    j_p = {k: jnp.asarray(v) for k, v in tree.items()}
    t_p = {k: torch.as_tensor(v).to(layers.serving_dtype(flat[(k,)])) for k, v in tree.items()}
    return j_p, t_p


def _scan_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal(h)).astype(np.float32)
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    return xh, dt, a, bm, cm


@pytest.mark.parametrize("variant", ["smoke", "full"])
def test_ssd_schema_equals_the_reference(variant):
    _jax()
    from repro import configs as j_configs
    from repro.models import layers as j_layers
    from repro.models import ssm as j_ssm

    mine = dict(layers._iter_leaves(ssm.ssd_schema(configs.get_config(ARCH, variant))))
    ref = dict(j_layers._iter_leaves(j_ssm.ssd_schema(j_configs.get_config(ARCH, variant))))
    assert mine.keys() == ref.keys()
    for path in ref:
        assert _leaf_tuple(mine[path]) == _leaf_tuple(ref[path]), path


def test_causal_conv_bit_for_bit():
    _jax()
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as j_ssm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20, 40)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 40))).astype(np.float32)
    b = (0.1 * rng.standard_normal(40)).astype(np.float32)
    want = jax.jit(j_ssm._causal_conv)(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w),
                                        jnp.asarray(b))
    got = ssm._causal_conv(torch.as_tensor(x).bfloat16(), torch.as_tensor(w), torch.as_tensor(b))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np32(got), _np32(want))


@pytest.mark.parametrize("b,s,h,p,n,chunk", [(2, 16, 4, 8, 6, 16), (2, 64, 4, 8, 6, 16),
                                             (1, 48, 3, 5, 7, 16), (2, 12, 3, 4, 5, 16)])
def test_ssd_scan_against_the_reference(b, s, h, p, n, chunk):
    """nc = 1 (one chunk, and a sequence shorter than the chunk) and nc = 3,
    4 chunks: outputs and final state."""
    _jax()
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as j_ssm

    args = _scan_inputs(s, b, s, h, p, n)
    jy, js = jax.jit(j_ssm.ssd_scan, static_argnums=5)(*map(jnp.asarray, args), chunk)
    ty, ts = ssm.ssd_scan(*map(torch.as_tensor, args), chunk)
    assert ty.shape == (b, s, h, p) and ts.shape == (b, h, p, n)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=SCAN_RTOL, atol=SCAN_ATOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=SCAN_RTOL, atol=SCAN_ATOL)


def test_ssd_scan_chunking_and_the_step_recurrence():
    """The scan at chunk 16 against itself at chunk 1 and against the
    decode's recurrence stepped token by token (state = state * exp(dt a)
    + (x dt) B^T; y = state C)."""
    args = [torch.as_tensor(a) for a in _scan_inputs(5, 2, 48, 3, 4, 5)]
    xh, dt, a, bm, cm = args
    y16, s16 = ssm.ssd_scan(*args, 16)
    y1, s1 = ssm.ssd_scan(*args, 1)
    torch.testing.assert_close(y1, y16, rtol=SCAN_RTOL, atol=SCAN_ATOL)
    torch.testing.assert_close(s1, s16, rtol=SCAN_RTOL, atol=SCAN_ATOL)
    state = torch.zeros_like(s16)
    ys = []
    for t in range(xh.shape[1]):
        da = torch.exp(dt[:, t] * a[None])
        bx = (xh[:, t] * dt[:, t, :, None])[..., None] * bm[:, t, None, None, :]
        state = state * da[:, :, None, None] + bx
        ys.append(torch.matmul(state, cm[:, t, None, :, None])[..., 0])
    torch.testing.assert_close(torch.stack(ys, 1), y16, rtol=SCAN_RTOL, atol=SCAN_ATOL)
    torch.testing.assert_close(state, s16, rtol=SCAN_RTOL, atol=SCAN_ATOL)


def test_ragged_sequences_and_short_prompts_raise():
    args = [torch.as_tensor(a) for a in _scan_inputs(1, 1, 24, 2, 3, 4)]
    with pytest.raises(ValueError, match="not divisible by chunk 16"):
        ssm.ssd_scan(*args, 16)
    cfg = configs.get_config(ARCH, "smoke")
    p = layers.init_params(ssm.ssd_schema(cfg), 0, CPU, dtype=layers.serving_dtype)
    x = torch.zeros((1, 2, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shorter than the SSD conv's 3-token cache"):
        ssm.ssd_block(x, p, cfg, return_cache=True)
    assert ssm.ssd_block(x, p, cfg).shape == x.shape  # no cache asked: runs


def test_ssd_block_and_decode_against_the_reference():
    """The block over 32 tokens (2 chunks of the smoke width's 16) with its
    cache, then three decode steps from the reference's cache, in bf16."""
    jax = _jax()
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.models import ssm as j_ssm

    cfg = configs.get_config(ARCH, "smoke")
    j_cfg = j_configs.get_config(ARCH, "smoke")
    j_p, p = module_params(j_ssm.ssd_schema(j_cfg), ssm.ssd_schema(cfg), 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 32, cfg.d_model)).astype(np.float32)
    steps = rng.standard_normal((3, 3, 1, cfg.d_model)).astype(np.float32)

    j_out, j_cache = jax.jit(lambda p_, x_: j_ssm.ssd_block(x_, p_, j_cfg, return_cache=True))(
        j_p, jnp.asarray(x).astype(jnp.bfloat16))
    out, cache = ssm.ssd_block(torch.as_tensor(x).bfloat16(), p, cfg, return_cache=True)
    assert out.dtype == torch.bfloat16
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == \
        {k: (tuple(v.shape), torch.float32) for k, v in j_cache.items()}
    _stats_close(out, j_out, "ssd_block out")
    for leaf in ("state", "conv"):
        _scaled_close(cache[leaf], j_cache[leaf], f"ssd_block cache {leaf}")

    j_step = jax.jit(lambda p_, x_, c_: j_ssm.ssd_decode(x_, p_, j_cfg, c_))
    tc = {k: torch.as_tensor(np.array(v)) for k, v in j_cache.items()}
    jc = j_cache
    for i in range(3):
        xi = steps[i]
        j_y, jc = j_step(j_p, jnp.asarray(xi).astype(jnp.bfloat16), jc)
        y, new = ssm.ssd_decode(torch.as_tensor(xi).bfloat16(), p, cfg, tc)
        assert new["state"] is tc["state"] and new["conv"] is tc["conv"]  # in place
        _stats_close(y, j_y, f"ssd_decode step {i}")
        for leaf in ("state", "conv"):
            _scaled_close(tc[leaf], jc[leaf], f"ssd_decode step {i} cache {leaf}")


def test_ssd_decode_into_a_second_cache():
    """``out`` takes the new state and conv tail and leaves the cache read
    as it was; the values are the in-place step's, bit for bit."""
    cfg = configs.get_config(ARCH, "smoke")
    p = layers.init_params(ssm.ssd_schema(cfg), 1, CPU, dtype=layers.serving_dtype)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(0)).bfloat16()
    _, cache = ssm.ssd_block(x, p, cfg, return_cache=True)
    before = {k: v.clone() for k, v in cache.items()}
    out = {k: torch.empty_like(v) for k, v in cache.items()}
    step = x[:, -1:]
    y_out, got = ssm.ssd_decode(step, p, cfg, cache, out)
    assert got is out and all(torch.equal(cache[k], before[k]) for k in cache)
    y_in, _ = ssm.ssd_decode(step, p, cfg, cache)
    assert torch.equal(y_in, y_out) and all(torch.equal(cache[k], out[k]) for k in cache)
