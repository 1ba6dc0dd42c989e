"""The port's MoE (``repro_torch.models.moe``) and the two MoE archs'
stacks, held against the JAX package's (``repro.models.moe``,
``repro.models.transformer``).

The block takes the same numpy inputs in both packages (params drawn per
leaf with ``test_torch_models.numpy_params``): the schema leaf for leaf,
``_capacity`` over a grid, and ``_moe_block_dense`` in f32 and bf16 at a
dropping capacity (0.5) and a non-dropping one (E/k).  Routing is a
thresholded output: where two experts' probabilities nearly tie, the two
frameworks' f32 router products (summed in different orders) may pick
different experts.  So the expert indices must equal the reference's on
every token whose gap between its k-th and (k+1)-th probability exceeds
1e-5, such tokens must be at least 99 % of all, and on them the kept/dropped
pattern is exact, y is within 1e-5 of the array's largest magnitude in f32
(the reference's init gives experts outputs up to ~50) and within one bf16
ulp in bf16 (``test_torch_models._bf16_close``; the port's silu takes the
reference's steps, and the block comes out bit for bit here), and aux is
within rtol 1e-5 in f32.  ``moe_impl="ep"`` without a mesh that has a
``"model"`` axis is the dense block bit for bit, and under a (2, 2) mesh
it runs the EP block; two calls are bit for bit.

The stacks, deepseek-moe-16b (GQA) and deepseek-v2-236b (MLA) at their
reference smoke configs (every layer MoE, capacity factor 1.25), on one
numpy params tree and the same tokens: ``lm_hidden``, ``lm_prefill``
(hidden and every cache leaf) and 8 decode steps.  Past layer 1 the two
frameworks' hidden states differ by bf16 rounding, so a token whose router
nearly ties may route to another expert in each, and its row differs by
O(1) (and, where the capacity drops pairs, a later token's slot can move
past the capacity with it); the reference's own criterion for two MoE
blocks whose routing differs (``tests/test_moe_ep.py``: |d| < 5e-2 on 98 %
of elements, median |d| < 5e-3) assumes f32 activations and fails on bf16
ones on rounding alone (the median is one bf16 ulp at unit scale for some
batch sizes).  The check here is by token: a token's row agrees where its
max |d| is under the dense stacks' bound (0.15; for logits, 10 % of their
largest magnitude, the dense stacks' logits bound); at least 80 % of rows
must agree (seen: 90.2 % of deepseek-moe-16b's 256 hidden rows, whose
tail of rows at 0.15-1 is where later tokens attend to a token that routed
differently in layer 0; 94.5-100 % elsewhere), the agreeing rows are held
to the dense stacks' Frobenius bound (3e-2), and the aux losses to the
reference's rtol 0.05.  A port that computed another function would leave
next to no row agreeing: with the same inputs the block is bit for bit the
reference's.  Cache leaves of layer 0 see identical inputs in both packages
and are held whole to the dense stacks' cache bounds; layer 1's on the
agreeing tokens.  Each decode step starts from the JAX package's own cache
(converted), so a routing flip in one step does not reach the next.  The
port's decode of token S-1 equals its prefill over S tokens within the
reference's bounds (atol 0.15, rtol 0.05) at capacity factor E/k, where no
pair can drop in either.
"""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.models import layers, moe, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

from test_torch_models import (  # noqa: E402
    SCALED_MAX_REL, _bf16_close, _j_params, _np32, _np_tree, _scaled_close, numpy_params)

CPU = "cpu"
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
GAP = 1e-5  # router gaps below this may route either way across frameworks
ROW_MAX_ABS, FRO_REL = 0.15, 3e-2  # the dense stacks' bounds (test_torch_models)
ROWS_AGREE = 0.8  # seen: 0.902 (deepseek-moe-16b's hidden rows) to 1.0
AUX_RTOL = 0.05  # tests/test_moe_ep.py


def _jax():
    return pytest.importorskip("jax")


def _cfgs(arch="deepseek-moe-16b", **kw):
    from repro import configs as j_configs

    return (j_configs.get_config(arch, "smoke").replace(**kw),
            configs.get_config(arch, "smoke").replace(**kw))


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------


def test_moe_schema_equals_the_reference():
    _jax()
    from repro.models import layers as j_layers
    from repro.models import moe as j_moe

    for arch in MOE_ARCHS:
        for variant in ("smoke", "full"):
            from repro import configs as j_configs

            got = list(layers._iter_leaves(moe.moe_schema(configs.get_config(arch, variant))))
            want = list(j_layers._iter_leaves(j_moe.moe_schema(
                j_configs.get_config(arch, variant))))
            assert [(p, leaf.shape, leaf.axes, leaf.init, leaf.scale) for p, leaf in got] == \
                [(p, leaf.shape, leaf.axes, leaf.init, leaf.scale) for p, leaf in want]


def test_capacity_equals_the_reference():
    _jax()
    from repro.models import moe as j_moe

    j_cfg, cfg = _cfgs()
    for t in (1, 2, 7, 48, 256, 3840, 4097):
        for cf in (0.5, 1.0, 1.25, 4.0, 64 / 6):
            for e, k in ((8, 2), (64, 6), (160, 6)):
                kw = dict(capacity_factor=cf, n_experts=e, top_k=k)
                got = moe._capacity(cfg.replace(**kw), t)
                assert type(got) is int and got == j_moe._capacity(j_cfg.replace(**kw), t)


def _block_inputs(cfg_j, seed=5, b=4, s=32):
    from repro.models import layers as j_layers
    from repro.models import moe as j_moe

    tree = numpy_params(j_moe.moe_schema(cfg_j), j_layers._iter_leaves, seed)
    x = np.random.default_rng(seed + 4).standard_normal((b, s, cfg_j.d_model)).astype(np.float32)
    return tree, x


def _j_routing(x, router, k):
    """The reference's router steps on the same inputs: (expert indices
    (T, k), gap between the k-th and (k+1)-th probability (T,))."""
    import jax
    import jax.numpy as jnp

    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1])).astype(jnp.float32)
                           @ jnp.asarray(router, jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    top = -np.sort(-np.asarray(probs), -1)
    return np.asarray(idx), top[:, k - 1] - top[:, k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", ["dropping", "no_drop"])
def test_moe_block_against_the_reference(dtype, capacity):
    jax = _jax()
    import jax.numpy as jnp
    from repro.models import moe as j_moe

    e, k = 8, 2
    cf = 0.5 if capacity == "dropping" else e / k
    j_cfg, cfg = _cfgs(capacity_factor=cf)
    tree, x = _block_inputs(j_cfg)
    t = x.shape[0] * x.shape[1]
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    j_y, j_aux = j_moe._moe_block_dense(jx, jax.tree.map(jnp.asarray, tree), j_cfg)
    p = jax.tree.map(torch.as_tensor, tree)
    y, aux = moe._moe_block_dense(tx, p, cfg)
    assert y.dtype == tx.dtype and y.shape == tx.shape

    # Routing: equal where the reference's gap is clear; such tokens >= 99 %.
    j_idx, gap = _j_routing(np.asarray(jx.astype(jnp.float32)), tree["router"], k)
    _, _, idx, _ = moe.route(tx.reshape(t, -1), p["router"], cfg)
    clear = gap > GAP
    assert clear.mean() >= 0.99, f"only {clear.mean():.3f} of tokens route clearly"
    np.testing.assert_array_equal(idx.numpy()[clear], j_idx[clear])

    # The kept/dropped pattern: the reference's slot rule on its own routing.
    cap = moe._capacity(cfg, t)
    onehot = np.eye(e, dtype=np.int64)[j_idx.reshape(-1)]
    j_pos = (np.cumsum(onehot, 0) - onehot)[np.arange(t * k), j_idx.reshape(-1)]
    _, pos, keep = moe.dispatch_slots(idx, e, cap)
    rows = np.repeat(clear, k)
    np.testing.assert_array_equal(pos.numpy()[rows], j_pos[rows])
    np.testing.assert_array_equal(keep.numpy()[rows], (j_pos < cap)[rows])
    if capacity == "dropping":
        assert not keep.all()  # the grid really drops
    else:
        assert keep.all()

    got, want = _np32(y).reshape(t, -1)[clear], _np32(j_y).reshape(t, -1)[clear]
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)
    else:
        _bf16_close(got, want, f"moe block ({capacity})")
        np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-5)


def test_ep_without_a_model_axis_is_the_dense_block_and_calls_repeat():
    cfg = configs.get_config("deepseek-moe-16b", "smoke")
    schema = moe.moe_schema(cfg)
    p = layers.init_params(schema, 3, CPU, dtype=layers.serving_dtype)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(1)).bfloat16()
    y, aux = moe.moe_block(x, p, cfg)
    y2, aux2 = moe.moe_block(x, p, cfg)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    ep = cfg.replace(moe_impl="ep")
    for mesh in (None, sharding.FleetMesh((torch.device(CPU),) * 2)):
        with (sharding.activate(mesh) if mesh is not None else contextlib.nullcontext()):
            y_ep, aux_ep = moe.moe_block(x, p, ep)
        assert torch.equal(y_ep, y) and torch.equal(aux_ep, aux)
    # A mesh with a "model" axis runs the EP block (held against the
    # reference's in tests/test_torch_mesh_model.py): at capacity factor
    # E/k, where no pair drops in either block, y equals the dense block's
    # within a bf16 ulp of its scale, and aux is the token shards' mean.
    nodrop = ep.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    y, _ = moe._moe_block_dense(x, p, nodrop)
    mesh = sharding.Mesh((torch.device(CPU),) * 4, ("data", "model"), (2, 2))
    with sharding.activate(mesh):
        y_ep, aux_ep = moe.moe_block(x, p, nodrop)
    assert y_ep.dtype == y.dtype and y_ep.shape == y.shape
    assert (y_ep.float() - y.float()).abs().max() <= 2 ** -7 * y.float().abs().max()
    shards = [moe.route(x.reshape(4, 4, -1)[i], p["router"], nodrop)[3] for i in range(4)]
    torch.testing.assert_close(aux_ep, torch.stack(shards).mean(), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The stacks against the JAX package
# ---------------------------------------------------------------------------

B, S, DECODE = 8, 32, 8


def _rows_agree(got, want, what, scaled=False):
    """Rows (tokens) agree where max |d| < ROW_MAX_ABS (logits, ``scaled``:
    under SCALED_MAX_REL of the array's largest magnitude, as
    ``test_torch_models._scaled_close`` holds them): at least ROWS_AGREE of
    them, those within FRO_REL (Frobenius, relative).  Returns the mask."""
    a = _np32(want).reshape(-1, _np32(want).shape[-1])
    g = _np32(got).reshape(a.shape)
    limit = SCALED_MAX_REL * np.abs(a).max() if scaled else ROW_MAX_ABS
    agree = np.abs(a - g).max(1) < limit
    assert agree.mean() >= ROWS_AGREE, f"{what}: only {agree.mean():.3f} of rows agree"
    rel = np.linalg.norm(a[agree] - g[agree]) / np.linalg.norm(a[agree])
    assert rel < FRO_REL, f"{what}: Frobenius relative error {rel:.4f} on agreeing rows"
    return agree


def _caches_close(got, want, agree, what):
    """Layer 0 whole (identical inputs in both packages); layer 1 on the
    tokens whose rows agree."""
    for leaf in want:
        g, w = _np32(got[leaf]), _np32(want[leaf])
        assert g.shape == w.shape, (leaf, g.shape, w.shape)
        _scaled_close(g[0], w[0], f"{what} {leaf} layer 0")
        for layer in range(1, w.shape[0]):
            rows = w.shape[1] * w.shape[2]
            gl, wl = g[layer].reshape(rows, -1), w[layer].reshape(rows, -1)
            _scaled_close(gl[agree], wl[agree], f"{what} {leaf} layer {layer}")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_stack_against_the_reference(arch):
    """lm_hidden, lm_prefill (hidden + every cache leaf) and 8 decode steps,
    each against the JAX package, by token (module docstring)."""
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

    j_h, j_aux = j_tr.lm_hidden(j_params, jnp.asarray(toks), j_cfg, remat=False)
    h, aux = transformer.lm_hidden(params, torch.as_tensor(toks), cfg)
    assert h.dtype == torch.bfloat16 and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=AUX_RTOL)
    _rows_agree(h, j_h, f"{arch} lm_hidden")
    _rows_agree(transformer.lm_logits(params, h, cfg), j_tr.lm_logits(j_params, j_h, j_cfg),
                f"{arch} lm_logits", scaled=True)

    j_hp, j_caches, j_pos = jax.jit(
        lambda p, t: j_tr.lm_prefill(p, t, j_cfg, max_len=max_len))(j_params, jnp.asarray(toks))
    hp, caches, pos = transformer.lm_prefill(params, torch.as_tensor(toks), cfg, max_len=max_len)
    agree = _rows_agree(hp, j_hp, f"{arch} lm_prefill hidden")
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos))
    assert set(caches["layers"]) == set(j_caches["layers"]) == (
        {"ckv", "k_rope"} if cfg.use_mla else {"k", "v"})
    # The prefill's cache slots are the prompt's tokens, (B, S) row-major.
    full = np.zeros((B, max_len), bool)
    full[:, :S] = agree.reshape(B, S)
    _caches_close(caches["layers"], j_caches["layers"], full.reshape(-1), f"{arch} cache")

    j_step = jax.jit(lambda p, t, c, q: j_tr.lm_decode_hidden(p, t, c, q, j_cfg))
    jc, jq = j_caches, j_pos
    got, want = [], []
    for i in range(DECODE):
        # Each step from the reference's own caches, converted.
        st = convert.serve_state_from_numpy(
            j_model.ServeState(caches=jc, pos=jq,
                               odl=j_engine.init_fleet(j_model.core_config(j_cfg), B)), CPU)
        slot = int(jq[0])
        j_hd, jc = j_step(j_params, jnp.asarray(feed[i]), jc, jq)
        hd, tc = transformer.lm_decode_hidden(params, torch.as_tensor(feed[i]), st.caches,
                                              st.pos, cfg)
        got.append(_np32(hd))
        want.append(_np32(j_hd))
        step_agree = np.abs(got[-1] - want[-1]).reshape(B, -1).max(1) < ROW_MAX_ABS
        for leaf in jc["layers"]:
            g = _np32(tc["layers"][leaf])[:, :, slot]
            w = _np32(jc["layers"][leaf])[:, :, slot]
            _scaled_close(g[0], w[0], f"{arch} decode step {i} {leaf} layer 0")
            _scaled_close(g[1][step_agree], w[1][step_agree], f"{arch} decode step {i} {leaf}")
        jq = jq + 1
    # B rows a step: pooled over the steps.
    _rows_agree(np.stack(got), np.stack(want), f"{arch} decode")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_prefill(arch):
    """The port's own check at capacity factor E/k (no pair can drop at any
    token count): decode of token S-1 after a prefill of S-1 tokens gives
    lm_hidden's logits at S-1 within the reference's bounds."""
    cfg = configs.get_config(arch, "smoke")
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    params = model_lib.build_params(cfg, seed=1, device=CPU)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 32)))
    hidden_all, _ = transformer.lm_hidden(params, toks, cfg)
    full = transformer.lm_logits(params, hidden_all, cfg)[:, -1]
    _, st = model_lib.prefill(params, toks[:, :31], cfg, max_len=32)
    logits, st2, odl = model_lib.serve_step(params, st, toks[:, 31:], cfg)
    np.testing.assert_allclose(_np32(logits), _np32(full), atol=0.15, rtol=0.05)
    assert odl.queried.shape == (4,) and int(st2.pos[0]) == 32
    feats = model_lib.decode_step(params, st2, toks[:, 31:], cfg)[1]
    assert feats.shape == (4, cfg.d_model) and bool(torch.isfinite(feats).all())
