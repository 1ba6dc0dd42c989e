"""Training the MoE stacks in the port, deepseek-moe-16b (GQA attention +
fine-grained MoE) and deepseek-v2-236b (MLA attention + MoE), held against
the JAX package's on the CPU at smoke width.

Each arch's params are one numpy tree (``test_torch_models.numpy_params``)
drawn at the port's init scale, loaded into both packages; the batch is
``TokenStream.batch(step)`` at B=4, S=32.  The loss is the cross-entropy
plus 0.01 times the MoE layers' load-balancing aux loss in both.

* Both packages computing in f32 (``COMPUTE_DTYPE`` set to f32 in both for
  the test, as ``tests/test_torch_train_families.py`` does), at capacity
  factor E/k (no pair can drop): ``model.accumulate_grads`` at
  ``microbatches`` 1 and 2 against jitted ``jax.value_and_grad`` of the
  reference's ``_forward_loss`` (remat on): the loss, the cross-entropy
  and the aux loss within 1e-5 (relative), every gradient leaf and each
  layer's slice of a stacked leaf within relative Frobenius 1e-4 (worst
  seen 9e-7).  Each layer's routing in the port equals the reference
  router's on the same layer inputs, on every token whose gap between
  its k-th and (k+1)-th probability exceeds 1e-5 (at least 99 % of them);
  a routing flip would also move aux by about E/T times a probability
  gap, far past 1e-5.
* In the bf16 compute the models run in, at the default capacity factor
  1.25: every slice within 3e-2, or within twice the largest movement of
  the reference's own gradient of that slice when its f32 params are
  scaled by 1 + 1e-5 noise (three draws), where that is larger: the rule
  of ``test_torch_train_families.py`` for mamba2.  In bf16 a near-tie in
  layer 1's router flips with the last bit of its input, and
  deepseek-v2-236b's reference gradient of layer 1's routed experts moves
  by 10-24 % under that noise alone (seen), deepseek-moe-16b's by 3-15 %.
* ``model.train_step`` in f32, one step at a time from the JAX package's
  state, at ``microbatches`` 1 and 2: loss and grad norm within 1e-5
  (relative), every new param within 1e-5, the head's counts exact.
* The dense block at the default capacity with a router skewed so that
  pairs drop: each dropped pair's row into the capacity buffers takes a
  gradient of exactly 0 (the port writes it to a trash row that is sliced
  away), a token whose every pair dropped takes exactly 0 in both packages,
  and the block's input gradient is the reference's within 1e-5 of its
  scale in f32.

In the port alone: remat equal to no remat (loss and grads within 1e-6;
the recomputed routing is the first one's), and every layer view's
gradient accumulating into its slice of the stacked buffer, the routed
experts' (L, E, d, f) leaves too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import layers, moe, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

from test_torch_train_families import (  # noqa: E402
    FRO_REL, _batch, _leaves, _np, _params_np, _rel_fro, _scaled_tree, _slices, _t_batch)

CPU = "cpu"
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
F32_REL = 1e-4  # gradients, both packages computing in f32
LOSS_REL = 1e-5  # loss, ce and aux in f32
GAP = 1e-5  # router gaps below this may route either way across frameworks


def _jax():
    return pytest.importorskip("jax")


@pytest.fixture
def f32(monkeypatch):
    """Both packages computing in f32 for the test."""
    _jax()
    import jax.numpy as jnp
    from repro.models import layers as j_layers

    monkeypatch.setattr(j_layers, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


def _no_drop(cfg):
    return cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)


def _j_cfg(arch, no_drop):
    from repro import configs as j_configs

    cfg = j_configs.get_config(arch, "smoke")
    return _no_drop(cfg) if no_drop else cfg


def _cfg(arch, no_drop):
    cfg = configs.get_config(arch, "smoke")
    return _no_drop(cfg) if no_drop else cfg


def _jax_grads(j_cfg, params_np, np_batch, mb):
    """The reference's (loss, feats, grads) as its ``train_step`` forms them:
    jitted ``value_and_grad`` of ``_forward_loss`` (remat on), with
    ``microbatches`` = mb summed in f32 and divided by mb."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.models import model as j_model

    grad_fn = jax.value_and_grad(j_model._forward_loss, has_aux=True)

    def fn(params, batch):
        gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        loss, feats = 0.0, []
        for i in range(mb):
            part = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                    for k, v in batch.items()}
            (l_i, (_, f_i)), g = grad_fn(params, part, j_cfg, True)
            gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32) / mb, gsum, g)
            loss, feats = loss + l_i / mb, feats + [f_i]
        return loss, jnp.concatenate(feats), gsum

    return jax.jit(fn)(jax.tree.map(jnp.asarray, params_np),
                       {k: jnp.asarray(v) for k, v in np_batch.items()})


def _port_state(cfg, params_np, device=CPU, tcfg=TrainConfig()):
    host = convert.train_state_to_numpy(model_lib.init_train_state(cfg, 0, tcfg, CPU))
    return convert.train_state_from_numpy(host._replace(params=params_np), cfg, device, tcfg)


def _port_grads(cfg, params_np, np_batch, mb):
    state = _port_state(cfg, params_np)
    return model_lib.accumulate_grads(state.params, _t_batch(np_batch), cfg,
                                      TrainConfig(microbatches=mb))


def _j_routing(x, router, k):
    """The reference's router steps on ``x`` (T, d): (expert indices (T, k),
    gap between the k-th and (k+1)-th probability (T,))."""
    import jax
    import jax.numpy as jnp

    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32) @ jnp.asarray(router, jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, k)
    top = -np.sort(-np.asarray(probs), -1)
    return np.asarray(idx), top[:, k - 1] - top[:, k]


def _forward_parts(arch, cfg, j_cfg, params_np, np_batch, monkeypatch):
    """(port, reference) of (ce, aux) on the whole batch, forward only, and
    the port's routing of each MoE layer held against the reference
    router's on the same layer inputs."""
    import jax.numpy as jnp
    from repro.models import layers as j_layers
    from repro.models import transformer as j_tr

    seen = []
    route = moe.route

    def recording(xt, router, c):
        out = route(xt, router, c)
        seen.append((xt.detach().float().numpy(), router.detach().float().numpy(), out[2]))
        return out

    monkeypatch.setattr(moe, "route", recording)
    params = _port_state(cfg, params_np).params
    batch = _t_batch(np_batch)
    with torch.no_grad():
        hidden, aux = transformer.lm_hidden(params, batch["tokens"], cfg, remat=False)
        ce = layers.softmax_cross_entropy(transformer.lm_logits(params, hidden, cfg),
                                          batch["labels"])
    monkeypatch.setattr(moe, "route", route)
    assert len(seen) == cfg.n_layers
    for i, (xt, router, idx) in enumerate(seen):
        j_idx, gap = _j_routing(xt, router, cfg.top_k)
        clear = gap > GAP
        assert clear.mean() >= 0.99, (arch, i, clear.mean())
        np.testing.assert_array_equal(idx.numpy()[clear], j_idx[clear], err_msg=f"layer {i}")

    j_params = {k: v for k, v in _np_to_j(params_np).items()}
    toks = jnp.asarray(np_batch["tokens"])
    j_hidden, j_aux = j_tr.lm_hidden(j_params, toks, j_cfg, remat=False)
    j_ce = j_layers.softmax_cross_entropy(j_tr.lm_logits(j_params, j_hidden, j_cfg),
                                          jnp.asarray(np_batch["labels"]))
    return (float(ce), float(aux)), (float(j_ce), float(j_aux))


def _np_to_j(tree):
    import jax
    import jax.numpy as jnp

    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, rel, what):
    assert abs(got - want) <= rel * abs(want), (what, got, want)


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_grads_in_f32_against_the_reference(arch, mb, f32, monkeypatch):
    cfg, j_cfg = _cfg(arch, True), _j_cfg(arch, True)
    params_np, np_batch = _params_np(arch), _batch(cfg, 1)
    (ce, aux), (j_ce, j_aux) = _forward_parts(arch, cfg, j_cfg, params_np, np_batch,
                                              monkeypatch)
    _close(ce, j_ce, LOSS_REL, "ce")
    _close(aux, j_aux, LOSS_REL, "aux")
    want = _jax_grads(j_cfg, params_np, np_batch, mb)
    loss, feats, grads = _port_grads(cfg, params_np, np_batch, mb)
    _close(float(loss), float(want[0]), LOSS_REL, "loss")
    if mb == 1:
        _close(float(loss), ce + 0.01 * aux, LOSS_REL, "loss = ce + 0.01 aux")
    assert _rel_fro(_np(feats), want[1]) < F32_REL
    assert {t.dtype for _, t in _leaves(grads)} == {torch.float32}
    for name, a, b in _slices(grads, want[2], cfg):
        err = _rel_fro(a, b)
        assert err < F32_REL, (arch, mb, name, err)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_grads_within_the_references_rounding_noise(arch):
    """The models' own bf16 compute at the default capacity: every slice
    within 3e-2, or twice the reference's own movement under 1e-5 param
    noise where that is larger (module docstring)."""
    cfg, j_cfg = _cfg(arch, False), _j_cfg(arch, False)
    params_np, np_batch = _params_np(arch), _batch(cfg, 1)
    want = _jax_grads(j_cfg, params_np, np_batch, 1)
    rng = np.random.default_rng(0)
    moved = [_jax_grads(j_cfg, _scaled_tree(params_np, rng), np_batch, 1)[2] for _ in range(3)]
    loss, feats, grads = _port_grads(cfg, params_np, np_batch, 1)
    _close(float(loss), float(want[0]), FRO_REL, "loss")
    assert _rel_fro(_np(feats), want[1]) < FRO_REL
    noise = {}
    for tree in moved:
        for name, a, b in _slices(tree, want[2], cfg):
            noise[name] = max(noise.get(name, 0.0), _rel_fro(a, b))
    for name, a, b in _slices(grads, want[2], cfg):
        err = _rel_fro(a, b)
        assert err < max(FRO_REL, 2 * noise[name]), (arch, name, err, noise[name])


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_step_in_f32_against_the_reference(arch, mb, f32):
    """Two ``train_step``s, each from the JAX package's state (converted),
    at the default capacity: loss and grad norm within 1e-5, every new
    param within 1e-5 (Adam's first steps move a param by about lr = 3e-4
    whatever its gradient, so this holds the gradients' signs and ratios;
    worst seen 1.1e-6), the head's counts exact."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.models import model as j_model
    from repro.optim import adam as j_adam

    cfg, j_cfg = _cfg(arch, False), _j_cfg(arch, False)
    tcfg = TrainConfig(microbatches=mb)
    params = _np_to_j(_params_np(arch))
    j_state = j_model.TrainState(params=params, opt=j_adam.init(params),
                                 odl=j_model.init_odl_state(j_cfg))
    step_fn = jax.jit(lambda st, b: j_model.train_step(st, b, j_cfg, JTrainConfig(microbatches=mb)))
    for step in (1, 2):
        np_batch = _batch(cfg, step)
        state = convert.train_state_from_numpy(j_state, cfg, CPU)
        j_new, j_metrics = step_fn(j_state, {k: jnp.asarray(v) for k, v in np_batch.items()})
        new, metrics = model_lib.train_step(state, _t_batch(np_batch), cfg, tcfg)
        for key in ("loss", "grad_norm"):
            _close(float(metrics[key]), float(j_metrics[key]), LOSS_REL, (step, key))
        got, want = convert.train_state_to_numpy(new), convert.train_state_to_numpy(j_new)
        for (path, g), (_, w) in zip(_leaves(got.params), _leaves(want.params), strict=True):
            worst = np.abs(g.astype(np.float64) - w).max()
            assert worst <= 1e-5, (arch, step, path, worst)
        assert int(got.odl.elm.count) == int(want.odl.elm.count) == step * 4
        j_state = j_new


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dropped_pairs_take_no_gradient(arch, f32):
    jax = _jax()
    import jax.numpy as jnp
    from repro.models import moe as j_moe

    cfg, j_cfg = _cfg(arch, False), _j_cfg(arch, False)
    p_np = {k: v for k, v in _params_np(arch)["layers"]["moe"].items() if k != "shared"}
    p_np = {k: v[0] for k, v in p_np.items()}  # layer 0, no shared experts
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    # Skew the router towards experts 0 and 1, so that their capacity
    # overflows and late tokens lose both of their pairs.
    mean = x.reshape(-1, cfg.d_model).mean(0)
    p_np["router"][:, :2] += 2.0 * (mean / np.square(mean).sum())[:, None]
    r = rng.standard_normal(x.shape).astype(np.float32)

    p = {k: torch.as_tensor(v) for k, v in p_np.items()}
    tx = torch.as_tensor(x).requires_grad_()
    y, _ = moe._moe_block_dense(tx, p, cfg)
    (y * torch.as_tensor(r)).sum().backward()

    def j_loss(xx):
        yy, _ = j_moe._moe_block_dense(xx, _np_to_j(p_np), j_cfg)
        return jnp.sum(yy * r)

    j_gx = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    gx = tx.grad.numpy()
    np.testing.assert_array_less(np.abs(gx - j_gx).max(), 1e-5 * np.abs(j_gx).max())

    t = x.shape[0] * x.shape[1]
    cap = moe._capacity(cfg, t)
    _, _, idx_k, _ = moe.route(torch.as_tensor(x).reshape(t, -1), p["router"], cfg)
    flat_e, pos, keep = moe.dispatch_slots(idx_k, cfg.n_experts, cap)
    assert not keep.all(), "the skewed router drops no pair"
    # Pair by pair: each pair's row into the buffers, its gradient.
    rows = torch.as_tensor(x).reshape(t, -1).repeat_interleave(cfg.top_k, 0).requires_grad_()
    buf = moe._dispatch(rows, flat_e, pos, keep, cfg.n_experts, cap)
    (buf * torch.randn(buf.shape, generator=torch.Generator().manual_seed(0))).sum().backward()
    assert not rows.grad[~keep].any() and rows.grad[keep].abs().sum(1).all()
    # A token whose every pair dropped: exactly 0 in both packages.
    gone = ~keep.view(t, cfg.top_k).any(1).numpy()
    assert gone.any()
    assert not gx.reshape(t, -1)[gone].any() and not j_gx.reshape(t, -1)[gone].any()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_equals_no_remat_and_grads_accumulate_in_place(arch, monkeypatch):
    cfg = _cfg(arch, False)
    state = _port_state(cfg, _params_np(arch))
    batch = _t_batch(_batch(cfg, 1))
    views = []
    layer_view = model_lib._layer_view

    def recording(p, g, i):
        v = layer_view(p, g, i)
        views.append((v, g[i]))
        return v

    monkeypatch.setattr(model_lib, "_layer_view", recording)
    l0, f0, g0 = model_lib.loss_and_grads(state.params, batch, cfg, remat=False)
    assert views and all(v.grad.data_ptr() == buf.data_ptr() for v, buf in views)
    experts = [buf for v, buf in views if buf.dim() == 3 and v.shape[0] == cfg.n_experts]
    assert len(experts) == 3 * cfg.n_layers and all(b.any() for b in experts)
    l1, f1, g1 = model_lib.loss_and_grads(state.params, batch, cfg, remat=True)
    assert abs(float(l0) - float(l1)) <= 1e-6
    torch.testing.assert_close(f0, f1, rtol=0, atol=1e-6)
    for a, b in zip(adam.leaves(g0), adam.leaves(g1), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert a.any()
