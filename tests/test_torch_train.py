"""The port's training path (``repro_torch.optim.adam``, ``core.pruning.
scan_update``, ``models.model`` train half, ``convert.train_state_*``,
``launch.train``, ``examples.train_lm_odl``), held against the JAX
package's on the CPU.

Tolerances, each against the JAX function on the same numpy inputs:

* ``adam.update`` on one f32 params and grads tree, at steps 1 and 3, with
  the global-norm clip active and inactive: params, m, v and the grad norm
  within rtol 1e-6, of the value or, where a moment cancels towards 0, of
  its leaf's largest magnitude (the two frameworks sum the squares of the
  norm in another order, so an active clip scales by factors an ulp apart,
  and ``0.9 m + 0.1 g`` cancels: worst seen 2.2e-7 of the leaf's scale).
* ``pruning.scan_update`` over query/agree/conf sequences that cross the
  X-streak and the mismatch step: every leaf exactly equal.
* ``model.odl_update`` fed the same f32 features and labels from numpy,
  from a cold head (count 0: every row queried) and from a warm one built by
  the JAX package and converted (count >= min_trained = 288, level > 0, so
  some rows prune): predictions, the queried mask, the count, the queried
  and agreeing rows' counts and every prune leaf exactly equal.  From the
  warm head P within 2e-5 in units of I/ridge (``P * ridge``) and beta
  within 2e-4; from the cold one (P = I/ridge = 100 I: S = I + H P H^T
  has a condition number of ~2e2 at 8 rows, and each package's f32 beta
  lies about as far from a float64 update as from the other's) P and beta
  within rtol 2e-3, atol 2e-3, the reference's own bound for its kernel
  against its einsum path from P = I/ridge (``tests/test_kernels.py::
  test_kernel_path_equals_oselm_module``).  The port runs the Pallas kernel's
  numerics (no symmetrisation of P), the JAX package its einsum path
  (``use_kernel=False``), whence the tolerances (ROADMAP Queue 3).
* ``model.accumulate_grads`` (``loss_and_grads``, and its f32 sum over
  ``microbatches`` = 2) at qwen3-4b's smoke width against
  ``jax.value_and_grad`` of the reference's ``_forward_loss`` on the same
  numpy params and batch: every gradient leaf, and every layer's slice of a
  stacked leaf, within the bf16 stack's relative Frobenius bound of
  ``tests/test_torch_models.py`` (3e-2), the loss and the pooled features
  too.
* ``model.train_step`` there, ``microbatches`` 1 and 2, one step at a time
  from the JAX package's state carried over by
  ``convert.train_state_from_numpy``: loss and grad norm within 3e-2,
  relative; ``odl_query_frac`` exact while the head is cold; new params
  within 2 lr + 1e-6 absolute, a sanity check only (Adam's first steps move
  each param by about lr whatever the gradient, so the gradients are held
  by the test above).
  Thresholded head outputs of a warm head fed each package's own backbone
  features are not compared: the features differ in the last bf16 bit.

In the port alone: two steps from one state bit for bit; remat equal to no
remat (loss and grads within 1e-6); 4 steps + resume to 8 bit for bit 8
uninterrupted ones through ``launch.train.train``; the NaN guard's
rollback; ``main`` parsing every flag of the reference's; the CLI exiting 1
with no card and no ``--device``; the example.  The other families train
too: the SSD and hybrid stacks and the encoder-decoder in
``tests/test_torch_train_families.py``, the MoE and MLA stacks in
``tests/test_torch_train_moe.py``.  Params come from one numpy tree per leaf
(``test_torch_models.numpy_params``): the JAX package's ``init_params``
salts ``hash()``.  Every checkpoint directory is a ``tmp_path``.

Tests marked ``cuda`` run on the card and skip elsewhere:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_train.py
"""

import dataclasses
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.data.tokens import TokenStream, TokenStreamConfig  # noqa: E402
from repro_torch.examples import train_lm_odl  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adam  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ARCH = "qwen3-4b"
B, S = 8, 16
FRO_REL = 3e-2  # the bf16 stack's bound (tests/test_torch_models.py)
P_TOL, BETA_TOL = 2e-5, 2e-4  # P in units of I/ridge
COLD_TOL = 2e-3  # rtol and atol from P = I/ridge (tests/test_kernels.py's)


def _jax():
    return pytest.importorskip("jax")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _np(a):
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _state_leaves(state):
    """Every leaf of a TrainState (either package) by name, as numpy."""
    host = convert.train_state_to_numpy(state)
    out = {f"params{k}": v for k, v in _leaves(host.params)}
    out.update({f"m{k}": v for k, v in _leaves(host.opt.m)})
    out.update({f"v{k}": v for k, v in _leaves(host.opt.v)})
    out["step"] = host.opt.step
    out.update({f"elm.{f}": getattr(host.odl.elm, f) for f in host.odl.elm._fields})
    out.update({f"prune.{f}": getattr(host.odl.prune, f) for f in host.odl.prune._fields})
    return out


def _assert_bitwise(a, b, what):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert la.keys() == lb.keys()
    differ = [k for k in la if la[k].shape != lb[k].shape or la[k].tobytes() != lb[k].tobytes()]
    assert not differ, f"{what}: leaves differ: {differ[:6]}"


def _batch(cfg, step, batch=B, seq=S, seed=0):
    stream = TokenStream(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                           global_batch=batch, n_domains=cfg.odl.n_out,
                                           seed=seed))
    return stream.batch(step)


def _t_batch(np_batch, device=CPU):
    return {k: torch.as_tensor(v, device=device) for k, v in np_batch.items()}


def _port_state(cfg, seed=3, device=CPU):
    """A port TrainState whose params are ``numpy_params`` (seeded per leaf)."""
    from test_torch_models import numpy_params

    from repro_torch.models import layers

    params = numpy_params(model_lib.build_schema(cfg), layers._iter_leaves, seed)
    host = convert.train_state_to_numpy(model_lib.init_train_state(cfg, 0, device=CPU))
    return convert.train_state_from_numpy(host._replace(params=params), cfg, device)


def _clone(state):
    return convert.train_state_from_numpy(state, configs.get_config(ARCH, "smoke"), CPU)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


# A params tree with a stacked leaf of each rank (layer slices of 3-d
# leaves are updated one at a time).
ADAM_SHAPES = {"embed": (16, 8), "final_norm": (8,), "layers": {"w": (3, 8, 12), "ln": (3, 8)}}


def _draw(rng, shapes, scale):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


@pytest.mark.parametrize("grad_clip", [1e3, 0.5], ids=["clip_inactive", "clip_active"])
def test_adam_against_the_reference(grad_clip):
    jax = _jax()
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.optim import adam as j_adam

    rng = np.random.default_rng(7)
    params = _draw(rng, ADAM_SHAPES, 1.0)
    grads = [_draw(rng, ADAM_SHAPES, 0.3) for _ in range(3)]
    tcfg = TrainConfig(grad_clip=grad_clip)
    j_tcfg = JTrainConfig(grad_clip=grad_clip)

    def t_tree(tree):
        return {k: t_tree(v) if isinstance(v, dict) else torch.tensor(v) for k, v in tree.items()}

    jp = jax.tree.map(jnp.asarray, params)
    js = j_adam.init(jp)
    tp = t_tree(params)
    ts = adam.init(tp)
    for step, g in enumerate(grads, start=1):
        jp, js, jg = j_adam.update(jax.tree.map(jnp.asarray, g), js, jp, j_tcfg)
        tp, ts, tg = adam.update(t_tree(g), ts, tp, tcfg)
        assert int(ts.step) == int(js.step) == step
        if step not in (1, 3):
            continue
        clipped = float(tg) > grad_clip
        assert clipped == (grad_clip < 1.0), f"step {step}: gnorm {float(tg)}"
        np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
        for name, want, got in (("params", jp, tp), ("m", js.m, ts.m), ("v", js.v, ts.v)):
            for (path, w), (_, t) in zip(_leaves(want), _leaves(got), strict=True):
                w = np.asarray(w)
                np.testing.assert_allclose(_np(t), w, rtol=1e-6, atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"step {step} {name}{path}")


def test_adam_update_writes_in_place_and_zero1_axes():
    p = {"w": torch.ones(2, 3)}
    st = adam.init(p)
    new_p, new_st, _ = adam.update({"w": torch.full((2, 3), 0.5)}, st, p, TrainConfig())
    assert new_p["w"] is p["w"] and new_st.m["w"] is st.m["w"] and new_st.v["w"] is st.v["w"]
    assert int(new_st.step) == 1 and int(st.step) == 0
    assert adam.zero1_axes(("embed", "mlp"), (64, 128), 4) == ("zero1", "mlp")
    assert adam.zero1_axes(("vocab", "embed"), (10, 6), 4) == ("vocab", "embed")


# ---------------------------------------------------------------------------
# scan_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,level,streak", [(0, 0, 0), (1, 2, 8), (2, 4, 9)])
def test_scan_update_against_the_reference(seed, level, streak):
    _jax()
    import jax.numpy as jnp
    from repro.core import pruning as j_pruning

    rng = np.random.default_rng(seed)
    k = 128
    queried = rng.uniform(size=k) < 0.95
    agree = rng.uniform(size=k) < 0.95
    conf = rng.uniform(size=k).astype(np.float32)
    start = [level, streak, 5, 3, 7]
    cfg = pruning.PruneConfig.for_hidden(128)
    want = j_pruning.scan_update(
        j_pruning.PruneState(*(jnp.asarray(v, jnp.int32) for v in start)),
        jnp.asarray(queried), jnp.asarray(agree), jnp.asarray(conf),
        j_pruning.PruneConfig.for_hidden(128))
    got = pruning.scan_update(
        pruning.PruneState(*(torch.tensor(v, dtype=torch.int32) for v in start)),
        torch.as_tensor(queried), torch.as_tensor(agree), torch.as_tensor(conf), cfg)
    for f in pruning.PruneState._fields:
        assert int(getattr(got, f)) == int(getattr(want, f)), f
    # The sequence crossed both transitions: the ladder moved both ways.
    levels = [level]
    st = pruning.PruneState(*(torch.tensor(v, dtype=torch.int32) for v in start))
    for q, a, c in zip(queried, agree, conf):
        st = pruning.update(st, torch.tensor(q), torch.tensor(a), torch.tensor(c), cfg)
        levels.append(int(st.level))
    steps = np.diff(levels)
    assert (steps > 0).any() and (steps < 0).any(), levels


# ---------------------------------------------------------------------------
# odl_update
# ---------------------------------------------------------------------------


def _clustered(rng, n, d, n_out, centers, ambiguous=False):
    """``n`` rows around the class centres and their labels; ``ambiguous``
    moves every other row halfway to the next class's centre, so that a warm
    head is sure of some rows (they prune) and unsure of the others."""
    labels = rng.integers(0, n_out, n).astype(np.int32)
    feats = centers[labels] + 0.5 * rng.standard_normal((n, d))
    if ambiguous:
        a = labels[1::2]
        feats[1::2] = 0.5 * (centers[a] + centers[(a + 1) % n_out]) \
            + 0.5 * rng.standard_normal((len(a), d))
    return feats.astype(np.float32), labels


@pytest.fixture(scope="module")
def jax_warm_odl():
    """A warm head built by the JAX package on clustered features (12 calls
    of 32 rows: count 384 >= 288), and the features' class centres."""
    jax = _jax()
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.models import model as j_model

    j_cfg = j_configs.get_config(ARCH, "smoke")
    rng = np.random.default_rng(5)
    centers = 2.0 * rng.standard_normal((j_cfg.odl.n_out, j_cfg.d_model))
    step = jax.jit(lambda o, f, y: j_model.odl_update(o, f, y, j_cfg))
    odl = j_model.init_odl_state(j_cfg)
    for _ in range(12):
        f, y = _clustered(rng, 32, j_cfg.d_model, j_cfg.odl.n_out, centers)
        odl, _ = step(odl, jnp.asarray(f), jnp.asarray(y))
    assert int(odl.elm.count) >= 288 and int(odl.prune.level) > 0, odl.prune
    return odl, centers


def _odl_to_port(j_odl, device=CPU):
    return model_lib.ODLState(
        elm=oselm.OSELMState(*(torch.tensor(np.array(x), device=device) for x in j_odl.elm)),
        prune=pruning.PruneState(*(torch.tensor(np.array(x), device=device)
                                   for x in j_odl.prune)))


def _gate(pkg_oselm, pkg_pruning, odl, feats, ecfg):
    """Each package's own gate on (odl, feats): preds and the queried mask,
    as its ``odl_update`` decides them."""
    preds, outs = pkg_oselm.predict(odl.elm, feats, ecfg)
    pcfg = pkg_pruning.PruneConfig.for_hidden(ecfg.n_hidden)
    conf = pkg_pruning.confidence(outs)
    prune = (odl.elm.count >= pcfg.min_trained) & (conf > pkg_pruning.theta_of(odl.prune, pcfg))
    return _np(preds), ~_np(prune)


def _check_odl_against_jax(j_odl, feats, labels, expect_pruned, cold=False):
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning
    from repro.models import model as j_model

    j_cfg = j_configs.get_config(ARCH, "smoke")
    cfg = configs.get_config(ARCH, "smoke")
    odl = _odl_to_port(j_odl)
    j_preds, j_queried = _gate(j_oselm, j_pruning, j_odl, jnp.asarray(feats),
                               j_model.elm_config(j_cfg))
    preds, queried = _gate(oselm, pruning, odl, torch.as_tensor(feats),
                           model_lib.elm_config(cfg))
    np.testing.assert_array_equal(preds, j_preds)
    np.testing.assert_array_equal(queried, j_queried)
    assert (not queried.all()) == expect_pruned and queried.any(), queried

    want, j_metrics = j_model.odl_update(j_odl, jnp.asarray(feats), jnp.asarray(labels), j_cfg)
    got, metrics = model_lib.odl_update(odl, torch.as_tensor(feats), torch.as_tensor(labels), cfg)
    # The fractions as counts of rows (the two frameworks' means may round
    # k/B to neighbouring floats).
    k = len(labels)
    for key in ("odl_query_frac", "odl_acc"):
        assert round(float(metrics[key]) * k) == round(float(j_metrics[key]) * k), key
    assert float(metrics["odl_theta"]) == float(j_metrics["odl_theta"])
    assert int(got.elm.count) == int(want.elm.count) == int(j_odl.elm.count) + queried.sum()
    for f in pruning.PruneState._fields:
        assert int(getattr(got.prune, f)) == int(getattr(want.prune, f)), f
    if cold:
        for leaf in ("P", "beta"):
            np.testing.assert_allclose(_np(getattr(got.elm, leaf)), getattr(want.elm, leaf),
                                       rtol=COLD_TOL, atol=COLD_TOL, err_msg=leaf)
        return
    ridge = cfg.odl.ridge
    dp = np.abs(_np(got.elm.P) - np.asarray(want.elm.P)).max() * ridge
    db = np.abs(_np(got.elm.beta) - np.asarray(want.elm.beta)).max()
    assert dp < P_TOL and db < BETA_TOL, (dp, db)


def test_odl_update_cold_against_the_reference():
    _jax()
    from repro import configs as j_configs
    from repro.models import model as j_model

    cfg = configs.get_config(ARCH, "smoke")
    rng = np.random.default_rng(9)
    feats = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.odl.n_out, B).astype(np.int32)
    _check_odl_against_jax(j_model.init_odl_state(j_configs.get_config(ARCH, "smoke")),
                           feats, labels, expect_pruned=False, cold=True)


def test_odl_update_warm_against_the_reference(jax_warm_odl):
    j_odl, centers = jax_warm_odl
    rng = np.random.default_rng(11)
    feats, labels = _clustered(rng, 32, centers.shape[1], centers.shape[0], centers,
                               ambiguous=True)
    _check_odl_against_jax(j_odl, feats, labels, expect_pruned=True)


def test_odl_update_past_the_single_pass_takes_the_two_stage_route(jax_warm_odl):
    """k = 96 rows (B x microbatches) reach the RLS update in one call: past
    the single pass's 64, the dispatch routes it to the two-stage route (on
    the card; the ``cuda`` test below counts it); on the CPU the plain
    version runs, within the warm tolerances of the JAX package's update."""
    cfg = configs.get_config(ARCH, "smoke")
    assert ops.rls_route(cfg.odl.n_hidden, 96, cfg.odl.n_out) == "two_stage"
    assert ops.rls_route(cfg.odl.n_hidden, 64, cfg.odl.n_out) == "single"
    j_odl, centers = jax_warm_odl
    feats, labels = _clustered(np.random.default_rng(12), 96, centers.shape[1],
                               centers.shape[0], centers, ambiguous=True)
    _check_odl_against_jax(j_odl, feats, labels, expect_pruned=True)


# ---------------------------------------------------------------------------
# train_step against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_train():
    """The JAX package's smoke config, a TrainState on numpy params, and its
    jitted train_step by microbatch count (compiled once per module)."""
    jax = _jax()
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.models import model as j_model
    from repro.optim import adam as j_adam

    from test_torch_models import numpy_params

    j_cfg = j_configs.get_config(ARCH, "smoke")
    params = jax.tree.map(jnp.asarray, numpy_params(
        j_model.build_schema(j_cfg), j_model.layers._iter_leaves, 3))
    state = j_model.TrainState(params=params, opt=j_adam.init(params),
                               odl=j_model.init_odl_state(j_cfg))
    steps = {}

    def step_fn(mb):
        if mb not in steps:
            tcfg = JTrainConfig(microbatches=mb)
            steps[mb] = jax.jit(lambda st, b: j_model.train_step(st, b, j_cfg, tcfg))
        return steps[mb]

    return j_cfg, state, step_fn


@pytest.fixture(scope="module")
def jax_grads(jax_train):
    """The reference's gradients as its ``train_step`` forms them: jitted
    ``value_and_grad`` of ``_forward_loss`` (remat on, as ``TrainConfig``'s
    default), with ``microbatches`` = mb summed in f32 and divided by mb."""
    jax = _jax()
    import jax.numpy as jnp
    from repro.models import model as j_model

    j_cfg = jax_train[0]
    grad_fn = jax.value_and_grad(j_model._forward_loss, has_aux=True)
    fns = {}

    def grads(mb):
        def fn(params, batch):
            parts = [{k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(mb)]
            gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
            loss, feats = 0.0, []
            for part in parts:
                (l_i, (_, f_i)), g = grad_fn(params, part, j_cfg, True)
                gsum = jax.tree.map(lambda a, b: a + b.astype(jnp.float32) / mb, gsum, g)
                loss, feats = loss + l_i / mb, feats + [f_i]
            return loss, jnp.concatenate(feats), gsum

        if mb not in fns:
            fns[mb] = jax.jit(fn)
        return fns[mb]

    return grads


def _rel_fro(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _assert_grads_close(got: dict, want: dict, what):
    """Each gradient leaf, and each layer's slice of a stacked one, within
    FRO_REL of ``want`` (relative Frobenius)."""
    for (path, g), (path_w, w) in zip(_leaves(got), _leaves(want), strict=True):
        assert path == path_w
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, (what, path)
        slices = [(f"{path}[{i}]", g[i], w[i]) for i in range(len(w))] \
            if path.startswith("/layers/") else [(path, g, w)]
        for name, a, b in slices:
            err = _rel_fro(a, b)
            assert err < FRO_REL, (what, name, err)


@pytest.mark.parametrize("mb", [1, 2])
def test_grads_against_the_reference(jax_train, jax_grads, mb):
    """The gradient of every leaf (each layer apart) against
    ``jax.value_and_grad`` on the same numpy params and batch."""
    import jax.numpy as jnp

    _, j_state, _ = jax_train
    cfg = configs.get_config(ARCH, "smoke")
    np_batch = _batch(cfg, 1)
    want_loss, want_feats, want = jax_grads(mb)(
        j_state.params, {k: jnp.asarray(v) for k, v in np_batch.items()})
    state = convert.train_state_from_numpy(j_state, cfg, CPU)
    loss, feats, got = model_lib.accumulate_grads(
        state.params, _t_batch(np_batch), cfg, TrainConfig(microbatches=mb))
    assert abs(float(loss) - float(want_loss)) / abs(float(want_loss)) < FRO_REL
    assert _rel_fro(_np(feats), want_feats) < FRO_REL
    assert {t.dtype for _, t in _leaves(got)} == {torch.float32}
    _assert_grads_close(got, want, f"microbatches {mb}")


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_against_the_reference(jax_train, mb):
    import jax.numpy as jnp

    j_cfg, j_state, step_fn = jax_train
    cfg = configs.get_config(ARCH, "smoke")
    tcfg = TrainConfig(microbatches=mb)
    lr = tcfg.learning_rate
    for step in (1, 2):
        np_batch = _batch(cfg, step)
        state = convert.train_state_from_numpy(j_state, cfg, CPU, tcfg)
        j_new, j_metrics = step_fn(mb)(j_state, {k: jnp.asarray(v) for k, v in np_batch.items()})
        new, metrics = model_lib.train_step(state, _t_batch(np_batch), cfg, tcfg)
        for key in ("loss", "grad_norm"):
            want, got = float(j_metrics[key]), float(metrics[key])
            assert abs(got - want) / abs(want) < FRO_REL, (step, key, got, want)
        assert float(metrics["odl_query_frac"]) == float(j_metrics["odl_query_frac"]) == 1.0
        got, want = _state_leaves(new), _state_leaves(j_new)
        for k in want:  # a sanity check: the gradients are held above
            if k.startswith("params"):
                worst = np.abs(got[k].astype(np.float64) - want[k]).max()
                assert worst <= 2 * lr + 1e-6, (step, k, worst)
        assert got["step"] == want["step"] == step
        assert got["elm.count"] == want["elm.count"] == step * B
        j_state = j_new


# ---------------------------------------------------------------------------
# The port alone
# ---------------------------------------------------------------------------


def test_train_state_round_trips_through_numpy_and_a_checkpoint(tmp_path):
    from repro_torch.runtime.checkpoint import CheckpointManager

    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    state, _ = model_lib.train_step(state, _t_batch(_batch(cfg, 1)), cfg)
    again = convert.train_state_from_numpy(convert.train_state_to_numpy(state), cfg, CPU)
    _assert_bitwise(state, again, "numpy round trip")
    # Master params in f32, never the serving dtypes of lm_params_from_numpy.
    assert {t.dtype for _, t in _leaves(again.params)} == {torch.float32}
    assert again.opt.step.shape == () and again.odl.elm.count.shape == ()
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, state)
    step, tree = mgr.restore()
    assert step == 1
    _assert_bitwise(state, convert.train_state_from_numpy(tree, cfg, CPU), "checkpoint")
    with pytest.raises(ValueError, match="shape"):
        bad = convert.train_state_to_numpy(state)
        bad.params["embed"] = bad.params["embed"][:-1]
        convert.train_state_from_numpy(bad, cfg, CPU)


def test_two_train_steps_from_one_state_are_bit_for_bit():
    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    batch = _t_batch(_batch(cfg, 1))
    a, ma = model_lib.train_step(_clone(state), batch, cfg)
    b, mb = model_lib.train_step(_clone(state), batch, cfg)
    _assert_bitwise(a, b, "two steps from one state")
    assert all(float(ma[k]) == float(mb[k]) for k in ma)


def test_train_step_writes_the_state_in_place():
    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    embed = state.params["embed"]
    before = embed.clone()
    new, _ = model_lib.train_step(state, _t_batch(_batch(cfg, 1)), cfg)
    assert new.params["embed"] is embed and not torch.equal(embed, before)


@pytest.mark.parametrize("mb", [1, 2])
def test_remat_equals_no_remat(mb):
    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    batch = _t_batch(_batch(cfg, 1))
    l0, f0, g0 = model_lib.loss_and_grads(state.params, batch, cfg, remat=False)
    l1, f1, g1 = model_lib.loss_and_grads(state.params, batch, cfg, remat=True)
    assert abs(float(l0) - float(l1)) <= 1e-6
    torch.testing.assert_close(f0, f1, rtol=0, atol=1e-6)
    for (path, a), (_, b) in zip(_leaves(g0), _leaves(g1), strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=path)
    # And through whole steps, with and without accumulation.
    outs = []
    for remat in (False, True):
        tcfg = TrainConfig(microbatches=mb, remat=remat)
        new, m = model_lib.train_step(_clone(state), batch, cfg, tcfg)
        outs.append((new, float(m["loss"])))
    assert abs(outs[0][1] - outs[1][1]) <= 1e-6
    for (path, a), (_, b) in zip(_leaves(outs[0][0].params), _leaves(outs[1][0].params)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=path)


def test_lm_hidden_checkpoints_only_while_training():
    """Serving (no grad recorded) runs the plain loop: no checkpoint frame."""
    from repro_torch.models import transformer

    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    toks = torch.as_tensor(_batch(cfg, 1)["tokens"])
    h, _ = transformer.lm_hidden(state.params, toks, cfg, remat=True)
    assert h.grad_fn is None
    with torch.no_grad():
        h2, _ = transformer.lm_hidden(state.params, toks, cfg, remat=True)
    assert torch.equal(h, h2)


def _train(tmp, steps, **kw):
    return train_mod.train(ARCH, "smoke", steps=steps, batch=4, seq=S, ckpt_dir=tmp,
                           ckpt_every=4, log_every=100, device=CPU, **kw)


def test_resume_equals_uninterrupted(tmp_path):
    full, full_losses = _train(None, 8)
    first, first_losses = _train(str(tmp_path / "run"), 4)
    resumed, resumed_losses = _train(str(tmp_path / "run"), 8)
    _assert_bitwise(resumed, full, "4 steps + resume to 8 against 8")
    assert first_losses + resumed_losses == full_losses
    assert len(resumed_losses) == 4
    # A run whose checkpoint is already at its last step trains nothing.
    _, none = _train(str(tmp_path / "run"), 8)
    assert none == []


def test_nan_guard_rolls_back(tmp_path, monkeypatch, caplog):
    """A non-finite loss at step 5 rolls back to step 4's checkpoint and
    skips batch 5: the run ends as steps 1-4, 6, 7, 8 in one go."""
    real = train_mod.make_step

    def poisoned(cfg, tcfg):
        step = real(cfg, tcfg)
        calls = iter(range(1, 100))

        def wrapped(state, batch):
            new, metrics = step(state, batch)
            if next(calls) == 5:
                metrics = dict(metrics, loss=torch.tensor(float("nan")))
            return new, metrics

        return wrapped

    monkeypatch.setattr(train_mod, "make_step", poisoned)
    with caplog.at_level("WARNING", logger="repro_torch.fault"):
        got, losses = _train(str(tmp_path / "run"), 8)
    assert "rolling back" in caplog.text
    assert math.isnan(losses[4]) and all(math.isfinite(x) for i, x in enumerate(losses) if i != 4)
    monkeypatch.setattr(train_mod, "make_step", real)

    cfg = configs.get_config(ARCH, "smoke")
    want, _ = _train(None, 4)
    for step in (6, 7, 8):
        want, _ = model_lib.train_step(want, _t_batch(_batch(cfg, step, batch=4)), cfg)
    _assert_bitwise(got, want, "rolled back run")


def _reference_flags():
    src = (ROOT / "src/repro/launch/train.py").read_text()
    main = src[src.index("def main(argv=None):"):]
    return re.findall(r'ap\.add_argument\(\s*"(--[a-z0-9-]+)"', main)


def test_main_parses_every_flag_of_the_reference(monkeypatch, capsys):
    flags = _reference_flags()
    assert len(flags) == 8
    values = {"--arch": "h2o-danube-1.8b", "--variant": "full", "--ckpt-dir": "/x"}
    argv = []
    for f in flags:
        argv += [f, values.get(f, "3")]
    calls = {}

    def fake_train(*a, **k):
        calls["train"] = (a, k)
        return None, [2.0, 1.0]

    monkeypatch.setattr(train_mod, "train", fake_train)
    train_mod.main(argv + ["--device", CPU])
    a, k = calls["train"]
    assert a == ("h2o-danube-1.8b", "full", 3, 3, 3, "/x")
    assert k["microbatches"] == 3 and k["seed"] == 3 and str(k["device"]) == CPU
    assert "final loss 1.0000 (first 2.0000)" in capsys.readouterr().out


def test_cli_without_a_card_or_device_exits_1():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    for module in ("repro_torch.launch.train", "repro_torch.examples.train_lm_odl"):
        out = subprocess.run([sys.executable, "-m", module, "--steps", "1"], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 1, (module, out.stdout, out.stderr[-2000:])
        assert "no CUDA device" in out.stderr


def test_example_runs(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    train_lm_odl.main(["--device", CPU, "--steps", "3", "--ckpt-dir", str(ckpt)])
    out = capsys.readouterr().out
    assert "preset=smoke: 139,648 params, 3 steps" in out and "loss:" in out
    assert "/tmp/repro_lm_odl_ckpt" not in train_lm_odl.__doc__
    # Without --ckpt-dir nothing is saved: a second run trains again.
    for _ in range(2):
        train_lm_odl.main(["--device", CPU, "--steps", "1"])
        assert "loss:" in capsys.readouterr().out
    p = train_lm_odl.preset_cfg("100m")
    assert p["cfg"].n_layers == 12 and p["cfg"].d_model == 768
    assert configs.get_config(ARCH, "smoke").n_layers == 2  # nothing patched


def test_train_config_equals_the_reference():
    _jax()
    from repro.configs.base import TrainConfig as JTrainConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("mb", [1, 2])
def test_card_grads_match_the_cpu(cuda_device, mb):
    """Every gradient leaf (each layer apart) on the card against the CPU's,
    within the relative Frobenius bound the JAX comparison uses."""
    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    batch = _batch(cfg, 1)
    tcfg = TrainConfig(microbatches=mb)
    card = convert.train_state_from_numpy(state, cfg, cuda_device)
    lc, fc, gc = model_lib.accumulate_grads(card.params, _t_batch(batch, cuda_device), cfg, tcfg)
    lh, fh, gh = model_lib.accumulate_grads(state.params, _t_batch(batch), cfg, tcfg)
    assert abs(float(lc) - float(lh)) / abs(float(lh)) < FRO_REL
    assert _rel_fro(_np(fc), _np(fh)) < FRO_REL
    _assert_grads_close(gc, _map_np(gh), f"card, microbatches {mb}")


def _map_np(tree):
    return {k: _map_np(v) if isinstance(v, dict) else _np(v) for k, v in tree.items()}


@pytest.mark.cuda
def test_card_train_step_matches_the_cpu(cuda_device):
    cfg = configs.get_config(ARCH, "smoke")
    state = _port_state(cfg)
    batch = _batch(cfg, 1)
    lr = TrainConfig().learning_rate
    ops.reset_launch_counts()
    card, mc = model_lib.train_step(
        convert.train_state_from_numpy(state, cfg, cuda_device), _t_batch(batch, cuda_device), cfg)
    assert ops.launch_counts["oselm_rls_update"] == 1
    assert ops.launch_counts["xorshift_projection"] == 2
    host, mh = model_lib.train_step(_clone(state), _t_batch(batch), cfg)
    for key in ("loss", "grad_norm"):
        assert abs(float(mc[key]) - float(mh[key])) / abs(float(mh[key])) < FRO_REL, key
    assert float(mc["odl_query_frac"]) == float(mh["odl_query_frac"]) == 1.0
    got, want = _state_leaves(card), _state_leaves(host)
    for k in want:  # a sanity check: the gradients are held above
        if k.startswith("params"):
            assert np.abs(got[k] - want[k]).max() <= 2 * lr + 1e-6, k


def _cpu_warm_odl(cfg, rng):
    """A warm head built on the CPU (12 calls of 32 clustered rows: count
    384 >= 288, level > 0) and the clusters' centres."""
    centers = 2.0 * rng.standard_normal((cfg.odl.n_out, cfg.d_model))
    odl = model_lib.init_odl_state(cfg, CPU)
    for _ in range(12):
        f, y = _clustered(rng, 32, cfg.d_model, cfg.odl.n_out, centers)
        odl, _ = model_lib.odl_update(odl, torch.as_tensor(f), torch.as_tensor(y), cfg)
    assert int(odl.elm.count) >= 288 and int(odl.prune.level) > 0
    return odl, centers


def _card_against_cpu(cfg, odl, f, y, device):
    """One odl_update from ``odl`` on the card and on the CPU: decisions
    exact, P and beta within the warm tolerances."""
    card_odl = model_lib.ODLState(*(type(g)(*(t.to(device) for t in g)) for g in odl))
    host, mh = model_lib.odl_update(odl, torch.as_tensor(f), torch.as_tensor(y), cfg)
    card, mc = model_lib.odl_update(card_odl, torch.as_tensor(f, device=device),
                                    torch.as_tensor(y, device=device), cfg)
    assert 0.0 < float(mh["odl_query_frac"]) < 1.0
    k = len(y)  # the fractions as counts of rows (each device's mean rounds k/B)
    for key in ("odl_query_frac", "odl_acc"):
        assert round(float(mc[key]) * k) == round(float(mh[key]) * k), key
    assert float(mc["odl_theta"]) == float(mh["odl_theta"])
    assert int(card.elm.count) == int(host.elm.count)
    for fld in pruning.PruneState._fields:
        assert int(getattr(card.prune, fld)) == int(getattr(host.prune, fld)), fld
    assert (card.elm.P.cpu() - host.elm.P).abs().max().item() * cfg.odl.ridge < P_TOL
    assert (card.elm.beta.cpu() - host.elm.beta).abs().max().item() < BETA_TOL


@pytest.mark.cuda
def test_card_odl_update_matches_the_cpu_from_a_warm_state(cuda_device):
    cfg = configs.get_config(ARCH, "smoke")
    rng = np.random.default_rng(5)
    odl, centers = _cpu_warm_odl(cfg, rng)
    f, y = _clustered(rng, 32, cfg.d_model, cfg.odl.n_out, centers, ambiguous=True)
    ops.reset_launch_counts()
    _card_against_cpu(cfg, odl, f, y, cuda_device)
    assert ops.launch_counts["oselm_rls_update"] == 1


@pytest.mark.cuda
def test_card_training_launches_the_one_head_rls_kernel(cuda_device, tmp_path):
    ops.reset_launch_counts()
    state, losses = train_mod.train(ARCH, "smoke", steps=2, batch=4, seq=S, device=cuda_device,
                                    ckpt_dir=str(tmp_path), ckpt_every=1, log_every=100)
    assert ops.launch_counts["oselm_rls_update"] == 2
    assert ops.launch_counts["xorshift_projection"] == 4
    assert all(math.isfinite(x) for x in losses)


@pytest.mark.cuda
def test_card_odl_update_past_the_single_pass_takes_the_two_stage_route(cuda_device):
    cfg = configs.get_config(ARCH, "smoke")
    rng = np.random.default_rng(13)
    odl, centers = _cpu_warm_odl(cfg, rng)
    f, y = _clustered(rng, 96, cfg.d_model, cfg.odl.n_out, centers, ambiguous=True)
    ops.reset_launch_counts()
    _card_against_cpu(cfg, odl, f, y, cuda_device)
    assert ops.launch_counts["rls_two_stage"] == 1 and ops.launch_counts["oselm_rls_update"] == 0


def test_rls_breakdown_marks_match_the_kernel_source():
    """The breakdown script's phases name the marks each kernel of the
    single pass sets, each once in that kernel (the general body and
    rank1_stream share ``rls_single_kernel``; the rank-1 cluster body is a
    kernel of its own), and the script needs a card."""
    from repro_torch.benchmarks import rls_breakdown

    src = (ROOT / "src/repro_torch/kernels/csrc/oselm_update.cu").read_text()
    kernels = {}
    for part in src.split("__global__ void")[1:]:
        name = re.search(r"(\w+)\(", part.split("\n", 1)[1]).group(1)
        kernels[name] = [int(i) for i in re.findall(r"RLS_MARK\((\d+), \w+\);", part)]
    assert sorted(kernels["rls_single_kernel"]) == list(range(rls_breakdown.N_MARKS))
    assert sorted(kernels["rls_rank1_cluster_kernel"]) == [0, 1, 2, 3, 4, 5, 8]
    assert kernels["rls_fleet_kernel"] == []

    def used(body):
        return {i for _, lo, hi in (rls_breakdown.START, rls_breakdown.WAIT)
                + rls_breakdown.PHASES[body] for i in (lo, hi)}

    assert used("general") == set(range(rls_breakdown.N_MARKS))
    assert used("rank1_stream") == {0, 1, 2, 8}
    assert used("rank1_cluster") == set(kernels["rls_rank1_cluster_kernel"])
    if not torch.cuda.is_available():
        assert rls_breakdown.main([]) == 1
