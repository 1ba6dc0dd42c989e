"""The dense stacks' training step over partitioned leaves
(``model.place_train_state`` and ``model.partitioned_train_step``), held
against the JAX package's sharded step and the port's meshless step on the
CPU.

The port's meshes are ``make_dev_mesh(d, m, devices=["cpu"] * (d m))``.
The JAX side needs 8 host devices, so it runs once, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_multidevice.py`` does): qwen3-4b at smoke width, its numpy
params drawn here at the port's init scale, two f32 steps of its
``train_step`` under ``sharding.activate(make_dev_mesh(2, 4))`` with remat
off, as ``test_multidevice.py:45`` runs it.

* Against the reference: loss and grad norm within 1e-5 (relative), every
  param within 1e-5 (``test_torch_mesh_model._assert_params_close``'s
  bound), every moment within 1e-5 of its scale.
* Against the meshless step: every dense arch at smoke on the (2, 4),
  (4, 2) and (2, 2) meshes, two steps from one state: in f32 the same
  bounds; in bf16 the reference test's own, loss rtol 2e-2 and leaves
  atol/rtol 3e-2.  A layout where "model" falls off the head dim (6 q heads
  on a 4-way axis) and FSDP splits leaves over "data" (``layers._BIG`` and
  ``_FSDP`` lowered so that smoke leaves pass them) on every mesh.
* Bookkeeping: after a step every param and moment is a ``Sharded`` on its
  ``abstract_train_state`` placement whose shards are that placement's
  slices of the gathered whole; each position's bytes equal the dry-run's
  per-device bytes; a step's exchanges under a census equal
  ``census.partitioned_train_exchanges``; the head, fed the step's
  gathered features, decides exactly as the meshless head on them.
* Resume (2 steps, save, restore, 2 more = 4 steps bit for bit), remat
  against no remat, 2 microbatches against 1, and the stacks the step does
  not run raise.
* The collectives of ``distributed.sharding`` and the partitioned pieces
  (vocab-parallel embedding and cross-entropy, TP attention) against their
  whole versions.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import census, dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402

from test_torch_train_families import _batch, _leaves, _params_np, _t_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
MESHES = [(2, 4), (4, 2), (2, 2)]
DENSE = ["qwen3-4b", "h2o-danube-1.8b", "mistral-nemo-12b", "deepseek-coder-33b",
         "chameleon-34b"]
OTHERS = ["mamba2-780m", "recurrentgemma-9b", "whisper-small"]
REF_ARCH = "qwen3-4b"
BATCH = 8  # rows a step: 4 a data row on (2, 4), 2 on (4, 2)
NO_REMAT = TrainConfig(remat=False)

REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.configs.base import TrainConfig
from repro.distributed import sharding
from repro.launch.mesh import make_dev_mesh
from repro.models import layers, model as M
from repro.optim import adam

inp = dict(np.load(sys.argv[1]))
params = {}
for key, v in inp.items():
    if key.startswith("params/"):
        sub = params
        parts = key[len("params/"):].split("/")
        for p in parts[:-1]:
            sub = sub.setdefault(p, {})
        sub[parts[-1]] = jnp.asarray(v)
layers.COMPUTE_DTYPE = jnp.float32
cfg = configs.get_config(str(inp["arch"]), "smoke")
tcfg = TrainConfig(remat=False)
state = M.TrainState(params=params, opt=adam.init(params), odl=M.init_odl_state(cfg))
out = {}
with sharding.activate(make_dev_mesh(2, 4)):
    step = jax.jit(lambda s, b: M.train_step(s, b, cfg, tcfg))
    for i in (1, 2):
        batch = {k: jnp.asarray(inp[f"batch{i}/{k}"]) for k in ("tokens", "labels", "odl_labels")}
        state, metrics = step(state, batch)
        for k in ("loss", "grad_norm"):
            out[f"train{i}/{k}"] = np.asarray(metrics[k])
for name, tree in (("params", state.params), ("m", state.opt.m), ("v", state.opt.v)):
    for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[name + "/" + "/".join(p.key for p in path)] = np.asarray(a)
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:  # the reference runs in a subprocess
        pytest.skip("the JAX package's reference needs jax")
    tmp = tmp_path_factory.mktemp("partitioned_train")
    cfg = configs.get_config(REF_ARCH, "smoke")
    inp = {"params" + path: a for path, a in _leaves(_params_np(REF_ARCH))}
    for i in (1, 2):
        inp.update({f"batch{i}/{k}": v for k, v in _batch(cfg, i, batch=BATCH).items()})
    inp["arch"] = np.array(REF_ARCH)
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "in.npz"),
                        str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-4000:]}"
    return dict(np.load(tmp / "out.npz")), inp


def _mesh(d, m):
    return mesh_lib.make_dev_mesh(d, m, devices=[CPU] * (d * m))


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def small_thresholds(monkeypatch):
    """``_BIG`` and ``_FSDP`` low enough that smoke leaves pass them: the
    post-pass puts "model" on another dim where the natural one does not
    divide, and "data" on the largest free dim of the larger leaves."""
    monkeypatch.setattr(layers, "_BIG", 1 << 10)
    monkeypatch.setattr(layers, "_FSDP", 1 << 12)


def _host_state(cfg, tcfg=TrainConfig(), params=None):
    host = convert.train_state_to_numpy(model_lib.init_train_state(cfg, 0, tcfg, device=CPU))
    return host if params is None else host._replace(params=params)


def _pair(cfg, mesh, tcfg=TrainConfig(), params=None):
    """(a whole state, the same state placed on ``mesh``), from one host state."""
    host = _host_state(cfg, tcfg, params)
    whole = convert.train_state_from_numpy(host, cfg, CPU, tcfg)
    placed = model_lib.place_train_state(convert.train_state_from_numpy(host, cfg, CPU, tcfg),
                                         mesh, cfg, tcfg)
    return whole, placed


def _steps(state, cfg, tcfg, mesh, steps=(1, 2), batch=BATCH):
    metrics = []
    for i in steps:
        b = _t_batch(_batch(cfg, i, batch=batch))
        if mesh is None:
            state, m = model_lib.train_step(state, b, cfg, tcfg)
        else:
            with sharding.activate(mesh):
                state, m = model_lib.train_step(state, b, cfg, tcfg)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().numpy() for k, v in tree.items()}


def _assert_states_close(got, want, bf16: bool, what):
    """Params within 1e-5 (abs) and moments within 1e-5 of their scale in
    f32; in bf16 every leaf within the reference test's atol = rtol = 3e-2."""
    for name in ("params", "m", "v"):
        a = got.params if name == "params" else getattr(got.opt, name)
        b = want.params if name == "params" else getattr(want.opt, name)
        for (path, x), (_, y) in zip(_leaves(_np_tree(a)), _leaves(_np_tree(b)), strict=True):
            x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
            if bf16:
                np.testing.assert_allclose(x, y, atol=3e-2, rtol=3e-2, err_msg=f"{what} {path}")
            else:
                scale = 1.0 if name == "params" else max(np.abs(y).max(), 1e-30)
                worst = np.abs(x - y).max() / scale
                assert worst <= 1e-5, (what, name, path, worst)


def _assert_metrics_close(got, want, bf16: bool, what):
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        if bf16:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=2e-2, err_msg=what)
        else:
            for key in ("loss", "grad_norm"):
                assert abs(a[key] - b[key]) <= 1e-5 * abs(b[key]), (what, i, key, a[key], b[key])


# ---------------------------------------------------------------------------
# Against the JAX package's sharded step
# ---------------------------------------------------------------------------


def test_partitioned_step_against_the_reference(ref, f32):
    out, inp = ref
    cfg = configs.get_config(REF_ARCH, "smoke")
    mesh = _mesh(2, 4)
    _, state = _pair(cfg, mesh, NO_REMAT, _params_np(REF_ARCH))
    for i in (1, 2):
        batch = {k: torch.as_tensor(inp[f"batch{i}/{k}"]) for k in ("tokens", "labels",
                                                                    "odl_labels")}
        with sharding.activate(mesh):
            state, metrics = model_lib.train_step(state, batch, cfg, NO_REMAT)
        for key in ("loss", "grad_norm"):
            want = float(out[f"train{i}/{key}"])
            assert abs(float(metrics[key]) - want) <= 1e-5 * abs(want), (i, key)
    assert model_lib.is_partitioned(state)
    whole = model_lib.gather_train_state(state)
    for name, tree in (("params", whole.params), ("m", whole.opt.m), ("v", whole.opt.v)):
        for path, a in _leaves(_np_tree(tree)):
            want = out[name + path]
            scale = 1.0 if name == "params" else np.abs(want).max()
            worst = np.abs(np.asarray(a, np.float64) - want).max() / scale
            assert worst <= 1e-5, (name, path, worst)


# ---------------------------------------------------------------------------
# Against the port's meshless step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", DENSE)
def test_partitioned_step_equals_the_meshless_step(arch, shape, dtype, monkeypatch):
    if dtype == "f32":
        monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    cfg = configs.get_config(arch, "smoke")
    mesh = _mesh(*shape)
    whole, placed = _pair(cfg, mesh, NO_REMAT)
    whole, m_whole = _steps(whole, cfg, NO_REMAT, None)
    placed, m_placed = _steps(placed, cfg, NO_REMAT, mesh)
    _assert_metrics_close(m_placed, m_whole, dtype == "bf16", (arch, shape))
    _assert_states_close(model_lib.gather_train_state(placed), whole, dtype == "bf16",
                         (arch, shape))
    assert int(placed.opt.step) == 2 and all(
        t.isfinite().all() for sh in adam.leaves(placed.params) for t in sh.shards.values())


def _off_head_cfg():
    """qwen3-4b smoke with 6 q heads (3 a kv head): on a 4-way "model" axis
    the heads do not split, and the post-pass puts "model" on d_model."""
    return configs.get_config("qwen3-4b", "smoke").replace(n_heads=6, n_kv_heads=2)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_model_off_the_head_dim_and_fsdp_leaves(shape, f32, small_thresholds):
    cfg = _off_head_cfg()
    mesh = _mesh(*shape)
    whole, placed = _pair(cfg, mesh, NO_REMAT)
    specs = {k: placed.params["layers"]["attn"][k].placement.spec for k in ("wq", "wo")}
    specs["wg"] = placed.params["layers"]["mlp"]["wg"].placement.spec
    assert "data" in specs["wg"] and "model" in specs["wg"]  # FSDP and TP
    if shape[1] == 4:  # 6 heads do not split 4 ways: "model" on d_model
        assert specs["wq"] == sharding.P(None, "model", None, "data")
        assert specs["wo"] == sharding.P(None, None, "data", "model")
    else:
        assert specs["wq"][2] == "model" and "data" in specs["wq"]
    whole, m_whole = _steps(whole, cfg, NO_REMAT, None)
    placed, m_placed = _steps(placed, cfg, NO_REMAT, mesh)
    _assert_metrics_close(m_placed, m_whole, False, shape)
    _assert_states_close(model_lib.gather_train_state(placed), whole, False, shape)


# ---------------------------------------------------------------------------
# Layout and bookkeeping
# ---------------------------------------------------------------------------


def _placements(cfg, mesh, tcfg=TrainConfig()):
    with sharding.activate(mesh):
        return model_lib.abstract_train_state(cfg, tcfg)


@pytest.mark.parametrize("layout", ["natural", "off_head_fsdp"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_shards_are_their_placements_slices_and_the_census_bytes(shape, layout, monkeypatch):
    """After a step, every param and moment is a ``Sharded`` on its
    ``abstract_train_state`` placement whose shards are exactly the slices
    that placement names of the gathered whole (the positions that hold
    one slice hold the same bits), on their entries; each position's bytes
    equal the dry-run's per-device bytes of params and moments."""
    cfg = configs.get_config("qwen3-4b", "smoke")
    if layout == "off_head_fsdp":
        monkeypatch.setattr(layers, "_BIG", 1 << 10)
        monkeypatch.setattr(layers, "_FSDP", 1 << 12)
        cfg = _off_head_cfg()
    mesh = _mesh(*shape)
    _, placed = _pair(cfg, mesh)
    placed, _ = _steps(placed, cfg, TrainConfig(), mesh, steps=(1,))
    metas, pl = _placements(cfg, mesh)
    per_pos = {pos: 0 for pos in mesh.positions()}
    want_bytes = 0
    for tree, meta_tree, pl_tree in ((placed.params, metas.params, pl.params),
                                     (placed.opt.m, metas.opt.m, pl.opt.m),
                                     (placed.opt.v, metas.opt.v, pl.opt.v)):
        for sh, meta, placement in zip(adam.leaves(tree), adam.leaves(meta_tree),
                                       adam.leaves(pl_tree), strict=True):
            assert isinstance(sh, sharding.Sharded) and sh.placement == placement
            whole = sh.gather()
            for pos, index in placement.indices_map(tuple(meta.shape)).items():
                shard = sh.shards[pos]
                assert shard.device == mesh.device_at(pos) and shard.dtype == meta.dtype
                assert torch.equal(shard, whole[index]), (placement.spec, pos)
                per_pos[pos] += shard.numel() * shard.element_size()
            want_bytes += dryrun.device_bytes(meta, placement)
    assert set(per_pos.values()) == {want_bytes}
    assert placed.opt.step.device == mesh.devices[0] and int(placed.opt.step) == 1


CENSUS_CASES = {"natural": ("qwen3-4b", (2, 4), TrainConfig(remat=False)),
                "remat": ("h2o-danube-1.8b", (4, 2), TrainConfig()),
                "microbatches": ("chameleon-34b", (2, 2), TrainConfig(microbatches=2)),
                "off_head_fsdp": (None, (2, 4), TrainConfig(microbatches=2)),
                "off_head_fsdp_2x2": (None, (2, 2), TrainConfig())}


@pytest.mark.parametrize("case", list(CENSUS_CASES))
def test_step_exchanges_equal_the_analytic_count(case, monkeypatch):
    arch, shape, tcfg = CENSUS_CASES[case]
    if arch is None:
        monkeypatch.setattr(layers, "_BIG", 1 << 10)
        monkeypatch.setattr(layers, "_FSDP", 1 << 12)
        cfg = _off_head_cfg()
    else:
        cfg = configs.get_config(arch, "smoke")
    mesh = _mesh(*shape)
    _, placed = _pair(cfg, mesh, tcfg)
    batch = _t_batch(_batch(cfg, 1, batch=BATCH))
    with sharding.activate(mesh), census.StepCensus() as c:
        model_lib.train_step(placed, batch, cfg, tcfg)
    got = census.collective_census(c)
    want = census.partitioned_train_exchanges(cfg, tcfg, mesh, BATCH, batch["tokens"].shape[1])
    assert got == want
    assert {"all-gather", "reduce-scatter", "all-reduce", "gather"} <= set(got)


def _clustered(rng, n, centers):
    y = rng.integers(0, len(centers), n)
    return (centers[y] + 0.3 * rng.standard_normal((n, centers.shape[1]))).astype(np.float32), y


def test_the_head_decides_exactly_as_the_meshless_head_on_the_same_features(f32):
    """A warm head (some rows prune) in the partitioned state: the step's
    gathered features (within 1e-5 of the meshless step's, batch order)
    fed to the meshless ``odl_update`` give the step's head bit for bit."""
    cfg = configs.get_config("qwen3-4b", "smoke")
    mesh = _mesh(2, 4)
    rng = np.random.default_rng(0)
    centers = 2.0 * rng.standard_normal((cfg.odl.n_out, cfg.d_model))
    odl = model_lib.init_odl_state(cfg, CPU)
    for _ in range(40):
        f, y = _clustered(rng, BATCH, centers)
        odl, _ = model_lib.odl_update(odl, torch.as_tensor(f), torch.as_tensor(y), cfg)
    assert int(odl.elm.count) >= 288 and int(odl.prune.level) > 0
    whole, placed = _pair(cfg, mesh, NO_REMAT)
    placed = placed._replace(odl=odl)
    batch = _t_batch(_batch(cfg, 1, batch=BATCH))
    params = model_lib.gather_train_state(placed).params
    with torch.no_grad():
        hidden, _ = model_lib.transformer.lm_hidden(whole.params, batch["tokens"], cfg,
                                                    remat=False)
    want_feats = hidden.float().mean(1)
    with sharding.activate(mesh):
        feats = model_lib.partitioned_loss_and_grads(placed.params, batch, cfg, False)[1]
    assert (feats - want_feats).abs().max() <= 1e-5 * want_feats.abs().max()
    for a, b in zip(adam.leaves(params), adam.leaves(model_lib.gather_train_state(placed).params)):
        assert torch.equal(a, b)  # the loss pass wrote no param
    want, m_want = model_lib.odl_update(odl, feats, batch["odl_labels"], cfg)
    with sharding.activate(mesh):
        got, m_got = model_lib.train_step(placed, batch, cfg, NO_REMAT)
    for key in ("odl_query_frac", "odl_acc", "odl_theta"):
        assert float(m_got[key]) == float(m_want[key]), key
    assert 0.0 < float(m_want["odl_query_frac"]) <= 1.0
    for a, b in zip(list(got.odl.elm) + list(got.odl.prune), list(want.elm) + list(want.prune)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Resume, remat, accumulation, the other stacks
# ---------------------------------------------------------------------------


def _assert_equal_states(a, b):
    a, b = model_lib.gather_train_state(a), model_lib.gather_train_state(b)
    for x, y in zip(adam.leaves(a.params) + adam.leaves(a.opt.m) + adam.leaves(a.opt.v),
                    adam.leaves(b.params) + adam.leaves(b.opt.m) + adam.leaves(b.opt.v),
                    strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.opt.step, b.opt.step)
    for x, y in zip(list(a.odl.elm) + list(a.odl.prune), list(b.odl.elm) + list(b.odl.prune)):
        assert torch.equal(x, y)


def test_save_restore_resumes_bit_for_bit(tmp_path):
    cfg = configs.get_config("qwen3-4b", "smoke")
    mesh = _mesh(2, 4)
    _, straight = _pair(cfg, mesh)
    straight, m_straight = _steps(straight, cfg, TrainConfig(), mesh, steps=(1, 2, 3, 4))
    _, first = _pair(cfg, mesh)
    first, m_first = _steps(first, cfg, TrainConfig(), mesh, steps=(1, 2))
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(2, first)
    step, resumed = checkpoint.restore_train_state(mgr, cfg, mesh)
    assert step == 2 and model_lib.is_partitioned(resumed)
    resumed, m_resumed = _steps(resumed, cfg, TrainConfig(), mesh, steps=(3, 4))
    assert m_first + m_resumed == m_straight
    _assert_equal_states(resumed, straight)


def test_remat_equals_no_remat(f32):
    cfg = configs.get_config("mistral-nemo-12b", "smoke")
    mesh = _mesh(4, 2)
    _, a = _pair(cfg, mesh)
    _, b = _pair(cfg, mesh)
    a, m_a = _steps(a, cfg, TrainConfig(remat=True), mesh)
    b, m_b = _steps(b, cfg, NO_REMAT, mesh)
    assert m_a == m_b
    _assert_equal_states(a, b)


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)], ids=["2x4", "2x2"])
def test_two_microbatches_against_one(shape, f32):
    cfg = configs.get_config("qwen3-4b", "smoke")
    mesh = _mesh(*shape)
    mb2 = TrainConfig(remat=False, microbatches=2)
    whole, placed = _pair(cfg, mesh, mb2)
    whole, m_whole = _steps(whole, cfg, mb2, None)
    placed, m_placed = _steps(placed, cfg, mb2, mesh)
    _assert_metrics_close(m_placed, m_whole, False, "mb 2 against the meshless mb 2")
    _assert_states_close(model_lib.gather_train_state(placed), whole, False, "mb 2")
    _, one = _pair(cfg, mesh, NO_REMAT)
    one, m_one = _steps(one, cfg, NO_REMAT, mesh)
    _assert_metrics_close(m_placed, m_one, False, "mb 2 against mb 1")
    _assert_states_close(model_lib.gather_train_state(placed),
                         model_lib.gather_train_state(one), False, "mb 2 against mb 1")


@pytest.mark.parametrize("arch", OTHERS)
def test_other_stacks_raise_on_partitioned_leaves(arch):
    cfg = configs.get_config(arch, "smoke")
    mesh = _mesh(2, 2)
    placed = model_lib.place_train_state(model_lib.init_train_state(cfg, 0, device=CPU), mesh,
                                         cfg)
    assert model_lib.is_partitioned(placed)
    batch = _t_batch(_batch(cfg, 1, batch=4))
    with sharding.activate(mesh), pytest.raises(NotImplementedError, match="item 6.5"):
        model_lib.train_step(placed, batch, cfg)


def test_whole_state_under_a_mesh_keeps_the_meshless_step():
    cfg = configs.get_config("qwen3-4b", "smoke")
    host = _host_state(cfg)
    a = convert.train_state_from_numpy(host, cfg, CPU)
    b = convert.train_state_from_numpy(host, cfg, CPU)
    a, m_a = _steps(a, cfg, TrainConfig(), _mesh(2, 4), steps=(1,))
    b, m_b = _steps(b, cfg, TrainConfig(), None, steps=(1,))
    assert m_a == m_b and not model_lib.is_partitioned(a)
    for x, y in zip(adam.leaves(a.params), adam.leaves(b.params)):
        assert torch.equal(x, y)


def test_partitioned_state_needs_its_mesh_and_a_splitting_batch():
    cfg = configs.get_config("qwen3-4b", "smoke")
    mesh = _mesh(2, 2)
    _, placed = _pair(cfg, mesh)
    batch = _t_batch(_batch(cfg, 1, batch=4))
    with pytest.raises(ValueError, match="mesh current"):
        model_lib.train_step(placed, batch, cfg)
    with sharding.activate(_mesh(2, 4)), pytest.raises(ValueError, match="mesh current"):
        model_lib.train_step(placed, batch, cfg)
    odd = _t_batch(_batch(cfg, 1, batch=3))
    with sharding.activate(mesh), pytest.raises(ValueError, match="does not split"):
        model_lib.train_step(placed, odd, cfg)


# ---------------------------------------------------------------------------
# The collectives and the partitioned pieces
# ---------------------------------------------------------------------------


def _parts(mesh, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return {pos: torch.randn(shape, generator=g).requires_grad_() for pos in mesh.positions()}


@pytest.mark.parametrize("axis", ["data", "model"])
def test_collectives_values_gradients_and_census(axis):
    mesh = _mesh(2, 4)
    n = mesh.shape[axis]
    i = mesh.axis_names.index(axis)
    x = _parts(mesh, (n * 2, 3), 0)

    def along(pos):
        return [x[p] for p in sharding.peers(pos, mesh, axis)]

    with census.StepCensus() as c:
        gathered = sharding.all_gather(x, mesh, axis, 0)
        scattered = sharding.reduce_scatter(x, mesh, axis, 0)
        summed = sharding.all_reduce(x, mesh, axis)
        top = sharding.all_reduce(x, mesh, axis, op="max")
        cast = sharding.broadcast(x, mesh, axis, root=1)
    moves = 8 * (n - 1)
    size = n * 2 * 3 * 4
    want = {"all-gather": {"count": moves, "bytes": moves * size},
            "reduce-scatter": {"count": moves, "bytes": moves * size // n},
            "all-reduce": {"count": 2 * moves, "bytes": 2 * moves * size},
            "broadcast": {"count": 8 - 8 // n, "bytes": (8 - 8 // n) * size}}
    assert census.collective_census(c) == dict(want, total_bytes=sum(
        v["bytes"] for v in want.values()))
    for pos in mesh.positions():
        peers = along(pos)
        assert torch.equal(gathered[pos], torch.cat(peers))
        total = peers[0]
        for t in peers[1:]:
            total = total + t
        assert torch.equal(summed[pos], total)
        assert torch.equal(scattered[pos], total.chunk(n)[pos[i]])
        assert torch.equal(top[pos], torch.stack(peers).amax(0))
        assert torch.equal(cast[pos], peers[1])
    # The gradient of an all-gather is the reduce-scatter of the gradients,
    # tallied into the census its forward ran under.
    w = _parts(mesh, (n * n * 2, 3), 1)
    with census.StepCensus() as c:
        gathered = sharding.all_gather(x, mesh, axis, 0)
        sum((gathered[p] * w[p]).sum() for p in gathered).backward()
    assert census.collective_census(c) == {"all-gather": want["all-gather"],
                                           "reduce-scatter": want["all-gather"],
                                           "total_bytes": 2 * moves * size}
    for pos in mesh.positions():
        grads = [w[p].chunk(n)[pos[i]] for p in sharding.peers(pos, mesh, axis)]
        total = grads[0]
        for t in grads[1:]:
            total = total + t
        torch.testing.assert_close(x[pos].grad, total, rtol=1e-6, atol=1e-6)


def test_relayout_gathers_dropped_dims_minor_axis_first():
    mesh = _mesh(2, 4)
    whole = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    for src, dst in ((sharding.P(("data", "model"), None), sharding.P()),
                     (sharding.P("data", "model"), sharding.P(None, "model")),
                     (sharding.P("model", "data"), sharding.P())):
        held = sharding.Placement(mesh, src).place(whole).shards
        got = sharding.relayout(held, src, dst, mesh)
        want = sharding.Placement(mesh, dst).indices_map(tuple(whole.shape))
        for pos, index in want.items():
            assert torch.equal(got[pos], whole[index]), (src, dst, pos)
    with pytest.raises(ValueError, match="not dropped"):
        sharding.relayout(held, sharding.P("model", "data"), sharding.P("data"), mesh)


def test_vocab_parallel_embedding_and_cross_entropy_equal_the_whole(f32):
    mesh = _mesh(2, 4)
    rng = np.random.default_rng(0)
    v, d = 64, 8
    table = torch.as_tensor(rng.standard_normal((v, d)).astype(np.float32))
    tokens = torch.as_tensor(rng.integers(0, v, (2, 5)))
    logits = torch.as_tensor(rng.standard_normal((2, 5, v)).astype(np.float32) * 4)
    mi = 1
    blocks = {pos: table[pos[mi] * 16:(pos[mi] + 1) * 16] for pos in mesh.positions()}
    toks = {pos: tokens for pos in mesh.positions()}
    emb = layers.vocab_parallel_embed(toks, blocks, mesh, split=True)
    rows = layers.vocab_parallel_cross_entropy(
        {pos: logits[..., pos[mi] * 16:(pos[mi] + 1) * 16] for pos in mesh.positions()},
        toks, mesh, split=True)
    want_rows = layers.cross_entropy_rows(logits, tokens)
    for pos in mesh.positions():
        assert torch.equal(emb[pos], table[tokens])
        torch.testing.assert_close(rows[pos], want_rows, rtol=1e-6, atol=1e-6)
    assert torch.equal(layers.softmax_cross_entropy(logits, tokens), want_rows.mean())


@pytest.mark.parametrize("kv_heads", [2, 4])
def test_tp_attention_sums_to_the_whole(kv_heads, f32):
    """4 q heads on a 4-way axis, with 2 kv heads (kept whole and sliced
    per position) or 4 (split): the partial outputs summed over "model"
    equal ``gqa_attention``."""
    cfg = configs.get_config("qwen3-4b", "smoke").replace(n_kv_heads=kv_heads)
    mesh = _mesh(2, 4)
    p = layers.init_params(attention.gqa_schema(cfg), 5, CPU)
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(2))
    positions = torch.arange(6)[None].expand(2, 6)
    want = attention.gqa_attention(x, p, cfg, positions)
    kv_split = kv_heads % 4 == 0
    local = {}
    for name, w in p.items():
        dim = {"wq": 1, "wo": 0, "wk": 1, "wv": 1}.get(name)
        split = dim is not None and (name in ("wq", "wo") or kv_split)
        local[name] = {pos: w.chunk(4, dim)[pos[1]] if split else w for pos in mesh.positions()}
    got = attention.gqa_attention_tp({pos: x for pos in mesh.positions()}, local, cfg,
                                     {pos: positions for pos in mesh.positions()}, mesh,
                                     heads_split=True, kv_split=kv_split)
    for pos in mesh.positions():
        torch.testing.assert_close(got[pos], want, rtol=1e-5, atol=1e-5)
    assert attention.local_heads(cfg, 3, 4) == ((3, 4), ((3 * kv_heads) // 4,
                                                        (3 * kv_heads) // 4 + 1))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_partitioned_step_on_the_card_against_the_meshless_step():
    """Two smoke steps on a (2, 4) mesh of cuda:0 entries against the
    meshless steps on the card in f32 (TF32 off); the head's kernels
    launch twice (projection) and once (RLS update) a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg = configs.get_config("qwen3-4b", "smoke")
    mesh = mesh_lib.make_dev_mesh(2, 4, devices=["cuda:0"] * 8)
    saved = (layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32)
    layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32 = torch.float32, False
    try:
        host = _host_state(cfg, NO_REMAT)
        whole = convert.train_state_from_numpy(host, cfg, "cuda", NO_REMAT)
        placed = model_lib.place_train_state(
            convert.train_state_from_numpy(host, cfg, "cuda", NO_REMAT), mesh, cfg, NO_REMAT)
        ops.reset_launch_counts()
        for i in (1, 2):
            batch = _t_batch(_batch(cfg, i, batch=BATCH), "cuda")
            with sharding.activate(mesh):
                placed, m_p = model_lib.train_step(placed, batch, cfg, NO_REMAT)
            counts = dict(ops.launch_counts)
            whole, m_w = model_lib.train_step(whole, batch, cfg, NO_REMAT)
            for key in ("loss", "grad_norm"):
                assert abs(float(m_p[key]) - float(m_w[key])) <= 1e-5 * abs(float(m_w[key]))
            ops.reset_launch_counts()
            assert counts.get("xorshift_projection") == 2 and counts.get("oselm_rls_update") == 1
        got = model_lib.gather_train_state(placed)
        for a, b in zip(adam.leaves(got.params), adam.leaves(whole.params)):
            assert float((a - b).abs().max()) <= 1e-5
    finally:
        layers.COMPUTE_DTYPE, torch.backends.cuda.matmul.allow_tf32 = saved
