"""The DeepSeek stacks' training step over partitioned leaves
(``model.place_train_state`` and ``model.partitioned_train_step``):
deepseek-moe-16b (GQA attention + DeepSeekMoE) and deepseek-v2-236b (MLA +
the same MoE block), under ``moe_impl`` "dense" and "ep", held against the
JAX package's sharded step and the port's own steps on the CPU.

The port's meshes are ``make_dev_mesh(d, m, devices=["cpu"] * (d m))``.
The JAX side needs 8 host devices, so it runs once, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_torch_partitioned_train.py`` does): for deepseek-moe-16b smoke
under "dense" and under "ep" and deepseek-v2-236b smoke, from numpy params
drawn by ``_params_np``, two f32 steps of its ``train_step`` under
``sharding.activate(make_dev_mesh(2, 4))`` with remat off, and each MoE
layer's routing on the first batch (the layers unrolled and run eagerly,
the "ep" case under the mesh).

* Against the reference: loss and grad norm within 1e-5 (relative), every
  param within 1e-5, every moment within 1e-5 of its scale
  (``test_torch_mesh_model.py``'s bounds); the first layer's routing equal
  to the reference's on every token, a later layer's on every token whose
  gap between its k-th and (k+1)-th probability exceeds 1e-5.
* Against the port's own steps on the (2, 4), (4, 2) and (2, 2) meshes in
  f32 and bf16 (``test_partitioned_step_equals_the_meshless_step``'s
  bounds): "dense" against the meshless step at the default capacity
  factor, where pairs drop, and "ep" against the whole-tensor EP step
  under the same mesh; in f32 the kept/dropped pairs exactly those of the
  step held to, in the first layer on every token and in a later one on
  every token before the first whose routing is not clear.  A batch whose
  tokens do not split over data x model ("model" drops from the token
  axes), and FSDP'd expert leaves (``layers._BIG`` and ``_FSDP`` lowered).
* Bookkeeping: after a step every param and moment is a ``Sharded`` on its
  placement whose shards are its slices, each position's bytes are the
  dry-run's, the expert weights' experts dim stays split over "model" at
  use; a step's exchanges under a census equal
  ``census.partitioned_train_exchanges`` (remat on and off, 2
  microbatches, both modes, both archs); remat equals no remat bit for bit;
  resume (2 steps, save, restore, 2 more) equals 4 steps bit for bit.
* The pieces: ``moe.moe_block_tp`` against the dense and the EP block and
  ``attention.mla_attention_tp`` against ``mla_attention``, forward and
  gradients.
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
from repro_torch.models import attention, layers, moe  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402

from test_torch_train_families import _batch, _leaves, _params_np, _t_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
MESHES = [(2, 4), (4, 2), (2, 2)]
ARCHS = ["deepseek-moe-16b", "deepseek-v2-236b"]
IMPLS = ["dense", "ep"]
# The reference's cases: (arch, moe_impl).
CASES = {"moe_dense": ("deepseek-moe-16b", "dense"), "moe_ep": ("deepseek-moe-16b", "ep"),
         "mla_dense": ("deepseek-v2-236b", "dense")}
BATCH = 8  # rows a step: 4 a data row on (2, 4), 2 on (4, 2)
GAP = 1e-5  # router gaps below this may route either way in another order of sums
NO_REMAT = TrainConfig(remat=False)

REFERENCE = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.configs.base import TrainConfig
from repro.distributed import sharding
from repro.launch.mesh import make_dev_mesh
from repro.models import layers, moe, transformer, model as M
from repro.optim import adam

inp = dict(np.load(sys.argv[1]))
cases = json.loads(str(inp["cases"]))
layers.COMPUTE_DTYPE = jnp.float32
mesh = make_dev_mesh(2, 4)
out = {}

def tree(prefix):
    t = {}
    for key, v in inp.items():
        if key.startswith(prefix):
            sub = t
            parts = key[len(prefix):].split("/")
            for p in parts[:-1]:
                sub = sub.setdefault(p, {})
            sub[parts[-1]] = jnp.asarray(v)
    return t

block = moe.moe_block
for case, (arch, impl) in cases.items():
    cfg = dataclasses.replace(configs.get_config(arch, "smoke"), moe_impl=impl)
    params = tree(f"{case}/params/")
    batches = [{k: jnp.asarray(inp[f"{case}/batch{i}/{k}"]) for k in ("tokens", "labels",
                                                                       "odl_labels")}
               for i in (1, 2)]
    # Each MoE layer's routing on the first batch, the layers unrolled and run eagerly.
    seen = []
    def record(x, p, c):
        seen.append((np.asarray(x), np.asarray(p["router"])))
        return block(x, p, c)
    moe.moe_block = record
    with sharding.activate(mesh):
        transformer.lm_hidden(params, batches[0]["tokens"],
                              dataclasses.replace(cfg, unroll_layers=True), remat=False)
    moe.moe_block = block
    for li, (x, router) in enumerate(seen):
        probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1])) @ jnp.asarray(router), -1)
        top, idx = jax.lax.top_k(probs, cfg.top_k + 1)
        out[f"{case}/route{li}/idx"] = np.asarray(idx[:, :cfg.top_k])
        out[f"{case}/route{li}/gap"] = np.asarray(top[:, cfg.top_k - 1] - top[:, cfg.top_k])
    state = M.TrainState(params=params, opt=adam.init(params), odl=M.init_odl_state(cfg))
    with sharding.activate(mesh):
        step = jax.jit(lambda s, b: M.train_step(s, b, cfg, TrainConfig(remat=False)))
        for i, batch in enumerate(batches, 1):
            state, metrics = step(state, batch)
            for k in ("loss", "grad_norm"):
                out[f"{case}/train{i}/{k}"] = np.asarray(metrics[k])
    for name, t in (("params", state.params), ("m", state.opt.m), ("v", state.opt.v)):
        for path, a in jax.tree_util.tree_flatten_with_path(t)[0]:
            out[f"{case}/{name}/" + "/".join(p.key for p in path)] = np.asarray(a)
np.savez(sys.argv[2], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:  # the reference runs in a subprocess
        pytest.skip("the JAX package's reference needs jax")
    import json

    tmp = tmp_path_factory.mktemp("partitioned_moe")
    inp = {"cases": np.array(json.dumps(CASES))}
    for case, (arch, impl) in CASES.items():
        cfg = configs.get_config(arch, "smoke")
        inp.update({f"{case}/params{path}": a for path, a in _leaves(_params_np(arch))})
        for i in (1, 2):
            inp.update({f"{case}/batch{i}/{k}": v
                        for k, v in _batch(cfg, i, batch=BATCH).items()})
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
    expert weights and the shared experts' are FSDP'd over "data"."""
    monkeypatch.setattr(layers, "_BIG", 1 << 10)
    monkeypatch.setattr(layers, "_FSDP", 1 << 12)


def _cfg(arch, impl):
    return configs.get_config(arch, "smoke").replace(moe_impl=impl)


def _host_state(cfg, tcfg=TrainConfig()):
    host = convert.train_state_to_numpy(model_lib.init_train_state(cfg, 0, tcfg, device=CPU))
    return host._replace(params=_params_np(cfg.arch_id))


def _pair(cfg, mesh, tcfg=TrainConfig()):
    """(a whole state, the same state placed on ``mesh``), from one host state."""
    host = _host_state(cfg, tcfg)
    whole = convert.train_state_from_numpy(host, cfg, CPU, tcfg)
    placed = model_lib.place_train_state(convert.train_state_from_numpy(host, cfg, CPU, tcfg),
                                         mesh, cfg, tcfg)
    return whole, placed


class _Record:
    """Each MoE block call's routing and kept pairs, in call order: ``route``'s
    probabilities and expert indices, ``_combine``'s kept mask (``moe``
    patched)."""

    def __init__(self, monkeypatch):
        self.routes, self.keep = [], []
        route, combine = moe.route, moe._combine

        def rec_route(xt, router, cfg):
            out = route(xt, router, cfg)
            self.routes.append((out[0].detach().clone(), out[2].detach().clone()))
            return out

        def rec_combine(out_e, flat_e, pos, keep, gate_k, dtype):
            self.keep.append(keep.detach().clone())
            return combine(out_e, flat_e, pos, keep, gate_k, dtype)

        monkeypatch.setattr(moe, "route", rec_route)
        monkeypatch.setattr(moe, "_combine", rec_combine)

    def clear(self):
        self.routes, self.keep = [], []

    def take(self, n_layers, copies=(1, 1)):
        """[(probs (T, E), expert indices (T, k), kept (T k,)) per layer] of
        the calls so far, each layer's shards concatenated in call order (the
        token order).  ``copies``: how many consecutive ``route`` and
        ``_combine`` calls hold one token shard (the positions of a data row
        where its tokens do not split over "model")."""
        routes, keep = self.routes, self.keep
        self.routes, self.keep = [], []
        if not routes:
            return []
        out = []
        for j in range(n_layers):
            r = routes[j * len(routes) // n_layers:(j + 1) * len(routes) // n_layers]
            k = keep[j * len(keep) // n_layers:(j + 1) * len(keep) // n_layers]
            r, k = r[::copies[0]], k[::copies[1]]
            assert len(r) == len(k)
            out.append((torch.cat([p for p, _ in r]), torch.cat([i for _, i in r]),
                        torch.cat(k)))
        return out


def _steps(state, cfg, tcfg, mesh, steps=(1, 2), batch=BATCH, seq=None, record=None,
           copies=(1, 1)):
    """``steps`` train_steps under ``mesh`` (None: without one): (state,
    metrics, the first step's routing by layer where ``record``, taken with
    ``copies``)."""
    metrics, routed = [], None
    if record is not None:
        record.clear()  # no call before these steps
    for i in steps:
        b = _t_batch(_batch(cfg, i, batch=batch) if seq is None else
                     _batch(cfg, i, batch=batch, seq=seq))
        if mesh is None:
            state, m = model_lib.train_step(state, b, cfg, tcfg)
        else:
            with sharding.activate(mesh):
                state, m = model_lib.train_step(state, b, cfg, tcfg)
        if record is not None and routed is None:
            routed = record.take(cfg.n_layers, copies)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics, routed


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else v.detach().float().numpy()
            for k, v in tree.items()}


def _assert_states_close(got, want, bf16: bool, what):
    """Params within 1e-5 (abs) and moments within 1e-5 of their scale in
    f32; in bf16 every leaf within atol = rtol = 3e-2."""
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


def _gap(probs, k):
    """Each token's gap between its k-th and (k+1)-th probability."""
    top = torch.sort(probs.double(), dim=-1, descending=True).values
    return (top[:, k - 1] - top[:, k]).numpy()


def _assert_routing_equal(got, want, gaps, k, what, keep=True):
    """``got``/``want`` [(expert indices (T, k), kept (T k,)) per layer]:
    the first layer's on every token; a later layer's on the tokens before
    the first whose gap (``gaps`` per layer, from ``want``'s router) is not
    past GAP, whose slots do not depend on where that token routes."""
    for layer, ((gi, gk), (wi, wk), gap) in enumerate(zip(got, want, gaps, strict=True)):
        unclear = np.flatnonzero(gap <= GAP)
        n = len(gap) if layer == 0 or not len(unclear) else int(unclear[0])
        np.testing.assert_array_equal(np.asarray(gi)[:n], np.asarray(wi)[:n],
                                      err_msg=f"{what} layer {layer} routing")
        if keep:
            np.testing.assert_array_equal(np.asarray(gk)[:n * k], np.asarray(wk)[:n * k],
                                          err_msg=f"{what} layer {layer} kept pairs")


# ---------------------------------------------------------------------------
# Against the JAX package's sharded step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_partitioned_step_against_the_reference(case, ref, f32, monkeypatch):
    """Loss and grad norm within 1e-5 (relative), moments within 1e-5 of
    their scale, the routing as the module docstring says; each param leaf
    within 1e-5 of the reference's, or, where the port's own step from the
    same state (the meshless one, or under "ep" the whole-tensor EP step)
    is further than that from the reference, within twice that step's
    distance: Adam's first step moves a param by lr g / (|g| + 1e-8), so
    where a gradient is near 1e-8 any other order of its sums moves the
    update by a good part of lr (moe_dense: one element of layers/moe/wu,
    its first gradient 2.4e-9, 2.6e-5 from the reference after the port's
    meshless steps)."""
    out, inp = ref
    cfg = _cfg(*CASES[case])
    mesh = _mesh(2, 4)
    own, state = _pair(cfg, mesh, NO_REMAT)
    record = _Record(monkeypatch)
    for i in (1, 2):
        batch = {k: torch.as_tensor(inp[f"{case}/batch{i}/{k}"])
                 for k in ("tokens", "labels", "odl_labels")}
        with sharding.activate(mesh):
            state, metrics = model_lib.train_step(state, batch, cfg, NO_REMAT)
        if i == 1:
            routed = record.take(cfg.n_layers)
        with sharding.activate(mesh) if cfg.moe_impl == "ep" else sharding.deactivate():
            own, _ = model_lib.train_step(own, batch, cfg, NO_REMAT)
        for key in ("loss", "grad_norm"):
            want = float(out[f"{case}/train{i}/{key}"])
            assert abs(float(metrics[key]) - want) <= 1e-5 * abs(want), (i, key)
    want = [(out[f"{case}/route{li}/idx"], None) for li in range(cfg.n_layers)]
    gaps = [out[f"{case}/route{li}/gap"] for li in range(cfg.n_layers)]
    _assert_routing_equal([(idx, None) for _, idx, _ in routed], want, gaps, cfg.top_k, case,
                          keep=False)
    assert all(len(g) == BATCH * 32 for g in gaps) and (gaps[0] > GAP).mean() >= 0.99
    assert model_lib.is_partitioned(state)
    whole = model_lib.gather_train_state(state)
    own_params = dict(_leaves(_np_tree(own.params)))
    for name, tree in (("params", whole.params), ("m", whole.opt.m), ("v", whole.opt.v)):
        for path, a in _leaves(_np_tree(tree)):
            want = out[f"{case}/{name}{path}"]
            if name == "params":
                spread = np.abs(np.asarray(own_params[path], np.float64) - want).max()
                bound = max(1e-5, 2 * spread)
                scale = 1.0
            else:
                bound, scale = 1e-5, np.abs(want).max()
            worst = np.abs(np.asarray(a, np.float64) - want).max() / scale
            assert worst <= bound, (name, path, worst, bound)


# ---------------------------------------------------------------------------
# Against the port's own steps
# ---------------------------------------------------------------------------


def _against_own_step(cfg, shape, bf16, monkeypatch, batch=BATCH, seq=None, tcfg=NO_REMAT):
    """Two partitioned steps against two from the same state: the meshless
    step ("dense") or the whole-tensor EP step under the same mesh ("ep");
    in f32 each layer's routing and kept pairs on the first step too.
    Returns the partitioned state."""
    mesh = _mesh(*shape)
    whole, placed = _pair(cfg, mesh, tcfg)
    record = _Record(monkeypatch)
    ep = cfg.moe_impl == "ep"
    # Where the tokens do not split over "model", every position of a data
    # row routes its tokens; the whole-tensor EP block combines them once.
    m = 1 if "model" in moe.ep_layout(batch * (seq or 32), cfg, mesh)[0] else shape[1]
    whole, m_whole, r_whole = _steps(whole, cfg, tcfg, mesh if ep else None, batch=batch,
                                     seq=seq, record=record, copies=(m if ep else 1, 1))
    placed, m_placed, r_placed = _steps(placed, cfg, tcfg, mesh, batch=batch, seq=seq,
                                        record=record, copies=(m, m))
    what = (cfg.arch_id, cfg.moe_impl, shape, "bf16" if bf16 else "f32")
    _assert_metrics_close(m_placed, m_whole, bf16, what)
    _assert_states_close(model_lib.gather_train_state(placed), whole, bf16, what)
    if not bf16:
        gaps = [_gap(p, cfg.top_k) for p, _, _ in r_whole]
        _assert_routing_equal([(i, k) for _, i, k in r_placed], [(i, k) for _, i, k in r_whole],
                              gaps, cfg.top_k, what)
        if cfg.moe_impl == "dense" and batch * (seq or 32) >= 64:
            assert not all(bool(k.all()) for _, _, k in r_whole), "the default capacity drops"
    assert int(placed.opt.step) == 2 and all(
        t.isfinite().all() for sh in adam.leaves(placed.params) for t in sh.shards.values())
    return placed


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_partitioned_step_equals_the_ports_own_step(arch, impl, shape, dtype, monkeypatch):
    if dtype == "f32":
        monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    _against_own_step(_cfg(arch, impl), shape, dtype == "bf16", monkeypatch)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_that_do_not_split_over_data_by_model(arch, impl, f32, monkeypatch):
    """2 rows of 3 tokens on (2, 4): 8 does not divide 6, so the token
    shards are the data rows and each position of a row routes all of its
    tokens ("model" drops from the token axes, as the reference's EP block
    drops it)."""
    cfg = _cfg(arch, impl)
    assert moe.ep_layout(6, cfg, _mesh(2, 4))[0] == ("data",)
    _against_own_step(cfg, (2, 4), False, monkeypatch, batch=2, seq=3)


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_expert_leaves(arch, shape, f32, small_thresholds, monkeypatch):
    cfg = _cfg(arch, "dense")
    mesh = _mesh(*shape)
    with sharding.activate(mesh):
        _, pl = model_lib.abstract_train_state(cfg)
    specs = {k: pl.params["layers"]["moe"][k].spec for k in ("wg", "wd", "router")}
    assert specs["wg"][1] == "model" and "data" in specs["wg"]  # EP and FSDP
    assert specs["router"] == sharding.P(None, None, "model")
    top, layer = model_lib.train_layout(cfg, pl.params)
    assert layer["moe/wg"][1] == sharding.P("model", None, None)  # experts split at use
    assert layer["moe/router"][1] == sharding.P(None, None)  # the router whole
    assert "data" in pl.params["layers"]["moe"]["shared"]["wg"].spec
    _against_own_step(cfg, shape, False, monkeypatch)


# ---------------------------------------------------------------------------
# Layout and bookkeeping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["natural", "fsdp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shards_are_their_placements_slices_and_the_census_bytes(arch, layout, monkeypatch):
    if layout == "fsdp":
        monkeypatch.setattr(layers, "_BIG", 1 << 10)
        monkeypatch.setattr(layers, "_FSDP", 1 << 12)
    cfg = _cfg(arch, "dense")
    mesh = _mesh(2, 4)
    _, placed = _pair(cfg, mesh)
    placed, _, _ = _steps(placed, cfg, TrainConfig(), mesh, steps=(1,))
    with sharding.activate(mesh):
        metas, pl = model_lib.abstract_train_state(cfg)
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
    # The expert weights stay their "model" slices: E / 4 experts a position.
    wg = placed.params["layers"]["moe"]["wg"]
    assert {t.shape[1] for t in wg.shards.values()} == {cfg.n_experts // 4}


CENSUS_CASES = {
    "moe_dense": ("deepseek-moe-16b", "dense", (2, 4), NO_REMAT, BATCH, 32),
    "moe_dense_remat": ("deepseek-moe-16b", "dense", (2, 4), TrainConfig(), BATCH, 32),
    "moe_ep_remat": ("deepseek-moe-16b", "ep", (4, 2), TrainConfig(), BATCH, 32),
    "moe_ep_microbatches": ("deepseek-moe-16b", "ep", (2, 2), TrainConfig(microbatches=2),
                            BATCH, 32),
    "mla_dense_microbatches": ("deepseek-v2-236b", "dense", (2, 4),
                               TrainConfig(microbatches=2), BATCH, 32),
    "mla_ep": ("deepseek-v2-236b", "ep", (2, 4), NO_REMAT, BATCH, 32),
    "mla_dense_unsplit_tokens": ("deepseek-v2-236b", "dense", (2, 4), TrainConfig(), 2, 3),
}


@pytest.mark.parametrize("case", list(CENSUS_CASES))
def test_step_exchanges_equal_the_analytic_count(case):
    arch, impl, shape, tcfg, batch, seq = CENSUS_CASES[case]
    cfg = _cfg(arch, impl)
    mesh = _mesh(*shape)
    _, placed = _pair(cfg, mesh, tcfg)
    b = _t_batch(_batch(cfg, 1, batch=batch, seq=seq))
    with sharding.activate(mesh), census.StepCensus() as c:
        model_lib.train_step(placed, b, cfg, tcfg)
    got = census.collective_census(c)
    assert got == census.partitioned_train_exchanges(cfg, tcfg, mesh, batch, seq)
    assert {"all-to-all", "all-gather", "reduce-scatter", "all-reduce", "gather"} <= set(got)


def _assert_equal_states(a, b):
    a, b = model_lib.gather_train_state(a), model_lib.gather_train_state(b)
    for x, y in zip(adam.leaves(a.params) + adam.leaves(a.opt.m) + adam.leaves(a.opt.v),
                    adam.leaves(b.params) + adam.leaves(b.opt.m) + adam.leaves(b.opt.v),
                    strict=True):
        assert torch.equal(x, y)
    assert torch.equal(a.opt.step, b.opt.step)
    for x, y in zip(list(a.odl.elm) + list(a.odl.prune), list(b.odl.elm) + list(b.odl.prune)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch, impl, f32, monkeypatch):
    """Remat recomputes each layer, routing as the forward did: bit for bit
    the step without it, routing and kept pairs included."""
    cfg = _cfg(arch, impl)
    mesh = _mesh(2, 4)
    _, a = _pair(cfg, mesh)
    _, b = _pair(cfg, mesh)
    record = _Record(monkeypatch)
    a, m_a, r_a = _steps(a, cfg, TrainConfig(remat=True), mesh, steps=(1,))
    calls = len(record.routes)  # the forward's and the recompute's
    b, m_b, r_b = _steps(b, cfg, NO_REMAT, mesh, steps=(1,), record=record)
    assert calls == 2 * 8 * cfg.n_layers
    a, m_a2, _ = _steps(a, cfg, TrainConfig(remat=True), mesh, steps=(2,))
    b, m_b2, _ = _steps(b, cfg, NO_REMAT, mesh, steps=(2,))
    assert m_a + m_a2 == m_b + m_b2
    _assert_equal_states(a, b)


@pytest.mark.parametrize("impl", IMPLS)
def test_save_restore_resumes_bit_for_bit(impl, tmp_path):
    cfg = _cfg("deepseek-moe-16b", impl)
    mesh = _mesh(2, 4)
    _, straight = _pair(cfg, mesh)
    straight, m_straight, _ = _steps(straight, cfg, TrainConfig(), mesh, steps=(1, 2, 3, 4))
    _, first = _pair(cfg, mesh)
    first, m_first, _ = _steps(first, cfg, TrainConfig(), mesh, steps=(1, 2))
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(2, first)
    step, resumed = checkpoint.restore_train_state(mgr, cfg, mesh)
    assert step == 2 and model_lib.is_partitioned(resumed)
    wg = resumed.params["layers"]["moe"]["wg"]
    assert wg.placement == first.params["layers"]["moe"]["wg"].placement
    resumed, m_resumed, _ = _steps(resumed, cfg, TrainConfig(), mesh, steps=(3, 4))
    assert m_first + m_resumed == m_straight
    _assert_equal_states(resumed, straight)


# ---------------------------------------------------------------------------
# The pieces against their whole versions
# ---------------------------------------------------------------------------


def _split_leaves(p, spec_of, mesh):
    """{name: {pos: slice}} of the whole leaves ``p`` by ``spec_of(name)``."""
    out = {}
    for name, w in p.items():
        placement = sharding.Placement(mesh, spec_of(name))
        out[name] = {pos: w[index] for pos, index in placement.indices_map(tuple(w.shape)).items()}
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", [(2, 4), (2, 2)], ids=["2x4", "2x2"])
def test_moe_block_tp_against_the_whole_block(impl, shape, f32):
    """The block on a mesh, each data row's tokens at its positions,
    against ``_moe_block_dense`` ("dense") or ``moe_block_ep`` under the
    same mesh ("ep") on the whole batch: y within 1e-5 of its scale at every
    position, aux within 1e-6, and the gradients of x and of every weight
    (the positions' contributions summed) within 1e-5 of their scale."""
    cfg = _cfg("deepseek-moe-16b", impl)
    mesh = _mesh(*shape)
    d_rows, m = shape
    p = _flat(layers.init_params(moe.moe_schema(cfg), 3, CPU))
    x = torch.randn((4, 16, cfg.d_model), generator=torch.Generator().manual_seed(1))
    specs = {"router": sharding.P(), "wg": sharding.P("model"), "wu": sharding.P("model"),
             "wd": sharding.P("model"), "shared/wg": sharding.P(None, "model"),
             "shared/wu": sharding.P(None, "model"), "shared/wd": sharding.P("model")}
    layout = {k: (v, v) for k, v in specs.items()}
    whole = {k: v.clone().requires_grad_() for k, v in p.items()}
    xw = x.clone().requires_grad_()
    pw = {k: v for k, v in whole.items() if "/" not in k}
    pw["shared"] = {k.split("/")[1]: v for k, v in whole.items() if "/" in k}
    if impl == "ep":
        y_want, aux_want = moe.moe_block_ep(xw, pw, cfg, mesh)
    else:
        y_want, aux_want = moe._moe_block_dense(xw, pw, cfg)
    g = torch.Generator().manual_seed(2)
    dy = torch.randn(y_want.shape, generator=g)
    (torch.sum(y_want * dy) + aux_want).backward()

    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    w = _split_leaves(leaves, specs.get, mesh)
    rows = x.shape[0] // d_rows
    xs = {pos: x[pos[0] * rows:(pos[0] + 1) * rows].clone().requires_grad_()
          for pos in mesh.positions()}
    y, aux = moe.moe_block_tp(xs, w, cfg, mesh, layout)
    loss = aux
    for pos, t in y.items():
        want = y_want[pos[0] * rows:(pos[0] + 1) * rows]
        assert (t - want).abs().max() <= 1e-5 * y_want.abs().max(), pos
        if pos[1] == 0:  # one copy of each row reaches the loss
            loss = loss + torch.sum(t * dy[pos[0] * rows:(pos[0] + 1) * rows])
    torch.testing.assert_close(aux, aux_want, rtol=1e-6, atol=0)
    loss.backward()
    gx = torch.zeros_like(x)
    for pos, t in xs.items():
        gx[pos[0] * rows:(pos[0] + 1) * rows] += t.grad
    assert (gx - xw.grad).abs().max() <= 1e-5 * xw.grad.abs().max()
    for name, leaf in leaves.items():
        assert (leaf.grad - whole[name].grad).abs().max() <= 1e-5 * whole[name].grad.abs().max(), \
            name


@pytest.mark.parametrize("heads_split", [True, False])
def test_mla_attention_tp_against_the_whole(heads_split, f32):
    """4 heads on a 4-way axis, split or each position's whole: the partial
    outputs summed over "model" equal ``mla_attention``, and the gradients
    of x and every weight (the positions' contributions summed) equal its
    within 1e-5 of their scale."""
    cfg = configs.get_config("deepseek-v2-236b", "smoke")
    mesh = _mesh(2, 4)
    p = layers.init_params(attention.mla_schema(cfg), 5, CPU)
    x = torch.randn((2, 6, cfg.d_model), generator=torch.Generator().manual_seed(2))
    positions = torch.arange(6)[None].expand(2, 6)
    pw = {k: v.clone().requires_grad_() for k, v in p.items()}
    xw = x.clone().requires_grad_()
    want = attention.mla_attention(xw, pw, cfg, positions)
    dy = torch.randn(want.shape, generator=torch.Generator().manual_seed(3))
    torch.sum(want * dy).backward()
    dims = {"wq_b": 1, "wkv_b": 1, "wo": 0}
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    local = {name: {pos: w.chunk(4, dims[name])[pos[1]] if heads_split and name in dims else w
                    for pos in mesh.positions()} for name, w in leaves.items()}
    xs = {pos: x.clone().requires_grad_() for pos in mesh.positions()}
    got = attention.mla_attention_tp(xs, local, cfg, {pos: positions for pos in mesh.positions()},
                                     mesh, heads_split=heads_split)
    loss = 0.0
    for pos, t in got.items():
        torch.testing.assert_close(t, want, rtol=1e-5, atol=1e-5)
        if pos == (0, 0) or not heads_split and pos[0] == 0 and pos[1] == 0:
            loss = loss + torch.sum(t * dy)
    loss.backward()
    gx = sum(t.grad for t in xs.values() if t.grad is not None)
    assert (gx - xw.grad).abs().max() <= 1e-5 * xw.grad.abs().max()
    for name, leaf in leaves.items():
        assert (leaf.grad - pw[name].grad).abs().max() <= 1e-5 * pw[name].grad.abs().max(), name


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_partitioned_moe_step_on_the_card_against_the_meshless_step():
    """Two smoke steps of deepseek-moe-16b ("dense") on a (2, 4) mesh of
    cuda:0 entries against the meshless steps on the card in f32 (TF32
    off); the head's kernels launch twice (projection) and once (RLS
    update) a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg = _cfg("deepseek-moe-16b", "dense")
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
