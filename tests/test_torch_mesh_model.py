"""The model side of the port's mesh, held against the JAX package's on the
CPU: ``sharding.resolve`` / ``ensure_axis_sharded`` / ``fleet_sharding``,
``layers.param_specs`` / ``abstract_params`` and each ``Placement``'s
slices, the expert-parallel MoE block (``moe.moe_block_ep``) and a
training step through it, the GPipe pipeline, and the elastic rescale.

The port's meshes are ``make_dev_mesh(d, m, devices=["cpu"] * (d m))``:
eight entries of the one CPU.  The JAX side needs 8 host devices, so it
runs once, in one subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` (as
``tests/test_multidevice.py`` does), behind a module-scoped fixture: the
inputs (numpy params drawn here, at the port's init scale, and data) go
to it in one ``.npz`` and everything this file compares comes back in
another.  The reference's MoE and training numbers are computed in f32
(``COMPUTE_DTYPE`` set to f32 there, and here for those tests).

* Specs, exactly: ``resolve`` over logical-axis cases, ``param_specs``
  and ``abstract_params`` (shapes, dtypes) of every arch's schema at smoke
  and full width (specs only: nothing is allocated), on the (2, 4), (4, 2)
  and (2, 2) meshes, each equal to the reference's ``PartitionSpec``; each
  ``Placement``'s slices equal to ``NamedSharding(mesh, spec).
  devices_indices_map(shape)``, by mesh position.
* The EP block on the 2 x 4 mesh, deepseek-moe-16b smoke, x (8, 32, 64)
  f32, at the default capacity factor and at 0.5 (pairs drop): each token
  shard's routing equal to the reference router's on every token whose
  gap between its k-th and (k+1)-th probability exceeds 1e-5, and its
  kept/dropped mask exact; y within 1e-5 of the reference's largest |y| on
  the tokens whose routing is clear; aux within 1e-6 (relative).  At 12
  tokens (8 does not divide them; the split drops "model" and runs over
  "data") and at 7 (nothing divides: the dense block) the same bounds.
  Against the port's dense block at capacity factor E/k: y within 1e-5 of
  its scale; the aux of the EP block is the mean of its token shards' aux
  losses (the reference's pmean), not the whole batch's, so it is held to
  that mean (1e-6) and to the dense aux within the reference's own
  criterion (``tests/test_moe_ep.py``: rtol 0.05).
* ``train_step`` with ``moe_impl="ep"`` under the 2 x 4 mesh against the
  reference's under its mesh, two steps from one numpy state: loss and grad
  norm within 1e-5 (relative), every new param within 1e-5.  Against the
  port's meshless step at capacity factor E/k (a token shard's capacity is
  rounded up to 8 on its own, so at 1.25 the two blocks drop different
  pairs) on a batch whose eight sequences are one sequence repeated, so
  that every token shard routes alike and the token shards' mean aux is
  the whole batch's: the same bounds.
* ``pipeline_forward`` on an 8-entry ``("stage",)`` mesh at the reference
  test's shapes: within 1e-5 of ``sequential_reference`` and of the
  reference's ``pipeline_forward``; ``bubble_fraction(8, 4) == 7/11``.
* qwen3-4b smoke params ``reshard_tree``d onto a (4, 2) mesh, saved, and
  ``rescale``d onto (2, 2): every shard bit for bit the slice its placement
  names, on its entry.  A fleet split under a (4, 2) dev mesh goes over
  ``data`` (shard k on entry (k, 0)), bit for bit ``run_fleet``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert, engine  # noqa: E402
from repro_torch.distributed import pipeline, sharding  # noqa: E402
from repro_torch.engine.types import tree_leaves  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, moe, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime import checkpoint  # noqa: E402

from test_torch_train_families import _batch, _leaves, _params_np, _t_batch  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"
MESHES = [(2, 4), (4, 2), (2, 2)]
EP_ARCH = "deepseek-moe-16b"
EP_X = (8, 32)  # 256 tokens: 32 a token shard on the 2 x 4 mesh
EP_CASES = {"default": (EP_X, None), "dropping": (EP_X, 0.5), "split_data": ((3, 4), None),
            "dense": ((7, 1), None)}
GAP = 1e-5  # router gaps below this may route either way across frameworks
PIPE = dict(n_stages=8, m=4, b=2, d=16)  # tests/test_multidevice.py's shapes
# Logical-axis cases of resolve: (names, shape or None).
RESOLVE_CASES = [
    (("batch", "seq", "embed"), (8, 32, 64)), (("batch", "seq", "embed"), (1, 32, 64)),
    (("batch", "seq", "embed"), None), (("batch", "heads", "head_dim"), (8, 56, 128)),
    (("embed", "mlp"), (64, 96)), (("experts", "embed", "mlp"), (8, 64, 48)),
    (("experts", "embed", "mlp"), (6, 64, 48)), (("stream", None, None), (8, 16, 16)),
    (("stream", None), (6, 4)), (("vocab", "embed"), (50280, 64)),
    (("heads", "kv_heads"), (16, 16)), (("seq_kv", "seq_sp"), (64, 64)), ((None, "mlp"), (3, 8)),
]
ENSURE_CASES = [  # (spec, shape, axis)
    ((None, None), (1024, 4096), "model"), ((None, "model"), (1024, 4096), "data"),
    (("model", None), (3, 4096), "model"), ((None, None, None), (2, 6, 10), "data"),
    ((None,), (4,), "model"), ((("data", "model"), None), (64, 64), "data"),
]

REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.configs.base import TrainConfig
from repro.distributed import pipeline, sharding
from repro.launch.mesh import _make_mesh, make_dev_mesh
from repro.models import layers, moe, model as M
from repro.optim import adam

inp = dict(np.load(sys.argv[1]))
cases = json.loads(str(inp.pop("cases")))
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

def spec_list(spec, n):
    e = list(spec) + [None] * (n - len(spec))
    return [list(x) if isinstance(x, tuple) else x for x in e]

def positions(mesh):
    return {d.id: list(map(int, i)) for i, d in np.ndenumerate(mesh.devices)}

def index_map(sh, shape, pos):
    return {json.dumps(pos[d.id]): [[s.start, s.stop] for s in ix]
            for d, ix in sh.devices_indices_map(tuple(shape)).items()}

specs, resolved, ensured, fleet = {}, {}, {}, {}
for dd, mm in cases["meshes"]:
    mesh = make_dev_mesh(dd, mm)
    pos = positions(mesh)
    tag = f"{dd}x{mm}"
    with sharding.activate(mesh):
        for arch in configs.ARCH_IDS:
            for variant in ("smoke", "full"):
                schema = M.build_schema(configs.get_config(arch, variant))
                ab, ps = layers.abstract_params(schema), layers.param_specs(schema)
                for path, leaf in layers._iter_leaves(schema):
                    a, s = ab, ps
                    for k in path:
                        a, s = a[k], s[k]
                    specs[f"{tag}/{arch}/{variant}/" + "/".join(path)] = dict(
                        spec=spec_list(s, len(a.shape)), shape=list(a.shape), dtype=str(a.dtype),
                        map=index_map(a.sharding, a.shape, pos))
        for i, (names, shape) in enumerate(cases["resolve"]):
            r = sharding.resolve(*names, shape=None if shape is None else tuple(shape))
            resolved[f"{tag}/{i}"] = spec_list(r, len(names))
        for i, (spec, shape, axis) in enumerate(cases["ensure"]):
            sp = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
            ensured[f"{tag}/{i}"] = spec_list(sharding.ensure_axis_sharded(sp, tuple(shape), axis),
                                              len(shape))
        sh = sharding.fleet_sharding(3, shape=(8, 16, 16))
        fleet[tag] = dict(spec=spec_list(sh.spec, 3), map=index_map(sh, (8, 16, 16), pos))
out["specs"] = np.array(json.dumps(specs))
out["resolved"] = np.array(json.dumps(resolved))
out["ensured"] = np.array(json.dumps(ensured))
out["fleet"] = np.array(json.dumps(fleet))

# The MoE block and the training step in f32.
layers.COMPUTE_DTYPE = jnp.float32
mesh = make_dev_mesh(2, 4)
base = configs.get_config(cases["ep_arch"], "smoke")
lp = jax.tree.map(lambda a: a[0], tree("params/layers/"))["moe"]
for name, cf in cases["ep"].items():
    cfg = base if cf is None else base.replace(capacity_factor=cf)
    x = jnp.asarray(inp[f"x/{name}"])
    with sharding.activate(mesh):
        y, aux = jax.jit(lambda xx, pp: moe.moe_block_ep(xx, pp, cfg, mesh))(x, lp)
    out[f"ep/{name}/y"], out[f"ep/{name}/aux"] = np.asarray(y), np.asarray(aux)
    # Each token shard's routing and kept pairs, the steps of the
    # reference's local_moe on the shard's tokens.
    t, k, e = x.shape[0] * x.shape[1], cfg.top_k, cfg.n_experts
    n = 8 if t % 8 == 0 else 2 if t % 2 == 0 else 1
    t_loc = t // n
    cap = max(8, -(-int(k * t_loc * cfg.capacity_factor / e) // 8) * 8)
    idx, gap, keep = [], [], []
    for s in range(n):
        xs = x.reshape(t, -1)[s * t_loc:(s + 1) * t_loc]
        probs = jax.nn.softmax(xs @ lp["router"], -1)
        _, idx_k = jax.lax.top_k(probs, k)
        top = -np.sort(-np.asarray(probs), -1)
        flat = idx_k.reshape(-1)
        onehot = jax.nn.one_hot(flat, e, dtype=jnp.int32)
        p = jnp.take_along_axis(jnp.cumsum(onehot, 0) - onehot, flat[:, None], 1)[:, 0]
        idx.append(np.asarray(idx_k)); gap.append(top[:, k - 1] - top[:, k])
        keep.append(np.asarray(p < cap))
    out[f"ep/{name}/idx"], out[f"ep/{name}/gap"] = np.stack(idx), np.stack(gap)
    out[f"ep/{name}/keep"] = np.stack(keep)

cfg = base.replace(moe_impl="ep")
params = tree("params/")
state = M.TrainState(params=params, opt=adam.init(params), odl=M.init_odl_state(cfg))
with sharding.activate(mesh):
    step = jax.jit(lambda s, b: M.train_step(s, b, cfg, TrainConfig()))
    for i in (1, 2):
        batch = {k: jnp.asarray(inp[f"batch{i}/{k}"]) for k in ("tokens", "labels", "odl_labels")}
        state, metrics = step(state, batch)
        out[f"train{i}/loss"] = np.asarray(metrics["loss"])
        out[f"train{i}/grad_norm"] = np.asarray(metrics["grad_norm"])
for path, a in jax.tree_util.tree_flatten_with_path(state.params)[0]:
    out["train/params/" + "/".join(p.key for p in path)] = np.asarray(a)

# The pipeline on an 8-device ("stage",) mesh.
stage_mesh = _make_mesh((8,), ("stage",))
got = pipeline.pipeline_forward(jnp.asarray(inp["pipe/h"]), {"w": jnp.asarray(inp["pipe/w"])},
                                lambda x, p: jnp.tanh(x @ p["w"]), stage_mesh)
out["pipe/out"] = np.asarray(got)
np.savez(sys.argv[2], **out)
print("OK")
"""


def _flat(tree, prefix):
    for path, a in _leaves(tree):
        yield prefix + path.lstrip("/"), a


def _ep_params():
    p = _params_np(EP_ARCH)["layers"]["moe"]
    return {k: ({n: a[0] for n, a in v.items()} if isinstance(v, dict) else v[0])
            for k, v in p.items()}


def _ep_x(name):
    shape, _ = EP_CASES[name]
    rng = np.random.default_rng(sum(shape))
    return rng.standard_normal(shape + (configs.get_config(EP_ARCH, "smoke").d_model,)) \
        .astype(np.float32)


def _repeated_batch(cfg, step):
    """``_batch`` at B=8, S=32 with every row the first row's."""
    b = _batch(cfg, step, batch=8)
    return {k: np.repeat(v[:1], len(v), 0) for k, v in b.items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("mesh_model")
    cfg = configs.get_config(EP_ARCH, "smoke")
    inp = dict(_flat(_params_np(EP_ARCH), "params/"))
    inp.update({f"x/{name}": _ep_x(name) for name in EP_CASES})
    for i in (1, 2):
        inp.update({f"batch{i}/{k}": v for k, v in _batch(cfg, i, batch=8).items()})
    rng = np.random.default_rng(0)
    n, m, b, d = PIPE["n_stages"], PIPE["m"], PIPE["b"], PIPE["d"]
    inp["pipe/h"] = rng.standard_normal((m, b, d)).astype(np.float32)
    inp["pipe/w"] = (rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32)
    inp["cases"] = np.array(json.dumps(dict(
        meshes=MESHES, resolve=RESOLVE_CASES, ensure=ENSURE_CASES, ep_arch=EP_ARCH,
        ep={name: cf for name, (_, cf) in EP_CASES.items()})))
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), str(tmp / "in.npz"),
                        str(tmp / "out.npz")], env=env, capture_output=True, text=True,
                       timeout=900, cwd=ROOT)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-4000:]}"
    out = dict(np.load(tmp / "out.npz"))
    for key in ("specs", "resolved", "ensured", "fleet"):
        out[key] = json.loads(str(out[key]))
    out["inputs"] = inp
    return out


def _cpu_mesh(d, m):
    return mesh_lib.make_dev_mesh(d, m, devices=[CPU] * (d * m))


def _spec_list(spec, n):
    e = list(spec) + [None] * (n - len(spec))
    return [list(x) if isinstance(x, tuple) else x for x in e]


def _index_map(placement, shape):
    return {json.dumps(list(pos)): [[s.start, s.stop] for s in ix]
            for pos, ix in placement.indices_map(tuple(shape)).items()}


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)


# ---------------------------------------------------------------------------
# Meshes and specs
# ---------------------------------------------------------------------------


def test_make_dev_mesh_device_rules(monkeypatch):
    mesh = _cpu_mesh(2, 4)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.axis_names == ("data", "model")
    assert mesh.devices == (torch.device(CPU),) * 8
    assert list(mesh.positions())[:3] == [(0, 0), (0, 1), (0, 2)]
    stage = mesh_lib.make_mesh((8,), ("stage",), devices=[CPU] * 9)
    assert stage.shape == {"stage": 8} and len(stage.devices) == 8
    with pytest.raises(ValueError, match="needs 8 entries > 4 visible devices"):
        mesh_lib.make_dev_mesh(2, 4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="cannot hold"):
        sharding.Mesh((torch.device(CPU),) * 3, ("data", "model"), (2, 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.make_dev_mesh()


@pytest.mark.parametrize("shape", MESHES)
def test_resolve_and_ensure_equal_the_reference(ref, shape):
    d, m = shape
    tag = f"{d}x{m}"
    with sharding.activate(_cpu_mesh(d, m)):
        for i, (names, dims) in enumerate(RESOLVE_CASES):
            got = sharding.resolve(*names, shape=dims)
            assert _spec_list(got, len(names)) == ref["resolved"][f"{tag}/{i}"], (names, dims)
        for i, (spec, dims, axis) in enumerate(ENSURE_CASES):
            got = sharding.ensure_axis_sharded(sharding.P(*spec), dims, axis)
            assert _spec_list(got, len(dims)) == ref["ensured"][f"{tag}/{i}"], (spec, dims, axis)
        placement = sharding.fleet_sharding(3, shape=(8, 16, 16))
        want = ref["fleet"][tag]
        assert _spec_list(placement.spec, 3) == want["spec"]
        assert _index_map(placement, (8, 16, 16)) == want["map"]
    assert sharding.named_sharding("batch") is None  # no mesh: no placement
    assert sharding.constrain(x := torch.ones(2), "batch") is x


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
@pytest.mark.parametrize("shape", MESHES)
def test_param_specs_and_placements_equal_the_reference(ref, shape, arch):
    """Every leaf's spec, meta shape and dtype, and each Placement's slices
    by mesh position, at smoke and full width."""
    d, m = shape
    mesh = _cpu_mesh(d, m)
    for variant in ("smoke", "full"):
        schema = model_lib.build_schema(configs.get_config(arch, variant))
        with sharding.activate(mesh):
            specs = layers.param_specs(schema)
            metas, placements = layers.abstract_params(schema)
        assert layers.abstract_params(schema)[1] is None  # no mesh: no placements
        for path, _ in layers._iter_leaves(schema):
            spec, meta, placement = specs, metas, placements
            for k in path:
                spec, meta, placement = spec[k], meta[k], placement[k]
            want = ref["specs"][f"{d}x{m}/{arch}/{variant}/" + "/".join(path)]
            assert meta.device.type == "meta" and meta.dtype == torch.float32
            assert list(meta.shape) == want["shape"] and want["dtype"] == "float32"
            assert _spec_list(spec, meta.dim()) == want["spec"], (variant, path)
            assert placement.mesh is mesh and placement.spec == spec
            assert _index_map(placement, meta.shape) == want["map"], (variant, path)


# ---------------------------------------------------------------------------
# Expert parallelism
# ---------------------------------------------------------------------------


def _ep_cfg(name):
    cfg = configs.get_config(EP_ARCH, "smoke")
    cf = EP_CASES[name][1]
    return cfg if cf is None else cfg.replace(capacity_factor=cf)


@pytest.mark.parametrize("name", list(EP_CASES))
def test_ep_block_against_the_reference(ref, name, f32):
    cfg = _ep_cfg(name)
    mesh = _cpu_mesh(2, 4)
    p = {k: ({n: torch.as_tensor(a) for n, a in v.items()} if isinstance(v, dict)
             else torch.as_tensor(v)) for k, v in _ep_params().items()}
    x = torch.as_tensor(_ep_x(name))
    y, aux = moe.moe_block_ep(x, p, cfg, mesh)
    want_y, want_aux = ref[f"ep/{name}/y"], ref[f"ep/{name}/aux"]
    t = x.shape[0] * x.shape[1]
    layout = moe.ep_layout(t, cfg, mesh)
    if name == "dense":
        assert layout is None
    else:
        tok_axes, n_split, t_loc, cap = layout
        assert tok_axes == (("data", "model") if t % 8 == 0 else ("data",))
        # Each token shard's routing and kept pairs, as the block computes them.
        idx_all, keep_all = [], []
        for k in range(n_split):
            _, _, idx_k, _ = moe.route(x.reshape(t, -1)[k * t_loc:(k + 1) * t_loc],
                                       p["router"], cfg)
            _, _, keep = moe.dispatch_slots(idx_k, cfg.n_experts, cap)
            idx_all.append(idx_k.numpy())
            keep_all.append(keep.numpy())
        idx_all, keep_all = np.stack(idx_all), np.stack(keep_all)
        clear = ref[f"ep/{name}/gap"] > GAP
        assert clear.mean() >= 0.99
        np.testing.assert_array_equal(idx_all[clear], ref[f"ep/{name}/idx"][clear])
        assert clear.all(), "a shard's mask is compared whole only where its routing is clear"
        np.testing.assert_array_equal(keep_all, ref[f"ep/{name}/keep"])
        if name == "dropping":
            assert not keep_all.all()
    clear_rows = np.ones(t, bool) if name == "dense" else ref[f"ep/{name}/gap"].reshape(-1) > GAP
    got = y.numpy().reshape(t, -1)[clear_rows]
    assert np.abs(got - want_y.reshape(t, -1)[clear_rows]).max() <= 1e-5 * np.abs(want_y).max()
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def test_ep_block_against_the_dense_block(f32):
    """At capacity factor E/k no pair drops in either block: y equal to the
    dense block's within 1e-5 of its scale; aux the token shards' mean, and
    within the reference's own rtol 0.05 of the whole batch's."""
    cfg = configs.get_config(EP_ARCH, "smoke")
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    p = layers.init_params(moe.moe_schema(cfg), 3, CPU)
    x = torch.randn((8, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    y_dense, aux_dense = moe._moe_block_dense(x, p, cfg)
    with sharding.activate(_cpu_mesh(2, 4)):
        y_ep, aux_ep = moe.moe_block(x, p, cfg.replace(moe_impl="ep"))
    assert (y_ep - y_dense).abs().max() <= 1e-5 * y_dense.abs().max()
    shards = [moe.route(part, p["router"], cfg)[3] for part in x.reshape(8, 32, -1)]
    torch.testing.assert_close(aux_ep, torch.stack(shards).mean(), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(aux_ep), float(aux_dense), rtol=0.05)


def _port_train_state(cfg):
    host = convert.train_state_to_numpy(model_lib.init_train_state(cfg, 0, device=CPU))
    return convert.train_state_from_numpy(host._replace(params=_params_np(EP_ARCH)), cfg, CPU)


def _assert_params_close(got, want, what):
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want), strict=True):
        worst = np.abs(np.asarray(g, np.float64) - w).max()
        assert worst <= 1e-5, (what, path, worst)


def test_ep_train_step_against_the_reference(ref, f32):
    cfg = configs.get_config(EP_ARCH, "smoke").replace(moe_impl="ep")
    state = _port_train_state(cfg)
    with sharding.activate(_cpu_mesh(2, 4)):
        for i in (1, 2):
            batch = {k: torch.as_tensor(ref["inputs"][f"batch{i}/{k}"])
                     for k in ("tokens", "labels", "odl_labels")}
            state, metrics = model_lib.train_step(state, batch, cfg)
            for key in ("loss", "grad_norm"):
                want = float(ref[f"train{i}/{key}"])
                assert abs(float(metrics[key]) - want) <= 1e-5 * abs(want), (i, key)
    got = convert.train_state_to_numpy(state).params
    want = {}
    for key, a in ref.items():
        if key.startswith("train/params/"):
            sub = want
            parts = key[len("train/params/"):].split("/")
            for k in parts[:-1]:
                sub = sub.setdefault(k, {})
            sub[parts[-1]] = a
    _assert_params_close(got, want, "ep train_step against the reference")


def test_ep_train_step_equals_the_meshless_step(f32):
    cfg = configs.get_config(EP_ARCH, "smoke")
    cfg = cfg.replace(moe_impl="ep", capacity_factor=cfg.n_experts / cfg.top_k)
    mesh_state, plain_state = _port_train_state(cfg), _port_train_state(cfg)
    for i in (1, 2):
        batch = _t_batch(_repeated_batch(cfg, i))
        with sharding.activate(_cpu_mesh(2, 4)):
            mesh_state, m_mesh = model_lib.train_step(mesh_state, batch, cfg)
        plain_state, m_plain = model_lib.train_step(plain_state, batch, cfg)
        for key in ("loss", "grad_norm"):
            want = float(m_plain[key])
            assert abs(float(m_mesh[key]) - want) <= 1e-5 * abs(want), (i, key)
    _assert_params_close(convert.train_state_to_numpy(mesh_state).params,
                         convert.train_state_to_numpy(plain_state).params, "ep against meshless")
    assert all(t.isfinite().all() for t in adam.leaves(mesh_state.params))


def test_remat_recomputes_under_the_forwards_mesh_scope():
    """The mesh scope is thread-local, and on the card autograd runs the
    backward (and so remat's recomputation) on a thread of its own, which
    sees no scope.  The recomputed layers must run the EP block the forward
    ran: here the backward runs outside the scope, and the gradients equal
    those of the same forward without remat."""
    cfg = configs.get_config(EP_ARCH, "smoke").replace(moe_impl="ep")
    state = _port_train_state(cfg)
    toks = torch.as_tensor(_batch(cfg, 1, batch=8)["tokens"])
    grads = []
    for remat in (False, True):
        params = _leaf_copies(state.params)
        with sharding.activate(_cpu_mesh(2, 4)):
            hidden, aux = transformer.lm_hidden(params, toks, cfg, remat=remat)
        (hidden.float().square().mean() + aux).backward()  # outside the scope
        grads.append([t.grad for t in adam.leaves(params)])
    for a, b in zip(*grads, strict=True):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _leaf_copies(tree):
    return {k: _leaf_copies(v) if isinstance(v, dict) else v.detach().clone().requires_grad_()
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# The pipeline, the rescale and the fleet on a dev mesh
# ---------------------------------------------------------------------------


def test_pipeline_against_sequential_and_the_reference(ref):
    h, w = (torch.as_tensor(ref["inputs"][k]) for k in ("pipe/h", "pipe/w"))
    n = PIPE["n_stages"]
    mesh = mesh_lib.make_mesh((n,), ("stage",), devices=[CPU] * n)

    def stage_fn(x, p):
        return torch.tanh(x @ p["w"])

    got = pipeline.pipeline_forward(h, {"w": w}, stage_fn, mesh)
    want = pipeline.sequential_reference(h, {"w": w}, stage_fn, n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref["pipe/out"], atol=1e-5)
    assert pipeline.bubble_fraction(8, 4) == 7 / 11
    with pytest.raises(ValueError, match="stage"):
        pipeline.pipeline_forward(h, {"w": w}, stage_fn, _cpu_mesh(2, 4))


def _assert_shards_are_their_slices(tree, full, mesh):
    for (path, sh), (_, whole) in zip(_leaves(tree), _leaves(full), strict=True):
        assert isinstance(sh, sharding.Sharded) and sh.placement.mesh == mesh, path
        for pos, index in sh.placement.indices_map(tuple(whole.shape)).items():
            shard = sh.shards[pos]
            assert shard.device == mesh.device_at(pos)
            assert shard.numpy().tobytes() == whole[index].numpy().tobytes(), (path, pos)
        assert torch.equal(sh.gather(), whole), path


def test_rescale_4x2_to_2x2_is_bit_for_bit(tmp_path):
    cfg = configs.get_config("qwen3-4b", "smoke")
    schema = model_lib.build_schema(cfg)
    params = layers.init_params(schema, 0, CPU)
    mesh_a, mesh_b = _cpu_mesh(4, 2), _cpu_mesh(2, 2)
    with sharding.activate(mesh_a):
        placed = checkpoint.reshard_tree(params, mesh_a, layers.param_specs(schema))
    _assert_shards_are_their_slices(placed, params, mesh_a)
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=1)
    mgr.save(1, placed)
    step, restored = checkpoint.rescale(mgr, schema, mesh_b)
    assert step == 1
    _assert_shards_are_their_slices(restored, params, mesh_b)
    wd = restored["layers"]["mlp"]["wd"]
    assert wd.placement.mesh.shape == {"data": 2, "model": 2}
    assert len({tuple(s.shape) for s in wd.shards.values()}) == 1


def test_fleet_splits_over_the_data_axis_of_a_dev_mesh():
    """The stream rule rides ``data`` on a (data, model) mesh: a fleet of 8
    splits into 4 shards, shard k on entry (k, 0), and the split run is
    ``run_fleet`` bit for bit."""
    cfg = model_lib.core_config(configs.get_config("qwen3-4b", "smoke"))
    rng = np.random.default_rng(3)
    xs = torch.as_tensor(rng.standard_normal((6, 8, cfg.elm.n_in)).astype(np.float32))
    ys = torch.as_tensor(rng.integers(0, cfg.elm.n_out, (6, 8)).astype(np.int32))
    fleet = engine.init_fleet(cfg, 8, CPU)
    solo, solo_out = engine.run_fleet(fleet, xs, ys, cfg, mode="train_phase")
    labelled = mesh_lib.make_dev_mesh(4, 2, devices=[f"cuda:{i}" for i in range(8)])
    with sharding.activate(labelled):  # distinct entries, to see which hold the shards
        assert sharding.fleet_axis_size() == 4
        assert sharding.fleet_devices() == [torch.device("cuda", 2 * k) for k in range(4)]
    with sharding.activate(_cpu_mesh(4, 2)):
        shards = engine.split_fleet(engine.init_fleet(cfg, 8, CPU), cfg, block=2)
        shards, out = engine.run_fleet_shards(shards, xs, ys, cfg, mode="train_phase")
    assert len(shards.states) == 4
    for a, b in zip(tree_leaves(engine.merge_fleet(shards)), tree_leaves(solo)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(out), tree_leaves(solo_out)):
        assert torch.equal(a.cpu(), b)
