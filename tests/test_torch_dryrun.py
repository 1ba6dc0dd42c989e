"""The port's dry-run (``launch/dryrun.py``, ``launch/mesh.
make_production_mesh`` and the abstract state of ``models/model.py``) held
against the JAX package's on the CPU.

The JAX side of the mesh tests needs 8 host devices, so it runs once, in
one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=8``
(as ``tests/test_torch_mesh_model.py`` does), behind a module-scoped
fixture; the port's meshes are entries of the meta device.

* ``make_production_mesh``: the reference's shapes and axes
  (``src/repro/launch/mesh.py:21``), meta entries by default.
* ``cache_axes`` equal to the reference's on every cache leaf of every
  arch's smoke config.
* ``abstract_train_state``, ``abstract_serve_state`` and ``input_specs``
  of every arch's smoke config at every ``LM_SHAPES`` entry, with no mesh
  and under a (2, 4) mesh: each leaf's shape, dtype and ``PartitionSpec``
  (ZeRO-1 moments and caches too) equal to the reference's
  ``ShapeDtypeStruct``s; the encoder-decoder's decode-cell caches too.
* The per-device ``argument_bytes`` of smoke train and decode cells equal
  to the reference's ``compiled.memory_analysis().argument_size_in_bytes``
  (its ``_train_cell``/``_decode_cell`` lowered and compiled under the
  same mesh).
* ``run_cell`` on a meta (2, 4) mesh at smoke width: ``ok`` or the
  reference's skip reason for one arch per family at every shape, with the
  reference's record keys and the port's own; ``main`` writes the jsonl and
  reports ``failures=0``.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # meta tensors and small shapes: threads only spin

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
META8 = ["meta"] * 8
# Cells whose argument bytes are compiled on the JAX side: (arch, shape).
CELLS = {
    "train": ("qwen3-4b", ("train_s", 32, 8, "train")),
    "moe_train": ("deepseek-moe-16b", ("train_s", 32, 8, "train")),
    "decode": ("qwen3-4b", ("decode_s", 64, 8, "decode")),
    "encdec_decode": ("whisper-small", ("decode_s", 64, 8, "decode")),
}
FAMILIES = ("qwen3-4b", "deepseek-moe-16b", "mamba2-780m", "recurrentgemma-9b",
            "chameleon-34b", "whisper-small")
RECORD_KEYS = ("arch", "shape", "mesh", "variant", "kind", "n_devices", "status", "raw_flops",
               "raw_bytes_accessed", "argument_bytes", "output_bytes", "temp_bytes",
               "alias_bytes", "peak_bytes", "collectives", "flops", "bytes_accessed",
               "collective_bytes")
PORT_KEYS = ("flops_total", "bytes_total", "temp_basis", "collectives_basis", "fits",
             "census_s")

REFERENCE = r"""
import contextlib, json, sys
import jax
jax.devices()  # eight host devices, before the dry-run module is imported
from repro import configs
from repro.configs.base import ShapeConfig, TrainConfig
from repro.distributed import sharding
from repro.launch import dryrun
from repro.launch.mesh import make_dev_mesh
from repro.models import model as M

cells = json.loads(sys.argv[1])
leaves = {}

def spec_list(sh, n):
    if sh is None:
        return [None] * n
    e = list(sh.spec) + [None] * (n - len(sh.spec))
    return [list(x) if isinstance(x, tuple) else x for x in e]

def key(p):
    return str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))

def record(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        leaves[prefix + "/" + "/".join(key(p) for p in path)] = dict(
            shape=list(leaf.shape), dtype=str(leaf.dtype),
            spec=spec_list(getattr(leaf, "sharding", None), len(leaf.shape)))

mesh = make_dev_mesh(2, 4)
for tag, m in (("none", None), ("2x4", mesh)):
    with (sharding.activate(m) if m is not None else contextlib.nullcontext()):
        for arch in configs.ARCH_IDS:
            cfg = configs.get_config(arch, "smoke")
            record(f"{tag}/{arch}/train", M.abstract_train_state(cfg, TrainConfig()))
            for s in configs.LM_SHAPES:
                record(f"{tag}/{arch}/inputs/{s.name}", M.input_specs(cfg, s))
                if s.kind == "decode" and not cfg.enc_dec:
                    record(f"{tag}/{arch}/serve/{s.name}",
                           M.abstract_serve_state(cfg, s.global_batch, s.seq_len))
args = {}
for name, (arch, shape) in cells.items():
    cfg = configs.get_config(arch, "smoke")
    shape = ShapeConfig(*shape)
    with sharding.activate(mesh, dryrun._rules_for(cfg, "base", mesh)):
        if shape.kind == "train":
            jitted, a = dryrun._train_cell(cfg, shape, TrainConfig(microbatches=1))
        else:
            jitted, a = dryrun._decode_cell(cfg, shape)
        record(f"cell/{name}", a)
        compiled = jitted.lower(*a).compile()
    args[name] = int(compiled.memory_analysis().argument_size_in_bytes)
print("RESULT " + json.dumps({"leaves": leaves, "argument_bytes": args}))
"""


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(REFERENCE), json.dumps(CELLS)],
                       env=env, capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout[-2000:]}\nSTDERR:\n{r.stderr[-4000:]}"
    line = next(x for x in r.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def _spec_list(placement, n):
    if placement is None:
        return [None] * n
    e = list(placement.spec) + [None] * (n - len(placement.spec))
    return [list(x) if isinstance(x, tuple) else x for x in e]


def _record(out, prefix, metas, placements):
    """Every leaf of a (metas, placements) pair by path, as the reference
    records its ShapeDtypeStructs."""
    if isinstance(metas, dict):
        for k in metas:
            _record(out, f"{prefix}/{k}", metas[k], None if placements is None else placements[k])
    elif isinstance(metas, tuple) and hasattr(metas, "_fields"):
        for f in metas._fields:
            _record(out, f"{prefix}/{f}", getattr(metas, f),
                    None if placements is None else getattr(placements, f))
    elif isinstance(metas, (tuple, list)):
        for i, m in enumerate(metas):
            _record(out, f"{prefix}/{i}", m, None if placements is None else placements[i])
    else:
        assert metas.device.type == "meta", prefix
        out[prefix] = dict(shape=list(metas.shape), dtype=str(metas.dtype).replace("torch.", ""),
                           spec=_spec_list(placements, metas.dim()))


def _port_leaves(tag):
    out = {}
    mesh = mesh_lib.make_dev_mesh(2, 4, devices=META8) if tag == "2x4" else None
    with (sharding.activate(mesh) if mesh is not None else sharding.deactivate()):
        for arch in configs.ARCH_IDS:
            cfg = configs.get_config(arch, "smoke")
            _record(out, f"{tag}/{arch}/train", *model_lib.abstract_train_state(cfg, TrainConfig()))
            for s in configs.LM_SHAPES:
                _record(out, f"{tag}/{arch}/inputs/{s.name}", *model_lib.input_specs(cfg, s))
                if s.kind == "decode" and not cfg.enc_dec:
                    _record(out, f"{tag}/{arch}/serve/{s.name}",
                            *model_lib.abstract_serve_state(cfg, s.global_batch, s.seq_len))
    return out


# ---------------------------------------------------------------------------
# The production mesh
# ---------------------------------------------------------------------------


def test_make_production_mesh_is_the_references():
    pod = mesh_lib.make_production_mesh()
    assert pod.axis_names == ("data", "model") and pod.sizes == (16, 16)
    assert len(pod.devices) == 256 and set(pod.devices) == {torch.device("meta")}
    two = mesh_lib.make_production_mesh(multi_pod=True)
    assert two.axis_names == ("pod", "data", "model") and two.sizes == (2, 16, 16)
    assert two.shape == {"pod": 2, "data": 16, "model": 16} and len(two.devices) == 512
    named = mesh_lib.make_production_mesh(devices=["cpu"] * 256)
    assert set(named.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="needs 256 entries"):
        mesh_lib.make_production_mesh(devices=["meta"] * 8)


# ---------------------------------------------------------------------------
# The abstract state against the reference's
# ---------------------------------------------------------------------------


def test_cache_axes_equal_the_references():
    """On every cache leaf of every arch's smoke config (the decoder-only
    serve state; the encoder-decoder's decode caches), the reference's
    ``cache_axes`` called with its own path format."""
    pytest.importorskip("jax")
    from repro.models import model as j_model

    n = 0
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch, "smoke")
        if cfg.enc_dec:
            caches = dryrun._decode_cell(cfg, ShapeConfig("d", 64, 8, "decode"))[1][2]
        else:
            caches = model_lib.abstract_serve_state(cfg, 8, 64)[0].caches

        def check(path, leaf):
            nonlocal n
            ref_path = tuple(f"['{k}']" for k in path)
            assert model_lib.cache_axes(path, leaf) == j_model.cache_axes(ref_path, leaf), path
            n += 1

        model_lib._map_path(check, caches)
    assert n >= 2 * len(configs.ARCH_IDS)


@pytest.mark.parametrize("tag", ["none", "2x4"])
def test_abstract_state_and_specs_equal_the_references(ref, tag):
    """Every leaf of ``abstract_train_state``, ``abstract_serve_state`` and
    ``input_specs`` (every arch, every LM shape): shape, dtype and spec,
    the moments' ZeRO-1 specs and the caches' included."""
    got = _port_leaves(tag)
    want = {k: v for k, v in ref["leaves"].items() if k.startswith(tag + "/")}
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    zero1 = [k for k in want if tag == "2x4" and "/opt/m/" in k and "data" in str(want[k]["spec"])]
    assert tag == "none" or len(zero1) > 10 * len(configs.ARCH_IDS)


def _smoke_cells(monkeypatch, shape=None):
    """``run_cell`` on a meta (2, 4) mesh at smoke width, at ``shape`` for
    every shape name where one is given.  Else, at the LM shapes,
    whisper-small's smoke config keeps 64 decoder positions, too few for
    their sequences (in both packages), so it has its full config's
    32,768; mamba2-780m scans chunks of its full config's 128 tokens (not
    16: 8 times fewer steps at 32k)."""
    get = configs.get_config

    def get_config(a, variant="full"):
        cfg = get(a, "smoke")
        if shape is not None:
            return cfg
        if cfg.enc_dec:
            return cfg.replace(max_source_len=32_768)
        return cfg.replace(ssm_chunk=128) if cfg.family == "ssm" else cfg

    monkeypatch.setattr(dryrun.configs, "get_config", get_config)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod=False: mesh_lib.make_dev_mesh(2, 4, devices=META8))
    if shape is not None:
        monkeypatch.setattr(dryrun.configs, "shape_by_name", lambda name: shape)


@pytest.mark.parametrize("name", list(CELLS))
def test_argument_bytes_equal_the_references(ref, name, monkeypatch):
    """Per-device argument bytes of a smoke cell under the (2, 4) mesh, and
    each of its leaves, against the reference's compiled cell."""
    arch, shape = CELLS[name]
    cfg = configs.get_config(arch, "smoke")
    shape = ShapeConfig(*shape)
    mesh = mesh_lib.make_dev_mesh(2, 4, devices=META8)
    with sharding.activate(mesh, dryrun._rules_for(cfg, "base", mesh)):
        _, args, placements = dryrun._cell_for(cfg, shape, TrainConfig(microbatches=1))
    got = {}
    _record(got, f"cell/{name}", args, placements)
    want = {k: v for k, v in ref["leaves"].items() if k.startswith(f"cell/{name}/")}
    assert got == want
    _smoke_cells(monkeypatch, shape)
    rec = dryrun.run_cell(arch, shape.name, False)
    assert rec["argument_bytes"] == ref["argument_bytes"][name]


# ---------------------------------------------------------------------------
# Cells and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_ok_or_the_references_skip(arch, monkeypatch):
    """One arch per family at every LM shape on a meta (2, 4) mesh at smoke
    width (``_smoke_cells``): ``ok`` with the reference's keys and the
    port's, or skipped with the reference's reason."""
    cfg = configs.get_config(arch, "smoke")
    _smoke_cells(monkeypatch)
    for shape in configs.LM_SHAPES:
        rec = dryrun.run_cell(arch, shape.name, False)
        assert rec["mesh"] == "2x4" and rec["n_devices"] == 8
        if shape.name == "long_500k" and not cfg.sub_quadratic:
            assert rec["status"] == "skipped"
            assert rec["reason"] == "full attention is quadratic at 524k"
            continue
        if shape.name == "long_500k" and cfg.enc_dec:
            assert rec == dict(rec, status="skipped", reason="enc-dec decoder capped below 500k")
            continue
        assert rec["status"] == "ok", rec
        for k in RECORD_KEYS + PORT_KEYS:
            assert k in rec, k
        assert rec["temp_basis"] == "data_shard" and rec["collectives_basis"] == "explicit"
        assert rec["argument_bytes"] > 0 and rec["temp_bytes"] > 0 and rec["flops"] > 0
        assert rec["flops_total"] == rec["flops"] * 8
        assert rec["fits"] == (rec["peak_bytes"] <= rec["device_bytes"])
        assert rec["peak_bytes"] == (rec["argument_bytes"] + rec["temp_bytes"]
                                     + max(rec["output_bytes"] - rec["alias_bytes"], 0))
        if shape.kind != "prefill":  # params and moments, or the caches, in place
            assert 0 < rec["alias_bytes"] < rec["argument_bytes"]


def test_main_writes_the_jsonl(tmp_path, capsys, monkeypatch):
    """The reference's CLI, its records in ``results/dryrun_torch.jsonl``
    (by default, beside the reference's ``results/dryrun.jsonl``); the
    cells at smoke width on the (2, 4) meta mesh."""
    monkeypatch.chdir(tmp_path)
    _smoke_cells(monkeypatch)
    rc = dryrun.main(["--arch", "qwen3-4b"])
    assert rc == 0
    out = tmp_path / "results" / "dryrun_torch.jsonl"
    assert "failures=0" in capsys.readouterr().err
    recs = [json.loads(x) for x in out.read_text().splitlines()]
    assert [r["shape"] for r in recs] == [s.name for s in configs.LM_SHAPES]
    assert [r["status"] for r in recs] == ["ok", "ok", "ok", "skipped"]
    assert {r["mesh"] for r in recs} == {"2x4"}
    assert not (tmp_path / "results" / "dryrun.jsonl").exists()
    if not torch.cuda.is_available():  # --device cuda needs the card
        assert dryrun.main(["--arch", "qwen3-4b", "--device", "cuda"]) == 1
