"""The port's stream-axis sharding scope and mesh (``repro_torch.distributed.
sharding``, ``repro_torch.launch.mesh``), mirroring the in-process half of
``tests/test_sharding.py``; the vmap-era fleet helpers of ``core/`` against
the JAX package's, with the mirror of ``tests/test_multidevice.py::
test_odl_fleet_shards_over_data_axis`` on a CPU mesh; and the repo's linter
on the port.

Everything runs in process on the CPU: a mesh of repeated ``cpu`` entries
stands for the forced host device count of the reference's tests.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp

    from repro.core import drift as j_drift
    from repro.core import oselm as j_oselm
    from repro.core import pruning as j_pruning

from repro_torch.core import drift as t_drift  # noqa: E402
from repro_torch.core import oselm as t_oselm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


def _cpu_mesh(n=1):
    return mesh_mod.make_fleet_mesh(devices=["cpu"] * n)


# ---------------------------------------------------------------------------
# The scope
# ---------------------------------------------------------------------------


def test_no_mesh_is_identity():
    tree = {"a": torch.ones((4, 3))}
    assert sharding.mesh_or_none() is None
    assert sharding.fleet_axis_size() == 1
    assert sharding.constrain_fleet(tree) is tree


def test_deactivate_restores_activate_scope():
    mesh = _cpu_mesh()
    with sharding.activate(mesh):
        assert sharding.mesh_or_none() is mesh
        assert sharding.fleet_axis_size() == 1  # a 1-entry fleet axis
        with sharding.deactivate():
            assert sharding.mesh_or_none() is None
            assert sharding.fleet_axis_size() == 1
        assert sharding.mesh_or_none() is mesh
    assert sharding.mesh_or_none() is None


def test_deactivate_and_activate_restore_on_exception():
    mesh = _cpu_mesh(4)
    with sharding.activate(mesh):
        with pytest.raises(RuntimeError, match="boom"):
            with sharding.deactivate():
                raise RuntimeError("boom")
        assert sharding.mesh_or_none() is mesh and sharding.fleet_axis_size() == 4
    with pytest.raises(RuntimeError, match="boom"):
        with sharding.activate(mesh):
            raise RuntimeError("boom")
    assert sharding.mesh_or_none() is None and sharding.fleet_axis_size() == 1


def test_nested_activate_restores_outer_rules():
    outer, inner = _cpu_mesh(4), _cpu_mesh(8)
    with sharding.activate(outer):
        assert sharding.fleet_axis_size() == 4
        with sharding.activate(outer, rules={"stream": None}):
            assert sharding.fleet_axis_size() == 1
        assert sharding.fleet_axis_size() == 4
        with sharding.activate(inner):
            assert sharding.mesh_or_none() is inner and sharding.fleet_axis_size() == 8
        assert sharding.mesh_or_none() is outer and sharding.fleet_axis_size() == 4
    assert sharding.DEFAULT_RULES["stream"] == ("fleet", "pod", "data")


@pytest.mark.parametrize("n", [4, 8])
def test_fleet_axis_size_on_cpu_meshes(n):
    mesh = _cpu_mesh(n)
    assert mesh.shape == {"fleet": n} and len(mesh.devices) == n
    assert mesh.devices == (torch.device("cpu"),) * n
    with sharding.activate(mesh):
        assert sharding.fleet_axis_size() == n
    with sharding.activate(mesh, rules={"stream": "fleet"}):
        assert sharding.fleet_axis_size() == n
    with sharding.activate(mesh, rules={"stream": ("pod", "data")}):  # axes the mesh lacks
        assert sharding.fleet_axis_size() == 1


def test_make_fleet_mesh_sizes_and_refusals(monkeypatch):
    assert len(_cpu_mesh(8).devices) == 8
    assert mesh_mod.make_fleet_mesh(3, devices=["cpu"] * 8).shape == {"fleet": 3}
    with pytest.raises(ValueError, match="mesh-fleet 9 > 8 visible devices"):
        mesh_mod.make_fleet_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="at least one device"):
        sharding.FleetMesh(())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_fleet_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_mod.make_fleet_mesh(2)


# ---------------------------------------------------------------------------
# The vmap-era fleet helpers against the JAX package
# ---------------------------------------------------------------------------


def _head_data(s=8, n_in=32, n_hidden=16, n_out=4, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, n_in)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[np.arange(s) % n_out]
    return x, y


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("masked", [False, True])
def test_oselm_fleet_predict_and_update_match_jax(masked):
    """``fleet_predict`` and ``fleet_update`` (two updates, so the second
    starts from a learned P) against the JAX package's vmaps: predictions
    exact, outputs 1e-4, P 2e-5 in units of its start I/ridge, beta 2e-4."""
    jcfg = j_oselm.OSELMConfig(n_in=32, n_hidden=16, n_out=4, variant="hash")
    tcfg = t_oselm.OSELMConfig(n_in=32, n_hidden=16, n_out=4, variant="hash")
    x, y = _head_data()
    mask = np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32) if masked else None
    jst, tst = j_oselm.init_fleet(jcfg, 8), t_oselm.init_fleet(tcfg, 8, "cpu")
    for step in range(2):
        xs = x * (1 + step)
        jst = j_oselm.fleet_update(jst, jnp.asarray(xs), jnp.asarray(y), jcfg,
                                   mask=None if mask is None else jnp.asarray(mask))
        tst = t_oselm.fleet_update(tst, torch.as_tensor(xs), torch.as_tensor(y), tcfg,
                                   mask=None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(tst.P.numpy() * tcfg.ridge, np.asarray(jst.P) * jcfg.ridge,
                               atol=2e-5)
    np.testing.assert_allclose(tst.beta.numpy(), np.asarray(jst.beta), atol=2e-4)
    np.testing.assert_array_equal(tst.count.numpy(), np.asarray(jst.count))
    if masked:
        np.testing.assert_array_equal(tst.P.numpy()[mask == 0],
                                      t_oselm.init_fleet(tcfg, 2, "cpu").P.numpy())
    jc, jo = j_oselm.fleet_predict(jst, jnp.asarray(x), jcfg)
    tc, to = t_oselm.fleet_predict(tst, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.usefixtures("jax_ref")
def test_drift_and_pruning_fleet_helpers_match_jax():
    """``drift.fleet_update``, ``pruning.fleet_should_query`` and
    ``pruning.fleet_update`` over 40 steps of 6 streams against the JAX
    vmaps: every integer and boolean leaf exact, floats 1e-5."""
    s = 6
    rng = np.random.default_rng(1)
    dcfg_j, dcfg_t = j_drift.DriftConfig(warmup=8), t_drift.DriftConfig(warmup=8)
    pcfg_j, pcfg_t = j_pruning.PruneConfig(min_trained=4), t_pruning.PruneConfig(min_trained=4)
    jd, td = j_drift.init_fleet(s), t_drift.init_fleet(s, "cpu")
    jp, tp = j_pruning.init_fleet(s), t_pruning.init_fleet(s, "cpu")
    for t in range(40):
        score = rng.standard_normal(s).astype(np.float32) * (5.0 if t >= 30 else 1.0)
        outputs = rng.uniform(size=(s, 4)).astype(np.float32)
        count = np.full(s, t, np.int32)
        agree = rng.uniform(size=s) < 0.8
        jd = j_drift.fleet_update(jd, jnp.asarray(score), dcfg_j)
        td = t_drift.fleet_update(td, torch.as_tensor(score), dcfg_t)
        jq = j_pruning.fleet_should_query(jp, jnp.asarray(outputs), jnp.asarray(count),
                                          jd.active, pcfg_j)
        tq = t_pruning.fleet_should_query(tp, torch.as_tensor(outputs), torch.as_tensor(count),
                                          td.active, pcfg_t)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq), err_msg=f"tick {t}")
        conf = np.clip(np.sort(outputs)[:, -1] - np.sort(outputs)[:, -2], 0, 1)
        jp = j_pruning.fleet_update(jp, jq, jnp.asarray(agree), jnp.asarray(conf), pcfg_j)
        tp = t_pruning.fleet_update(tp, tq, torch.as_tensor(agree), torch.as_tensor(conf),
                                    pcfg_t)
        for name in t_drift.DriftState._fields:
            a, b = getattr(td, name).numpy(), np.asarray(getattr(jd, name))
            if a.dtype == np.float32:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"drift.{name} tick {t}")
        for name in t_pruning.PruneState._fields:
            np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)),
                                          err_msg=f"prune.{name} tick {t}")
    assert bool(np.asarray(jd.active).any())  # the shifted scores tripped the detector
    assert int(np.asarray(jp.skips).sum()) > 0  # and confident heads skipped


@pytest.mark.usefixtures("jax_ref")
def test_odl_fleet_shards_over_the_fleet_axis():
    """Mirror of ``tests/test_multidevice.py::test_odl_fleet_shards_over_data_axis``:
    8 heads split over a 4-entry mesh, two rows a shard, each shard's
    ``fleet_update`` on its own device; stitched back they equal the
    unsharded update bit for bit, and the JAX package's within tolerance."""
    tcfg = t_oselm.OSELMConfig(n_in=32, n_hidden=16, n_out=4, variant="hash")
    jcfg = j_oselm.OSELMConfig(n_in=32, n_hidden=16, n_out=4, variant="hash")
    x = np.random.default_rng(0).standard_normal((8, 32)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[np.arange(8) % 4]
    mesh = mesh_mod.make_fleet_mesh(4, devices=["cpu"] * 4)
    fleet = t_oselm.init_fleet(tcfg, 8, "cpu")
    whole = t_oselm.fleet_update(fleet, torch.as_tensor(x), torch.as_tensor(y), tcfg)
    with sharding.activate(mesh):
        n = sharding.fleet_axis_size()
        w = 8 // n
        parts = []
        for k, dev in enumerate(mesh.devices):
            rows = slice(k * w, (k + 1) * w)
            shard = t_oselm.OSELMState(*(a[rows].to(dev) for a in fleet))
            parts.append(t_oselm.fleet_update(shard, torch.as_tensor(x[rows], device=dev),
                                              torch.as_tensor(y[rows], device=dev), tcfg))
    f2 = t_oselm.OSELMState(*(torch.cat(leaves) for leaves in zip(*parts)))
    assert n == 4 and f2.P.shape == (8, 16, 16)
    for a, b in zip(f2, whole):
        assert torch.equal(a, b)
    want = j_oselm.fleet_update(j_oselm.init_fleet(jcfg, 8), jnp.asarray(x), jnp.asarray(y), jcfg)
    np.testing.assert_allclose(f2.P.numpy() * tcfg.ridge, np.asarray(want.P) * jcfg.ridge,
                               atol=2e-5)
    np.testing.assert_allclose(f2.beta.numpy(), np.asarray(want.beta), atol=2e-4)


# ---------------------------------------------------------------------------
# The repo's linter on the port
# ---------------------------------------------------------------------------


def test_odlint_clean_on_the_port():
    """``tools/odlint src/repro_torch`` finds nothing: the port carries the
    reference's marks (lock holders and guarded fields, the CLI prints,
    the shard-local entry points)."""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" / "odlint"), "src/repro_torch"],
                          capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "clean" in proc.stdout
