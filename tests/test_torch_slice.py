"""The port's first slice as a whole against the JAX package: the HAR data,
the S=1 paper path, a T-tick fleet run, and import isolation.

Long runs are compared by end aggregates, not tick by tick: the two
frameworks round differently, so a value sitting on a threshold (the drift
k-sigma test, ``conf > theta``) can flip.  Tolerances: accuracy within
1 pt, comm volume within 2 pts.  Inside the port, the accounting identities
hold exactly.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro import engine as j_engine  # noqa: E402
from repro.core import odl_head as j_head  # noqa: E402
from repro.core import oselm as j_oselm  # noqa: E402
from repro.core import pruning as j_pruning  # noqa: E402
from repro.data import har as j_har  # noqa: E402
from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.configs import har_odl as t_har_odl  # noqa: E402
from repro_torch.core import oselm as t_oselm  # noqa: E402
from repro_torch.core import pruning as t_pruning  # noqa: E402
from repro_torch.data import har as t_har  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
N = 16  # a narrow head keeps the CPU run short; the full width runs on the card


@pytest.fixture(scope="module")
def data():
    return j_har.generate(seed=0)


def test_har_copy_is_byte_identical(data):
    mine = t_har.generate(seed=0)
    for f in ("train_x", "train_y", "test0_x", "test0_y", "test1_x", "test1_y"):
        a, b = getattr(mine, f), getattr(data, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for a, b in zip(t_har.odl_split(mine, 0.6, 0), j_har.odl_split(data, 0.6, 0)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _boot_jax(data, theta):
    elm = j_oselm.OSELMConfig(n_in=561, n_hidden=N, n_out=6, seed=77, ridge=1e-2)
    ladder = {} if theta == "auto" else {"ladder": (theta,)}
    cfg = j_head.ODLCoreConfig(elm=elm, prune=j_pruning.PruneConfig(min_trained=288, **ladder))
    st0 = j_oselm.init_state_batch(elm, jnp.asarray(data.train_x), jax.nn.one_hot(data.train_y, 6))
    return cfg, j_head.init_state(cfg)._replace(elm=st0)


def _boot_torch(data, theta):
    from repro_torch.core import odl_head as t_head

    elm = t_oselm.OSELMConfig(n_in=561, n_hidden=N, n_out=6, seed=77, ridge=1e-2)
    ladder = {} if theta == "auto" else {"ladder": (theta,)}
    cfg = t_head.ODLCoreConfig(elm=elm, prune=t_pruning.PruneConfig(min_trained=288, **ladder))
    y0 = torch.nn.functional.one_hot(torch.as_tensor(data.train_y).long(), 6).float()
    st0 = t_oselm.init_state_batch(elm, torch.as_tensor(data.train_x), y0)
    return t_head, cfg, t_head.init_state(cfg, device="cpu")._replace(elm=st0)


@pytest.mark.parametrize("theta", ["auto", 0.16])
def test_paper_path_aggregates_match(data, theta):
    """``run_training_phase`` at S=1: accuracy within 1 pt, comm within 2 pts.
    At N=16 the auto ladder never leaves theta=1 (the full-supervision
    baseline); the fixed 0.16 ladder prunes."""
    ox, oy, tx, ty = j_har.odl_split(data, 0.6, 0)
    jcfg, jcore = _boot_jax(data, theta)
    jcore, _ = jax.jit(functools.partial(j_head.run_training_phase, cfg=jcfg))(
        jcore, jnp.asarray(ox), jnp.asarray(oy))
    j_acc = float(j_head.accuracy(jcore, jnp.asarray(tx), jnp.asarray(ty), jcfg))
    j_comm = float(j_pruning.comm_volume_fraction(jcore.prune))

    t_head, tcfg, tcore = _boot_torch(data, theta)
    tcore, outs = t_head.run_training_phase(tcore, ox, oy, tcfg)
    t_acc = float(t_head.accuracy(tcore, tx, ty, tcfg))
    t_comm = float(t_pruning.comm_volume_fraction(tcore.prune))

    assert abs(t_acc - j_acc) <= 0.01, (t_acc, j_acc)
    assert abs(t_comm - j_comm) <= 0.02, (t_comm, j_comm)
    # Accounting inside the port: exact.
    assert int(tcore.prune.queries) == int(outs.queried.sum())
    assert int(tcore.prune.queries + tcore.prune.skips) == len(ox)
    assert float(tcore.meter.up_bytes) == 561 * 4 * int(outs.queried.sum())


def test_algorithm1_stream_detects_the_same_drift(data):
    """``run_stream`` (algo1) over a calm-then-shifted stream, as in
    ``tests/test_odl_system.py``: both packages stay calm, then enter
    training; training and query counts within 2 % of the stream."""
    calm = data.test0_x[:150]
    shifted = np.clip(data.test1_x[:150] * 4.0 + 2.0, -3, 3).astype(np.float32)
    xs = np.concatenate([calm, shifted])
    ys = np.concatenate([data.test0_y[:150], data.test1_y[:150]]).astype(np.int32)

    jcfg, jcore = _boot_jax(data, "auto")
    _, jout = jax.jit(functools.partial(j_head.run_stream, cfg=jcfg))(
        jcore, jnp.asarray(xs), jnp.asarray(ys))
    t_head, tcfg, tcore = _boot_torch(data, "auto")
    _, tout = t_head.run_stream(tcore, xs, ys, tcfg)

    j_train, t_train = np.asarray(jout.mode_training), tout.mode_training.numpy()
    assert not j_train[:140].any() and not t_train[:140].any()
    assert t_train[150:].any() and j_train[150:].any()
    assert abs(int(t_train.sum()) - int(j_train.sum())) <= 0.02 * len(xs)
    assert abs(int(tout.queried.sum()) - int(np.asarray(jout.queried).sum())) <= 0.02 * len(xs)


def test_fleet_run_end_aggregates_match():
    """A T-tick algo1 fleet run of the paper's config at a narrow width:
    per-stream training/query totals close to the JAX engine's, and the
    port's accounting identities exact."""
    jcfg = j_engine.EngineConfig(
        elm=j_oselm.OSELMConfig(n_in=561, n_hidden=N, n_out=6, ridge=1e-2),
        prune=j_pruning.PruneConfig.for_hidden(N),
    )
    tcfg = t_har_odl.smoke()
    s, t, shift_at = 4, 96, 64
    d = t_har.generate(seed=0)
    rng = np.random.default_rng(5)
    xs = np.concatenate([
        d.test0_x[rng.integers(0, len(d.test0_x), (shift_at, s))],
        np.clip(d.test1_x[rng.integers(0, len(d.test1_x), (t - shift_at, s))] * 4.0 + 2.0, -3, 3),
    ]).astype(np.float32)
    ys = rng.integers(0, 6, (t, s)).astype(np.int32)

    jst, jout = j_engine.run_fleet(j_engine.init_fleet(jcfg, s), jnp.asarray(xs),
                                   jnp.asarray(ys), jcfg, mode="algo1")
    tst, tout = t_engine.run_fleet(t_engine.init_fleet(tcfg, s, device="cpu"), xs, ys, tcfg,
                                   mode="algo1")
    np.testing.assert_array_equal(tout.mode_training.numpy()[:shift_at], False)
    j_train = np.asarray(jout.mode_training).sum(0)
    t_train = tout.mode_training.numpy().sum(0)
    assert np.all(np.abs(t_train - j_train) <= 0.02 * t)
    assert np.all(np.abs(tout.queried.numpy().sum(0) - np.asarray(jout.queried).sum(0)) <= 0.02 * t)
    np.testing.assert_array_equal((tst.prune.queries + tst.prune.skips).numpy(), t_train)
    np.testing.assert_array_equal(tst.meter.up_bytes.numpy(), 561 * 4 * tout.queried.numpy().sum(0))
    assert tst.elm.count.dtype == torch.int32 and tst.drift.active.dtype == torch.bool


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py, import without loading
    ``jax`` or anything of ``repro``."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(ROOT / 'src')!r})
sys.path.insert(0, {str(ROOT)!r})
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
print(len(names))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25
