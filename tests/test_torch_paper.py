"""The port's paper path against the JAX package: the analytic models
(Tables 1, 2's parameter counts and 4, Fig 4's mW), the drift ticks, the
§3 drift protocol (``repro_torch.benchmarks.common``) and the table
harness (``repro_torch.benchmarks.paper_tables``).

The analytic values and the drift ticks must be exactly equal.  A drift
trial is a 1008-tick run whose thresholds (``conf > theta``, the ladder's
streaks) can flip on a rounding difference, so its aggregates meet the
ROADMAP's long-run rule: accuracy within 1 pt, comm volume within 2 pts,
and the port's own accounting exact.  Widths are narrow (N=32) to keep the
CPU run short; the full widths (N=128, N=256) run on the card in
``chip_smoke.py``'s phase 5b.

The test marked ``cuda`` needs the card and skips elsewhere; the file
imports without JAX there (the tests against the JAX package skip).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

ROOT = Path(__file__).resolve().parent.parent
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    # The JAX package's harness lives in the root ``benchmarks`` package.
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmarks import common as j_common
    from benchmarks import paper_tables as j_tables
    from repro.core import memory_model as j_mm
    from repro.core import power_model as j_pm
    from repro.data import har as j_har
    from repro.engine import fleet as j_fleet
    from repro.engine import stream as j_stream

from repro_torch import engine as t_engine  # noqa: E402
from repro_torch.benchmarks import common as t_common  # noqa: E402
from repro_torch.benchmarks import paper_tables as t_tables  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402
from repro_torch.core import memory_model as t_mm  # noqa: E402
from repro_torch.core import power_model as t_pm  # noqa: E402
from repro_torch.data import har as t_har  # noqa: E402
from repro_torch.engine import stream as t_stream  # noqa: E402

N_TRIAL = 32  # narrow, and wide enough that the auto ladder prunes
PERIODS = (0.5, 1.0, 5.0, 10.0, 60.0)
QUERY_RATES = (0.0, 0.05, 0.443, 0.5, 0.9, 1.0)


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs the JAX package (the reference)")


# ---------------------------------------------------------------------------
# Memory and power models: the port's copies equal the reference exactly.
# The nine checks of tests/test_models_analytic.py, on the port's models,
# each also held equal to the JAX package's value.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("jax_ref")
def test_table1_exact():
    got, want = t_mm.table1(), j_mm.table1()
    assert got == want
    assert t_mm.PAPER_TABLE1 == j_mm.PAPER_TABLE1
    for variant in ("noodl", "base", "hash"):
        np.testing.assert_allclose(got[variant], t_mm.PAPER_TABLE1[variant], atol=0.005, rtol=0)
    for n, m, hidden in ((24, 4, (8, 16)), (561, 6, (100, 384))):
        assert t_mm.table1(n, m, hidden) == j_mm.table1(n, m, hidden)


@pytest.mark.usefixtures("jax_ref")
def test_table2_param_counts():
    assert t_mm.PAPER_TABLE2 == j_mm.PAPER_TABLE2
    for n_hidden in (16, 32, 64, 128, 256, 512):
        s = t_mm.CoreShape(N=n_hidden)
        assert t_mm.odl_param_count(s) == j_mm.odl_param_count(j_mm.CoreShape(N=n_hidden))
    for n_hidden, expect in t_mm.PAPER_TABLE2.items():
        got = t_mm.odl_param_count(t_mm.CoreShape(N=n_hidden))
        assert abs(got - expect) / expect < 0.02


@pytest.mark.usefixtures("jax_ref")
def test_odlhash_smaller_than_noodl_for_small_N():
    for n_hidden in (32, 64, 128, 256, 512):
        s, js = t_mm.CoreShape(N=n_hidden), j_mm.CoreShape(N=n_hidden)
        for fn in ("noodl_bytes", "odlbase_bytes", "odlhash_bytes"):
            assert getattr(t_mm, fn)(s) == getattr(j_mm, fn)(js), (fn, n_hidden)
        for variant in ("noodl", "base", "hash"):
            assert t_mm.memory_kb(variant, s) == j_mm.memory_kb(variant, js)
        assert (t_mm.odlhash_bytes(s) < t_mm.noodl_bytes(s)) == (n_hidden <= 256)
    assert t_mm.BYTES_PER_WORD == j_mm.BYTES_PER_WORD


@pytest.mark.usefixtures("jax_ref")
def test_memory_ratio_128_to_256():
    r = t_mm.odlhash_bytes(t_mm.CoreShape(N=256)) / t_mm.odlhash_bytes(t_mm.CoreShape(N=128))
    want = j_mm.odlhash_bytes(j_mm.CoreShape(N=256)) / j_mm.odlhash_bytes(j_mm.CoreShape(N=128))
    assert r == want
    assert abs(r - 3.91) < 0.01


@pytest.mark.usefixtures("jax_ref")
def test_table4_times_reproduced_by_cycle_model():
    for name in ("FREQ_HZ", "T_PRED_MS", "T_TRAIN_MS", "P_PRED_MW", "P_TRAIN_MW", "P_IDLE_MW",
                 "P_SLEEP_MW", "BLE_RATE_BPS", "BLE_SUPPLY_V", "BLE_TX_CURRENT_A",
                 "QUERY_BYTES_UP", "QUERY_BYTES_DOWN", "E_COMM_UJ", "T_COMM_MS",
                 "PAPER_AUTO_COMM_VOLUME", "PAPER_AUTO_REDUCTION", "PAPER_TABLE4"):
        assert getattr(t_pm, name) == getattr(j_pm, name), name
    for n_hidden in (64, 128, 256):
        s, js = t_mm.CoreShape(N=n_hidden), j_mm.CoreShape(N=n_hidden)
        assert t_pm.predict_time_ms(s) == j_pm.predict_time_ms(js)
        assert t_pm.train_time_ms(s) == j_pm.train_time_ms(js)
        assert t_pm.proj_ops(s) == j_pm.proj_ops(js)
        assert t_pm.rls_ops(s) == j_pm.rls_ops(js)
        assert t_pm.predict_time_ms(s, 20e6) == j_pm.predict_time_ms(js, 20e6)
    s = t_mm.CoreShape()
    assert abs(t_pm.predict_time_ms(s) - t_pm.T_PRED_MS) < 1e-6
    assert abs(t_pm.train_time_ms(s) - t_pm.T_TRAIN_MS) < 1e-6
    t64 = t_pm.train_time_ms(t_mm.CoreShape(N=64))
    t256 = t_pm.train_time_ms(t_mm.CoreShape(N=256))
    assert t64 < t_pm.T_TRAIN_MS < t256


@pytest.mark.usefixtures("jax_ref")
def test_per_second_operation_feasible():
    s = t_mm.CoreShape()
    assert t_pm.train_time_ms(s) + t_pm.predict_time_ms(s) < 1000
    assert t_pm._cpm_proj() == j_pm._cpm_proj() and t_pm._cpm_rls() == j_pm._cpm_rls()


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("period,expect", sorted(t_pm.PAPER_AUTO_REDUCTION.items()))
def test_fig4_auto_power_reduction(period, expect):
    got = t_pm.power_reduction_pct(t_pm.PAPER_AUTO_COMM_VOLUME, period)
    assert got == j_pm.power_reduction_pct(j_pm.PAPER_AUTO_COMM_VOLUME, period)
    assert abs(got - expect) < 0.5, f"period {period}s: {got:.1f}% vs paper {expect}%"


@pytest.mark.usefixtures("jax_ref")
def test_power_monotone_in_query_rate():
    for period in PERIODS:
        for q in QUERY_RATES:
            assert t_pm.avg_power_mw(q, period) == j_pm.avg_power_mw(q, period), (q, period)
            assert t_pm.power_reduction_pct(q, period) == j_pm.power_reduction_pct(q, period)
            got, want = t_pm.event_energy_uj(q, period), j_pm.event_energy_uj(q, period)
            assert (got.predict, got.train, got.comm, got.sleep, got.total) == (
                want.predict, want.train, want.comm, want.sleep, want.total)
        s = t_mm.CoreShape(N=256)
        assert t_pm.avg_power_mw(0.3, period, s) == j_pm.avg_power_mw(
            0.3, period, j_mm.CoreShape(N=256))
    ps = [t_pm.avg_power_mw(q, 1.0) for q in (0.0, 0.25, 0.5, 0.75, 1.0)]
    assert all(a < b for a, b in zip(ps, ps[1:]))


@pytest.mark.usefixtures("jax_ref")
def test_raw_ble_energy_is_much_smaller_than_calibrated():
    assert t_pm.raw_ble_energy_uj() == j_pm.raw_ble_energy_uj()
    assert t_pm.raw_ble_energy_uj() < 0.1 * t_pm.E_COMM_UJ


# ---------------------------------------------------------------------------
# The table harness: analytic rows exact; the drift tables' rows from the
# same trials (a stub of drift_trial in both packages) exact.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("table", ["table1_memory", "table4_core"])
def test_analytic_table_rows_equal_reference(table, capsys):
    got = getattr(t_tables, table)()
    printed = capsys.readouterr().out
    want = getattr(j_tables, table)()
    assert got == want
    assert [type(v) for _, v, _ in got] == [type(v) for _, v, _ in want]
    assert printed == capsys.readouterr().out and "paper" in printed


def _stub_trial(calls):
    """A deterministic stand-in of ``drift_trial``: values from the
    arguments, every call recorded."""

    def trial(run_seed, theta, n_hidden=128, variant="hash", dataset_seed=0, device=None):
        calls.append((run_seed, theta, n_hidden, variant))
        t = 0.5 if theta == "auto" else float(theta)
        base = 0.9 + 0.001 * run_seed + (0.01 if variant == "base" else 0.0) + n_hidden / 1e4
        return dict(before=base, after=base - 0.02 * (1 - t), noodl_after=base - 0.1,
                    comm=t * (0.95 + 0.01 * run_seed), queries=0, skips=0)

    return trial


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("table,trials", [("table2_params", 2), ("table3_drift", 2),
                                          ("fig3_pruning", 2), ("fig4_power", 3)])
def test_drift_table_rows_equal_reference_for_the_same_trials(table, trials, monkeypatch):
    """Row names, values, derived strings and trial calls equal: Fig 4's mW
    equal the reference's for the same comm volumes."""
    t_calls, j_calls = [], []
    monkeypatch.setattr(t_common, "drift_trial", _stub_trial(t_calls))
    monkeypatch.setattr(j_common, "drift_trial", _stub_trial(j_calls))
    got = getattr(t_tables, table)(trials=trials, device="cpu")
    want = getattr(j_tables, table)(trials=trials)
    assert got == want
    assert t_calls == j_calls and len(t_calls) > 0
    assert t_tables.PAPER_TABLE3 == j_tables.PAPER_TABLE3


@pytest.mark.usefixtures("jax_ref")
def test_run_skip_drift_rows_are_the_reference_paper_rows(capsys):
    rows = t_run.main(["--skip-drift"])
    capsys.readouterr()
    assert rows == j_tables.table1_memory() + j_tables.table4_core()


def test_run_default_device_is_the_card(monkeypatch):
    """Without ``--device`` the drift tables go to CUDA, never to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_run.main(["--trials", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_common.drift_trial(0, 1.0, n_hidden=N_TRIAL)


# ---------------------------------------------------------------------------
# Drift ticks: byte-identical.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def splits():
    return t_har.generate(seed=0)


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("n_streams,calm,severities,seed", [
    (1, 0, None, 0),
    (1, 400, [2.0], 0),
    (3, 0, None, 1),
    (3, 50, [1.2, 2.0, 2.6], 2),
])
def test_drift_tick_stream_is_byte_identical(splits, n_streams, calm, severities, seed):
    jsplits = j_har.generate(seed=0)
    t_ticks, t_labels = t_har.drift_tick_stream(splits, n_streams=n_streams, seed=seed,
                                                calm=calm, severities=severities)
    j_ticks, j_labels = j_har.drift_tick_stream(jsplits, n_streams=n_streams, seed=seed,
                                                calm=calm, severities=severities)
    assert t_labels.dtype == j_labels.dtype and t_labels.shape == j_labels.shape
    assert t_labels.tobytes() == j_labels.tobytes()
    got, want = list(t_ticks), list(j_ticks)
    assert len(got) == len(want) == len(t_labels)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (n_streams, 561)
        assert a.tobytes() == b.tobytes()


def test_drift_tick_stream_rejects_bad_arguments(splits):
    with pytest.raises(ValueError, match="severities"):
        t_har.drift_tick_stream(splits, n_streams=2, severities=[1.0])
    with pytest.raises(ValueError, match="calm prefix"):
        t_har.drift_tick_stream(splits, calm=len(splits.test0_x) + 1)


# ---------------------------------------------------------------------------
# The §3 drift protocol against the JAX package's.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("jax_ref")
@pytest.mark.parametrize("variant", ["hash", "base"])
@pytest.mark.parametrize("theta", [1.0, 0.32, "auto"])
def test_drift_trial_matches_reference(variant, theta):
    got = t_common.drift_trial(0, theta, n_hidden=N_TRIAL, variant=variant, device="cpu")
    want = j_common.drift_trial(0, theta, n_hidden=N_TRIAL, variant=variant)
    assert set(got) == set(want)
    for key in ("before", "noodl_after"):  # the boot and the readout, no long run
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    assert abs(got["after"] - want["after"]) <= 0.01, (got["after"], want["after"])
    assert abs(got["comm"] - want["comm"]) <= 0.02, (got["comm"], want["comm"])
    # The port's accounting: every tick of the retraining stream either
    # queried or was pruned, and comm is queries over ticks.
    n_ticks = len(j_har.odl_split(j_har.generate(seed=0), 0.6, 0)[0])
    assert got["queries"] + got["skips"] == n_ticks
    assert got["comm"] == pytest.approx(got["queries"] / n_ticks, abs=1e-7)
    if theta == 1.0:
        assert got["queries"] == n_ticks and got["comm"] == 1.0


def test_boot_core_on_the_named_device(splits):
    cfg, core = t_common.boot_core(splits, 3, "auto", n_hidden=16, variant="base", device="cpu")
    assert cfg.elm.seed == 80 and cfg.elm.variant == "base" and cfg.prune.min_trained == 288
    assert core.elm.P.device.type == "cpu" and core.elm.P.shape == (16, 16)
    assert int(core.elm.count) == len(splits.train_x)
    cfg, _ = t_common.boot_core(splits, 0, 0.5, n_hidden=16, device="cpu")
    assert cfg.prune.ladder == (0.5,)
    assert t_common.mean_std([{"a": 1.0}, {"a": 3.0}], "a") == (2.0, 1.0)


# ---------------------------------------------------------------------------
# The stats keys of the runner caches.
# ---------------------------------------------------------------------------


@pytest.mark.usefixtures("jax_ref")
def test_cache_stats_keys_match_reference():
    assert set(t_stream.cache_stats()) == set(j_stream.cache_stats())
    assert set(t_engine.runner_cache_info()) == set(j_fleet.runner_cache_info())
    # The chunk runner's entry is its LRU's own counters, and its bound is
    # the reference's.
    info = t_engine.fleet._chunk_runner.cache_info()
    assert t_engine.runner_cache_info()["chunk_runner"] == {
        "hits": info.hits, "misses": info.misses, "size": info.currsize,
        "maxsize": info.maxsize}
    assert info.maxsize == j_fleet.runner_cache_info()["chunk_runner"]["maxsize"] == 32
    assert set(t_stream.StreamStats().summary()["caches"]) == set(
        j_stream.StreamStats().summary()["caches"])


# ---------------------------------------------------------------------------
# On the card: ODLBase's alpha inside graphed stream ticks.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_base_hidden_inside_graphed_stream_equals_cpu(cuda_device):
    """An ODLBase session on the card builds alpha before its graphs are
    captured, replays them, and ends as the CPU session does (decisions
    equal, floats within the long-run tolerance)."""
    from repro_torch.core import oselm
    from repro_torch.engine import graphs

    elm = oselm.OSELMConfig(n_in=561, n_hidden=64, n_out=6, variant="base", seed=91)
    cfg = t_engine.EngineConfig(elm=elm)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((12, 4, 561)).astype(np.float32) * 0.3
    ys = rng.integers(0, 6, (12, 4)).astype(np.int32)
    oselm._ALPHAS.clear()
    res = {}
    for dev in ("cpu", cuda_device):
        teacher = t_stream.LatencyTeacher(t_stream.array_labels(ys), latency=1, seed=3)
        before = dict(graphs.replay_counts)
        res[str(dev)] = t_stream.run(t_engine.init_fleet(cfg, 4, device=dev), iter(xs), cfg,
                                     teacher, mode="train_phase")
        replays = sum(graphs.replay_counts.values()) - sum(before.values())
        assert (replays > 0) == (dev != "cpu")
    cuda_alpha = oselm.make_alpha(elm, cuda_device)
    assert cuda_alpha.device.type == "cuda"
    assert torch.equal(cuda_alpha.cpu(), oselm.make_alpha(elm, "cpu"))
    (st_c, out_c, stats_c), (st_g, out_g, stats_g) = res["cpu"], res[str(cuda_device)]
    np.testing.assert_array_equal(out_g.queried, out_c.queried)
    np.testing.assert_array_equal(out_g.pred, out_c.pred)
    assert stats_g.labels_applied == stats_c.labels_applied
    np.testing.assert_allclose(st_g.elm.beta.cpu().numpy(), st_c.elm.beta.numpy(),
                               rtol=2e-3, atol=2e-3)
    x = torch.as_tensor(xs[0], device=cuda_device)
    np.testing.assert_allclose(oselm.hidden(x, elm).cpu().numpy(),
                               oselm.hidden(x.cpu(), elm).numpy(), atol=1e-5)


@pytest.mark.cuda
def test_cuda_alpha_first_built_inside_a_capture_raises(cuda_device):
    from repro_torch.core import oselm

    elm = oselm.OSELMConfig(n_in=24, n_hidden=16, variant="base", seed=12345)
    oselm._ALPHAS.clear()
    g = torch.cuda.CUDAGraph()
    x = torch.ones(2, 24, device=cuda_device)
    with pytest.raises(RuntimeError, match="inside a CUDA-graph capture"):
        with torch.cuda.graph(g):
            oselm.hidden(x, elm)
