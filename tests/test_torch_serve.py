"""The port's serving path (``repro_torch.models.model`` serve half,
``repro_torch.launch.serve``, ``repro_torch.examples.serve_cascade``).

The head on backbone features, against the JAX package: one tick at a time
with the reference state fed in at every tick (ROADMAP), the port's
``gate`` — ``serve_step``'s head — fed the JAX package's decode features
gives exactly the JAX package's ``queried`` mask, predictions, drift
leaves, ladder and meter, confidence and theta within 1e-5; and
``serve_apply_labels`` gives beta within 2e-4 and P within 2e-5 in units of
its start I/ridge (``P * ridge``), as the sharding tests hold P.
``serve_step`` itself on the JAX package's params and prefill state gives
the reference's logits within the bf16 stack bounds of
``tests/test_torch_models.py``.

The serve CLI on the CPU at smoke width (``device="cpu"``, 16 tokens): two
tenants under each backpressure policy, the rpc teacher, a resumed run
against the uninterrupted one (every stream counter equal), ``--migrate``
and ``--mesh-fleet 4`` on a CPU mesh all reconcile; ``main`` parses every
flag of the reference's ``main``.  The serve cascade example runs.

Tests marked ``cuda`` run on the card and skip elsewhere:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_serve.py
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert, engine  # noqa: E402
from repro_torch.engine import stream  # noqa: E402
from repro_torch.examples import serve_cascade  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ARCH = "qwen3-4b"
TOKENS = 16


def _jax():
    return pytest.importorskip("jax")


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The head on backbone features, against the JAX package
# ---------------------------------------------------------------------------


def test_serve_head_on_backbone_features_against_the_reference():
    jax = _jax()
    import jax.numpy as jnp
    from repro import configs as j_configs
    from repro.models import model as j_model

    from test_torch_models import numpy_params

    j_cfg = j_configs.get_config(ARCH, "smoke")
    cfg = configs.get_config(ARCH, "smoke")
    tree = numpy_params(j_model.build_schema(j_cfg), j_model.layers._iter_leaves, seed=4)
    j_params = jax.tree.map(jnp.asarray, tree)
    params = convert.lm_params_from_numpy(tree, cfg, CPU)
    b, ticks = 6, 12
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, (b, 8)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab_size, (ticks, b, 1)).astype(np.int32)
    _, j_state = j_model.prefill(j_params, jnp.asarray(prompt), j_cfg, max_len=8 + ticks)
    j_step = jax.jit(lambda p, st, t: j_model.serve_step(p, st, t, j_cfg))
    j_apply = jax.jit(lambda st, c, l, m: j_model.serve_apply_labels(st, c, l, m, j_cfg))
    ecfg = model_lib.core_config(cfg)

    # serve_step itself, on the reference's params and prefill state.
    st = convert.serve_state_from_numpy(j_state, CPU)
    logits, _, _ = model_lib.serve_step(params, st, torch.as_tensor(feed[0]), cfg)
    j_logits, _, _ = j_step(j_params, j_state, jnp.asarray(feed[0]))
    # The logits bounds of tests/test_torch_models.py (Frobenius, and the
    # worst difference against the logits' largest magnitude).
    a, g = np.asarray(j_logits, np.float32), logits.float().numpy()
    assert np.linalg.norm(a - g) / np.linalg.norm(a) < 3e-2
    assert np.abs(a - g).max() / np.abs(a).max() < 0.1

    for t in range(ticks):
        # The reference's features and gate, then the port's gate on them,
        # from the reference's state.
        j_logits, j_next, j_out = j_step(j_params, j_state, jnp.asarray(feed[t]))
        feats = np.asarray(j_out.feats)  # the decode's last hidden state, f32
        assert feats.shape == (b, cfg.d_model) and feats.dtype == np.float32
        odl = convert.engine_state_from_numpy(convert.engine_state_to_numpy(j_state.odl), CPU)
        new_odl, out = engine.gate(odl, torch.as_tensor(feats), ecfg)
        for f in ("queried", "pred", "drift_active"):
            np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(j_out, f)),
                                          err_msg=f"tick {t}: {f}")
        for f in ("confidence", "theta", "outputs", "h"):
            np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(j_out, f)),
                                       atol=1e-5, rtol=1e-5, err_msg=f"tick {t}: {f}")
        want = convert.engine_state_to_numpy(j_next.odl)
        got = convert.engine_state_to_numpy(new_odl)
        for leaf in want:
            if leaf.startswith(("prune.", "meter.")) or leaf in ("drift.steps", "drift.hits",
                                                                 "drift.calm", "drift.active"):
                np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=f"tick {t}: {leaf}")
            else:
                np.testing.assert_allclose(got[leaf], want[leaf], atol=1e-5, rtol=1e-5,
                                           err_msg=f"tick {t}: {leaf}")

        # The teacher answers part of the queried streams; labels applied
        # against the gate's context in both packages.
        labels = rng.integers(0, cfg.odl.n_out, b).astype(np.int32)
        mask = np.asarray(j_out.queried) & (rng.uniform(size=b) < 0.8)
        j_applied = j_apply(j_next, j_out, jnp.asarray(labels), jnp.asarray(mask))
        port_next = model_lib.ServeState(caches=None, pos=None, odl=new_odl)
        applied = model_lib.serve_apply_labels(port_next, out, torch.as_tensor(labels),
                                               torch.as_tensor(mask), cfg)
        want = convert.engine_state_to_numpy(j_applied.odl)
        got = convert.engine_state_to_numpy(applied.odl)
        np.testing.assert_allclose(got["elm.beta"], want["elm.beta"], atol=2e-4, rtol=0)
        np.testing.assert_allclose(got["elm.P"] * ecfg.elm.ridge, want["elm.P"] * ecfg.elm.ridge,
                                   atol=2e-5, rtol=0)
        for leaf in ("elm.count", "prune.level", "prune.streak", "prune.queries", "prune.skips"):
            np.testing.assert_array_equal(got[leaf], want[leaf], err_msg=f"tick {t}: {leaf}")
        j_state = j_applied


# ---------------------------------------------------------------------------
# The serve CLI on the CPU
# ---------------------------------------------------------------------------


def _serve(**kw):
    kw = dict(dict(batch=4, gen_tokens=TOKENS, device=CPU), **kw)
    return serve_lib.serve(ARCH, "smoke", **kw)


def _stream_counters(path):
    """Every odl_stream_* counter of a --metrics-json run, by tenant."""
    doc = json.loads(Path(path).read_text())
    assert doc["report"]["identity_ok"]
    out = {}
    for name, rows in doc["registry"]["counters"].items():
        if name.startswith("odl_stream_"):
            for row in rows:
                out[(name, json.dumps(row["labels"], sort_keys=True))] = row["value"]
    return out


@pytest.mark.parametrize("policy", stream.BACKPRESSURE_POLICIES)
def test_two_tenants_reconcile_under_each_policy(policy, tmp_path, capsys):
    queries, skips = _serve(tenants=2, backpressure=policy, pending_capacity=2,
                            teacher_latency=2, teacher_jitter=2, teacher_loss=0.1,
                            metrics_json=str(tmp_path / "m.json"))
    assert queries + skips == 2 * TOKENS * 4
    counters = _stream_counters(tmp_path / "m.json")
    assert {json.loads(k)["tenant"] for _, k in counters} == {"tenant0", "tenant1"}
    out = capsys.readouterr().out
    assert out.count("accounting ok") == 2 and "BROKEN" not in out


def test_rpc_teacher_reconciles(capsys):
    queries, skips = _serve(tenants=2, teacher="rpc")
    assert queries + skips == 2 * TOKENS * 4
    out = capsys.readouterr().out
    assert "label server:" in out and out.count("accounting ok") == 2


def test_resume_equals_the_uninterrupted_run(tmp_path, monkeypatch):
    """Snapshots every 4 ticks; a run stopped after 10 ticks resumes from
    its tick-8 snapshot, each tenant replaying the decode to that cursor,
    and ends with every stream counter of the uninterrupted 16-tick run."""
    kw = dict(tenants=2, teacher_latency=2, teacher_jitter=1, teacher_loss=0.1,
              pending_capacity=3)
    _serve(metrics_json=str(tmp_path / "whole.json"), **kw)
    snaps = str(tmp_path / "snaps")
    _serve(gen_tokens=10, snapshot_dir=snaps, snapshot_every=4, **kw)
    decodes = []
    real = serve_lib._decode_feats

    def counted(*a):
        decodes.append(a[-1])
        return real(*a)

    monkeypatch.setattr(serve_lib, "_decode_feats", counted)
    _serve(snapshot_dir=snaps, snapshot_every=4, resume=True,
           metrics_json=str(tmp_path / "resumed.json"), **kw)
    # The shared decode, then one replay per resumed tenant.
    assert len(decodes) == 3
    assert _stream_counters(tmp_path / "resumed.json") == _stream_counters(tmp_path / "whole.json")


def test_migrate_reconciles(capsys):
    queries, skips = _serve(tenants=2, migrate=True, teacher_latency=2)
    assert queries + skips == 2 * TOKENS * 4
    out = capsys.readouterr().out
    assert "tenant0 migrated at tick" in out and out.count("accounting ok") == 2


def test_mesh_fleet_on_a_cpu_mesh_reconciles_per_shard(capsys):
    queries, skips = _serve(batch=6, mesh_fleet=4, teacher_latency=1)
    assert queries + skips == TOKENS * 6
    out = capsys.readouterr().out
    assert out.count("accounting ok") == 4 and "mesh aggregate: 4 shard(s)" in out
    assert "padded 2 dead rows" in out


def _reference_flags():
    src = (ROOT / "src/repro/launch/serve.py").read_text()
    main = src[src.index("def main(argv=None):"):]
    return re.findall(r'ap\.add_argument\(\s*"(--[a-z0-9-]+)"', main)


def test_main_parses_every_flag_of_the_reference(monkeypatch):
    flags = _reference_flags()
    assert len(flags) >= 30
    values = {"--arch": "h2o-danube-1.8b", "--variant": "smoke", "--backpressure": "coalesce",
              "--sched": "drr", "--fuse-cohorts": "off", "--teacher": "rpc",
              "--fleet-ticks": "decode", "--teacher-secret": "s", "--snapshot-dir": "/x",
              "--metrics-json": "/y", "--teacher-loss": "0.5", "--rpc-timeout": "2.5",
              "--teacher-batch-window": "3", "--fleet-tick-sleep": "2"}
    store_true = {"--teacher-compress", "--resume", "--migrate", "--no-fleet-migrate",
                  "--no-fleet-drain"}
    argv = []
    for f in flags:
        argv += [f] if f in store_true else [f, values.get(f, "3")]
    calls = {}
    monkeypatch.setattr(serve_lib, "serve", lambda *a, **k: calls.setdefault("serve", (a, k)))
    monkeypatch.setattr(serve_lib, "serve_fleet", lambda **k: calls.setdefault("fleet", k))
    serve_lib.main(argv + ["--workers", "0", "--device", CPU])
    args, kw = calls["serve"]
    assert args == ("h2o-danube-1.8b", "smoke")
    assert kw["backpressure"] == "coalesce" and kw["sched"] == "drr" and kw["resume"]
    assert kw["fuse_cohorts"] is False and kw["teacher_batch_window_s"] == 3e-3
    assert kw["teacher_compress"] and kw["migrate"] and kw["device"] == CPU
    serve_lib.main(argv + ["--device", CPU])  # --workers 3 from the flag sweep
    assert calls["fleet"]["workers"] == 3 and calls["fleet"]["fleet_ticks"] == "decode"
    assert calls["fleet"]["migrate"] is False and calls["fleet"]["drain"] is False


def test_serve_cascade_example_runs(capsys):
    serve_cascade.main(["--device", CPU, "--ticks", "40", "--batch", "4"])
    out = capsys.readouterr().out
    assert "tick   40: teacher query fraction (last 20) =" in out
    assert "teacher traffic: first 20 ticks" in out


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_serve_on_the_card(cuda_device, capsys):
    """``launch.serve.serve`` at smoke width on the card (default device), two tenants:
    reconciles, and the decode replays bit for bit."""
    queries, skips = serve_lib.serve(ARCH, "smoke", batch=4, gen_tokens=TOKENS, tenants=2)
    assert queries + skips == 2 * TOKENS * 4
    cfg = configs.get_config(ARCH, "smoke")
    params, prompts, state = serve_lib.build_backbone(cfg, 4, 16, 128, 0, cuda_device)
    a = list(serve_lib._decode_feats(params, state, prompts, cfg, 8))
    b = list(serve_lib._decode_feats(params, state, prompts, cfg, 8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
