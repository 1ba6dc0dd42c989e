"""The MoE archs' serving path in the port: deepseek-moe-16b (GQA + MoE)
and deepseek-v2-236b (MLA latent cache + MoE) at smoke width through
``launch.serve`` (two tenants, ``--mesh-fleet 4`` on a CPU mesh, and
``--workers 2`` on decode ticks), the
graphed decode tick over any cache dict, the parameter and cache loaders
of ``convert``, and a deepseek-v2-236b ``decode`` tenant migrated between
two port workers on the CPU, bit for bit its solo run.

The training entry points build a state and a finite gradient for both archs.
Tests marked ``cuda`` run on the card and skip elsewhere: the card's decode
against the CPU's on the same weights, and two card decodes through
``_decode_feats`` (one CUDA graph a step) bit for bit, for both archs:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_moe_serve.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, convert  # noqa: E402
from repro_torch.engine import snapshot  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402
from repro_torch.runtime import worker as worker_mod  # noqa: E402

from test_torch_elastic import (  # noqa: E402
    _assert_state_trees_equal, _assert_stats_equal, _decode_solo, _spawn_cpu_worker,
    _wait_live_at)

CPU = "cpu"
MOE_ARCHS = ("deepseek-moe-16b", "deepseek-v2-236b")
TOKENS = 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_two_tenants_reconcile(arch, capsys):
    queries, skips = serve_lib.serve(arch, "smoke", batch=4, gen_tokens=TOKENS, tenants=2,
                                     teacher_latency=2, teacher_jitter=1, device=CPU)
    assert queries + skips == 2 * TOKENS * 4
    out = capsys.readouterr().out
    assert out.count("accounting ok") == 2 and "BROKEN" not in out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_mesh_fleet_on_a_cpu_mesh_reconciles_per_shard(arch, capsys):
    queries, skips = serve_lib.serve(arch, "smoke", batch=6, gen_tokens=TOKENS, mesh_fleet=4,
                                     teacher_latency=1, device=CPU)
    assert queries + skips == TOKENS * 6
    out = capsys.readouterr().out
    assert out.count("accounting ok") == 4 and "mesh aggregate: 4 shard(s)" in out


def test_elastic_fleet_on_decode_ticks_reconciles(capsys, monkeypatch):
    """``--workers 2 --fleet-ticks decode``: two CPU workers decoding
    deepseek-v2-236b (MLA caches), one of them drained, every tenant
    reconciled (a tenant that finished on the drained worker is counted
    from the drain, not waited for).  Whether the router catches tenant0
    mid-stream to move it depends on the workers' timing (the bit-for-bit
    migration of an MLA decode tenant is the test below).  The workers run
    one intra-op thread, as ``test_torch_elastic._spawn_cpu_worker``'s do."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    queries, skips = serve_lib.serve_fleet(workers=2, tenants=2, batch=4, gen_tokens=32,
                                           fleet_ticks="decode", arch="deepseek-v2-236b",
                                           device=CPU)
    assert queries + skips == 2 * 32 * 4
    out = capsys.readouterr().out
    assert "scale-in: drained w1" in out
    assert out.count("accounting ok") == 3 and "BROKEN" not in out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_feats_replay_and_follow_the_serve_step(arch):
    """``_decode_feats`` (the graphed tick on the card, eager here) over the
    arch's cache leaves: two calls from one prefill are bit for bit, the
    prefill's caches are left as they were, and each tick's features are
    ``decode_step``'s on the same greedy tokens."""
    cfg = configs.get_config(arch, "smoke")
    params, prompts, state = serve_lib.build_backbone(cfg, 3, 8, 32, 5, CPU)
    before = {k: v.clone() for k, v in state.caches["layers"].items()}
    a = list(serve_lib._decode_feats(params, state, prompts, cfg, 6))
    b = list(serve_lib._decode_feats(params, state, prompts, cfg, 6))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == 6
    assert all(torch.equal(before[k], state.caches["layers"][k]) for k in before)
    st = model_lib.ServeState(caches={"layers": {k: v.clone() for k, v in before.items()}},
                              pos=state.pos, odl=state.odl)
    token = prompts[:, -1:]
    for want in a:
        logits, feats, st = model_lib.decode_step(params, st, token, cfg)
        assert torch.equal(feats, want)
        token = torch.argmax(logits, -1)[:, None]


def test_convert_loads_expert_and_latent_leaves():
    """``lm_params_from_numpy`` walks the schema generically: the 3-D expert
    leaves, the shared experts and the MLA leaves load with their shapes
    and serving dtypes, and a misshapen expert leaf raises;
    ``serve_state_from_numpy`` keeps the latent cache leaves in bf16."""
    from test_torch_models import numpy_params

    cfg = configs.get_config("deepseek-v2-236b", "smoke")
    schema = model_lib.build_schema(cfg)
    tree = numpy_params(schema, layers._iter_leaves, 6)
    params = convert.lm_params_from_numpy(tree, cfg, CPU)
    moe_p, attn_p = params["layers"]["moe"], params["layers"]["attn"]
    assert moe_p["wg"].shape == (cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff_expert)
    assert moe_p["wg"].dtype == torch.bfloat16 and moe_p["router"].dtype == torch.bfloat16
    assert set(moe_p["shared"]) == {"wg", "wu", "wd"}
    assert attn_p["kv_a_norm"].dtype == torch.float32 and attn_p["wkv_b"].dtype == torch.bfloat16
    assert torch.equal(moe_p["wd"].float(), torch.as_tensor(tree["layers"]["moe"]["wd"])
                       .bfloat16().float())
    bad = dict(tree, layers=dict(tree["layers"], moe=dict(
        tree["layers"]["moe"], wu=tree["layers"]["moe"]["wu"][:, :-1])))
    with pytest.raises(ValueError, match="moe/wu"):
        convert.lm_params_from_numpy(bad, cfg, CPU)

    _, st = model_lib.prefill(params, torch.zeros((2, 5), dtype=torch.int64), cfg, max_len=9)
    host = model_lib.ServeState(
        caches={"layers": {k: v.float().numpy() for k, v in st.caches["layers"].items()}},
        pos=st.pos.numpy(), odl=st.odl)
    back = convert.serve_state_from_numpy(host, CPU)
    for k, v in st.caches["layers"].items():
        assert back.caches["layers"][k].dtype == torch.float32  # as given: the f32 host copy
        assert torch.equal(back.caches["layers"][k].bfloat16(), v)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_training_entry_points_build_a_state_and_a_finite_gradient(arch):
    """A TrainState builds (f32 master params, zero moments), and
    ``loss_and_grads`` gives a finite loss and a finite gradient for every
    leaf, the routed experts' and the router's among them; the trainers
    are held against the JAX package in ``tests/test_torch_train_moe.py``."""
    cfg = configs.get_config(arch, "smoke")
    state = model_lib.init_train_state(cfg, device=CPU)
    assert {t.dtype for t in adam.leaves(state.params)} == {torch.float32}
    assert not any(t.any() for t in adam.leaves(state.opt.m))
    batch = {"tokens": torch.zeros((2, 4), dtype=torch.int64),
             "labels": torch.zeros((2, 4), dtype=torch.int64)}
    loss, feats, grads = model_lib.loss_and_grads(state.params, batch, cfg)
    assert bool(torch.isfinite(loss)) and feats.shape == (2, cfg.d_model)
    for g in adam.leaves(grads):
        assert bool(torch.isfinite(g).all())
    assert grads["layers"]["moe"]["router"].any() and grads["layers"]["moe"]["wg"].any()


def test_mla_decode_tenant_migrates_between_port_workers():
    """A deepseek-v2-236b ``decode`` tenant (MLA latent caches) admitted on
    one CPU port worker, moved to another past tick 4, ends bit for bit as
    the in-process session fed by ``_decode_feats`` (state, counters,
    label latencies)."""
    t_total, cut = 16, 4
    odl_cfg = model_lib.core_config(configs.get_config("deepseek-v2-236b", "smoke"))
    spec = worker_mod.tenant_spec(
        "mla_decoder", odl_cfg, s=4, mode="serve", capacity=4, backpressure="drop_oldest",
        ticks=serve_lib.decode_ticks_spec("deepseek-v2-236b", "smoke", batch=4, seed=3,
                                          t_total=t_total, tick_sleep_ms=20.0),
        teacher=worker_mod.latency_teacher_spec(n_out=odl_cfg.elm.n_out, latency=2,
                                                jitter=1, seed=3),
    )
    workers = [_spawn_cpu_worker(f"mla{i}") for i in range(2)]
    try:
        w_a, w_b = workers
        w_a.admit(spec)
        _wait_live_at(w_a, ["mla_decoder"], cut)
        sent_spec, wire = w_a.extract("mla_decoder")
        moved_at = snapshot.ticks_consumed(snapshot.decode_snapshot(wire))
        assert cut <= moved_at < t_total
        assert w_b.admit(sent_spec, wire)["migrated"] is True
        elastic.Router([w_b]).wait_finished(["mla_decoder"], timeout_s=120)
        stats_wire, tree = w_b.result("mla_decoder")
    finally:
        for w in workers:
            w.close(shutdown=True)
    solo_state, solo_stats, _ = _decode_solo(spec, t_total)
    _assert_state_trees_equal(snapshot.state_to_tree(solo_state), tree["state"], "mla tenant")
    _assert_stats_equal(stats_wire, solo_stats, "mla tenant")
    assert stats_wire["stream_steps"] == t_total * spec["s"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_card_decode_matches_the_cpu_on_the_same_weights(arch, cuda_device):
    """The same weights (built on the CPU, copied to the card) at capacity
    factor E/k: each device's decode equals its own prefill within the
    reference's bounds, and the card's logits are the CPU's by token
    (``tests/test_torch_moe.py``'s row criterion: a near-tie routes either
    way on two devices as on two frameworks)."""
    from test_torch_moe import _rows_agree

    cfg = configs.get_config(arch, "smoke")
    cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    cpu_params = model_lib.build_params(cfg, seed=1, device=CPU)
    card_params = _to(cpu_params, cuda_device)
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (16, 16)))
    outs = {}
    for dev, p in ((CPU, cpu_params), (cuda_device, card_params)):
        t = toks.to(dev)
        _, st = model_lib.prefill(p, t[:, :15], cfg, max_len=32)
        logits, _, _ = model_lib.serve_step(p, st, t[:, 15:], cfg)
        h_all, _ = transformer.lm_hidden(p, t, cfg)
        full = transformer.lm_logits(p, h_all, cfg)[:, -1]
        np.testing.assert_allclose(logits.float().cpu().numpy(), full.float().cpu().numpy(),
                                   atol=0.15, rtol=0.05)
        outs[str(dev)] = logits
    _rows_agree(outs[str(cuda_device)], outs[CPU], f"{arch} card vs cpu logits", scaled=True)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_two_card_decodes_bit_for_bit(arch, cuda_device):
    """Two decodes of 8 tokens from one prefill on the card, each step one
    CUDA graph replay (``_decode_feats``): bit for bit; and ``dus`` on the
    MLA arch as well."""
    variants = [configs.get_config(arch, "smoke")]
    if variants[0].use_mla:
        variants.append(variants[0].replace(cache_update="dus"))
    for cfg in variants:
        params, prompts, state = serve_lib.build_backbone(cfg, 4, 16, 64, 0, cuda_device)
        a = list(serve_lib._decode_feats(params, state, prompts, cfg, 8))
        b = list(serve_lib._decode_feats(params, state, prompts, cfg, 8))
        assert all(torch.equal(x, y) for x, y in zip(a, b))
