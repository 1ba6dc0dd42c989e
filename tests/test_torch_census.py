"""The port's step census (``launch/census.py``), the kernels' meta route
and costs (``kernels/ops``) and the exchange helper
(``distributed/sharding.exchange``) on the CPU.

* A smoke step's census (FLOPs, bytes, live peak) is the same on meta
  tensors and on CPU tensors, and with the process's caches cold and warm,
  for every arch's train, prefill and decode cells.
* A smoke dense decode step's FLOPs equal a count written out here from the
  config's dimensions; an entry point adds its ``kernel_cost`` once, with
  the aten-level counting paused inside it.
* ``cost_extrapolation`` equals the full-depth census at 4 layers (6 for
  the hybrid stack: two pattern groups).
* The EP block on a 2 x 4 mesh of CPU entries and the pipeline at the
  reference test's shapes: their exchanges equal the analytic count and
  bytes (forward, and backward for the EP block), 0 on one entry, and the
  block's output is bit for bit the one without a census.
* A meta tensor never reaches a kernel or a plain version, and counts no
  launch; a CUDA tensor never takes the meta route (``cuda`` marker).
* ``kernel_cost``: the plan's pass's bytes equal the bytes of its plain
  version's inputs and outputs in each mode; the projection's and the RLS
  update's formulas.
* ``ref.fused_elm_head_ref`` against the JAX package's at
  ``tests/test_kernels.py``'s shapes.
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro_torch import configs, engine  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.distributed import pipeline, sharding  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import census, dryrun  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import layers, moe, rglru  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

HAVE_JAX = importlib.util.find_spec("jax") is not None
SMALL = {"train": ShapeConfig("t", 16, 4, "train"),
         "prefill": ShapeConfig("p", 16, 4, "prefill"),
         "decode": ShapeConfig("d", 16, 4, "decode")}
PIPE = dict(n_stages=8, m=4, b=2, d=16)  # tests/test_multidevice.py's shapes


def _one(device):
    return mesh_lib.make_mesh((1, 1), ("data", "model"), [device])


def _census(cfg, shape, device, tcfg=TrainConfig()):
    args = None if device == "meta" else dryrun.materialize(cfg, shape, tcfg, False, device)
    return dryrun.census_cell(cfg, shape, _one(device), {}, tcfg, device=device, args=args)


# ---------------------------------------------------------------------------
# The census on meta and on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_census_is_the_same_on_meta_and_on_the_cpu(arch):
    """And the same with the process's caches cold (the first census after
    ``cache_clear``) and warm: a cache's fill is not counted."""
    cfg = configs.get_config(arch, "smoke")
    for kind, shape in SMALL.items():
        layers._rope_frequencies.cache_clear()
        rglru._const.cache_clear()
        cold = _census(cfg, shape, "meta")
        meta, cpu = _census(cfg, shape, "meta"), _census(cfg, shape, "cpu")
        for key in ("flops_total", "bytes_total", "temp_bytes", "new_output_bytes",
                    "kernel_calls", "collectives"):
            assert cold[key] == meta[key] == cpu[key], (kind, key)
        assert meta["flops_total"] > 0 and meta["temp_bytes"] > 0
        if kind == "train":  # two projections and one RLS update of the head
            assert meta["kernel_calls"] == {"xorshift_projection": 2, "oselm_rls_update": 1}


def test_dense_decode_flops_by_hand():
    """qwen3-4b smoke, one decode token at B streams against S cache slots:
    per layer the q/k/v projections, scores and values over every slot, the
    output projection and the SwiGLU's three products; the logits; the
    head's projection (``kernel_cost``) and the plan's pass (readout and
    feature mean)."""
    cfg = configs.get_config("qwen3-4b", "smoke")
    b, s = 4, 16
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                           cfg.d_ff, cfg.vocab_size)
    n, m = cfg.odl.n_hidden, cfg.odl.n_out
    per_layer = (2 * b * d * (h + 2 * kv) * hd  # q, k, v
                 + 2 * (2 * b * h * s * hd)  # scores, probs @ V
                 + 2 * b * h * hd * d  # out
                 + 3 * 2 * b * d * ff)  # SwiGLU
    want = cfg.n_layers * per_layer + 2 * b * d * v + 2 * b * d * n + (2 * b * n * m + 2 * b * d)
    got = _census(cfg, ShapeConfig("d", s, b, "decode"), "meta")
    assert got["flops_total"] == want
    assert got["kernel_calls"] == {"xorshift_projection": 1, "plan_rows": 1}


def test_an_entry_point_adds_its_cost_once():
    x = torch.randn(6, 40)
    with census.StepCensus() as c:
        h = ops.xorshift_projection(x, 7, 16)
    flops, nbytes = ops.kernel_cost("xorshift_projection", (6, 40, 16))
    assert (c.flops, c.bytes_accessed) == (flops, nbytes) and c.aten_flops == 0
    assert c.kernel_calls == {"xorshift_projection": 1}
    assert c.peak_live_bytes == h.untyped_storage().nbytes() >= h.numel() * 4
    with pytest.raises(RuntimeError, match="do not nest"), c, census.StepCensus():
        pass


@pytest.mark.parametrize("arch,depth", [("qwen3-4b", 4), ("mamba2-780m", 4),
                                        ("recurrentgemma-9b", 6), ("whisper-small", 4)])
def test_cost_extrapolation_equals_the_full_depth_census(arch, depth):
    base = configs.get_config(arch, "smoke")
    cfg = base.replace(n_layers=depth, **({"n_enc_layers": depth} if base.enc_dec else {}))
    mesh = mesh_lib.make_dev_mesh(2, 4, devices=["meta"] * 8)
    for shape in SMALL.values():
        shape = ShapeConfig(shape.name, shape.seq_len, 8, shape.kind)
        ext = dryrun.cost_extrapolation(cfg, shape, mesh, {}, "float32")
        full = dryrun.census_cell(cfg, shape, mesh, {}, TrainConfig())
        assert ext["flops"] == full["flops_total"] / 8, shape.kind
        assert ext["bytes"] == full["bytes_total"] / 8, shape.kind
        assert ext["coll"] == 0


# ---------------------------------------------------------------------------
# Exchanges
# ---------------------------------------------------------------------------


def _ep_case(mesh_shape):
    cfg = configs.get_config("deepseek-moe-16b", "smoke")
    params = layers.init_params(moe.moe_schema(cfg), 3, "cpu", dtype=torch.float32)
    x = torch.randn(8, 32, cfg.d_model, generator=torch.Generator().manual_seed(4))
    d, m = mesh_shape
    return cfg, params, x, mesh_lib.make_dev_mesh(d, m, devices=["cpu"] * (d * m))


def test_ep_block_exchanges_equal_the_analytic_count():
    """2 x 4 mesh, 256 tokens in 8 token shards: each position receives the
    dispatch buffers of its model row's 3 other positions ((E/4, C, d)
    each), and sends back as many; backward, the same again."""
    cfg, p, x, mesh = _ep_case((2, 4))
    plain, _ = moe.moe_block_ep(x, p, cfg, mesh)
    xg = x.clone().requires_grad_()
    with census.StepCensus() as c:
        y, aux = moe.moe_block_ep(xg, p, cfg, mesh)
        fwd = census.collective_census(c)
        (y.sum() + aux).backward()
    assert torch.equal(y.detach(), plain)
    _, n_split, t_loc, cap = moe.ep_layout(256, cfg, mesh)
    assert n_split == 8
    block = (cfg.n_experts // 4) * cap * cfg.d_model * 4
    assert fwd == {"all-to-all": {"count": 2 * 8 * 3, "bytes": 2 * 8 * 3 * block},
                   "total_bytes": 2 * 8 * 3 * block}
    assert census.collective_census(c)["all-to-all"] == {"count": 96, "bytes": 96 * block}


def test_pipeline_hand_offs_equal_the_analytic_count():
    n, m, b, d = PIPE["n_stages"], PIPE["m"], PIPE["b"], PIPE["d"]
    rng = np.random.default_rng(0)
    h = torch.as_tensor(rng.standard_normal((m, b, d)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((n, d, d)) / np.sqrt(d)).astype(np.float32))
    mesh = mesh_lib.make_mesh((n,), ("stage",), ["cpu"] * n)
    with census.StepCensus() as c:
        got = pipeline.pipeline_forward(h, {"w": w}, lambda x, p: torch.tanh(x @ p["w"]), mesh)
    want = pipeline.sequential_reference(h, {"w": w}, lambda x, p: torch.tanh(x @ p["w"]), n)
    assert torch.allclose(got, want, atol=1e-6)
    ticks = n + m - 1
    assert census.collective_census(c) == {
        "collective-permute": {"count": ticks * (n - 1), "bytes": ticks * (n - 1) * b * d * 4},
        "total_bytes": ticks * (n - 1) * b * d * 4}


def test_no_exchange_on_one_entry():
    cfg, p, x, mesh = _ep_case((1, 1))
    one = mesh_lib.make_mesh((1,), ("stage",), ["cpu"])
    with census.StepCensus() as c:
        moe.moe_block_ep(x, p, cfg, mesh)
        pipeline.pipeline_forward(x[:2], {"w": torch.eye(cfg.d_model)[None]},
                                  lambda a, q: a @ q["w"], one)
    assert census.collective_census(c) == {"total_bytes": 0}
    # Without a census the helper is the plain move.
    t = torch.ones(3)
    assert sharding.exchange(t, (0,), (1,), mesh_lib.make_mesh((2,), ("stage",), ["cpu"] * 2)) is t


# ---------------------------------------------------------------------------
# The kernels' routes and costs
# ---------------------------------------------------------------------------


def _entry_calls(device):
    """Every entry point of ``ops`` once on ``device``: {name: outputs}."""
    ecfg = model_lib.core_config(configs.get_config("qwen3-4b", "smoke"))
    s, n_in = 5, ecfg.elm.n_in
    n, m = ecfg.elm.n_hidden, ecfg.elm.n_out
    gen = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.rand(*shape, generator=gen).to(device)

    st = engine.init_fleet(ecfg, s, device)
    x, h, beta = rand(s, n_in), rand(s, n), rand(s, n, m)
    P = torch.eye(n, device=device).expand(s, n, n).contiguous()
    H, Y = rand(s, 2, n), rand(s, 2, m)
    out = {
        "xorshift_projection": ops.xorshift_projection(x, 5, n),
        "readout": ops.readout(h, beta),
        "row_abs_mean": ops.row_abs_mean(x),
        "oselm_rls_update_fleet": ops.oselm_rls_update_fleet(P, beta, H, Y),
        "oselm_rls_update": ops.oselm_rls_update(P[0], beta[0], H[0], Y[0]),
    }
    for mode in ("algo1", "serve", "train_phase"):
        out[f"plan_rows/{mode}"] = ops.plan_rows(h, beta, x, st.elm.count, st.prune, st.drift,
                                                 st.meter, ecfg, mode)
    return out


def _shapes(tree):
    return [(tuple(t.shape), t.dtype) for t in dryrun._leaves(tree)]


def test_meta_tensors_reach_no_kernel_nor_plain_version(monkeypatch):
    want = {k: _shapes(v) for k, v in _entry_calls("cpu").items()}

    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a kernel or a plain version")

    for mod, names in ((ops._ref, ("xorshift_projection_ref", "readout_ref", "row_abs_mean_ref",
                                   "plan_rows_ref", "rls_update_ref")),
                       (ops._xorshift_proj, ("xorshift_projection",)),
                       (ops._plan_rows, ("plan_rows", "readout", "row_abs_mean")),
                       (ops._oselm_update, ("rls_single", "rls_fleet", "small_operands"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    before = dict(ops.launch_counts)
    got = _entry_calls("meta")
    assert ops.launch_counts == before
    for k, v in got.items():
        assert all(t.device.type == "meta" for t in dryrun._leaves(v)), k
        assert _shapes(v) == want[k], k


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_meta_route(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor took the meta route")

    monkeypatch.setattr(ops, "_meta", refuse)
    ops.reset_launch_counts()
    got = _entry_calls("cuda")
    assert all(t.device.type == "cuda" for v in got.values() for t in dryrun._leaves(v))
    assert all(ops.launch_counts[k] > 0 for k in ("xorshift_projection", "readout",
                                                  "row_abs_mean", "plan_rows"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "decode"])
def test_card_run_at_smoke_width(kind):
    """A smoke cell on a one-entry mesh of the card: the census on the card
    equal to the census on meta, the argument bytes as asked of the
    allocator, within 512 bytes a leaf of what it allocated."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    cfg = configs.get_config("qwen3-4b", "smoke")
    r = dryrun.card_run(cfg, SMALL[kind], TrainConfig(), kind == "decode")
    assert r["census_equal"], r["first_difference"]
    assert 0 <= r["allocated_bytes"] - r["argument_bytes"] <= 512 * r["n_leaves"]
    assert r["requested_bytes"] in (None, r["argument_bytes"])


@pytest.mark.parametrize("mode", ["algo1", "serve", "train_phase"])
def test_plan_rows_cost_is_its_plain_versions_bytes(mode):
    """The bytes ``chip_smoke.py``'s bound counted for the pass: h, beta,
    count and the state leaves in (x where the detector steps), the plan's
    seven fields, prune and meter out (drift where it steps)."""
    ecfg = model_lib.core_config(configs.get_config("qwen3-4b", "smoke"))
    s, n_in, n, m = 7, ecfg.elm.n_in, ecfg.elm.n_hidden, ecfg.elm.n_out
    st = engine.init_fleet(ecfg, s, "cpu")
    h, beta, x = torch.rand(s, n), torch.rand(s, n, m), torch.rand(s, n_in)
    r = ref.plan_rows_ref(h, beta, x, st.elm.count, st.prune, st.drift, st.meter, ecfg, mode)

    def nb(*trees):
        return sum(t.numel() * t.element_size() for t in dryrun._leaves(trees))

    reads_x = mode != "train_phase"
    reads = nb(h, beta, st.elm.count, st.prune, st.drift, st.meter) + (nb(x) if reads_x else 0)
    writes = nb(tuple(r[:7]), r.prune, r.meter) + (nb(r.drift) if reads_x else 0)
    flops, nbytes = ops.kernel_cost("plan_rows", (s, n, m, n_in), mode=mode)
    assert nbytes == reads + writes
    assert flops == 2 * s * n * m + (2 * s * n_in if reads_x else 0)


def test_projection_and_rls_costs():
    s, n_in, n = 32, 2560, 128
    assert ops.kernel_cost("xorshift_projection", (s, n_in, n)) == (
        2.0 * s * n_in * n, 4.0 * (s * n_in + s * n))
    s, n, k, m = 16384, 128, 1, 6
    want = (2.0 * s * n * n * (2 * k + m),
            4.0 * (2 * s * n * n + 2 * s * n * m + s * k * n + s * k * m))
    for name in ("oselm_rls_update_fleet", "oselm_rls_update", "rls_two_stage"):
        assert ops.kernel_cost(name, (s, n, k, m)) == want
    assert ops.kernel_cost("readout", (4, 8, 3)) == (2.0 * 96, 4.0 * (32 + 96 + 12))
    assert ops.kernel_cost("row_abs_mean", (4, 10)) == (80.0, 4.0 * 44)
    with pytest.raises(KeyError):
        ops.kernel_cost("nothing", (1,))


@pytest.mark.skipif(not HAVE_JAX, reason="needs jax (the reference)")
def test_fused_elm_head_ref_equals_the_references():
    """``tests/test_kernels.py::test_fused_head_composition``'s shapes and
    tolerances: the projection 1e-5, P' 2e-5, beta' 2e-4."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as j_ref

    n_in, n, m, k = 100, 64, 6, 4
    x = jax.random.normal(jax.random.PRNGKey(1), (k, n_in))
    f = jax.random.normal(jax.random.PRNGKey(2), (2 * n, n)) / np.sqrt(n)
    P = jnp.linalg.inv(f.T @ f + 0.1 * jnp.eye(n))
    beta = jnp.zeros((n, m))
    Y = jax.nn.one_hot(jnp.arange(k) % m, m)
    h_want, p_want, b_want = j_ref.fused_elm_head_ref(x, P, beta, Y, 5)
    h, p, b = ref.fused_elm_head_ref(*(torch.as_tensor(np.array(a)) for a in (x, P, beta, Y)),
                                     5)
    np.testing.assert_allclose(h.numpy(), h_want, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), p_want, atol=2e-5)
    np.testing.assert_allclose(b.numpy(), b_want, atol=2e-4)
