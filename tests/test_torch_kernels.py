"""Parity of the port's two kernels with the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain PyTorch versions (``ref``);
they are held against the Pallas kernels run in interpret mode and against
the JAX oracles, at the tolerances of ``tests/test_kernels.py``.  The RLS
tests hold the port against the **Pallas numerics** (no symmetrisation of
P', beta' from P' @ W) — one of the three RLS numerics the JAX package has.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card; they skip where there is none.  They need no JAX, so the file
also runs on the card's machine, which has none (the tests against the JAX
package skip there):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_kernels.py
"""

import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

# Where JAX is installed the JAX package must import: a broken reference
# fails here and does not skip the parity tests.  Only a machine without JAX
# (the card's) runs the torch-only tests alone.
HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp
    from repro.core import oselm as j_oselm
    from repro.kernels import ref as j_ref
    from repro.kernels.oselm_update import (
        oselm_rls_update as j_rls,
        oselm_rls_update_fleet as j_rls_fleet,
    )
    from repro.kernels.xorshift_proj import xorshift_projection as j_proj

from repro_torch.core import xorshift as t_xorshift  # noqa: E402
from repro_torch.kernels import oselm_update, ops, ref, xorshift_proj  # noqa: E402

PROJ_SHAPES = [(8, 128, 128), (8, 256, 384), (3, 561, 128), (130, 100, 72), (1, 16, 16)]


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


def _x(b, n_in, seed):
    return np.random.default_rng(seed).standard_normal((b, n_in)).astype(np.float32)


@pytest.mark.parametrize("b,n_in,n_hidden", PROJ_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.usefixtures("jax_ref")
def test_projection_matches_pallas_and_oracle(b, n_in, n_hidden, dtype):
    x = _x(b, n_in, b * 7 + n_in)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = ops.xorshift_projection(tx, 0x2D2A, n_hidden).numpy()
    tol = 2e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, np.asarray(j_proj(jx, 0x2D2A, n_hidden, interpret=True)),
                               atol=tol)
    np.testing.assert_allclose(got, np.asarray(j_ref.xorshift_projection_ref(jx, 0x2D2A, n_hidden)),
                               atol=tol)


@pytest.mark.parametrize("activation", ["sigmoid", "relu", "identity"])
@pytest.mark.usefixtures("jax_ref")
def test_projection_activations_and_scale(activation):
    x = _x(5, 96, 1)
    got = ops.xorshift_projection(torch.as_tensor(x), 7, 64, scale=0.5, activation=activation)
    want = j_proj(jnp.asarray(x), 7, 64, scale=0.5, activation=activation, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.usefixtures("jax_ref")
def test_projection_tanh_matches_oselm_hidden():
    """The Pallas body has no tanh; the port's kernel and plain version do,
    held against ``repro.core.oselm.hidden`` (its jnp path)."""
    cfg = j_oselm.OSELMConfig(n_in=40, n_hidden=24, activation="tanh", seed=5)
    x = _x(6, 40, 2)
    want = np.asarray(j_oselm.hidden(jnp.asarray(x), cfg))
    got = ops.xorshift_projection(torch.as_tensor(x), 5, 24, activation="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_projection_leading_dims():
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((2, 5, 48)).astype(np.float32))
    got = ops.xorshift_projection(x, 5, 32)
    assert got.shape == (2, 5, 32)
    np.testing.assert_array_equal(got.reshape(10, 32).numpy(),
                                  ops.xorshift_projection(x.reshape(10, 48), 5, 32).numpy())


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round the f32 significand to 10 bits, ties away
    from zero (add half of the dropped range to the magnitude, then mask)."""
    bits = v.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_mask(v: torch.Tensor) -> torch.Tensor:
    """Round to TF32 by masking the low 13 mantissa bits: the kernel's high
    part (``tf32_hi``), and what the tensor cores read of an operand."""
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _is_tf32(v: torch.Tensor) -> bool:
    return bool(((v.view(torch.int32) & 0x1FFF) == 0).all())


def _mix16x2(x: np.ndarray) -> np.ndarray:
    """The projection kernel's two-wide counter hash (``mix16x2`` in
    ``csrc/xorshift_proj.cu``) on uint32 lanes holding two u16 values."""
    x = x.astype(np.uint32)
    for c in t_xorshift.MIX_CONSTANTS:
        x ^= (x << np.uint32(7)) & np.uint32(0xFF80FF80)
        x ^= (x >> np.uint32(9)) & np.uint32(0x007F007F)
        x ^= (x << np.uint32(8)) & np.uint32(0xFF00FF00)
        x = ((x & np.uint32(0xFFFF0000)) * np.uint32(c)) | ((x * np.uint32(c)) & np.uint32(0xFFFF))
    return x


def test_two_wide_hash_matches_mix16_on_every_u16():
    lo = np.arange(65536, dtype=np.uint32)
    hi = lo[::-1].copy()
    packed = _mix16x2(lo | (hi << np.uint32(16)))
    want = t_xorshift.mix16(torch.as_tensor(np.stack([lo, hi]).astype(np.int64))).numpy()
    np.testing.assert_array_equal(packed & 0xFFFF, want[0])
    np.testing.assert_array_equal(packed >> 16, want[1])


@pytest.mark.parametrize("source", ["u16_to_unit", "alpha_hash"])
@pytest.mark.parametrize("hi", [_tf32_mask, _tf32_rna], ids=["mask", "rna"])
def test_alpha_splits_exactly_into_two_tf32_parts(source, hi):
    """alpha = a_hi + a_lo exactly, both TF32, whether a_hi is rounded or
    masked: the projection kernel's a_hi * x + a_lo * x loses nothing of
    alpha."""
    if source == "u16_to_unit":
        alpha = t_xorshift.u16_to_unit(torch.arange(65536, dtype=torch.int64))
    else:
        alpha = t_xorshift.alpha_hash(0x2D2A, 561, 128, device="cpu").reshape(-1)
    a_hi = hi(alpha)
    a_lo = alpha - a_hi
    assert _is_tf32(a_hi) and _is_tf32(a_lo)
    assert torch.equal(a_hi.double() + a_lo.double(), alpha.double())


@pytest.mark.parametrize("b,n_in,n_hidden", [(256, 561, 128), (130, 100, 72)])
@pytest.mark.parametrize("activation", ["sigmoid", "identity"])
@pytest.mark.usefixtures("jax_ref")
def test_three_term_tf32_product_within_tolerance(b, n_in, n_hidden, activation):
    """The kernel's arithmetic, emulated in plain torch: x and alpha split
    into TF32 hi and lo parts, the tensor cores reading each operand with
    its low 13 mantissa bits masked, x_hi a_hi + x_hi a_lo + x_lo a_hi
    summed in f32; within 1e-5 of the JAX oracle."""
    x = torch.as_tensor(_x(b, n_in, 17))
    alpha = t_xorshift.alpha_hash(0x2D2A, n_in, n_hidden, device="cpu")
    x_hi = _tf32_mask(x)
    x_lo = _tf32_mask(x - x_hi)
    a_hi = _tf32_mask(alpha)
    a_lo = alpha - a_hi
    z = sum(_tf32_mask(u) @ _tf32_mask(v) for u, v in ((x_hi, a_hi), (x_hi, a_lo), (x_lo, a_hi)))
    got = ref.activate(z * float(np.float32(1.0 / np.sqrt(n_in))), activation)
    want = np.asarray(j_ref.xorshift_projection_ref(jnp.asarray(x.numpy()), 0x2D2A, n_hidden,
                                                     activation=activation))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _chip_smoke():
    """The card script's module (its shape lists), imported from the root."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def test_projection_plan_fits_every_card_shape():
    """``projection_plan`` at every shape ``chip_smoke.py`` holds the kernel
    at: the grid covers H, every block has at least one K group and the
    groups cover K, the split route stays within one wave and sizes its
    workspace as groups x B x N floats, and the order over K is n_in's."""
    for b, n_in, n in _chip_smoke().K1_SHAPES:
        plan = xorshift_proj.projection_plan(b, n_in, n)
        rows, cols, splits = plan.grid
        assert (rows, cols) == (-(-b // 128), -(-n // 128))
        assert (plan.group, plan.groups) == xorshift_proj.k_groups(n_in)
        assert plan.group * plan.groups >= -(-n_in // 32) > plan.group * (plan.groups - 1)
        assert splits * plan.groups_per_block >= plan.groups
        assert (splits - 1) * plan.groups_per_block < plan.groups
        if plan.split:
            assert rows * cols <= xorshift_proj.SPLIT_MAX_BLOCKS
            assert rows * cols * splits <= xorshift_proj.SMS
            assert plan.workspace_bytes == 4 * plan.groups * b * n
        else:
            assert splits == 1 and plan.groups_per_block == plan.groups
            assert plan.workspace_bytes == 0


@pytest.mark.parametrize("b,n_in,n_hidden", [(256, 2560, 128), (32, 2560, 128), (8, 5120, 128)])
def test_projection_plan_spreads_few_rows(b, n_in, n_hidden):
    """At the backbones' few rows the K range is split over 64 blocks or
    more, where the one-pass grid had one or two."""
    plan = xorshift_proj.projection_plan(b, n_in, n_hidden)
    assert plan.split and plan.grid[0] * plan.grid[1] * plan.grid[2] >= 64


def test_projection_plan_keeps_the_fleet_grid():
    """The fleet shape keeps its one wave of 128 blocks, each over all of K
    as one chain of tile sums, and needs no workspace."""
    assert xorshift_proj.projection_plan(16384, 561, 128) == xorshift_proj.ProjectionPlan(
        (128, 1, 1), 1, 18, 18, 0)
    # Forcing the split route at the fleet's shape is no split: one wave.
    assert not xorshift_proj.projection_plan(16384, 561, 128, split_max_blocks=10 ** 6).split


@pytest.mark.parametrize("b,n_in,n_hidden", [(256, 2560, 128), (8, 5120, 128), (1, 561, 128)])
@pytest.mark.usefixtures("jax_ref")
def test_fixed_k_association_within_tolerance(b, n_in, n_hidden):
    """The kernel's arithmetic on either route, emulated in plain torch:
    each 32-deep K tile summed on its own (the three TF32 products), the
    tiles of a group added in order into a group sum from 0, the group sums
    in order into the total from 0 (``k_groups``); within 1e-5 of the JAX
    oracle."""
    x = torch.as_tensor(_x(b, n_in, 19))
    alpha = t_xorshift.alpha_hash(0x2D2A, n_in, n_hidden, device="cpu")
    x_hi = _tf32_mask(x)
    x_lo = _tf32_mask(x - x_hi)
    a_hi = _tf32_mask(alpha)
    a_lo = alpha - a_hi
    group, groups = xorshift_proj.k_groups(n_in)
    tiles = [slice(t, min(t + 32, n_in)) for t in range(0, n_in, 32)]
    total = torch.zeros(b, n_hidden)
    for g in range(groups):
        gsum = torch.zeros(b, n_hidden)
        for k in tiles[g * group:(g + 1) * group]:
            gsum = gsum + sum(u[:, k] @ v[k] for u, v in ((x_hi, a_hi), (x_hi, a_lo),
                                                          (x_lo, a_hi)))
        total = total + gsum
    got = ref.activate(total * float(np.float32(1.0 / np.sqrt(n_in))), "sigmoid")
    want = np.asarray(j_ref.xorshift_projection_ref(jnp.asarray(x.numpy()), 0x2D2A, n_hidden))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_kernel_routes_times_both_sides_of_each_choice():
    """The crossover script times rows on both sides of the projection's
    SPLIT_MAX_BLOCKS (at n_in 561) and ranks on both sides of the single
    pass's SPREAD_MIN_K; it needs a card."""
    from repro_torch.benchmarks import kernel_routes

    blocks = [-(-b // 128) for b, n_in in kernel_routes.ROUTE_SHAPES if n_in == 561]
    assert min(blocks) <= xorshift_proj.SPLIT_MAX_BLOCKS < max(blocks)
    ranks = kernel_routes.SPREAD_RANKS
    assert min(ranks) < oselm_update.SPREAD_MIN_K <= max(ranks)
    if not torch.cuda.is_available():
        assert kernel_routes.main([]) == 1


def _rls_case(s, n, k, m, seed):
    """SPD P (inverse Gram of random features + ridge), beta, H, Y — numpy."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((s, 3 * n, n)) / np.sqrt(n)
    P = np.linalg.inv(np.einsum("sij,sik->sjk", f, f) + 0.1 * np.eye(n)).astype(np.float32)
    beta = (0.1 * rng.standard_normal((s, n, m))).astype(np.float32)
    H = (1 / (1 + np.exp(-rng.standard_normal((s, k, n))))).astype(np.float32)
    Y = np.eye(m, dtype=np.float32)[rng.integers(0, m, (s, k))]
    return P, beta, H, Y


@pytest.mark.parametrize(
    "s,n,k,m",
    [(3, 20, 2, 4), (2, 128, 1, 6), (1, 64, 16, 3), (4, 200, 1, 10)],
)
@pytest.mark.usefixtures("jax_ref")
def test_rls_fleet_matches_pallas(s, n, k, m):
    P, beta, H, Y = _rls_case(s, n, k, m, seed=n + k)
    p_want, b_want = j_rls_fleet(*map(jnp.asarray, (P, beta, H, Y)), interpret=True)
    p_got, b_got = ops.oselm_rls_update_fleet(*map(torch.as_tensor, (P, beta, H, Y)))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), atol=2e-5)
    np.testing.assert_allclose(b_got.numpy(), np.asarray(b_want), atol=2e-4)


@pytest.mark.parametrize("n,k,m", [(128, 1, 6), (128, 8, 6), (64, 64, 3)])
@pytest.mark.usefixtures("jax_ref")
def test_rls_single_head_matches_pallas(n, k, m):
    P, beta, H, Y = (a[0] for a in _rls_case(1, n, k, m, seed=3 * n + k))
    p_want, b_want = j_rls(*map(jnp.asarray, (P, beta, H, Y)), interpret=True)
    p_got, b_got = ops.oselm_rls_update(*map(torch.as_tensor, (P, beta, H, Y)))
    assert p_got.shape == (n, n) and b_got.shape == (n, m)
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), atol=2e-5)
    np.testing.assert_allclose(b_got.numpy(), np.asarray(b_want), atol=2e-4)


def test_rls_masked_stream_is_exact_identity():
    P, beta, H, Y = _rls_case(3, 16, 1, 4, seed=9)
    H[1] = 0.0
    Y[1] = 0.0
    p, b = ops.oselm_rls_update_fleet(*map(torch.as_tensor, (P, beta, H, Y)))
    np.testing.assert_array_equal(p[1].numpy(), P[1])
    np.testing.assert_array_equal(b[1].numpy(), beta[1])


@pytest.mark.parametrize("n", [128, 256, 257, 384])
@pytest.mark.parametrize("k", [1, 64, 65])
def test_rls_route_by_shape(n, k):
    """The single pass takes N <= 256 and k <= 64 (N a multiple of 4); every
    other shape goes to the two-stage route.  A single-pass plan fits the
    block's shared memory with at most 128 rows of P per block."""
    want = "single" if n <= 256 and k <= 64 else "two_stage"
    assert ops.rls_route(n, k, 6) == want
    plan = oselm_update.single_pass_plan(n, k, 6)
    assert (plan is not None) == (want == "single")
    if plan is not None:
        c, ns = plan
        assert c in (1, 2, 4) and n // c <= 128 and 1 <= ns <= 3
        assert oselm_update.single_pass_smem_bytes(n, k, 6, c, ns) <= 227 * 1024


def test_rls_route_plans_of_the_repo_shapes():
    """The fleet shape streams three stages through one block; N = 256 splits
    its rows over a cluster of four; N not a multiple of 4 is two-stage.
    From k = 2 on, N = 128 spreads a stream over four blocks of 32 rows,
    three stages deep (one block and two stages before that was measured
    the slower plan at every k from 2 to 64)."""
    assert oselm_update.single_pass_plan(128, 1, 6) == (1, 3)
    assert oselm_update.single_pass_plan(256, 1, 6) == (4, 3)
    assert oselm_update.single_pass_plan(128, 16, 6) == (4, 3)
    assert ops.rls_route(130, 1, 6) == "two_stage"
    # Blocks keep 32 rows or more where they can, else the smallest cluster.
    assert oselm_update.single_pass_plan(64, 64, 3)[0] == 2
    assert oselm_update.single_pass_plan(20, 2, 4)[0] == 1


@pytest.mark.parametrize("k", [2, 8, 32, 64])
def test_one_head_at_the_training_shape_spreads_over_a_cluster(k):
    """From k = 2 (the training path's 32 and 8 rows a step among them) one
    head spreads over a cluster of four blocks of 32 rows, three stages
    deep, whose layout (PHt's rows padded to an odd stride) fits a block;
    the plan is a function of (N, k, m) alone."""
    plan = oselm_update.single_pass_plan(128, k, 6)
    assert plan == (4, 3)
    c, ns = plan
    want = 32 + 4 * (ns * (32 * 128 + k * 128 + 128 * 6) + 6 * 128 + 32 * (k | 1)
                     + 2 * k * k + k * 6)
    assert oselm_update.single_pass_smem_bytes(128, k, 6, c, ns) == want <= 227 * 1024


def test_cpu_path_launches_no_kernel():
    before = dict(ops.launch_counts)
    ops.xorshift_projection(torch.zeros(2, 8), 1, 4)
    P, beta, H, Y = _rls_case(1, 8, 1, 2, seed=0)
    ops.oselm_rls_update_fleet(*map(torch.as_tensor, (P, beta, H, Y)))
    assert ops.launch_counts == before


def test_rls_update_writes_into_out_buffers():
    """With ``out`` the update lands in the caller's buffers (the stream
    runtime's ping-pong pair), equal to a call without it."""
    P, beta, H, Y = map(torch.as_tensor, _rls_case(3, 16, 1, 4, seed=2))
    want = ops.oselm_rls_update_fleet(P, beta, H, Y)
    out = (torch.empty_like(P), torch.empty_like(beta))
    got = ops.oselm_rls_update_fleet(P, beta, H, Y, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """A kernel wrapper launches on CUDA or raises; it never computes the
    plain version itself."""
    with pytest.raises(ValueError, match="CUDA"):
        xorshift_proj.xorshift_projection(torch.zeros(2, 8), 1, 4)
    P, beta, H, Y = map(torch.as_tensor, _rls_case(1, 8, 1, 2, seed=0))
    pht, g, w = oselm_update.small_operands(P, beta, H, Y)
    with pytest.raises(ValueError, match="CUDA"):
        oselm_update.rls_fleet(P, beta, pht, g, w)
    with pytest.raises(ValueError, match="CUDA"):
        oselm_update.rls_single(P, beta, H, Y)
    # The entry points take CUDA, CPU and meta tensors (meta: shapes only,
    # no launch counted); any other device raises.
    before = dict(ops.launch_counts)
    h = ops.xorshift_projection(torch.zeros(2, 8, device="meta"), 1, 4)
    assert h.device.type == "meta" and h.shape == (2, 4) and ops.launch_counts == before
    with pytest.raises(ValueError, match="CUDA, CPU or meta"):
        ops._route(types.SimpleNamespace(device=torch.device("xpu")))


# ---------------------------------------------------------------------------
# On the card: the CUDA kernels against their plain versions.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_in,n_hidden", PROJ_SHAPES)
@pytest.mark.parametrize("activation", ["sigmoid", "relu", "tanh", "identity"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_projection_matches_plain(cuda_device, b, n_in, n_hidden, activation, dtype):
    x = torch.as_tensor(_x(b, n_in, 11), device=cuda_device).to(getattr(torch, dtype))
    got = xorshift_proj.xorshift_projection(x, 0x2D2A, n_hidden, activation=activation)
    want = ref.xorshift_projection_ref(x, 0x2D2A, n_hidden, activation=activation)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol)


# The backbones' serving and training shapes (256 streams or 32 / 8 pooled
# rows of d_model) and the paper's one stream at N = 128 and 256.
PROJ_PATH_SHAPES = [(256, 2560, 128), (32, 2560, 128), (256, 5120, 128), (8, 5120, 128),
                    (256, 4096, 128), (32, 4096, 128), (256, 2048, 128), (256, 1536, 128),
                    (32, 768, 128), (1, 561, 128), (1, 561, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n_in,n_hidden", PROJ_PATH_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_projection_at_path_shapes_matches_plain(cuda_device, b, n_in, n_hidden, dtype):
    x = torch.as_tensor(_x(b, n_in, 13), device=cuda_device).to(getattr(torch, dtype))
    tol = 2e-3 if dtype == "bfloat16" else 1e-5
    for activation in ["sigmoid", "relu", "tanh", "identity"]:
        got = xorshift_proj.xorshift_projection(x, 0x2D2A, n_hidden, activation=activation)
        want = ref.xorshift_projection_ref(x, 0x2D2A, n_hidden, activation=activation)
        torch.cuda.synchronize()
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n_in", [561, 2560, 5120])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_projection_rows_independent_of_b_and_route(cuda_device, n_in, dtype):
    """The first 8 rows of one x come out bit for bit at B = 1 to 16,384,
    by the plan's route, by the one pass and by a split of K."""
    x = torch.as_tensor(_x(16384, n_in, 23), device=cuda_device).to(getattr(torch, dtype))
    want = xorshift_proj.xorshift_projection(x, 0x2D2A, 128)[:8]
    for b in (16384, 4096, 512, 256, 32, 8, 1):
        for smb in (xorshift_proj.SPLIT_MAX_BLOCKS, 0, 10 ** 6):
            plan = xorshift_proj.projection_plan(b, n_in, 128, split_max_blocks=smb)
            got = xorshift_proj.xorshift_projection(x[:b].contiguous(), 0x2D2A, 128, plan=plan)
            assert torch.equal(got[:8], want[:b]), (b, plan)


# The single pass's shapes, then one of each two-stage trigger: N > 256,
# k > 64, N not a multiple of 4; then heads spread over clusters of four
# (k >= 32), more streams than clusters among them.
RLS_CARD_SHAPES = [(64, 128, 1, 6), (8, 256, 1, 6), (1, 128, 16, 6), (4, 64, 64, 3),
                   (8, 72, 1, 6), (4, 384, 1, 6), (2, 128, 65, 6), (4, 130, 1, 6),
                   (1, 128, 32, 6), (64, 128, 32, 6), (3, 128, 64, 6), (2, 256, 32, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,m", RLS_CARD_SHAPES)
def test_cuda_rls_matches_plain(cuda_device, s, n, k, m):
    """The whole update through the dispatch (single pass, or the two-stage
    route where the single pass does not take the shape) against its plain
    version."""
    P, beta, H, Y = (torch.as_tensor(a, device=cuda_device) for a in _rls_case(s, n, k, m, 5))
    before = dict(ops.launch_counts)
    p_got, b_got = ops.oselm_rls_update_fleet(P, beta, H, Y)
    p_want, b_want = ref.rls_update_ref(P, beta, H, Y)
    torch.cuda.synchronize()
    counter = "oselm_rls_update_fleet" if ops.rls_route(n, k, m) == "single" else "rls_two_stage"
    assert ops.launch_counts[counter] == before[counter] + 1
    np.testing.assert_allclose(p_got.cpu().numpy(), p_want.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(b_got.cpu().numpy(), b_want.cpu().numpy(), atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,m", [(64, 128, 1, 6), (8, 256, 1, 6), (1, 128, 16, 6),
                                     (4, 384, 1, 6)])
def test_cuda_two_stage_pass_matches_plain(cuda_device, s, n, k, m):
    P, beta, H, Y = (torch.as_tensor(a, device=cuda_device) for a in _rls_case(s, n, k, m, 5))
    pht, g, w = oselm_update.small_operands(P, beta, H, Y)
    p_got, b_got = oselm_update.rls_fleet(P, beta, pht, g, w)
    p_want, b_want = ref.rls_fused_ref(P, beta, pht, g, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(p_got.cpu().numpy(), p_want.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(b_got.cpu().numpy(), b_want.cpu().numpy(), atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(128, 16, 6), (128, 32, 6), (128, 8, 6)])
def test_cuda_one_head_rls_matches_plain(cuda_device, n, k, m):
    """Kernel 3 (the one-head entry) at the training path's shapes, under
    the dispatch's plan, against its plain version; a head whose rows are
    all masked comes out exactly as it went in."""
    P, beta, H, Y = (torch.as_tensor(a[0], device=cuda_device) for a in _rls_case(1, n, k, m, 7))
    before = ops.launch_counts["oselm_rls_update"]
    p_got, b_got = ops.oselm_rls_update(P, beta, H, Y)
    p_want, b_want = (a[0] for a in ref.rls_update_ref(P[None], beta[None], H[None], Y[None]))
    p_same, b_same = ops.oselm_rls_update(P, beta, torch.zeros_like(H), torch.zeros_like(Y))
    torch.cuda.synchronize()
    assert ops.launch_counts["oselm_rls_update"] == before + 2
    np.testing.assert_allclose(p_got.cpu().numpy(), p_want.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(b_got.cpu().numpy(), b_want.cpu().numpy(), atol=2e-4)
    assert torch.equal(p_same, P) and torch.equal(b_same, beta)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,m", [(5, 128, 1, 6), (3, 256, 1, 6), (2, 64, 64, 3),
                                     (3, 128, 32, 6)])
def test_cuda_rls_masked_stream_is_exact_identity(cuda_device, s, n, k, m):
    P, beta, H, Y = _rls_case(s, n, k, m, seed=9)
    H[1] = 0.0
    Y[1] = 0.0
    p, b = ops.oselm_rls_update_fleet(*(torch.as_tensor(a, device=cuda_device)
                                        for a in (P, beta, H, Y)))
    np.testing.assert_array_equal(p[1].cpu().numpy(), P[1])
    np.testing.assert_array_equal(b[1].cpu().numpy(), beta[1])


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,m", [(5, 128, 1, 6), (4, 384, 1, 6)])
def test_cuda_rls_writes_into_out_buffers(cuda_device, s, n, k, m):
    """Both routes write into ``out`` exactly what they write into new
    buffers, and refuse an ``out`` that overlaps an input (they write out
    of place)."""
    P, beta, H, Y = (torch.as_tensor(a, device=cuda_device) for a in _rls_case(s, n, k, m, 3))
    want = ops.oselm_rls_update_fleet(P, beta, H, Y)
    out = (torch.full_like(P, float("nan")), torch.full_like(beta, float("nan")))
    got = ops.oselm_rls_update_fleet(P, beta, H, Y, out=out)
    torch.cuda.synchronize()
    assert got[0] is out[0] and got[1] is out[1]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="overlaps"):
        ops.oselm_rls_update_fleet(P, beta, H, Y, out=(P, out[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(128, 1, 6), (256, 1, 6), (256, 64, 6), (200, 1, 10),
                                   (20, 2, 4), (128, 32, 6), (128, 33, 6), (128, 64, 6)])
def test_cuda_single_pass_layout_agrees(cuda_device, n, k, m):
    """The dispatch's count of the single pass's shared memory is the
    kernel library's own."""
    c, ns = oselm_update.single_pass_plan(n, k, m)
    assert oselm_update.kernel_smem_bytes(n, k, m, c, ns) == (
        oselm_update.single_pass_smem_bytes(n, k, m, c, ns))
