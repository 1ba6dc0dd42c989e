"""The fleet's RLS update at N = 256, k = 1 on a cluster of four blocks
(``rls_rank1_cluster_kernel`` in ``csrc/oselm_update.cu``).

On the CPU: its plan and shared-memory layout, the rule that chooses it,
and a numpy emulation of its order of operations (each block's rows of PHt
and share of H β summed as the kernel's butterfly adds them, S over all N
as each lane's chunks then a xor tree, E over the four blocks' shares in
rank order, β' as (P' h) E), held against the JAX package's
``oselm_rls_update_fleet`` run in interpret mode, at the tolerances of
``tests/test_kernels.py`` (P 2e-5, β 2e-4).

Tests marked ``cuda`` hold the kernel against its plain version on the card
and a stream's P' and β' bit for bit at any S and any grid; they skip where
there is none.  The card's machine has no JAX, and this file runs there
too (the JAX test skips):

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_rls_rank1_cluster.py
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp
    from repro.kernels.oselm_update import oselm_rls_update_fleet as j_rls_fleet

from repro_torch.kernels import oselm_update, ref  # noqa: E402

# Every (N, k, m) the repo runs or tests through the single pass, and its
# plan (unchanged by the rank-1 cluster body's smaller layout).
REPO_PLANS = {
    (8, 1, 2): (1, 3), (16, 1, 4): (1, 3), (20, 2, 4): (1, 3), (64, 1, 6): (1, 3),
    (64, 16, 3): (2, 3), (64, 64, 3): (2, 3), (72, 1, 6): (1, 3), (128, 1, 6): (1, 3),
    (128, 8, 6): (4, 3), (128, 16, 6): (4, 3), (128, 32, 6): (4, 3), (128, 33, 6): (4, 3),
    (128, 64, 6): (4, 3), (200, 1, 10): (2, 2), (256, 1, 6): (4, 3), (256, 32, 6): (4, 1),
    (256, 64, 6): (4, 1),
}


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


def _rls_case(s, n, k, m, seed):
    """SPD P (inverse Gram of random features + ridge), beta, H, Y — numpy."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((s, 3 * n, n)) / np.sqrt(n)
    P = np.linalg.inv(np.einsum("sij,sik->sjk", f, f) + 0.1 * np.eye(n)).astype(np.float32)
    beta = (0.1 * rng.standard_normal((s, n, m))).astype(np.float32)
    H = (1 / (1 + np.exp(-rng.standard_normal((s, k, n))))).astype(np.float32)
    Y = np.eye(m, dtype=np.float32)[rng.integers(0, m, (s, k))]
    return P, beta, H, Y


def test_fleet_n256_plan_and_layout():
    """(256, 1, 6) runs as four blocks of 64 rows, three stages deep, on the
    rank-1 cluster body: a stage holds the block's rows of P, h and only its
    rows of β (68,096 B), then two exchange areas of four slots of 64 + 8
    floats."""
    assert oselm_update.single_pass_plan(256, 1, 6) == (4, 3)
    assert oselm_update.rank1_cluster(256, 1, 6, 4)
    stage = 4 * (64 * 256 + 256 + 64 * 6)
    assert stage == 68_096
    want = 32 + 3 * stage + 4 * 2 * 4 * (64 + 8)
    assert oselm_update.single_pass_smem_bytes(256, 1, 6, 4, 3) == want == 206_624
    assert want <= oselm_update.MAX_SMEM_BYTES


@pytest.mark.parametrize("shape", sorted(REPO_PLANS))
def test_repo_shapes_keep_their_plans(shape):
    plan = oselm_update.single_pass_plan(*shape)
    assert plan == REPO_PLANS[shape]
    assert oselm_update.single_pass_smem_bytes(*shape, *plan) <= oselm_update.MAX_SMEM_BYTES


@pytest.mark.parametrize("n,k,m,c,want", [
    (256, 1, 6, 4, True), (256, 1, 8, 4, True), (128, 1, 6, 4, True), (128, 1, 6, 2, True),
    (256, 1, 6, 2, False),  # 128 rows a block
    (256, 1, 9, 4, False),  # m > 8
    (256, 2, 6, 4, False),  # k > 1
    (252, 1, 6, 4, False),  # 63 rows: a slot's PHt would not stay 16-byte aligned
    (128, 1, 6, 1, False),  # one block: rank1_stream
    (384, 1, 6, 4, False),  # N > 256
])
def test_rank1_cluster_rule(n, k, m, c, want):
    assert oselm_update.rank1_cluster(n, k, m, c) is want


# ---------------------------------------------------------------------------
# The kernel's order of operations, emulated in numpy float32.
# ---------------------------------------------------------------------------


def _fma(a, b, c):
    """fmaf: the product (exact in float64) and the sum in float64, then one
    rounding to float32."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _dot_lanes(a, b):
    """Each lane's dot4 over its chunk l, then onto it its chunk l + 32:
    a, b (..., 2, 32, 4) -> (..., 32)."""
    acc = np.zeros(np.broadcast_shapes(a.shape, b.shape)[:-3] + (32,), np.float32)
    for half in (0, 1):
        for e in range(4):
            acc = _fma(a[..., half, :, e], b[..., half, :, e], acc)
    return acc


def _butterfly(v):
    """``butterfly_sum`` over the 32 lanes: v (..., 32, V) -> (..., 32),
    lane l ending with the sum of value l >> (5 - log2 V)."""
    lanes = np.arange(32)
    n = v.shape[-1]
    for o in (16, 8, 4, 2, 1):
        partner = lanes ^ o
        if n > 1:
            n //= 2
            up = ((lanes & o) != 0)[:, None]
            lo, hi = v[..., :n], v[..., n:2 * n]
            send, keep = np.where(up, lo, hi), np.where(up, hi, lo)
            v = keep + send[..., partner, :]
        else:
            v = v + v[..., partner, :]
    return v[..., 0]


def _xor_sum(v):
    """A sum over the 32 lanes by xor shuffles: v (..., 32) -> (...,)."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def rank1_cluster_emulated(P, beta, H, Y, c=4):
    """(P', β') as ``rls_rank1_cluster_kernel`` computes them at N = 256 on
    four blocks of 64 rows: lane l owns columns 4l..4l+3 and 128+4l..; warp w
    rows w, w + 8, ... of its block."""
    s, n, _ = P.shape
    m = beta.shape[2]
    r = n // c
    assert n == 256 and r == 64 and m <= 8
    chunks = lambda x: x.reshape(*x.shape[:-1], 2, 32, 4)  # noqa: E731
    h = H[:, 0]
    hl = chunks(h)[:, None, None, None]  # (S, 1, 1, 1, 2, 32, 4)
    rows = lambda x: x.reshape(s, c, r // 8, 8, *x.shape[2:])  # noqa: E731  (S, block, t, w, ...)

    # 1. PHt of each block's rows (row w + 8t sits in lane 4t after the butterfly).
    v = _dot_lanes(chunks(rows(P)), hl)  # (S, c, t, w, 32)
    sums = _butterfly(np.moveaxis(v, 2, -1))  # (S, c, w, 32)
    pht = np.moveaxis(sums[..., ::4], -1, 2).reshape(s, n)  # (S, c, t, w) -> rows
    #    Each block's share of H beta: rows l and l + 32 of the block, by lane.
    hb = h.reshape(s, c, 2, 32)
    bb = beta.reshape(s, c, 2, 32, m)
    ev = _fma(hb[:, :, 1, :, None], bb[:, :, 1], _fma(hb[:, :, 0, :, None], bb[:, :, 0], 0.0))
    ev = np.concatenate([ev, np.zeros((s, c, 32, 8 - m), np.float32)], axis=-1)
    shares = _butterfly(ev)[..., ::4][..., :m]  # (S, c, m)

    # 2. S over all N (each lane's chunks, then the xor tree), E over the
    #    shares in rank order, G.
    sv = np.float32(1.0) + _xor_sum(_dot_lanes(hl[:, 0, 0, 0], chunks(pht)))
    g = pht / sv[:, None]
    total = np.zeros((s, m), np.float32)
    for b in range(c):
        total = total + shares[:, b]
    e = Y[:, 0] - total

    # 3. P' = P - PHt G (two roundings), q = P' h by rows, beta' = fma(q, E, beta).
    new_p = P - pht[:, :, None] * g[:, None, :]
    q = _butterfly(np.moveaxis(_dot_lanes(chunks(rows(new_p)), hl), 2, -1))
    q = np.moveaxis(q[..., ::4], -1, 2).reshape(s, n)
    new_beta = _fma(q[:, :, None], e[:, None, :], beta)
    return new_p, new_beta


def test_butterfly_emulation_sums_each_value():
    """The emulated butterfly leaves in lane l the sum of value l >> 2 over
    the 32 lanes (V = 8), as the kernel's does."""
    v = np.random.default_rng(0).integers(-50, 50, (3, 32, 8)).astype(np.float32)
    got = _butterfly(v)
    want = v.sum(axis=1)[:, np.arange(32) >> 2]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [8, 3])
@pytest.mark.usefixtures("jax_ref")
def test_emulated_order_matches_pallas(s):
    """The rank-1 cluster body's order of operations against the JAX
    package's fleet update in interpret mode; a masked stream (H = 0,
    Y = 0) comes out exactly as it went in."""
    P, beta, H, Y = _rls_case(s, 256, 1, 6, seed=40 + s)
    H[1] = 0.0
    Y[1] = 0.0
    p_got, b_got = rank1_cluster_emulated(P, beta, H, Y)
    p_want, b_want = j_rls_fleet(*map(jnp.asarray, (P, beta, H, Y)), interpret=True)
    np.testing.assert_allclose(p_got, np.asarray(p_want), atol=2e-5)
    np.testing.assert_allclose(b_got, np.asarray(b_want), atol=2e-4)
    np.testing.assert_array_equal(p_got[1], P[1])
    np.testing.assert_array_equal(b_got[1], beta[1])
    # And the port's plain version, which the card's kernel is held to.
    p_ref, b_ref = ref.rls_update_ref(*map(torch.as_tensor, (P, beta, H, Y)))
    np.testing.assert_allclose(p_got, p_ref.numpy(), atol=2e-5)
    np.testing.assert_allclose(b_got, b_ref.numpy(), atol=2e-4)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _card_case(s, n, k, m, seed, device):
    """SPD P, beta, H, one-hot Y of s streams, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn(s, n, n, generator=g, device=device) / n ** 0.5
    P = torch.bmm(a, a.transpose(1, 2)) + 0.1 * torch.eye(n, device=device)
    beta = 0.1 * torch.randn(s, n, m, generator=g, device=device)
    H = torch.sigmoid(torch.randn(s, k, n, generator=g, device=device))
    Y = torch.nn.functional.one_hot(
        torch.randint(0, m, (s, k), generator=g, device=device), m).to(torch.float32)
    return P, beta, H, Y


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 33, 34, 67, 512])
def test_cuda_rank1_cluster_matches_plain(cuda_device, s):
    P, beta, H, Y = _card_case(s, 256, 1, 6, 70 + s, cuda_device)
    H[0] = 0.0
    Y[0] = 0.0  # stream 0 masked
    p_got, b_got = oselm_update.rls_single(P, beta, H, Y)
    p_want, b_want = ref.rls_update_ref(P, beta, H, Y)
    torch.cuda.synchronize()
    assert (p_got - p_want).abs().max().item() <= 2e-5
    assert (b_got - b_want).abs().max().item() <= 2e-4
    assert torch.equal(p_got[0], P[0]) and torch.equal(b_got[0], beta[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(256, 1, 6), (128, 16, 6), (128, 1, 6)])
def test_cuda_stream_bit_for_bit_across_s_and_grids(cuda_device, n, k, m):
    """A stream's P' and β' do not depend on how many streams share the
    launch nor on how many clusters walk them: as many as fit, one, three,
    or more than the card holds at once."""
    P, beta, H, Y = _card_case(512, n, k, m, 90 + n + k, cuda_device)
    want_p, want_b = oselm_update.rls_single(P, beta, H, Y)
    for s in (1, 2, 33, 34, 67, 512):
        part = tuple(t[:s].contiguous() for t in (P, beta, H, Y))
        for clusters in (None, 1, 3, 200):
            got_p, got_b = oselm_update.rls_single(*part, clusters=clusters)
            assert torch.equal(got_p, want_p[:s]) and torch.equal(got_b, want_b[:s]), (s, clusters)


@pytest.mark.cuda
def test_cuda_launch_clusters_fit_the_card(cuda_device):
    """A cluster plan runs as many clusters as the card holds at once (at
    most SMs / blocks), a one-block plan one block an SM; never more than
    streams; a count asked for is the count run."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for n, k, m in ((256, 1, 6), (128, 16, 6)):
        c, _ = oselm_update.single_pass_plan(n, k, m)
        fit = oselm_update.launch_clusters(16384, n, k, m)
        assert 1 <= fit <= sms // c
        assert oselm_update.launch_clusters(1, n, k, m) == 1
        assert oselm_update.launch_clusters(16384, n, k, m, clusters=5) == 5
    assert oselm_update.launch_clusters(16384, 128, 1, 6) == sms


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m,c,ns", [(256, 1, 6, 4, 3), (256, 1, 8, 4, 2), (128, 1, 6, 4, 3),
                                        (128, 1, 6, 2, 3), (256, 1, 6, 2, 1)])
def test_cuda_layouts_agree_under_any_plan(cuda_device, n, k, m, c, ns):
    """The kernel library counts each body's layout as the dispatch does,
    under the plan's cluster and under others (the rank-1 cluster body's at
    four blocks of 64 or 32 rows and two of 64, the general body's at two
    of 128)."""
    assert oselm_update.kernel_smem_bytes(n, k, m, c, ns) == (
        oselm_update.single_pass_smem_bytes(n, k, m, c, ns))


@pytest.mark.cuda
@pytest.mark.parametrize("plan", [(4, 3), (2, 3)])
def test_cuda_rank1_cluster_under_other_plans(cuda_device, plan):
    """N = 128, k = 1 forced onto clusters of four and of two blocks (the
    rank-1 cluster body at 32 and 64 rows a block) against the plain
    version."""
    P, beta, H, Y = _card_case(40, 128, 1, 6, 17, cuda_device)
    p_got, b_got = oselm_update.rls_single(P, beta, H, Y, plan=plan)
    p_want, b_want = ref.rls_update_ref(P, beta, H, Y)
    torch.cuda.synchronize()
    assert (p_got - p_want).abs().max().item() <= 2e-5
    assert (b_got - b_want).abs().max().item() <= 2e-4
