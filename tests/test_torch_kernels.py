"""Parity of the port's two kernels with the JAX package's Pallas kernels.

On the CPU the port's wrappers run the plain PyTorch versions (``ref``);
they are held against the Pallas kernels run in interpret mode and against
the JAX oracles, at the tolerances of ``tests/test_kernels.py``.  The RLS
tests hold the port against the **Pallas numerics** (no symmetrisation of
P', beta' from P' @ W) — one of the three RLS numerics the JAX package has.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
the card; they skip where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro.core import oselm as j_oselm  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.oselm_update import (  # noqa: E402
    oselm_rls_update as j_rls,
    oselm_rls_update_fleet as j_rls_fleet,
)
from repro.kernels.xorshift_proj import xorshift_projection as j_proj  # noqa: E402
from repro_torch.kernels import oselm_update, ops, ref, xorshift_proj  # noqa: E402

PROJ_SHAPES = [(8, 128, 128), (8, 256, 384), (3, 561, 128), (130, 100, 72), (1, 16, 16)]


def _x(b, n_in, seed):
    return np.random.default_rng(seed).standard_normal((b, n_in)).astype(np.float32)


@pytest.mark.parametrize("b,n_in,n_hidden", PROJ_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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
def test_projection_activations_and_scale(activation):
    x = _x(5, 96, 1)
    got = ops.xorshift_projection(torch.as_tensor(x), 7, 64, scale=0.5, activation=activation)
    want = j_proj(jnp.asarray(x), 7, 64, scale=0.5, activation=activation, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


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
def test_rls_fleet_matches_pallas(s, n, k, m):
    P, beta, H, Y = _rls_case(s, n, k, m, seed=n + k)
    p_want, b_want = j_rls_fleet(*map(jnp.asarray, (P, beta, H, Y)), interpret=True)
    p_got, b_got = ops.oselm_rls_update_fleet(*map(torch.as_tensor, (P, beta, H, Y)))
    np.testing.assert_allclose(p_got.numpy(), np.asarray(p_want), atol=2e-5)
    np.testing.assert_allclose(b_got.numpy(), np.asarray(b_want), atol=2e-4)


@pytest.mark.parametrize("n,k,m", [(128, 1, 6), (128, 8, 6), (64, 64, 3)])
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


def test_cpu_path_launches_no_kernel():
    before = dict(ops.launch_counts)
    ops.xorshift_projection(torch.zeros(2, 8), 1, 4)
    P, beta, H, Y = _rls_case(1, 8, 1, 2, seed=0)
    ops.oselm_rls_update_fleet(*map(torch.as_tensor, (P, beta, H, Y)))
    assert ops.launch_counts == before


def test_kernel_wrappers_refuse_non_cuda_tensors():
    """A kernel wrapper launches on CUDA or raises; it never computes the
    plain version itself."""
    with pytest.raises(ValueError, match="CUDA"):
        xorshift_proj.xorshift_projection(torch.zeros(2, 8), 1, 4)
    P, beta, H, Y = map(torch.as_tensor, _rls_case(1, 8, 1, 2, seed=0))
    pht, g, w = oselm_update.small_operands(P, beta, H, Y)
    with pytest.raises(ValueError, match="CUDA"):
        oselm_update.rls_fleet(P, beta, pht, g, w)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.xorshift_projection(torch.zeros(2, 8, device="meta"), 1, 4)


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
def test_cuda_projection_matches_plain(cuda_device, b, n_in, n_hidden, activation):
    x = torch.as_tensor(_x(b, n_in, 11), device=cuda_device)
    got = xorshift_proj.xorshift_projection(x, 0x2D2A, n_hidden, activation=activation)
    want = ref.xorshift_projection_ref(x, 0x2D2A, n_hidden, activation=activation)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,k,m", [(64, 128, 1, 6), (8, 256, 1, 6), (1, 128, 16, 6)])
def test_cuda_rls_matches_plain(cuda_device, s, n, k, m):
    P, beta, H, Y = (torch.as_tensor(a, device=cuda_device) for a in _rls_case(s, n, k, m, 5))
    pht, g, w = oselm_update.small_operands(P, beta, H, Y)
    p_got, b_got = oselm_update.rls_fleet(P, beta, pht, g, w)
    p_want, b_want = ref.rls_fused_ref(P, beta, pht, g, w)
    torch.cuda.synchronize()
    np.testing.assert_allclose(p_got.cpu().numpy(), p_want.cpu().numpy(), atol=2e-5)
    np.testing.assert_allclose(b_got.cpu().numpy(), b_want.cpu().numpy(), atol=2e-4)

