"""The per-stream row reductions of ``plan`` (``repro_torch.kernels``
``readout`` and ``row_abs_mean``) against the JAX package and against their
plain versions.

The JAX package computes both in XLA inside ``repro.engine.fleet.plan``
(``jnp.einsum("sn,snm->sm", h, beta)``) and ``repro.core.drift.score``
(``jnp.mean(jnp.abs(x))``); the port dispatches them to a hand-written
kernel on the card (the reduced instances of ``csrc/plan_rows.cu``'s
per-stream pass) and to the plain versions on the CPU.  Against JAX the values agree within 1e-5
(f32 sums in another order); inside the port a row's value does not depend
on how many rows share the call, on the CPU bit for bit here and on the
card in the ``cuda`` tests:

    PYTHONPATH=src python3 -m pytest -q -m cuda tests/test_torch_plan_rows.py
"""

import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HAVE_JAX = importlib.util.find_spec("jax") is not None
if HAVE_JAX:
    import jax.numpy as jnp

    from repro.core import drift as j_drift

from repro_torch.core import drift as t_drift  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SHAPES = [(1, 16, 4), (3, 16, 4), (7, 128, 6), (64, 100, 1)]


@pytest.fixture
def jax_ref():
    if not HAVE_JAX:
        pytest.skip("needs JAX, the package the port is held against")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _inputs(s, n, m, seed=0):
    rng = np.random.default_rng(seed)
    h = (1 / (1 + np.exp(-rng.standard_normal((s, n))))).astype(np.float32)
    beta = (0.1 * rng.standard_normal((s, n, m))).astype(np.float32)
    x = (2 * rng.standard_normal((s, 561))).astype(np.float32)
    return h, beta, x


@pytest.mark.parametrize("s,n,m", SHAPES)
@pytest.mark.usefixtures("jax_ref")
def test_cpu_row_reductions_match_jax(s, n, m):
    """``ops.readout`` and ``ops.row_abs_mean`` on CPU tensors equal the JAX
    package's einsum and feature mean within 1e-5, and the drift score that
    holds the feature mean equals the JAX score within 1e-5."""
    h, beta, x = _inputs(s, n, m, seed=s)
    got = ops.readout(torch.as_tensor(h), torch.as_tensor(beta)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.einsum("sn,snm->sm", h, beta)), rtol=1e-5,
                               atol=1e-5)
    got = ops.row_abs_mean(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.mean(jnp.abs(x), axis=-1)), rtol=1e-5,
                               atol=1e-5)
    o = 0.1 * x[:, :6]
    np.testing.assert_allclose(
        t_drift.score(torch.as_tensor(x), torch.as_tensor(o), t_drift.DriftConfig()).numpy(),
        np.asarray(j_drift.score(jnp.asarray(x), jnp.asarray(o), j_drift.DriftConfig())),
        rtol=1e-5, atol=1e-5)


def test_cpu_rows_do_not_depend_on_their_neighbours():
    """Each row of the CPU path, computed with 1, 3 or 16 rows beside it,
    is bit for bit the same (a cohort's stacked plan must equal a member's)."""
    h, beta, x = _inputs(48, 128, 6, seed=1)
    h, beta, x = torch.as_tensor(h), torch.as_tensor(beta), torch.as_tensor(x)
    full_o, full_a = ops.readout(h, beta), ops.row_abs_mean(x)
    full_p = ops.xorshift_projection(x, 7, 128)
    for w in (1, 3, 16):
        for lo in range(0, 48, w):
            hi = lo + w
            assert torch.equal(ops.readout(h[lo:hi].clone(), beta[lo:hi].clone()), full_o[lo:hi])
            assert torch.equal(ops.row_abs_mean(x[lo:hi].clone()), full_a[lo:hi])
            assert torch.equal(ops.xorshift_projection(x[lo:hi].clone(), 7, 128), full_p[lo:hi])


def test_row_abs_mean_keeps_leading_axes():
    x = torch.randn(2, 3, 5)
    assert torch.equal(ops.row_abs_mean(x), ref.row_abs_mean_ref(x.reshape(6, 5)).reshape(2, 3))
    assert ops.row_abs_mean(torch.randn(5)).shape == ()


@pytest.mark.cuda
@pytest.mark.parametrize("s,n,m", SHAPES + [(16384, 128, 6)])
def test_cuda_row_kernels_match_plain_versions(cuda_device, s, n, m):
    h, beta, x = (torch.as_tensor(a, device=cuda_device) for a in _inputs(s, n, m, seed=s))
    before = dict(ops.launch_counts)
    o, a = ops.readout(h, beta), ops.row_abs_mean(x)
    assert ops.launch_counts["readout"] == before["readout"] + 1
    assert ops.launch_counts["row_abs_mean"] == before["row_abs_mean"] + 1
    torch.testing.assert_close(o, ref.readout_ref(h, beta), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(a, ref.row_abs_mean_ref(x), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_rows_do_not_depend_on_their_neighbours(cuda_device):
    """On the card too: rows computed 1, 3 or 1024 at a time equal the same
    rows inside a launch of 16,384."""
    h, beta, x = (torch.as_tensor(a, device=cuda_device) for a in _inputs(16384, 128, 6, seed=2))
    full_o, full_a = ops.readout(h, beta), ops.row_abs_mean(x)
    for w in (1, 3, 1024):
        for lo in range(0, 16384 - w, 16384 // 7):
            hi = lo + w
            assert torch.equal(ops.readout(h[lo:hi].clone(), beta[lo:hi].clone()), full_o[lo:hi])
            assert torch.equal(ops.row_abs_mean(x[lo:hi].clone()), full_a[lo:hi])


@pytest.mark.cuda
def test_cuda_row_kernels_reject_what_they_do_not_take(cuda_device):
    from repro_torch.kernels import plan_rows

    h = torch.ones(4, 8, device=cuda_device)
    with pytest.raises(ValueError):
        plan_rows.readout(h, torch.ones(4, 9, 2, device=cuda_device))
    with pytest.raises(ValueError):
        plan_rows.readout(h.double(), torch.ones(4, 8, 2, device=cuda_device, dtype=torch.float64))
    with pytest.raises(ValueError):
        plan_rows.row_abs_mean(torch.ones(4, 8, device=cuda_device)[:, ::2])
    with pytest.raises(ValueError):
        plan_rows.readout(h.cpu(), torch.ones(4, 8, 2))
