"""The port's OS-ELM update functions take the JAX package's ``use_kernel``
keyword and ignore it: the device of the tensors picks the path.

Each of ``sequential_update``, ``fleet_update``, ``fleet_rank1_update_h``
and ``fleet_rank1_update`` gives the same result bit for bit with
``use_kernel`` None, True and False, and accepts the calls the JAX
package's own tests make (``tests/test_engine.py``,
``tests/test_kernels.py``).  CPU tensors made from a numpy seed; no JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import oselm  # noqa: E402

N_IN, N_HIDDEN, N_OUT, S, K = 24, 16, 5, 5, 6
FUNCTIONS = ("sequential_update", "fleet_update", "fleet_rank1_update_h", "fleet_rank1_update")


def _case(name, seed=0):
    """(state, positional args after it) for ``name``, from a numpy seed."""
    rng = np.random.default_rng(seed)
    cfg = oselm.OSELMConfig(n_in=N_IN, n_hidden=N_HIDDEN, n_out=N_OUT, seed=3)
    rows = K if name == "sequential_update" else S
    x = torch.as_tensor(np.tanh(rng.standard_normal((rows, N_IN))).astype(np.float32))
    y = torch.as_tensor(np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, rows)])
    mask = torch.as_tensor((rng.random(rows) < 0.7).astype(np.float32))
    if name == "sequential_update":
        x0 = torch.as_tensor(np.tanh(rng.standard_normal((40, N_IN))).astype(np.float32))
        y0 = torch.as_tensor(np.eye(N_OUT, dtype=np.float32)[rng.integers(0, N_OUT, 40)])
        return oselm.init_state_batch(cfg, x0, y0), (x, y, cfg), mask
    state = oselm.init_fleet(cfg, S, device="cpu")
    if name == "fleet_rank1_update_h":
        x = oselm.hidden(x, cfg)
    return state, (x, y, cfg), mask


@pytest.mark.parametrize("name", FUNCTIONS)
@pytest.mark.parametrize("use_kernel", [True, False])
def test_update_functions_accept_use_kernel(name, use_kernel):
    """None, True and False give one result, bit for bit, with and without a mask."""
    fn = getattr(oselm, name)
    state, args, mask = _case(name)
    for kw in ({}, {"mask": mask}):
        want = fn(state, *args, **kw, use_kernel=None)
        got = fn(state, *args, **kw, use_kernel=use_kernel)
        bare = fn(state, *args, **kw)
        for a, b, c in zip(got, want, bare):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_reference_callers_raise_no_type_error():
    """The JAX package's own tests call the updates so
    (``tests/test_engine.py:136-137``, ``tests/test_kernels.py:128``)."""
    state, (x, y, cfg), mask = _case("fleet_rank1_update")
    a = oselm.fleet_rank1_update(state, x, y, cfg, mask=mask, use_kernel=False)
    b = oselm.fleet_rank1_update(state, x, y, cfg, mask=mask, use_kernel=True)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    st0, (x, y, cfg), _ = _case("sequential_update")
    jnp_path = oselm.sequential_update(st0, x, y, cfg)
    kernel_path = oselm.sequential_update(st0, x, y, cfg, use_kernel=True)
    assert all(torch.equal(u, v) for u, v in zip(jnp_path, kernel_path))
    # Positionally, in the JAX package's order: alpha, mask, use_kernel.
    got = oselm.sequential_update(st0, x, y, cfg, None, None, True)
    assert all(torch.equal(u, v) for u, v in zip(got, jnp_path))
    h = oselm.hidden(x[:S], cfg)
    fleet = oselm.init_fleet(cfg, S, device="cpu")
    want = oselm.fleet_rank1_update_h(fleet, h, y[:S], cfg)
    got = oselm.fleet_rank1_update_h(fleet, h, y[:S], cfg, None, False)
    assert all(torch.equal(u, v) for u, v in zip(got, want))
