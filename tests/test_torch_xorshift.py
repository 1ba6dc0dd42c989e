"""Parity of the port's Xorshift16 weights with the JAX package (bit-exact)."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: more threads only spin

from repro.core import xorshift as jx  # noqa: E402
from repro_torch.core import xorshift as tx  # noqa: E402


@pytest.mark.parametrize(
    "seed,n_in,n_hidden,row_offset,col_offset",
    [
        (7, 64, 640, 0, 0),  # test_xorshift.py's full matrix
        (7, 8, 640, 13, 77),  # a tile of it at an offset
        (0x2D2A, 561, 128, 0, 0),  # the HAR shape
        (65535, 561, 256, 0, 0),  # the paper's Tables 2-3 width
    ],
)
def test_alpha_hash_bit_exact(seed, n_in, n_hidden, row_offset, col_offset):
    want = np.asarray(
        jx.alpha_hash(seed, n_in, n_hidden, row_offset=row_offset, col_offset=col_offset)
    )
    got = tx.alpha_hash(
        seed, n_in, n_hidden, row_offset=row_offset, col_offset=col_offset, device="cpu"
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_mix16_and_step_bit_exact_on_every_u16():
    x = np.arange(65536, dtype=np.uint16)
    want_mix = np.asarray(jx.mix16(jnp.asarray(x)))
    want_step = np.asarray(jx.xorshift16_step(jnp.asarray(x)))
    got_mix = tx.mix16(torch.as_tensor(x.astype(np.int64))).numpy()
    got_step = tx.xorshift16_step(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got_mix, want_mix.astype(np.int64))
    np.testing.assert_array_equal(got_step, want_step.astype(np.int64))


def test_rounds_and_unit_map_bit_exact():
    x = np.arange(0, 65536, 17, dtype=np.uint16)
    want = np.asarray(jx.xorshift16_rounds(jnp.asarray(x), 5))
    got = tx.xorshift16_rounds(torch.as_tensor(x.astype(np.int64)), 5).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    u_want = np.asarray(jx.u16_to_unit(jnp.asarray(x)))
    u_got = tx.u16_to_unit(torch.as_tensor(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(u_got.view(np.uint32), u_want.view(np.uint32))


def test_sequential_stream_matches():
    np.testing.assert_array_equal(tx.xorshift16_stream(0x1234, 500), jx.xorshift16_stream(0x1234, 500))
    assert tx.xorshift16_stream(0, 4).tolist() == jx.xorshift16_stream(0, 4).tolist()


def test_constants_match():
    for name in ("SHIFT_A", "SHIFT_B", "SHIFT_C", "DEFAULT_ROUNDS", "DEFAULT_SEED", "MIX_CONSTANTS"):
        assert getattr(tx, name) == getattr(jx, name), name
