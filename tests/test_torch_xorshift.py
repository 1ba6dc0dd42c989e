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


# ---------------------------------------------------------------------------
# ODLBase: the stored dense alpha (JAX's threefry2x32 uniform), bit-exact.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_in,n_hidden", [
    (77, 561, 128),  # Table 3's ODLBase boot at N=128 (run seed 0)
    (78, 561, 256),  # ... at N=256 (run seed 1)
    (0, 24, 16),
    (123456, 48, 32),
])
@pytest.mark.parametrize("scale", [1.0, 0.37])
def test_alpha_dense_bit_exact(seed, n_in, n_hidden, scale):
    want = np.asarray(jx.alpha_dense(seed, n_in, n_hidden, scale))
    got = tx.alpha_dense(seed, n_in, n_hidden, scale, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == (n_in, n_hidden)
    assert got.tobytes() == want.tobytes()
    assert got.min() >= -scale and got.max() < scale


def test_alpha_for_variant_bit_exact():
    got = tx.alpha_for_variant("base", 9, 24, 16, device="cpu").numpy()
    assert got.tobytes() == np.asarray(jx.alpha_for_variant("base", 9, 24, 16)).tobytes()
    assert tx.alpha_for_variant("hash", 9, 24, 16, device="cpu") is None
    with pytest.raises(ValueError, match="unknown ODL variant"):
        tx.alpha_for_variant("dense", 9, 24, 16, device="cpu")


def test_threefry2x32_known_answer():
    """The Random123 known-answer vector for Threefry-2x32-20 (key and
    counter all ones; the JAX package's threefry tests use it too)."""
    ones = np.array([0xFFFFFFFF], dtype=np.uint32)
    b1, b2 = tx.threefry2x32(0xFFFFFFFF, 0xFFFFFFFF, ones, ones)
    assert (int(b1[0]), int(b2[0])) == (0x1CB996FC, 0xBB002BE7)


def test_hidden_base_builds_alpha_like_the_reference():
    """``hidden(variant="base")`` with no alpha builds the reference's alpha
    (once per device, then cached) and matches the reference's H."""
    from repro.core import oselm as j_oselm
    from repro_torch.core import oselm as t_oselm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((9, 48)).astype(np.float32)
    for act, scale in (("sigmoid", 1.0), ("tanh", 2.5)):
        jcfg = j_oselm.OSELMConfig(n_in=48, n_hidden=32, n_out=4, variant="base", seed=123456,
                                   activation=act, alpha_scale=scale)
        tcfg = t_oselm.OSELMConfig(n_in=48, n_hidden=32, n_out=4, variant="base", seed=123456,
                                   activation=act, alpha_scale=scale)
        want = np.asarray(j_oselm.hidden(jnp.asarray(x), jcfg))
        got = t_oselm.hidden(torch.as_tensor(x), tcfg).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        alpha = t_oselm.make_alpha(tcfg, "cpu")
        assert t_oselm.make_alpha(tcfg, "cpu") is alpha  # cached, not rebuilt
        assert alpha.numpy().tobytes() == np.asarray(j_oselm.make_alpha(jcfg)).tobytes()
    assert t_oselm.make_alpha(tcfg.replace(variant="hash"), "cpu") is None
