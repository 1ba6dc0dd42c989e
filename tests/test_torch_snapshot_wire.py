"""The port's snapshot wire codec (``repro_torch.engine.snapshot.
encode_snapshot`` / ``decode_snapshot``), mirroring
``tests/test_snapshot_wire.py`` test for test: a full session snapshot tree
encoded to one v2 binary frame and decoded back is bitwise identical, and
truncated, corrupted, mis-versioned or foreign frames are rejected loudly.
Byte equality with the JAX package's frames is checked in
``tests/test_torch_snapshot_interop.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import engine  # noqa: E402
from repro_torch.core import drift as drift_mod  # noqa: E402
from repro_torch.core import oselm, pruning  # noqa: E402
from repro_torch.engine import snapshot, stream, wire  # noqa: E402


def _cfg():
    return engine.EngineConfig(
        elm=oselm.OSELMConfig(n_in=24, n_hidden=16, n_out=4, variant="hash", ridge=1e-2),
        prune=pruning.PruneConfig(min_trained=1_000_000),
        drift=drift_mod.DriftConfig(),
    )


def _assert_trees_bitwise(a, b, path=""):
    if isinstance(a, (dict, list, tuple)):
        # Container structure must match exactly; leaves compare as arrays
        # (a python/numpy scalar decodes as its 0-d array, exactly like the
        # np.save/np.load checkpoint path).
        assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{path}: keys differ"
        for k in a:
            _assert_trees_bitwise(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length differs"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_bitwise(x, y, f"{path}[{i}]")
    else:
        xa, xb = np.asarray(a), np.asarray(b)
        assert xa.dtype == xb.dtype, f"{path}: dtype {xa.dtype} != {xb.dtype}"
        assert xa.shape == xb.shape, f"{path}: shape {xa.shape} != {xb.shape}"
        assert xa.tobytes() == xb.tobytes(), f"{path}: bytes differ"


def test_roundtrip_all_leaf_dtypes():
    """Every dtype a snapshot tree carries (floats, ints, bools and the 0-d
    unicode JSON meta leaf) survives bitwise."""
    tree = {
        "meta": np.asarray('{"v": 1, "t": 17}'),  # 0-d <U17
        "f32": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
        "f64": np.array([np.pi, -0.0, np.inf], np.float64),
        "i32": np.arange(-3, 3, dtype=np.int32),
        "i64": np.array([2**40, -(2**40)], np.int64),
        "u8": np.arange(256, dtype=np.uint8),
        "bool": np.array([True, False, True]),
        "scalar": np.float32(0.25),
        "nested": {"ring": [np.zeros((2, 2), np.float32),
                            (np.int32(7), np.ones(3, bool))]},
        "empty": np.zeros((0, 4), np.float32),
    }
    out = snapshot.decode_snapshot(snapshot.encode_snapshot(tree))
    _assert_trees_bitwise(tree, out)
    # NaN payloads survive too (checksums compare bytes, not values).
    nan_tree = {"x": np.array([np.nan, 1.0], np.float32)}
    out = snapshot.decode_snapshot(snapshot.encode_snapshot(nan_tree))
    assert np.isnan(out["x"][0]) and out["x"][1] == 1.0


def test_roundtrip_real_session_snapshot():
    """A live mid-stream session's full snapshot tree (state, pending ring,
    teacher RNG, stats) roundtrips bitwise over the wire."""
    cfg = _cfg()
    rng = np.random.default_rng(3)
    teacher = stream.LatencyTeacher(
        label_fn=lambda tick, feats: rng.integers(0, 4, size=np.asarray(feats).shape[0]),
        latency=2, jitter=2, loss_prob=0.2, seed=5,
    )
    sess = stream.StreamSession(
        engine.init_fleet(cfg, 4, "cpu"), cfg, teacher, mode="train_phase",
        capacity=4, backpressure="coalesce",
    )
    xs = np.tanh(rng.normal(size=(40, 4, 24))).astype(np.float32)
    sess.start(xs[0])
    for x in xs[1:]:
        sess.advance(x)
    tree = sess.snapshot()
    frame = snapshot.encode_snapshot(tree)
    assert isinstance(frame, bytes) and frame[0] == wire.WIRE_V2
    _assert_trees_bitwise(tree, snapshot.decode_snapshot(frame))
    # In-flight ring state really was mid-flight (the interesting case).
    assert len(sess.ring) > 0


def test_truncated_frame_rejected():
    frame = snapshot.encode_snapshot({"a": np.arange(8, dtype=np.float32)})
    for cut in (0, 3, 5, len(frame) // 2, len(frame) - 1):
        with pytest.raises(EOFError):
            snapshot.decode_snapshot(frame[:cut])


def test_corrupt_payload_rejected_by_checksum():
    frame = bytearray(snapshot.encode_snapshot({"w": np.ones((4, 4), np.float32)}))
    frame[-1] ^= 0xFF  # flip one payload byte
    with pytest.raises(ValueError, match="checksum"):
        snapshot.decode_snapshot(bytes(frame))
    # The error names the leaf so the operator knows what rotted.
    with pytest.raises(ValueError, match="'w'"):
        snapshot.decode_snapshot(bytes(frame))


def test_corrupt_header_rejected():
    frame = bytearray(snapshot.encode_snapshot({"a": np.zeros(2, np.float32)}))
    frame[7] ^= 0xFF  # inside the JSON header
    with pytest.raises((ValueError, EOFError)):
        snapshot.decode_snapshot(bytes(frame))


def test_version_byte_mismatch_rejected():
    frame = bytearray(snapshot.encode_snapshot({"a": np.zeros(2, np.float32)}))
    frame[0] = 0x01  # v1 frame byte on a snapshot frame
    with pytest.raises(ValueError, match="version byte"):
        snapshot.decode_snapshot(bytes(frame))


def test_wrong_frame_kind_rejected():
    """A well-formed v2 frame that is not a snapshot (e.g. an RPC teacher
    frame) is refused, not misparsed."""
    frame = wire._encode_frame({"kind": "ask", "payload_len": 4}, b"\0\0\0\0")
    with pytest.raises(ValueError):
        snapshot.decode_snapshot(frame)
