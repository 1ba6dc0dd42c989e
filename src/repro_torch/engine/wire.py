"""The teacher transport's wire formats, the port's own copy of the JAX
package's framing in ``engine/rpc.py``, byte for byte:

* **v2 frame**: ``[0x02][u32 LE header length][JSON header][raw payload]``,
  the header JSON with ``separators=(",", ":")``.  Snapshots travel in it
  (``engine/snapshot.py``), and so do the teacher's asks and replies.
* **v1 line**: one newline-terminated JSON object (the legacy teacher wire).
* **zlib envelope**: ``[0x03][u32 LE compressed length][zlib stream]`` whose
  decompressed bytes are one whole v2 frame (``ZLIB_LEVEL`` 1: speed over
  ratio, the payloads are feature blocks at tick rate).

The ask/reply codec: an ask frame carries, per ask, ``mask`` (S × uint8)
then ``feats`` (S·n_in × float32 LE); a reply frame ``answered`` (S ×
uint8) then ``labels`` (S × int32 LE).  The encoders take host arrays; the
caller copies a tensor on the card to host memory before it gets here
(``engine/rpc.py``).
"""

from __future__ import annotations

import contextlib
import json
import socket
import zlib

import numpy as np

from repro_torch.engine.stream import TeacherReply

# First byte of every v2 frame.  0x02 (STX) can never start a JSON line, so
# the v1 (JSON lines) and v2 formats coexist on one connection.
WIRE_V2 = 0x02
_WIRE_V2_BYTE = bytes([WIRE_V2])

# First byte of a zlib envelope around one v2 frame.
WIRE_V3_ZLIB = 0x03
_WIRE_V3_BYTE = bytes([WIRE_V3_ZLIB])

ZLIB_LEVEL = 1


def _encode_frame(header: dict, payload: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return _WIRE_V2_BYTE + len(hdr).to_bytes(4, "little") + hdr + payload


def _compress_frame(frame: bytes) -> bytes:
    """Wrap one complete v2 frame in a zlib envelope (wire byte 0x03)."""
    z = zlib.compress(frame, ZLIB_LEVEL)
    return _WIRE_V3_BYTE + len(z).to_bytes(4, "little") + z


def _shutdown_socket(sock: socket.socket) -> None:
    """Tear a connection down for real: ``close()`` alone drops one
    reference, and ``makefile()`` readers keep the fd (and the peer's
    blocking ``recv``) alive; ``shutdown`` sends the FIN regardless,
    unblocking both ends' readers."""
    with contextlib.suppress(OSError):
        sock.shutdown(socket.SHUT_RDWR)
    with contextlib.suppress(OSError):
        sock.close()


def _read_exact(f, n: int) -> bytes:
    buf = f.read(n)
    if buf is None or len(buf) != n:
        raise EOFError(f"stream ended inside a frame (wanted {n} bytes, "
                       f"got {0 if buf is None else len(buf)})")
    return buf


def _iter_wire(f):
    """Yield every message on a buffered binary stream, either format.

    Yields ``("v2", header, payload)`` for binary frames and ``("v1",
    obj_or_None, raw_line)`` for JSON lines (``None`` when the line does not
    parse).  A zlib envelope is unwrapped here and yielded as the v2 frame
    it holds, with ``header["_z"] = (wire_bytes, raw_bytes)`` so a server
    can meter compression and answer in kind.  Ends cleanly on EOF between
    messages; raises ``EOFError`` (or ``ValueError`` for a corrupt header or
    envelope) when the stream dies inside a frame: a torn frame
    desynchronizes everything after it, so the caller drops the connection.
    """
    while True:
        b = f.read(1)
        if not b:
            return
        if b[0] == WIRE_V3_ZLIB:
            zlen = int.from_bytes(_read_exact(f, 4), "little")
            try:
                inner = zlib.decompress(_read_exact(f, zlen))
            except zlib.error as e:
                raise ValueError(f"corrupt zlib envelope: {e}") from e
            if not inner or inner[0] != WIRE_V2:
                raise ValueError("zlib envelope does not contain a v2 frame")
            hlen = int.from_bytes(inner[1:5], "little")
            header = json.loads(inner[5 : 5 + hlen].decode())
            if not isinstance(header, dict):
                raise ValueError(f"v2 frame header is not an object: {header!r}")
            payload = inner[5 + hlen :]
            if len(payload) != int(header.get("payload_len", 0)):
                raise ValueError("zlib envelope payload length mismatch")
            header["_z"] = (5 + zlen, len(inner))
            yield "v2", header, payload
        elif b[0] == WIRE_V2:
            hlen = int.from_bytes(_read_exact(f, 4), "little")
            header = json.loads(_read_exact(f, hlen).decode())
            if not isinstance(header, dict):
                # Valid JSON but not an object: without payload_len the frame
                # boundary is unknowable, so it is corrupt like a torn frame.
                raise ValueError(f"v2 frame header is not an object: {header!r}")
            payload = _read_exact(f, int(header.get("payload_len", 0)))
            yield "v2", header, payload
        else:
            line = b + f.readline()
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                obj = None
            yield "v1", obj, line


def encode_asks(asks) -> bytes:
    """One v2 request frame from ``[(ticket, tick, mask, feats), ...]`` of
    host arrays.  Header spec per ask: ``t`` ticket, ``k`` tick, ``s``
    streams, ``d`` n_in; payload per ask: mask (S × uint8) then feats (S·d ×
    float32 LE)."""
    specs, chunks = [], []
    for ticket, tick, mask, feats in asks:
        mask8 = np.ascontiguousarray(np.asarray(mask), dtype=np.uint8)
        f32 = np.ascontiguousarray(np.asarray(feats), dtype="<f4")
        s = int(mask8.shape[0])
        specs.append({"t": int(ticket), "k": int(tick), "s": s,
                      "d": int(f32.size // s) if s else 0})
        chunks += [mask8.tobytes(), f32.tobytes()]
    payload = b"".join(chunks)
    return _encode_frame({"kind": "ask", "payload_len": len(payload), "asks": specs}, payload)


def decode_asks(header: dict, payload: bytes):
    """Inverse of ``encode_asks``: ``[(ticket, tick, mask, feats), ...]``."""
    out, off = [], 0
    for spec in header["asks"]:
        s, d = int(spec["s"]), int(spec["d"])
        mask = np.frombuffer(payload, np.uint8, s, off).astype(bool)
        off += s
        feats = np.frombuffer(payload, "<f4", s * d, off).reshape(s, d)
        off += s * d * 4
        out.append((int(spec["t"]), int(spec["k"]), mask, feats))
    return out


def encode_replies(replies) -> bytes:
    """One v2 reply frame from ``[(ticket, answered, labels), ...]``."""
    specs, chunks = [], []
    for ticket, answered, labels in replies:
        a8 = np.ascontiguousarray(np.asarray(answered), dtype=np.uint8)
        l32 = np.ascontiguousarray(np.asarray(labels), dtype="<i4")
        specs.append({"t": int(ticket), "s": int(a8.shape[0])})
        chunks += [a8.tobytes(), l32.tobytes()]
    payload = b"".join(chunks)
    return _encode_frame({"kind": "reply", "payload_len": len(payload), "replies": specs},
                         payload)


def decode_replies(header: dict, payload: bytes) -> list[TeacherReply]:
    """Inverse of ``encode_replies``: ``[TeacherReply, ...]``."""
    out, off = [], 0
    for spec in header["replies"]:
        s = int(spec["s"])
        answered = np.frombuffer(payload, np.uint8, s, off).astype(bool)
        off += s
        labels = np.frombuffer(payload, "<i4", s, off).astype(np.int32)
        off += s * 4
        out.append(TeacherReply(ticket=int(spec["t"]), labels=labels, answered=answered))
    return out
