"""The v2 binary frame of the JAX package's ``engine/rpc.py``, the port's
own copy: ``[0x02][u32 LE header length][JSON header][raw payload]``, the
header JSON with ``separators=(",", ":")``.  Snapshots travel in it
(``engine/snapshot.py``), byte for byte as the reference writes them; the
port of the teacher transport reuses it."""

from __future__ import annotations

import json

# First byte of every v2 frame.  0x02 (STX) can never start a JSON line, so
# the v1 (JSON lines) and v2 formats coexist on one connection.
WIRE_V2 = 0x02
_WIRE_V2_BYTE = bytes([WIRE_V2])


def _encode_frame(header: dict, payload: bytes = b"") -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return _WIRE_V2_BYTE + len(hdr).to_bytes(4, "little") + hdr + payload
