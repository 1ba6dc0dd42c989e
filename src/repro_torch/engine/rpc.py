"""Teacher transport: the ``stream.Teacher`` protocol over a real TCP socket
(PyTorch counterpart of ``repro/engine/rpc.py``, wire-compatible with it).

``LatencyTeacher`` models the teacher round trip in ticks; this module puts
a real network hop in its place: a label server on the other end of a
socket, wall-clock latency, and timeout -> loss (a reply that misses its
deadline is treated exactly like a lost ticket: the ring entry drains as
``queries_lost``, and a straggler that limps in after its timeout is
discarded, never applied).

Two clients share the transport:

* ``RpcTeacher``: one connection per tenant, one wire message per ask.
* ``BatchedRpcClient`` / ``BatchedRpcTeacher``: one connection per teacher
  host shared by every tenant.  Asks from all tenants that land within a
  flush window (``batch_window_s``, at most ``batch_max`` asks) are framed
  into one request, and the batched reply is demuxed to per-tenant inboxes.
  Each handle speaks the unchanged ``stream.Teacher`` protocol, so a
  ``StreamSession`` cannot tell the transports apart; only the wire can.
  The HMAC handshake runs once per connection, i.e. once per host.

Features on the card.  A session asks with the tick's features as it holds
them: a tensor on the card (a solo session's shipped tick), a CPU tensor,
or a host array (a cohort member's row of the stacked tick).  The session
rewrites those buffers at later ticks, the batched client frames its queue
later on its flush thread, and a reconnect re-asks from its pending map.
So every ``ask`` copies the features into host memory that the ask owns,
on the caller's thread, before it returns (``_host_feats``).  The flush
and reader threads handle numpy only and make no CUDA call; the label
server answers from numpy and never touches the card.

Wire protocol (``engine/wire.py``), the reference's byte for byte: v1
newline JSON (one object per ask and per reply, float lists for the
features), v2 length-prefixed binary frames (one frame per ask, or many asks
in one frame from the batched client; the reply frame mirrors the request
frame), and the 0x03 zlib envelope around one v2 frame (``compress=True``,
answered in kind).  An ask frame carries all S rows (mask, then S × n_in
float32 features), whichever streams query: 36.78 MB per ask at S=16,384,
n_in=561.

Authentication (``secret=``): a mutual shared-secret HMAC challenge and
response on connect, in newline JSON before any framed traffic.  The server
opens with ``{"challenge": <hex nonce>}``; the client answers ``{"auth":
HMAC_SHA256(secret, challenge), "nonce": <hex nonce>}``; the server checks
the digest and answers the client's nonce with ``{"auth_ok":
HMAC_SHA256(secret, nonce)}``.  A wrong or missing digest closes the socket
(an unauthenticated client never receives a label), and a server that
cannot answer the client's nonce is refused before any of its labels can
train the fleet.  Compression is granted in the same exchange
(``"compress": "zlib"`` on the auth line, echoed in ``auth_ok``).

The bundled ``LabelServer`` answers ``label[s] = (7 * tick + s) % n_out``
(``expected_label``), so tests can check exact labels; ``loss_prob`` /
``jitter_s`` / ``delay_s`` inject faults on the reply path.  Run it alone::

    PYTHONPATH=src python -m repro_torch.engine.rpc --port 0 --n-out 6

(``--port 0`` binds an ephemeral port and prints ``PORT <p>``, which
``loopback_server`` parses), or check every round trip::

    PYTHONPATH=src python -m repro_torch.engine.rpc --selftest [--device cpu]

Locks come from ``runtime/lockdebug.py`` under the reference's names, and
the clients' meters go to the port's ``runtime/telemetry.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import hmac
import json
import os
import pathlib
import secrets as secrets_mod
import socket
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.engine.stream import TeacherReply
from repro_torch.engine.wire import (  # noqa: F401  (re-exported: the reference's names)
    WIRE_V2,
    WIRE_V3_ZLIB,
    _compress_frame,
    _encode_frame,
    _iter_wire,
    _shutdown_socket,
    decode_asks,
    decode_replies,
    encode_asks,
    encode_replies,
)
from repro_torch.runtime import lockdebug
from repro_torch.runtime import telemetry as _telemetry

WIRE_FORMATS = ("v1", "v2")

# Batched-client defaults: how long the first queued ask waits for company
# before the frame is flushed, and the per-frame ask cap.
DEFAULT_BATCH_WINDOW_S = 1e-3
DEFAULT_BATCH_MAX = 64


def expected_label(tick: int, s: int, n_out: int) -> int:
    """The deterministic rule ``LabelServer`` answers with."""
    return (7 * tick + s) % n_out


def expected_labels(tick: int, n_streams: int, n_out: int) -> np.ndarray:
    """``expected_label`` for streams ``0..n_streams-1`` as one int32 array."""
    return ((7 * int(tick) + np.arange(n_streams, dtype=np.int64)) % n_out).astype(np.int32)


def _digest(secret: str, challenge: str) -> str:
    return hmac.new(secret.encode(), challenge.encode(), "sha256").hexdigest()


def _host_feats(feats) -> np.ndarray:
    """``feats`` as a float32 numpy array in host memory this call owns.

    A tensor on the card is copied to the host (a blocking copy: the host
    waits for the tick that wrote it), on the caller's thread.  A CPU tensor
    or a host array is copied as well: the caller may rewrite it after
    ``ask`` returns.
    """
    if not torch.is_tensor(feats):
        return np.array(feats, dtype=np.float32)
    return feats.detach().to("cpu", torch.float32, copy=True).numpy()


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------


class LabelServer:
    """Threaded loopback label server (one thread per client connection).

    Answers both wire formats, each request in its own: a v1 JSON line gets
    a v1 JSON line back, a v2 frame (one ask or many) one v2 reply frame
    covering every ask it carried.  ``loss_prob`` drops individual asks from
    the reply (the client's deadline maps them to loss); ``delay_s`` plus a
    uniform ``jitter_s`` sleep before each reply.  Answers from numpy only.
    """

    def __init__(self, port: int = 0, n_out: int = 6, delay_s: float = 0.0,
                 host: str = "127.0.0.1", secret: Optional[str] = None,
                 loss_prob: float = 0.0, jitter_s: float = 0.0, seed: int = 0):
        self.n_out = n_out
        self.delay_s = delay_s
        self.jitter_s = jitter_s
        self.loss_prob = loss_prob
        self.seed = seed
        self.secret = secret
        self.auth_failures = 0  # connections refused by the HMAC handshake
        self.requests_v1 = 0  # v1 JSON-line requests served
        self.frames_v2 = 0  # v2 request frames served (1 frame : N asks)
        self.asks_served = 0  # individual asks across both formats
        self.frame_errors = 0  # undecodable lines / torn v2 frames
        # Compression (zlib envelopes, both directions): wire bytes moved
        # against the raw v2 bytes they stand for.
        self.frames_compressed = 0
        self.compressed_bytes_in = 0
        self.raw_bytes_in = 0
        self.compressed_bytes_out = 0
        self.raw_bytes_out = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(8)
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        # Guards the thread/connection bookkeeping and the public counters:
        # concurrent connection threads must not lose increments.
        self._tlock = lockdebug.make_lock("rpc.LabelServer._tlock")
        self._threads: list[threading.Thread] = []
        self._conns: set[socket.socket] = set()
        self._accepted = 0

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            if self._stop.is_set():  # close()'s wake-up dial, not a client
                with contextlib.suppress(OSError):
                    conn.close()
                break
            with self._tlock:
                # A long-running server accepts unboundedly many connections:
                # dead client threads must not accumulate.
                self._threads = [t for t in self._threads if t.is_alive()]
                self._accepted += 1
                self._conns.add(conn)
                t = threading.Thread(target=self._client, args=(conn, self._accepted),
                                     daemon=True)
                t.start()
                self._threads.append(t)

    def start(self) -> "LabelServer":
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        with self._tlock:
            self._threads.append(t)
        return self

    def thread_count(self) -> int:
        """Live worker threads (accept loop + open connections)."""
        with self._tlock:
            return sum(t.is_alive() for t in self._threads)

    def stats(self) -> dict:
        """Every public counter as one JSON-able dict: what a wire ``stats``
        request returns (``server_stats``)."""
        with self._tlock:
            out = {
                "auth_failures": self.auth_failures,
                "requests_v1": self.requests_v1,
                "frames_v2": self.frames_v2,
                "asks_served": self.asks_served,
                "frame_errors": self.frame_errors,
                "frames_compressed": self.frames_compressed,
                "compressed_bytes_in": self.compressed_bytes_in,
                "raw_bytes_in": self.raw_bytes_in,
                "compressed_bytes_out": self.compressed_bytes_out,
                "raw_bytes_out": self.raw_bytes_out,
                "connections_accepted": self._accepted,
            }
        out["thread_count"] = self.thread_count()
        out["n_out"] = self.n_out
        out["delay_s"] = self.delay_s
        out["jitter_s"] = self.jitter_s
        out["loss_prob"] = self.loss_prob
        return out

    def close(self) -> None:
        """Stop accepting, unblock and join every client thread."""
        self._stop.set()
        # Closing a listening socket does not reliably interrupt accept():
        # dial it once so the accept loop wakes, sees the flag and exits.
        dial_host = "127.0.0.1" if self.host in ("0.0.0.0", "::") else self.host
        with contextlib.suppress(OSError):
            socket.create_connection((dial_host, self.port), timeout=0.5).close()
        with contextlib.suppress(OSError):
            self._sock.close()
        with self._tlock:
            conns = list(self._conns)
            threads = list(self._threads)
        for c in conns:
            _shutdown_socket(c)
        me = threading.current_thread()
        for t in threads:
            if t is not me:
                t.join(timeout=5.0)
        with self._tlock:
            self._threads = [t for t in self._threads if t.is_alive()]

    def _client(self, conn: socket.socket, conn_id: int) -> None:
        # Per-connection fault rng: deterministic given (seed, conn_id), and
        # unshared, so concurrent connections never race it.
        rng = np.random.default_rng((self.seed, conn_id))
        try:
            with conn, conn.makefile("rwb") as f:
                if self.secret is not None and not self._handshake(f):
                    self._count("auth_failures")
                    return  # an unauthenticated connection gets no label
                self._serve_connection(f, rng)
        finally:
            with self._tlock:
                self._conns.discard(conn)

    def _count(self, counter: str, by: int = 1) -> None:
        with self._tlock:
            setattr(self, counter, getattr(self, counter) + by)

    def _serve_connection(self, f, rng) -> None:
        try:
            for kind, obj, payload in _iter_wire(f):
                if kind == "v2":
                    if isinstance(obj, dict) and obj.get("kind") == "stats":
                        # Live counter scrape: answered at once, without the
                        # fault model's sleep.
                        reply = _encode_frame(
                            {"kind": "stats", "payload_len": 0, "stats": self.stats()}, b"")
                        try:
                            f.write(reply)
                            f.flush()
                        except OSError:
                            return
                        continue
                    if not isinstance(obj, dict) or obj.get("kind") != "ask":
                        continue
                    z = obj.pop("_z", None)
                    try:
                        asks = decode_asks(obj, payload)
                    except (KeyError, TypeError, ValueError):
                        self._count("frame_errors")
                        return  # desynchronized: drop the connection
                    self._count("frames_v2")
                    out = encode_replies(self._answer(asks, rng))
                    if z is not None:
                        # Answer a compressed request in kind; meter both
                        # directions.
                        self._count("frames_compressed")
                        self._count("compressed_bytes_in", by=z[0])
                        self._count("raw_bytes_in", by=z[1])
                        raw_len = len(out)
                        out = _compress_frame(out)
                        self._count("compressed_bytes_out", by=len(out))
                        self._count("raw_bytes_out", by=raw_len)
                else:
                    if obj is None or not isinstance(obj, dict):
                        self._count("frame_errors")
                        continue
                    self._count("requests_v1")
                    ask = (int(obj.get("ticket", 0)), int(obj.get("tick", 0)),
                           np.asarray(obj.get("mask", []), bool), None)
                    replies = self._answer([ask], rng)
                    if not replies:
                        continue  # lost: never answered
                    ticket, answered, labels = replies[0]
                    out = (json.dumps({
                        "ticket": ticket,
                        "labels": [int(v) for v in labels],
                        "answered": [bool(v) for v in answered],
                    }) + "\n").encode()
                self._sleep(rng)
                try:
                    f.write(out)
                    f.flush()
                except OSError:
                    return
        except (EOFError, ValueError):
            # The stream died (or a header was corrupt) inside a frame.
            self._count("frame_errors")

    def _answer(self, asks, rng):
        """Labels for each surviving ask: ``[(ticket, answered, labels)]`` (a
        ``loss_prob`` casualty has no entry: it is never answered)."""
        out = []
        self._count("asks_served", by=len(asks))
        for ticket, tick, mask, _feats in asks:
            if self.loss_prob > 0.0 and rng.uniform() < self.loss_prob:
                continue
            out.append((ticket, np.asarray(mask, bool),
                        expected_labels(tick, len(mask), self.n_out)))
        return out

    def _sleep(self, rng) -> None:
        delay = self.delay_s
        if self.jitter_s > 0.0:
            delay += float(rng.uniform(0.0, self.jitter_s))
        if delay > 0.0:
            time.sleep(delay)

    def _handshake(self, f) -> bool:
        """Mutual challenge and response: send a nonce, require its keyed
        digest back (constant-time compare), then prove our knowledge of the
        secret by answering the client's nonce, all before any label."""
        challenge = secrets_mod.token_hex(16)
        try:
            f.write((json.dumps({"challenge": challenge}) + "\n").encode())
            f.flush()
            line = f.readline()
        except OSError:
            return False
        try:
            reply = json.loads(line)
        except ValueError:
            # Not JSON, including a binary v2 frame from a client without a
            # secret (UnicodeDecodeError is a ValueError too).
            return False
        if not isinstance(reply, dict):
            return False
        if not hmac.compare_digest(str(reply.get("auth", "")), _digest(self.secret, challenge)):
            return False
        ok = {"auth_ok": _digest(self.secret, str(reply.get("nonce", "")))}
        if reply.get("compress") == "zlib":
            ok["compress"] = "zlib"  # the grant rides the handshake
        try:
            f.write((json.dumps(ok) + "\n").encode())
            f.flush()
        except OSError:
            return False
        return True


# ---------------------------------------------------------------------------
# Client-side connection plumbing (shared by both clients)
# ---------------------------------------------------------------------------


def _authenticate(sock: socket.socket, wfile, secret: str, compress: bool = False) -> bool:
    """Client half of the mutual HMAC handshake (see the module docstring).
    Raises ``ConnectionError`` (after closing the socket) unless both ends
    prove knowledge of the secret.  ``compress=True`` asks for zlib on the
    auth line; the return value is whether the server granted it."""
    with sock.makefile("rb") as rf:
        try:
            hello = json.loads(rf.readline())
        except (OSError, ValueError):
            hello = None  # silent, closed or garbled server
        if not isinstance(hello, dict) or "challenge" not in hello:
            _shutdown_socket(sock)
            raise ConnectionError(
                "label server sent no auth challenge but a secret is configured; "
                "refusing the unauthenticated connection")
        nonce = secrets_mod.token_hex(16)
        auth_line = {"auth": _digest(secret, hello["challenge"]), "nonce": nonce}
        if compress:
            auth_line["compress"] = "zlib"
        wfile.write((json.dumps(auth_line) + "\n").encode())
        wfile.flush()
        try:
            proof = json.loads(rf.readline())
        except (OSError, ValueError):
            proof = None
    ok = isinstance(proof, dict) and hmac.compare_digest(
        str(proof.get("auth_ok", "")), _digest(secret, nonce))
    if not ok:
        _shutdown_socket(sock)
        raise ConnectionError(
            "label server failed to prove knowledge of the shared secret; "
            "refusing to train on its labels")
    return bool(compress and proof.get("compress") == "zlib")


class _WireConnection:
    """The client side both teachers share: dial and handshake, a buffered
    writer behind a write lock (two threads on one connection must never
    interleave partial frames), wire counters, and poison on failure: a
    write that raises ``OSError`` mid-frame leaves the stream
    desynchronized, so the connection is marked ``broken`` and every later
    send skips the wire (callers map the silence to timeout -> loss)."""

    def __init__(self, host: str, port: int, connect_timeout_s: float,
                 secret: Optional[str], compress: bool = False):
        self.sock = socket.create_connection((host, port), timeout=connect_timeout_s)
        self.wfile = self.sock.makefile("wb")
        # With a handshake, compression is negotiated; without one the
        # caller's request is taken at face value (the server answers
        # envelopes in kind).
        if secret is not None:
            self.compress_granted = _authenticate(self.sock, self.wfile, secret,
                                                  compress=compress)
        else:
            self.compress_granted = bool(compress)
        # connect_timeout_s governed the dial and the handshake; steady-state
        # reads block indefinitely (deadlines are per ticket).
        self.sock.settimeout(None)
        self.wlock = lockdebug.make_lock("rpc._WireConnection.wlock")
        self.broken = False
        self.messages = 0  # request messages actually written
        self.bytes = 0  # request bytes actually written

    def send(self, data: bytes) -> bool:
        """Write one whole frame or line; False when the connection is (or
        just became) dead.  Never writes after a half frame poisoned it."""
        with self.wlock:
            if self.broken:
                return False
            try:
                self.wfile.write(data)
                self.wfile.flush()
            except OSError:
                self.broken = True
                _shutdown_socket(self.sock)
                return False
            self.messages += 1
            self.bytes += len(data)
            return True

    def close(self) -> None:
        # Shut down before taking the write lock: a writer blocked in
        # flush() holds it, and only the shutdown can fail its write.
        _shutdown_socket(self.sock)
        with self.wlock:
            with contextlib.suppress(OSError, ValueError):
                self.wfile.close()


def _reply_reader(sock: socket.socket, handler) -> None:
    """Reader-thread body both teachers share: decode every wire message
    (either format) and hand reply batches to ``handler(replies, arrived)``;
    exits when the socket dies (mid-frame included)."""
    try:
        with sock.makefile("rb") as f:
            for kind, obj, payload in _iter_wire(f):
                replies = _parse_wire_replies(kind, obj, payload)
                if replies:
                    handler(replies, time.monotonic())
    except (OSError, ValueError, EOFError):
        pass  # socket closed, or the stream died mid-frame


def _parse_wire_replies(kind, obj, payload) -> list[TeacherReply]:
    """Replies carried by one wire message, either format (empty when the
    message is not a reply)."""
    if kind == "v2":
        if isinstance(obj, dict) and obj.get("kind") == "reply":
            return decode_replies(obj, payload)
        return []
    if not isinstance(obj, dict) or "ticket" not in obj:
        return []
    return [TeacherReply(ticket=int(obj["ticket"]), labels=np.asarray(obj["labels"], np.int32),
                         answered=np.asarray(obj["answered"], bool))]


# ---------------------------------------------------------------------------
# Per-tenant client (one connection per tenant)
# ---------------------------------------------------------------------------


class RpcTeacher:
    """``stream.Teacher`` over its own TCP socket, with timeout -> loss.

    ``ask`` copies the tick's features to the host (``_host_feats``),
    serializes them with the mask and sends one wire message (v2 binary
    frames by default, ``wire="v1"`` newline JSON).  A reader thread judges
    each reply against its ticket's deadline at arrival and queues the
    survivors in an inbox that ``poll`` drains, so a reply that made its
    deadline is never lost to a late poll.  A ticket unanswered for
    ``timeout_s`` wall seconds leaves ``in_flight()`` and maps to loss; a
    reply past its deadline is dropped at arrival (``timed_out``).  A write
    that fails mid-frame marks the connection dead: later asks skip the
    wire and map straight to timeout -> loss.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 5.0,
                 connect_timeout_s: float = 5.0, secret: Optional[str] = None,
                 wire: str = "v2", compress: bool = False):
        if wire not in WIRE_FORMATS:
            raise ValueError(f"unknown wire format {wire!r}; choose {WIRE_FORMATS}")
        if compress and wire != "v2":
            raise ValueError("compress=True requires the v2 wire format (zlib envelopes carry "
                             "v2 frames; v1 newline JSON has no framing to wrap)")
        self.timeout_s = timeout_s
        self.wire = wire
        self._endpoint = f"{host}:{int(port)}"  # telemetry label only
        # The handshake runs here, synchronously, before the reader thread
        # owns the socket.
        self._conn = _WireConnection(host, port, connect_timeout_s, secret, compress=compress)
        self._lock = lockdebug.make_lock("rpc.RpcTeacher._lock")  # pending map + inbox
        self._next_ticket = 0
        self._pending: dict[int, float] = {}  # ticket -> wall deadline
        self._inbox: list[TeacherReply] = []
        self.timed_out = 0  # tickets whose reply missed (or never made) its deadline
        self._reader = threading.Thread(target=_reply_reader,
                                        args=(self._conn.sock, self._on_replies), daemon=True)
        self._reader.start()

    @property
    def broken(self) -> bool:
        """True once a write failure poisoned the connection."""
        return self._conn.broken

    @property
    def wire_messages(self) -> int:
        return self._conn.messages

    @property
    def wire_bytes(self) -> int:
        return self._conn.bytes

    def sync_telemetry(self, **labels) -> None:
        """Mirror the wire meters into the enabled telemetry registry
        (no-op when telemetry is off)."""
        tel = _telemetry.TELEMETRY
        if tel is None:
            return
        labels.setdefault("endpoint", self._endpoint)
        reg = tel.registry
        reg.set_counter("odl_rpc_wire_messages", self.wire_messages, **labels)
        reg.set_counter("odl_rpc_wire_bytes", self.wire_bytes, **labels)
        with self._lock:
            reg.set_counter("odl_rpc_timed_out", self.timed_out, **labels)

    def _on_replies(self, replies: list[TeacherReply], arrived: float) -> None:
        with self._lock:
            for reply in replies:
                deadline = self._pending.pop(reply.ticket, None)
                if deadline is None:
                    continue  # unknown, or already expired (and counted)
                if arrived > deadline:
                    self.timed_out += 1  # straggler: timeout -> loss
                    continue
                self._inbox.append(reply)

    def ask(self, feats, mask, tick: int) -> int:
        mask_np = np.array(mask, bool)
        feats_np = _host_feats(feats)
        with self._lock:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending[ticket] = time.monotonic() + self.timeout_s
        if self.wire == "v2":
            data = encode_asks([(ticket, int(tick), mask_np, feats_np)])
            if self._conn.compress_granted:
                data = _compress_frame(data)
        else:
            data = (json.dumps({
                "ticket": ticket,
                "tick": int(tick),
                "mask": mask_np.tolist(),
                "feats": feats_np.tolist(),
            }) + "\n").encode()
        # A dead connection leaves the ticket pending until its deadline,
        # then maps it to loss like any other timeout.
        self._conn.send(data)
        return ticket

    def _expire(self) -> None:
        now = time.monotonic()
        with self._lock:
            dead = [t for t, dl in self._pending.items() if dl < now]
            for t in dead:
                del self._pending[t]
                self.timed_out += 1

    def poll(self, tick: int) -> list[TeacherReply]:
        self._expire()  # never-arrived tickets past their deadline -> loss
        with self._lock:
            out, self._inbox = self._inbox, []
        return out

    def in_flight(self) -> int:
        self._expire()
        with self._lock:
            return len(self._pending)

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "RpcTeacher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Batched shared-connection client (one connection per teacher host)
# ---------------------------------------------------------------------------


class BatchedRpcTeacher:
    """One tenant's ``stream.Teacher`` handle over a shared
    ``BatchedRpcClient``: the unchanged protocol, multiplexed with every
    other tenant's traffic onto one connection.  Made by
    ``BatchedRpcClient.tenant()``."""

    def __init__(self, client: "BatchedRpcClient", name: Optional[str] = None):
        self._client = client
        self.name = name
        self._inbox: list[TeacherReply] = []
        self.timed_out = 0  # this tenant's deadline casualties

    def ask(self, feats, mask, tick: int) -> int:
        return self._client._ask(self, feats, mask, tick)

    def poll(self, tick: int) -> list[TeacherReply]:
        return self._client._poll(self)

    def in_flight(self) -> int:
        return self._client._in_flight(self)

    def close(self) -> None:
        """No-op: the shared connection outlives any one tenant; close the
        ``BatchedRpcClient`` when every tenant is done."""

    def __enter__(self) -> "BatchedRpcTeacher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class BatchedRpcClient:
    """One shared connection to one teacher host, multiplexing every
    tenant's asks into batched v2 frames.

    An ask from any handle gets a connection-global ticket, is registered
    with its wall deadline (and its host copy of the features, for a
    re-ask) and queued; the queue is flushed as one framed request when
    ``batch_max`` asks have accumulated or ``batch_window_s`` has passed
    since the first queued ask (a background flusher owns the window;
    ``batch_window_s=0`` flushes inline).  The reader thread demuxes each
    reply to the handle that asked, judging deadlines at arrival, so the
    semantics are those of a per-tenant ``RpcTeacher``; only the number of
    wire messages changes.

    The HMAC handshake runs once per connection.  A dead connection gets one
    metered lazy reconnect at the next flush (``reconnects`` /
    ``asks_reasked``): a fresh dial, handshake and reader, with every
    pending unexpired ticket re-asked through it under its original
    deadline.  If the dial fails, queued and later asks map to timeout ->
    loss until the next poisoning earns its own attempt.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 5.0,
                 connect_timeout_s: float = 5.0, secret: Optional[str] = None,
                 batch_window_s: float = DEFAULT_BATCH_WINDOW_S,
                 batch_max: int = DEFAULT_BATCH_MAX, compress: bool = False):
        if batch_max < 1:
            raise ValueError(f"batch_max must be >= 1, got {batch_max}")
        self.timeout_s = timeout_s
        self.batch_window_s = batch_window_s
        self.batch_max = int(batch_max)
        # Kept for the lazy reconnect.
        self._host, self._port = host, int(port)
        self._connect_timeout_s = connect_timeout_s
        self._secret = secret
        self._compress = bool(compress)
        self._conn = _WireConnection(host, port, connect_timeout_s, secret, compress=compress)
        # Guards the queue, the pending map and the handles' inboxes.
        self._cond = lockdebug.make_condition("rpc.BatchedRpcClient._cond")
        self._closed = False
        self._next_ticket = 0
        # ticket -> (owning handle, wall deadline, (tick, mask, feats));
        # present == in flight.  The payload is the ask's own host copy, kept
        # for a re-ask after a reconnect.
        self._pending: dict[int, tuple[BatchedRpcTeacher, float, tuple]] = {}
        self._queue: list[tuple[int, int, np.ndarray, np.ndarray]] = []  # unflushed asks
        self._flush_deadline: Optional[float] = None
        self._tenants: list[BatchedRpcTeacher] = []
        self._reconnect_lock = lockdebug.make_lock("rpc.BatchedRpcClient._reconnect_lock")
        self._reconnect_spent = False  # the current broken connection's attempt is used
        self.timed_out = 0  # deadline casualties across all tenants
        self.asks_sent = 0  # individual asks across all frames
        self.reconnects = 0  # successful lazy reconnects
        self.asks_reasked = 0  # in-flight asks re-sent after a reconnect
        self._reader = threading.Thread(target=_reply_reader,
                                        args=(self._conn.sock, self._on_replies), daemon=True)
        self._reader.start()
        self._flusher: Optional[threading.Thread] = None
        if self.batch_window_s > 0:
            self._flusher = threading.Thread(target=self._flush_loop, daemon=True)
            self._flusher.start()

    @property
    def broken(self) -> bool:
        return self._conn.broken

    @property
    def wire_messages(self) -> int:
        return self._conn.messages

    @property
    def wire_bytes(self) -> int:
        return self._conn.bytes

    def sync_telemetry(self, **labels) -> None:
        """Mirror this connection's wire meters into the enabled telemetry
        registry (absolute writes); no-op when telemetry is off."""
        tel = _telemetry.TELEMETRY
        if tel is None:
            return
        labels.setdefault("endpoint", f"{self._host}:{self._port}")
        reg = tel.registry
        reg.set_counter("odl_rpc_wire_messages", self.wire_messages, **labels)
        reg.set_counter("odl_rpc_wire_bytes", self.wire_bytes, **labels)
        with self._cond:
            reg.set_counter("odl_rpc_asks_sent", self.asks_sent, **labels)
            reg.set_counter("odl_rpc_timed_out", self.timed_out, **labels)
            reg.set_counter("odl_rpc_reconnects", self.reconnects, **labels)
            reg.set_counter("odl_rpc_asks_reasked", self.asks_reasked, **labels)

    def tenant(self, name: Optional[str] = None) -> BatchedRpcTeacher:
        """A new per-tenant ``stream.Teacher`` handle on this connection."""
        handle = BatchedRpcTeacher(self, name=name)
        with self._cond:
            self._tenants.append(handle)
        return handle

    # -- the Teacher protocol's backend (called through the handles) -------

    def _ask(self, handle: BatchedRpcTeacher, feats, mask, tick: int) -> int:
        mask_np = np.array(mask, bool)
        feats_np = _host_feats(feats)  # on the caller's thread, before the queue
        batch = None
        with self._cond:
            ticket = self._next_ticket
            self._next_ticket += 1
            self._pending[ticket] = (handle, time.monotonic() + self.timeout_s,
                                     (int(tick), mask_np, feats_np))
            self._queue.append((ticket, int(tick), mask_np, feats_np))
            if (len(self._queue) >= self.batch_max or self.batch_window_s <= 0
                    or self._conn.broken):
                batch = self._take_locked()
            else:
                if self._flush_deadline is None:
                    self._flush_deadline = time.monotonic() + self.batch_window_s
                self._cond.notify_all()
        if batch:
            self._send(batch)
        return ticket

    def _poll(self, handle: BatchedRpcTeacher) -> list[TeacherReply]:
        self._expire()
        with self._cond:
            out, handle._inbox = handle._inbox, []
        return out

    def _in_flight(self, handle: BatchedRpcTeacher) -> int:
        self._expire()
        with self._cond:
            return sum(1 for ent in self._pending.values() if ent[0] is handle)

    # -- internals ---------------------------------------------------------

    def _take_locked(self):  # odlint: holds-lock(_cond)
        """Take up to ``batch_max`` queued asks (the caller holds _cond)."""
        batch = self._queue[: self.batch_max]
        self._queue = self._queue[self.batch_max:]
        self._flush_deadline = time.monotonic() + self.batch_window_s if self._queue else None
        return batch

    def _flush_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and self._flush_deadline is None:
                    self._cond.wait()
                if self._closed:
                    return
                now = time.monotonic()
                if self._flush_deadline > now:
                    # Wait out the window (new asks may fill batch_max and
                    # flush inline first: re-check on wake).
                    self._cond.wait(timeout=self._flush_deadline - now)
                    continue
                batch = self._take_locked()
            if batch:
                self._send(batch)

    def _send(self, batch) -> None:
        if self._conn.broken:
            # One lazy reconnect per poisoned connection.  On success every
            # pending unexpired ticket, this batch's included, is re-asked
            # through the fresh connection; on failure the tickets stay
            # pending until their deadlines, then map to loss.
            self._reconnect_and_reask()
            return
        tel = _telemetry.TELEMETRY
        tok = tel.tracer.begin("rpc.flush") if tel is not None else None
        sent = self._conn.send(self._frame(batch))
        if sent:
            with self._cond:
                self.asks_sent += len(batch)
        if tok is not None:
            tel.tracer.end(tok, asks=len(batch), sent=sent)
            tel.registry.observe("odl_rpc_batch_occupancy", len(batch))

    def _frame(self, batch) -> bytes:
        data = encode_asks(batch)
        # The grant of the *current* connection: a reconnect renegotiates.
        if self._conn.compress_granted:
            data = _compress_frame(data)
        return data

    def _reconnect_and_reask(self) -> None:
        with self._reconnect_lock:
            if self._closed:
                return  # nobody is left to consume the replies
            if not self._conn.broken:
                return  # another thread already swapped in a live connection
            if self._reconnect_spent:
                return  # this poisoning's single attempt is used up
            self._reconnect_spent = True
            try:
                conn = _WireConnection(self._host, self._port, self._connect_timeout_s,
                                       self._secret, compress=self._compress)
            except OSError:
                return
            old, self._conn = self._conn, conn
            threading.Thread(target=_reply_reader, args=(conn.sock, self._on_replies),
                             daemon=True).start()
            old.close()
            tel = _telemetry.TELEMETRY
            if tel is not None:
                tel.tracer.event("rpc.reconnect", endpoint=f"{self._host}:{self._port}")
            with self._cond:
                self.reconnects += 1
                self._reconnect_spent = False  # a later poisoning earns its own attempt
                # Every pending ticket's frame died with the old socket or
                # was answered on it after it went half-dead: its reply can
                # now only come through a re-ask, under its original deadline.
                now = time.monotonic()
                resend = [(t, *payload) for t, (_, dl, payload) in sorted(self._pending.items())
                          if dl >= now]
            for i in range(0, len(resend), self.batch_max):
                chunk = resend[i:i + self.batch_max]
                if self._conn.send(self._frame(chunk)):
                    with self._cond:
                        self.asks_sent += len(chunk)
                        self.asks_reasked += len(chunk)

    def _on_replies(self, replies: list[TeacherReply], arrived: float) -> None:
        with self._cond:
            for reply in replies:
                ent = self._pending.pop(reply.ticket, None)
                if ent is None:
                    continue  # unknown or already expired
                handle, deadline = ent[0], ent[1]
                if arrived > deadline:
                    handle.timed_out += 1
                    self.timed_out += 1
                    continue
                handle._inbox.append(reply)

    def _expire(self) -> None:
        now = time.monotonic()
        with self._cond:
            dead = [t for t, ent in self._pending.items() if ent[1] < now]
            for t in dead:
                handle = self._pending.pop(t)[0]
                handle.timed_out += 1
                self.timed_out += 1

    def close(self) -> None:
        with self._cond:
            self._closed = True
            batch = self._take_locked() if self._queue else None
            self._cond.notify_all()
        if batch:
            self._send(batch)  # best effort: do not strand queued asks
        if self._flusher is not None:
            self._flusher.join(timeout=2.0)
        self._conn.close()

    def __enter__(self) -> "BatchedRpcClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def server_stats(host: str, port: int, secret: Optional[str] = None,
                 timeout_s: float = 5.0) -> dict:
    """Scrape a running ``LabelServer``'s counters over the wire: a fresh
    connection (with the HMAC handshake when a secret is set), one v2
    ``{"kind": "stats"}`` frame, and the server's counter dict back."""
    sock = socket.create_connection((host, port), timeout=timeout_s)
    try:
        wfile = sock.makefile("wb")
        if secret is not None:
            _authenticate(sock, wfile, secret)
        wfile.write(_encode_frame({"kind": "stats", "payload_len": 0}, b""))
        wfile.flush()
        with sock.makefile("rb") as rf:
            for kind, obj, _payload in _iter_wire(rf):
                if kind == "v2" and isinstance(obj, dict) and obj.get("kind") == "stats":
                    return dict(obj.get("stats") or {})
    finally:
        _shutdown_socket(sock)
    raise ConnectionError("label server closed the connection without answering the stats "
                          "request")


# ---------------------------------------------------------------------------
# Loopback subprocess helper
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def loopback_server(n_out: int = 6, delay_s: float = 0.0, secret: Optional[str] = None,
                    loss_prob: float = 0.0, jitter_s: float = 0.0):
    """Spawn ``python -m repro_torch.engine.rpc`` as a subprocess label
    server on an ephemeral loopback port; yields ``(host, port)`` and stops
    the process on exit.  The child sees no CUDA device: it answers from
    numpy and must start while the parent holds the card."""
    src_root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    cmd = [sys.executable, "-m", "repro_torch.engine.rpc", "--port", "0",
           "--n-out", str(n_out), "--delay-ms", str(int(delay_s * 1000)),
           "--loss-prob", str(loss_prob), "--jitter-ms", str(int(jitter_s * 1000))]
    if secret is not None:
        cmd += ["--secret", secret]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, env=env, text=True)
    try:
        line = proc.stdout.readline()
        if not line.startswith("PORT "):
            raise RuntimeError(f"label server failed to start: {line!r}")
        yield "127.0.0.1", int(line.split()[1])
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()


def _selftest(device) -> int:
    """Round trips over subprocess loopback servers: v2 and v1 per-tenant
    clients, the batched client with two tenants in one frame, zlib
    envelopes against an in-process server, then HMAC auth and an
    unauthenticated client against a secured server (which must get
    nothing).  The features are tensors on ``device``."""
    from repro_torch import resolve_device

    device = resolve_device(device)
    s, n_out = 4, 6
    feats = torch.zeros((s, 3), dtype=torch.float32, device=device)
    mask = np.ones((s,), bool)

    def drain(teacher, timeout=10.0):
        deadline = time.monotonic() + timeout
        replies = []
        while not replies and time.monotonic() < deadline:
            replies = teacher.poll(0)
            if not replies and teacher.in_flight() == 0:
                replies = teacher.poll(0)
                break
            time.sleep(0.01)
        return replies

    def roundtrip(host, port, secret=None, timeout_s=10.0, wire="v2"):
        with RpcTeacher(host, port, timeout_s=timeout_s, secret=secret, wire=wire) as teacher:
            ticket = teacher.ask(feats, mask, tick=3)
            return ticket, drain(teacher, timeout=min(timeout_s, 10.0))

    want = expected_labels(3, s, n_out).tolist()
    with loopback_server(n_out=n_out) as (host, port):
        for wire in WIRE_FORMATS:
            ticket, replies = roundtrip(host, port, wire=wire)
            assert replies and replies[0].ticket == ticket, f"no {wire} reply"
            assert replies[0].labels.tolist() == want, (wire, replies[0].labels)
        with BatchedRpcClient(host, port, timeout_s=10.0, batch_window_s=0.2) as client:
            a, b = client.tenant("a"), client.tenant("b")
            a.ask(feats, mask, tick=3)
            b.ask(feats, mask, tick=3)
            ra, rb = drain(a), drain(b)
            assert ra and ra[0].labels.tolist() == want, "batched tenant a"
            assert rb and rb[0].labels.tolist() == want, "batched tenant b"
            assert client.wire_messages == 1 and client.asks_sent == 2, (
                client.wire_messages, client.asks_sent)
    s_z = 64
    feats_z = torch.zeros((s_z, 8), dtype=torch.float32, device=device)
    want_z = expected_labels(3, s_z, n_out).tolist()
    server = LabelServer(port=0, n_out=n_out).start()
    try:
        with RpcTeacher("127.0.0.1", server.port, timeout_s=10.0, compress=True) as teacher:
            ticket = teacher.ask(feats_z, np.ones((s_z,), bool), tick=3)
            replies = drain(teacher)
            assert replies and replies[0].ticket == ticket, "no zlib reply"
            assert replies[0].labels.tolist() == want_z, replies[0].labels
        assert server.frames_compressed == 1, server.frames_compressed
        assert server.raw_bytes_in > server.compressed_bytes_in > 0, (
            server.raw_bytes_in, server.compressed_bytes_in)
        assert server.raw_bytes_out >= server.compressed_bytes_out > 0, (
            server.raw_bytes_out, server.compressed_bytes_out)
    finally:
        server.close()
    with loopback_server(n_out=n_out, secret="s3cr3t") as (host, port):
        ticket, replies = roundtrip(host, port, secret="s3cr3t")
        assert replies and replies[0].labels.tolist() == want, "auth roundtrip"
        # Unauthenticated client: the server closes the connection; the ask
        # times out into loss and no label arrives.
        _, replies = roundtrip(host, port, secret=None, timeout_s=0.5)
        assert not replies, "unauthenticated client must receive nothing"
    # odlint: disable=ODL005 -- CLI selftest result line, not library code
    print(f"rpc selftest OK on {device} (v1 + v2 + zlib + batched + hmac + reject): {want}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--n-out", type=int, default=6)
    ap.add_argument("--delay-ms", type=int, default=0,
                    help="server-side per-request delay (timeout testing)")
    ap.add_argument("--jitter-ms", type=int, default=0,
                    help="extra uniform per-reply delay in [0, J] ms")
    ap.add_argument("--loss-prob", type=float, default=0.0,
                    help="share of asks never answered (the client's deadline maps them "
                         "to loss)")
    ap.add_argument("--secret", default=None,
                    help="shared secret: require the HMAC handshake on every connection")
    ap.add_argument("--selftest", action="store_true",
                    help="spawn loopback servers and round-trip asks through every client")
    ap.add_argument("--device", default=None,
                    help="--selftest: where the asked features live (CUDA unless named)")
    args = ap.parse_args(argv)
    if args.selftest:
        return _selftest(args.device)
    server = LabelServer(port=args.port, n_out=args.n_out, delay_s=args.delay_ms / 1000.0,
                         secret=args.secret, loss_prob=args.loss_prob,
                         jitter_s=args.jitter_ms / 1000.0)
    # odlint: disable=ODL005 -- CLI contract: launchers parse this PORT line
    print(f"PORT {server.port}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
