"""Durable sessions: full-fidelity snapshot/restore of a live StreamSession
(PyTorch counterpart of ``repro/engine/snapshot.py``).

Learned state is paid for: every teacher query costs communication energy,
so a crash that discards a tenant's trained ``beta``/``P`` throws real
joules away.  ``capture`` serializes everything a ``StreamSession``
(``engine/stream.py``) needs to continue exactly where it stopped:

  * the ``EngineState`` (elm / prune ladder / drift detector / comm meter,
    every leaf bit for bit through host numpy);
  * the ``PendingRing`` contents, each entry with its plan-time
    ``PlanOutput`` context, its raw features (so a fresh teacher can be
    *re-asked*) and its ticket id;
  * backpressure-policy state: ``block``'s deferred asks and, through the
    ring entries' ``queried`` masks, ``coalesce``'s merge map;
  * ``StreamStats`` counters and the latency windows;
  * the in-flight (planned, not yet asked) tick's features and plan;
  * the tick-source cursor (``ticks_consumed``); and
  * the teacher's own state when it supports it (``snapshot_state`` /
    ``restore_snapshot``; ``LatencyTeacher`` does).

The tree is the JAX package's: the same leaf paths, dtypes (int32
counters, bool ``drift.active``, f32 meter, P and beta) and meta JSON, so a
snapshot captured by either package restores in the other, and
``encode_snapshot`` of one numpy tree gives the same bytes in both.

On the card ``StreamSession.state`` is a view of the session's *current*
ping-pong buffers (``stream._StateBuffers``), which the next replays
overwrite; the ring's plans and shipped ticks are tensors on the card.
``capture`` therefore copies every leaf into host memory the tree owns
(``checkpoint.to_host``): ``.cpu()`` runs on the compute stream after the
replay that wrote the leaf.  On the CPU the same hazard is aliasing
(``tensor.numpy()`` shares the buffer), so CPU leaves are copied too.  A
cohort member's plans are ``PlanSlice`` row views; capture materializes
their rows.

``restore`` rebuilds the session on an explicit device (CUDA unless the
caller names one; never the CPU by default): the state is put there, the
session builds its own buffers and captures its graphs on its first tick,
and the ring's, the deferred asks' and the pending tick's features go
through the session's ``ship``, whose copies the compute stream waits for.

Restore guarantee: with a snapshot-capable deterministic teacher, a session
snapshotted at tick k and restored elsewhere replays the exact op sequence
of the uninterrupted run: final state, outputs and accounting are bit for
bit identical (``tests/test_torch_snapshot.py`` for every backpressure
policy; ``chip_smoke.py`` phase 6g on the card).  With a teacher that
cannot be snapshot, the in-flight ring entries are re-asked through the
fresh teacher (``pending="reask"``, metered as ``tickets_reasked``) or
dropped (``pending="drop"``, metered as lost); the accounting identity
holds either way.

Published atomically through ``runtime/checkpoint.py``.
``engine/durable.py`` drives a single durable session; the multiplexer
(``engine/multiplex.py``) wires per-tenant snapshots, resume and live
migration on top.  ``capture`` is one ``snapshot.save`` telemetry span and
``restore`` one ``snapshot.restore`` span (``runtime/telemetry.py``).  The
load signals (``tick_rate_ema``, ``ring_occupancy_hwm``) ride the snapshot;
the registry and the trace ring are process-local and never do.
"""

from __future__ import annotations

import dataclasses
import json
import time
import zlib
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch import convert, resolve_device
from repro_torch.engine import fleet, stream, wire
from repro_torch.engine.types import EngineConfig, EngineState
from repro_torch.runtime import checkpoint as ckpt_mod
from repro_torch.runtime import telemetry as _telemetry
from repro_torch.runtime.checkpoint import to_host

SNAPSHOT_VERSION = 1

# Wire-format version of encode_snapshot/decode_snapshot frames, bumped
# independently of SNAPSHOT_VERSION (which versions the tree's semantics).
SNAPSHOT_WIRE_VERSION = 1

# How a restore handles ring entries whose teacher state could not come
# along: re-ask them through the fresh teacher, drop them (metered as
# lost), or pick automatically (restore the teacher when it supports
# snapshots, re-ask otherwise).
PENDING_POLICIES = ("auto", "reask", "drop")

_STATE_GROUPS = ("elm", "prune", "drift", "meter")


def config_to_dict(cfg) -> dict:
    """The reference's name for ``convert.config_to_dict`` (its worker and
    router call it): an ``EngineConfig`` of either package as a nested dict."""
    return convert.config_to_dict(cfg)


def config_from_dict(d: dict) -> EngineConfig:
    """The reference's name for ``convert.engine_config_from_dict``."""
    return convert.engine_config_from_dict(d)


# ---------------------------------------------------------------------------
# State and plans <-> numpy trees (CheckpointManager restores dicts and
# lists, not NamedTuples, so leaves go by field name)
# ---------------------------------------------------------------------------


def _np_tree(nt) -> dict:
    """NamedTuple (or ``PlanSlice``) of tensors -> {field: host array the
    tree owns}."""
    return {k: to_host(v) for k, v in nt._asdict().items()}


def state_to_tree(state: EngineState) -> dict:
    return {g: _np_tree(getattr(state, g)) for g in _STATE_GROUPS}


def state_from_tree(tree: dict, device: str | torch.device | None = None) -> EngineState:
    """The state of a tree as tensors on ``device`` (CUDA unless named)."""
    return convert.engine_state_from_numpy(
        {f"{g}.{k}": v for g in _STATE_GROUPS for k, v in tree[g].items()}, device)


def _plan_to_tree(p) -> dict:
    return _np_tree(p)


def _plan_from_tree(d: dict, device: torch.device) -> fleet.PlanOutput:
    return fleet.PlanOutput(
        **{k: torch.as_tensor(np.array(d[k]), device=device) for k in fleet.PlanOutput._fields}
    )


def _meta_leaf(meta: dict) -> np.ndarray:
    # One 0-d unicode leaf: np.save/np.load round-trips it without pickle,
    # and arbitrary-precision ints (the PCG64 state) survive via JSON.
    return np.asarray(json.dumps(meta))


def _meta_of(tree: dict) -> dict:
    return json.loads(np.asarray(tree["meta"]).item())


# ---------------------------------------------------------------------------
# Resumable tick sources (the "tick-source cursor" of a snapshot)
# ---------------------------------------------------------------------------


class ResumableTicks:
    """Tick source with a cursor: ``factory(start)`` builds an iterator
    positioned at tick ``start``.  The cursor counts ticks yielded, is
    recorded in every snapshot (``ticks_consumed``), and ``seek`` repoints
    the source for resume."""

    def __init__(self, factory: Callable[[int], Iterable], start: int = 0):
        self.factory = factory
        self.cursor = start
        self._it = None

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = iter(self.factory(self.cursor))
        x = next(self._it)  # StopIteration propagates to the caller
        self.cursor += 1
        return x

    def seek(self, tick: int) -> "ResumableTicks":
        self._it = None
        self.cursor = int(tick)
        return self


def array_ticks(xs) -> ResumableTicks:
    """Resumable view of a materialized (T, S, n_in) numpy array, tensor (on
    any device) or list of per-tick arrays: seek is an index."""

    def factory(start):
        for t in range(start, len(xs)):
            yield xs[t]

    return ResumableTicks(factory)


def seek_ticks(ticks, consumed: int) -> None:
    """Reposition a tick source at ``consumed`` ticks for resume; raises if
    the source is a plain iterator."""
    seek = getattr(ticks, "seek", None)
    if seek is None:
        raise ValueError(
            "resume needs a seekable tick source (snapshot.ResumableTicks "
            f"or an object with .seek), got {type(ticks).__name__}"
        )
    seek(consumed)


# ---------------------------------------------------------------------------
# Capture
# ---------------------------------------------------------------------------


def _entry_tree(ent) -> dict:
    return {
        "tick": np.asarray(ent.tick, np.int64),
        "queried": np.asarray(ent.queried, bool),
        "x": to_host(ent.x),
        "plan": _plan_to_tree(ent.plan),
    }


def capture(sess: "stream.StreamSession") -> dict:
    """Serialize a live session to a tree of host numpy leaves + JSON meta.

    The session keeps running afterwards: capture only reads, and every
    leaf is a copy the tree owns (see the module docstring).  Wall time
    elapsed so far is folded into the captured ``wall_s``; the load signals
    (``tick_rate_ema``, ``ring_occupancy_hwm``) ride the meta ``stats``.
    """
    if sess._finished:
        raise RuntimeError("cannot snapshot a finished session")
    if sess.live is not None:
        raise ValueError("a session with dead padding rows (live < S) cannot be snapshot: "
                         "the snapshot format does not carry live")
    tel = _telemetry.TELEMETRY
    tok = tel.tracer.begin("snapshot.save") if tel is not None else None
    stats = sess.stats
    wall_s = stats.wall_s
    if sess._t_start is not None:
        wall_s += time.perf_counter() - sess._t_start
    counters = {
        f.name: getattr(stats, f.name)
        for f in dataclasses.fields(stream.StreamStats)
        if f.name not in ("tick_ms", "label_latency_ticks", "wall_s")
    }
    state = sess.state
    meta = {
        "version": SNAPSHOT_VERSION,
        "t": sess.t,
        "mode": sess.mode,
        "backpressure": sess.backpressure,
        "capacity": sess.ring.capacity,
        "collect": sess.collect,
        "donate": sess._donate,
        "started": sess.started(),
        "has_pending": sess._p is not None,
        "ticks_consumed": sess.t + (1 if sess._x is not None else 0),
        "s": int(state.elm.count.shape[0]),
        "cfg": convert.config_to_dict(sess.cfg),
        "stats": {**counters, "wall_s": wall_s},
        "ring_tickets": [int(t) for t in sess.ring.tickets()],
        "teacher_snapshot": hasattr(sess.teacher, "snapshot_state"),
    }
    tree: dict = {
        "meta": _meta_leaf(meta),
        "state": state_to_tree(state),
        "ring": [_entry_tree(e) for e in sess.ring.entries()],
        "deferred": [_entry_tree(d) for d in sess._deferred],
        "stats": {
            "tick_ms": np.asarray(stats.tick_ms, np.float64),
            "label_latency_ticks": np.asarray(stats.label_latency_ticks, np.float64),
        },
    }
    if sess._p is not None:
        tree["pending"] = {"x": to_host(sess._x), "plan": _plan_to_tree(sess._p)}
    if meta["teacher_snapshot"]:
        tree["teacher"] = sess.teacher.snapshot_state()
    if sess.collect and sess._cols["pred"]:
        tree["collected"] = {k: np.stack(v) for k, v in sess._cols.items()}
        tree["collected"]["trained"] = np.stack(sess._trained_rows)
    if tok is not None:
        tel.tracer.end(tok, t=sess.t, ring=len(tree["ring"]), **sess.telemetry_labels)
    return tree


def ticks_consumed(tree: dict) -> int:
    """How many ticks the snapshotted session had pulled from its source:
    the cursor a resumed tick source must seek to."""
    return int(_meta_of(tree)["ticks_consumed"])


# ---------------------------------------------------------------------------
# Restore
# ---------------------------------------------------------------------------


def restore(
    tree: dict,
    teacher: "stream.Teacher",
    cfg: Optional[EngineConfig] = None,
    ship: Optional[Callable] = None,
    pending: str = "auto",
    device: str | torch.device | None = None,
) -> "stream.StreamSession":
    """Rebuild a ``StreamSession`` from a :func:`capture` tree (either
    package's) on ``device``: CUDA unless the caller names one, and with no
    CUDA device and none named this raises.

    ``teacher`` is a *fresh* teacher instance.  If both the snapshot and the
    teacher support teacher state (``restore_snapshot``), the teacher is
    restored bit for bit.  Otherwise the ring's in-flight entries are
    handled per ``pending``: ``"reask"`` re-submits each through the fresh
    teacher (new ticket ids, metered as ``tickets_reasked``; their queries
    stay counted once in ``queries_issued``), ``"drop"`` meters them as
    lost, and ``"auto"`` picks reask.  Either way the query-accounting
    identity survives the restore.
    """
    if pending not in PENDING_POLICIES:
        raise ValueError(f"unknown pending policy {pending!r}; choose one of {PENDING_POLICIES}")
    meta = _meta_of(tree)
    if meta["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"snapshot version {meta['version']} != supported {SNAPSHOT_VERSION}")
    device = resolve_device(device)
    tel = _telemetry.TELEMETRY
    tok = tel.tracer.begin("snapshot.restore") if tel is not None else None
    if cfg is None:
        cfg = convert.engine_config_from_dict(meta["cfg"])
    sess = stream.StreamSession(
        state_from_tree(tree["state"], device),
        cfg,
        teacher,
        mode=meta["mode"],
        capacity=meta["capacity"],
        backpressure=meta["backpressure"],
        collect=meta["collect"],
        donate=meta["donate"],
        ship=ship,
    )
    sess.t = meta["t"]
    sess._t_start = time.perf_counter() if meta["started"] else None

    stats = sess.stats
    for name, value in meta["stats"].items():
        setattr(stats, name, type(getattr(stats, name))(value))
    stats.tick_ms.extend(np.asarray(tree["stats"]["tick_ms"]).tolist())
    stats.label_latency_ticks.extend(np.asarray(tree["stats"]["label_latency_ticks"]).tolist())

    entries = [
        stream.PendingTicket(
            tick=int(np.asarray(e["tick"])),
            queried=np.asarray(e["queried"], bool),
            plan=_plan_from_tree(e["plan"], device),
            x=sess.ship(np.asarray(e["x"])),
        )
        for e in tree["ring"]
    ]
    tickets = [int(t) for t in meta["ring_tickets"]]

    restore_fn = getattr(teacher, "restore_snapshot", None)
    if pending == "auto" and "teacher" in tree and restore_fn is not None:
        # Same-host resume: the teacher continues bit for bit (RNG, ticket
        # counter, undelivered inbox), so the old ticket ids stay valid.
        restore_fn(tree["teacher"])
        for ticket, ent in zip(tickets, entries):
            sess.ring.push(ticket, ent)
    elif entries and pending != "drop":
        # Fresh teacher: the old tickets mean nothing to it.  Re-ask each
        # in-flight entry (oldest first) with its captured features and
        # origin tick; the plan-time context rides along.  New wire asks
        # (tickets_issued), not new decisions (queries_issued unchanged).
        for ent in entries:
            ticket = teacher.ask(ent.x, ent.queried, ent.tick)
            stats.tickets_issued += 1
            stats.tickets_reasked += 1
            sess.ring.push(ticket, ent)
    elif entries:
        # pending="drop": the in-flight queries can never be answered.
        for ent in entries:
            stats.tickets_lost += 1
            stats.queries_lost += int(ent.queried.sum())

    for d in tree["deferred"]:
        sess._deferred.append(
            stream.DeferredAsk(
                tick=int(np.asarray(d["tick"])),
                x=sess.ship(np.asarray(d["x"])),
                queried=np.asarray(d["queried"], bool),
                plan=_plan_from_tree(d["plan"], device),
            )
        )

    if meta["has_pending"]:
        sess._x = sess.ship(np.asarray(tree["pending"]["x"]))
        sess._p = _plan_from_tree(tree["pending"]["plan"], device)

    if "collected" in tree:
        col = tree["collected"]
        for k in sess._cols:
            sess._cols[k] = [np.array(row) for row in np.asarray(col[k])]
        sess._trained_rows = [np.array(row) for row in np.asarray(col["trained"])]
    if tok is not None:
        tel.tracer.end(tok, t=sess.t, ring=len(entries), pending=pending)
    return sess


# ---------------------------------------------------------------------------
# Wire codec: a snapshot tree as ONE length-prefixed binary frame
# ---------------------------------------------------------------------------
#
# The v2 frame of engine/wire.py, [0x02][4-byte LE header length][JSON
# header][raw payload], with the header carrying the tree structure
# (runtime.checkpoint's manifest encoding) and a per-leaf spec list {path,
# dtype, shape, length, crc32}; the payload is every leaf's C-order bytes
# concatenated in spec order.  Each leaf carries its own zlib.crc32, so a
# flipped bit anywhere is rejected naming the damaged leaf.


def encode_snapshot(tree: dict) -> bytes:
    """Serialize a :func:`capture` tree (or any dict/list tree of numpy
    leaves or tensors) to one self-delimiting binary frame."""
    specs = []
    chunks = []
    for path, leaf in ckpt_mod._flatten(tree):
        # tobytes() serializes any layout in C order; ascontiguousarray
        # would promote 0-d leaves (the unicode meta) to 1-d and break the
        # bitwise roundtrip.
        arr = to_host(leaf)
        buf = arr.tobytes()
        specs.append({
            "path": "/".join(path),
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "len": len(buf),
            "crc": zlib.crc32(buf),
        })
        chunks.append(buf)
    payload = b"".join(chunks)
    header = {
        "kind": "snapshot",
        "wire_version": SNAPSHOT_WIRE_VERSION,
        "payload_len": len(payload),
        "tree": ckpt_mod._manifest_of(tree),
        "leaves": specs,
    }
    return wire._encode_frame(header, payload)


def decode_snapshot(data: bytes) -> dict:
    """Rebuild the tree from :func:`encode_snapshot` bytes.

    Raises ``ValueError`` on a wrong version byte, a non-snapshot frame, a
    corrupt leaf checksum (naming the leaf) or a wire-version mismatch, and
    ``EOFError`` when the buffer ends inside the frame.  Every returned leaf
    owns its bytes.
    """
    if len(data) < 5:
        raise EOFError(
            f"snapshot frame truncated: {len(data)} bytes is shorter than "
            "the [version][header length] preamble"
        )
    if data[0] != wire.WIRE_V2:
        raise ValueError(
            f"snapshot frame version byte {data[0]:#04x} != v2 "
            f"{wire.WIRE_V2:#04x}: not a snapshot wire frame"
        )
    hlen = int.from_bytes(data[1:5], "little")
    if len(data) < 5 + hlen:
        raise EOFError(
            f"snapshot frame truncated inside the header (wanted {hlen} "
            f"header bytes, have {len(data) - 5})"
        )
    try:
        header = json.loads(data[5 : 5 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt snapshot frame header: {e}") from e
    if not isinstance(header, dict) or header.get("kind") != "snapshot":
        kind = header.get("kind") if isinstance(header, dict) else header
        raise ValueError(f"frame is not a snapshot (kind={kind!r})")
    if header.get("wire_version") != SNAPSHOT_WIRE_VERSION:
        raise ValueError(
            f"snapshot wire version {header.get('wire_version')} != "
            f"supported {SNAPSHOT_WIRE_VERSION}"
        )
    payload = data[5 + hlen :]
    if len(payload) != int(header["payload_len"]):
        raise EOFError(
            f"snapshot frame truncated in the payload (declared "
            f"{header['payload_len']} bytes, have {len(payload)})"
        )
    leaves = {}
    off = 0
    for spec in header["leaves"]:
        buf = payload[off : off + spec["len"]]
        off += spec["len"]
        if zlib.crc32(buf) != spec["crc"]:
            raise ValueError(
                f"snapshot leaf {spec['path']!r} failed its checksum: "
                "refusing to restore corrupt state"
            )
        arr = np.frombuffer(buf, dtype=np.dtype(spec["dtype"]))
        leaves[spec["path"]] = arr.reshape(spec["shape"]).copy()
    return ckpt_mod._unflatten(leaves, header["tree"])
