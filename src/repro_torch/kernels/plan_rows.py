"""The per-stream pass of ``plan`` on Hopper: the launch wrappers of
``csrc/plan_rows.cu``.

Not a port of a Pallas kernel: everything ``engine/fleet.py``'s ``plan`` and
``gate`` do after the hidden projection (the readout, argmax and top-2, the
drift detector's feature mean and update, the query decision, the masks of
the mode, the comm meter and the ladder's skip step) was ~100-160 small
torch ops a tick, and the readout and the feature mean were torch
reductions that split a row's sum by the number of rows.  One kernel does
it all, stream by stream, each row summed in an order fixed by the shapes
alone, so a row's result does not depend on how many rows share the launch
or where they lie.  See the source for the design.

* ``plan_rows`` — the fused pass, in ``algo1``, ``serve`` or ``train_phase``
  (``gate`` is ``serve``); m from 2 to ``MAX_M``;
* ``readout`` — the readout only, any m;
* ``row_abs_mean`` — the feature mean only.

Plain versions: ``ref.plan_rows_ref``, ``ref.readout_ref`` and
``ref.row_abs_mean_ref``.  Device dispatch and the launch counts live in
``ops``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.core.labels import BYTES_PER_FEATURE, BYTES_PER_LABEL
from repro_torch.kernels import build
from repro_torch.kernels.ref import PlanRows

KINDS = {"algo1": 0, "serve": 1, "train_phase": 2, "readout": 3, "mean": 4}
MAX_M = 16  # columns of the fused kinds (csrc MAX_M)
MAX_LADDER = 8

# The three argument arrays of ``plan_rows_launch``, in the source's order
# (checked against the library's own lists when it is loaded).
POINTERS = (
    "h", "beta", "x", "count", "level", "streak", "queries", "skips", "phase_trained", "mean",
    "var", "steps", "hits", "calm", "active", "up_bytes", "down_bytes", "teacher_available",
    "drift_active", "outputs", "pred", "confidence", "queried", "controller_on", "theta",
    "mode_training", "new_level", "new_streak", "new_queries", "new_skips",
    "new_phase_trained", "new_mean", "new_var", "new_steps", "new_hits", "new_calm",
    "new_active", "new_up_bytes", "new_down_bytes", "feature_mean",
)
INTS = ("S", "N", "m", "n_in", "use_features", "use_confidence", "prune_enabled", "n_ladder",
        "x_consec", "min_trained", "warmup", "enter_hits", "exit_calm")
FLOATS = ("k_sigma", "decay", "keep", "up_per_query", "down_per_query",
          *(f"ladder{i}" for i in range(MAX_LADDER)))


@functools.cache
def _lib():
    lib = build.library("plan_rows")
    for fn, names in ((lib.plan_rows_pointer_names, POINTERS), (lib.plan_rows_int_names, INTS),
                      (lib.plan_rows_float_names, FLOATS)):
        fn.restype = ctypes.c_char_p
        got = tuple(n for n in fn().decode().split(",") if n)
        if got != names:
            raise RuntimeError(f"csrc/plan_rows.cu takes {got}, the wrapper passes {names}")
    lib.plan_rows_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_void_p]
    lib.plan_rows_launch.restype = ctypes.c_int
    lib.plan_rows_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.plan_rows_smem_bytes.restype = ctypes.c_int
    lib.plan_rows_error_string.argtypes = [ctypes.c_int]
    lib.plan_rows_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dim: int, dtype=torch.float32, device=None) -> None:
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name} must be a CUDA tensor on {device or 'the card'}, got {t.device}")
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)} (contiguous: {t.is_contiguous()})")


def _rows(t: torch.Tensor, name: str, s: int, dtype, device) -> torch.Tensor:
    _check(t, name, 1, dtype, device)
    if t.shape[0] != s:
        raise ValueError(f"{name} has {t.shape[0]} rows, not {s}")
    return t


def _launch(kind: str, device: torch.device, ptrs: dict, ints: dict, floats: dict) -> None:
    lib = _lib()
    p = (ctypes.c_void_p * len(POINTERS))(*(ptrs.get(n) for n in POINTERS))
    i = (ctypes.c_int * len(INTS))(*(int(ints.get(n, 0)) for n in INTS))
    f = (ctypes.c_float * len(FLOATS))(*(float(floats.get(n, 0.0)) for n in FLOATS))
    with torch.cuda.device(device):
        rc = lib.plan_rows_launch(KINDS[kind], p, i, f,
                                  torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"plan_rows ({kind}) launch failed: "
                           f"{lib.plan_rows_error_string(rc).decode()}")


def _fits(kind: str, n: int, m: int, n_in: int, use_features: bool) -> None:
    if _lib().plan_rows_smem_bytes(KINDS[kind], n, m, n_in, int(use_features)) < 0:
        raise ValueError(f"plan_rows ({kind}): one stream's rows (N={n}, m={m}, n_in={n_in}) "
                         "do not fit in a block's shared memory")


def readout(h: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """o[s] = h[s] @ beta[s] on the card: h (S, N), beta (S, N, m) -> (S, m) f32."""
    _check(h, "h", 2)
    _check(beta, "beta", 3, device=h.device)
    s, n = h.shape
    if beta.shape[:2] != (s, n):
        raise ValueError(f"beta {tuple(beta.shape)} does not match h {tuple(h.shape)}")
    m = beta.shape[2]
    out = torch.empty((s, m), dtype=torch.float32, device=h.device)
    if s == 0 or m == 0:
        return out
    if n == 0:
        raise ValueError("readout of rows with no elements")
    _fits("readout", n, m, 0, False)
    _launch("readout", h.device, {"h": h.data_ptr(), "beta": beta.data_ptr(),
                                  "outputs": out.data_ptr()}, {"S": s, "N": n, "m": m}, {})
    return out


def row_abs_mean(x: torch.Tensor) -> torch.Tensor:
    """mean(|x[s]|) on the card: x (S, n) f32 -> (S,) f32."""
    _check(x, "x", 2)
    s, n = x.shape
    out = torch.empty((s,), dtype=torch.float32, device=x.device)
    if s == 0:
        return out
    if n == 0:
        raise ValueError("row_abs_mean of rows with no elements")
    _fits("mean", 0, 0, n, True)
    _launch("mean", x.device, {"x": x.data_ptr(), "feature_mean": out.data_ptr()},
            {"S": s, "n_in": n}, {})
    return out


def _f32(v: float) -> float:
    return float(np.float32(v))


def plan_rows(
    h: torch.Tensor,  # (S, N) f32
    beta: torch.Tensor,  # (S, N, m) f32
    x: torch.Tensor,  # (S, n_in) f32 (not read in train_phase)
    count: torch.Tensor,  # (S,) int32, elm.count
    prune,  # PruneState of (S,) int32
    drift,  # DriftState of (S,): f32 mean, var; int32 steps, hits, calm; bool active
    meter,  # CommMeter of (S,) f32
    cfg,  # EngineConfig
    mode: str,
    teacher_available: Optional[torch.Tensor] = None,  # (S,) bool
    drift_active: Optional[torch.Tensor] = None,  # (S,) bool, train_phase only
    out: Optional[tuple] = None,  # (PruneState, DriftState, CommMeter) buffers
    feature_mean: Optional[torch.Tensor] = None,  # (S,) f32: also write a = mean(|x|) here
) -> PlanRows:
    """The fused pass on the card: ``ref.plan_rows_ref``'s outputs.

    ``out`` gives the buffers of the new prune, drift and meter leaves
    (each row is read before it is written, so they may be the inputs');
    else new ones are made.  In ``train_phase`` the detector is not
    stepped: its leaves are copied into ``out``'s, or, without ``out``, the
    input's are returned as they are.
    Raises on a shape, dtype or device the kernel does not take, and if the
    launch fails.
    """
    if mode not in ("algo1", "serve", "train_phase"):
        raise ValueError(f"unknown engine mode {mode!r}")
    _check(h, "h", 2)
    dev = h.device
    _check(beta, "beta", 3, device=dev)
    s, n = h.shape
    if beta.shape[:2] != (s, n):
        raise ValueError(f"beta {tuple(beta.shape)} does not match h {tuple(h.shape)}")
    m = beta.shape[2]
    if not 2 <= m <= MAX_M:
        raise ValueError(f"plan_rows takes 2 <= m <= {MAX_M} outputs (top-2), got m={m}")
    if n == 0:
        raise ValueError("plan_rows of heads with no hidden units")
    if x.dim() != 2 or x.shape[0] != s:
        raise ValueError(f"x must be (S={s}, n_in), got {tuple(x.shape)}")
    n_in = x.shape[1]
    pc, dc = cfg.prune, cfg.drift
    if not 1 <= len(pc.ladder) <= MAX_LADDER:
        raise ValueError(f"plan_rows takes a ladder of 1 to {MAX_LADDER} values, got {pc.ladder}")
    stepped = mode != "train_phase"
    if stepped and not (dc.use_features or dc.use_confidence):
        raise ValueError("the drift score needs use_features or use_confidence")
    reads_x = stepped and dc.use_features
    if reads_x:
        _check(x, "x", 2, device=dev)
        if n_in == 0:
            raise ValueError("the drift feature mean of rows with no elements")
    i32, f32, b8 = torch.int32, torch.float32, torch.bool
    ins = {"h": h, "beta": beta, "x": x if reads_x else None,
           "count": _rows(count, "count", s, i32, dev)}
    for name in ("level", "streak", "queries", "skips", "phase_trained"):
        ins[name] = _rows(getattr(prune, name), f"prune.{name}", s, i32, dev)
    for name, dtype in (("mean", f32), ("var", f32), ("steps", i32), ("hits", i32),
                        ("calm", i32), ("active", b8)):
        ins[name] = _rows(getattr(drift, name), f"drift.{name}", s, dtype, dev)
    ins["up_bytes"] = _rows(meter.up_bytes, "meter.up_bytes", s, f32, dev)
    ins["down_bytes"] = _rows(meter.down_bytes, "meter.down_bytes", s, f32, dev)
    if teacher_available is not None:
        ins["teacher_available"] = _rows(teacher_available, "teacher_available", s, b8, dev)
    if drift_active is not None and mode == "train_phase":
        ins["drift_active"] = _rows(drift_active, "drift_active", s, b8, dev)

    def new(group):
        return type(group)(*(torch.empty((s,), dtype=t.dtype, device=dev) for t in group))

    if out is None:
        new_prune, new_meter = new(prune), new(meter)
        new_drift = new(drift) if stepped else drift
    else:
        new_prune, new_drift, new_meter = out
        for group, prefix, ref_group in ((new_prune, "out.prune", prune),
                                         (new_drift, "out.drift", drift),
                                         (new_meter, "out.meter", meter)):
            for name, t, like in zip(group._fields, group, ref_group):
                _rows(t, f"{prefix}.{name}", s, like.dtype, dev)
    outs = {
        "outputs": torch.empty((s, m), dtype=f32, device=dev),
        "pred": torch.empty((s,), dtype=i32, device=dev),
        "confidence": torch.empty((s,), dtype=f32, device=dev),
        "queried": torch.empty((s,), dtype=b8, device=dev),
        "controller_on": torch.empty((s,), dtype=b8, device=dev),
        "theta": torch.empty((s,), dtype=f32, device=dev),
        "mode_training": torch.empty((s,), dtype=b8, device=dev),
    }
    ptrs = {k: (None if t is None else t.data_ptr()) for k, t in ins.items()}
    ptrs.update({k: t.data_ptr() for k, t in outs.items()})
    for name in new_prune._fields:
        ptrs[f"new_{name}"] = getattr(new_prune, name).data_ptr()
    if new_drift is not drift:  # train_phase without ``out`` writes no drift leaf
        for name in new_drift._fields:
            ptrs[f"new_{name}"] = getattr(new_drift, name).data_ptr()
    ptrs["new_up_bytes"] = new_meter.up_bytes.data_ptr()
    ptrs["new_down_bytes"] = new_meter.down_bytes.data_ptr()
    if feature_mean is not None:
        if not reads_x:
            raise ValueError(f"no feature mean is computed in {mode} with these flags")
        ptrs["feature_mean"] = _rows(feature_mean, "feature_mean", s, f32, dev).data_ptr()
    result = PlanRows(prune=new_prune, drift=new_drift, meter=new_meter, **outs)
    if s == 0:
        return result
    _fits(mode, n, m, n_in, reads_x)
    ladder = [_f32(v) for v in pc.ladder]
    _launch(mode, dev, ptrs, {
        "S": s, "N": n, "m": m, "n_in": n_in, "use_features": dc.use_features,
        "use_confidence": dc.use_confidence, "prune_enabled": pc.enabled,
        "n_ladder": len(ladder), "x_consec": pc.x_consec, "min_trained": pc.min_trained,
        "warmup": dc.warmup, "enter_hits": dc.enter_hits, "exit_calm": dc.exit_calm,
    }, {
        # The f32 values the plain version computes with: decay and 1 - decay
        # as drift.update rounds them; the others as torch casts a Python
        # scalar against an f32 tensor.
        "k_sigma": _f32(dc.k_sigma), "decay": _f32(dc.ewma_decay),
        "keep": float(np.float32(1.0) - np.float32(dc.ewma_decay)),
        "up_per_query": _f32(n_in * BYTES_PER_FEATURE), "down_per_query": _f32(BYTES_PER_LABEL),
        **{f"ladder{i}": v for i, v in enumerate(ladder)},
    })
    return result
