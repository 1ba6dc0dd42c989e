"""Device dispatch for the kernels, their launch counts and their costs.

A CPU tensor goes to the plain PyTorch version (``ref``); a CUDA tensor goes
to the hand-written kernel, and a failed build or launch raises — there is
no fallback.  A meta tensor (the dry-run's abstract state) gets outputs of
the right shapes and dtypes on the meta device: nothing is computed, no
kernel or plain version is reached and no launch is counted.  Any other
device raises.  The RLS update takes one of two
routes by shape (``rls_route``); that is a choice by shape, made before any
launch, never a retry.

``launch_counts`` holds one plain integer per kernel and route, raised by
one where the kernel is launched and nowhere else, so a run can show that
its main path went through the kernels (``chip_smoke.py`` reads it).  A
call made while a CUDA graph is being captured launches nothing: it records
the kernel into the graph, and raises ``captured_counts`` instead, from
which ``engine.graphs`` learns which kernels each of its graphs replays.
``launch_shapes`` notes, beside either count, the shape of the call (keyed
as ``chip_smoke.py`` keys the shapes it holds each kernel at), so a process
can say at which shapes it ran each kernel.  The keys of all three:

* ``xorshift_projection`` — the projection kernel;
* ``oselm_rls_update_fleet`` — the single-pass RLS kernel, from the fleet entry;
* ``oselm_rls_update`` — the same kernel, from the one-head entry;
* ``rls_two_stage`` — the two-stage RLS route, from either entry;
* ``plan_rows`` — the fused per-stream pass of ``plan`` and ``gate``
  after the projection (readout, top-2, drift detector, query decision,
  meter, the ladder's skip step), every plan in every mode;
* ``readout`` — the readout alone, a reduced instance of the same kernel
  (no path of the engine calls it);
* ``row_abs_mean`` — the drift detector's feature mean alone, likewise.

Each wrapper's CPU path gives a row the same result whatever the number of
rows beside it, as its kernel does on the card: a cohort's stacked dispatch
must equal each member's own (``engine/cohort.py``).

``kernel_cost(name, shape)`` is each entry point's whole call in FLOPs and
bytes (each input read once, each output written once): ``chip_smoke.py``
bounds the kernels with it, and under a ``launch.census.StepCensus`` every
entry point adds it for its call, on any device, with the aten-level
counting paused inside it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import oselm_update as _oselm_update
from repro_torch.kernels import plan_rows as _plan_rows
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import xorshift_proj as _xorshift_proj
from repro_torch.launch import census as _census

launch_counts = {
    "xorshift_projection": 0,
    "oselm_rls_update_fleet": 0,
    "oselm_rls_update": 0,
    "rls_two_stage": 0,
    "plan_rows": 0,
    "readout": 0,
    "row_abs_mean": 0,
}
captured_counts = dict.fromkeys(launch_counts, 0)
launch_shapes: dict[str, set[tuple]] = {name: set() for name in launch_counts}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
        launch_shapes[name].clear()


def _count(name: str, shape: tuple) -> None:
    """One launch of ``name`` at ``shape`` on the current CUDA stream, or one
    kernel node recorded into the graph that stream is capturing."""
    counts = captured_counts if torch.cuda.is_current_stream_capturing() else launch_counts
    counts[name] += 1
    launch_shapes[name].add(shape)


def _route(t: torch.Tensor) -> str:
    """``"cuda"`` (the kernel), ``"cpu"`` (the plain version) or ``"meta"``
    (shapes only); any other device raises."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"repro_torch kernels run on CUDA, CPU or meta tensors, got {t.device}")


# Bytes a stream of the plan's state: prune (five int32), drift (f32 mean
# and var, int32 steps, hits and calm, bool active), meter (two f32).
_PRUNE_BYTES, _DRIFT_BYTES, _METER_BYTES = 5 * 4, 5 * 4 + 1, 2 * 4
# The plan's seven per-stream fields besides o: pred, confidence, theta
# (4 bytes each) and queried, controller_on, mode_training (bool).
_PLAN_FIELD_BYTES = 3 * 4 + 3 * 1


def kernel_cost(name: str, shape: tuple, mode: str = "serve",
                use_features: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of one whole call of entry point ``name`` at
    ``shape``, keyed as ``launch_shapes`` keys it: each input read once,
    each output written once, every product counted once (2 per
    multiply-add; the projection's TF32 split into three products and its
    split route's workspace of partial sums are the kernel's own choices,
    not the work).

    * ``xorshift_projection`` (S, n_in, N): x f32 in, H out;
    * ``oselm_rls_update_fleet``, ``oselm_rls_update``, ``rls_two_stage``
      (S, N, k, m): P and beta in and out, H and Y in; PH^T, the downdate
      and P'W, 2 S N^2 (2k + m);
    * ``plan_rows`` (S, N, m, n_in) in ``mode``: h, beta, count and the
      prune, drift and meter leaves in, x too where the detector steps on
      the features; o and the plan's fields, prune and meter out, drift
      too where it steps; the readout and the feature mean;
    * ``readout`` (S, N, m): h and beta in, o out;
    * ``row_abs_mean`` (S, n): x in, the mean out.
    """
    if name == "xorshift_projection":
        s, n_in, n = shape
        return 2.0 * s * n_in * n, 4.0 * (s * n_in + s * n)
    if name in ("oselm_rls_update_fleet", "oselm_rls_update", "rls_two_stage"):
        s, n, k, m = shape
        return (2.0 * s * n * n * (2 * k + m),
                4.0 * (2 * s * n * n + 2 * s * n * m + s * k * n + s * k * m))
    if name == "plan_rows":
        s, n, m, n_in = shape
        reads_x = mode != "train_phase" and use_features
        reads = s * (4 * n + 4 * n * m + 4 + _PRUNE_BYTES + _DRIFT_BYTES + _METER_BYTES)
        writes = s * (4 * m + _PLAN_FIELD_BYTES + _PRUNE_BYTES + _METER_BYTES)
        if reads_x:
            reads += 4 * s * n_in
            writes += s * _DRIFT_BYTES
        return 2.0 * s * n * m + (2.0 * s * n_in if reads_x else 0.0), float(reads + writes)
    if name == "readout":
        s, n, m = shape
        return 2.0 * s * n * m, 4.0 * (s * n + s * n * m + s * m)
    if name == "row_abs_mean":
        s, n = shape
        return 2.0 * s * n, 4.0 * (s * n + s)
    raise KeyError(f"no cost for kernel {name!r}")


def _add_cost(c, name: str, shape: tuple, outputs, inputs, **kw) -> None:
    """The call's cost into the open census ``c`` (None: none open)."""
    if c is not None:
        c.add_kernel(name, *kernel_cost(name, shape, **kw), outputs, inputs)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def xorshift_projection(
    x: torch.Tensor,
    seed: int,
    n_hidden: int,
    scale: float = 1.0,
    activation: str = "sigmoid",
) -> torch.Tensor:
    """ODLHash projection H = act(x @ alpha(seed) * scale / sqrt(n_in)).

    Accepts (..., n_in); leading dims are flattened for the kernel.
    """
    with _census.kernel_call() as c:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        shape = (x2.shape[0], x2.shape[1], n_hidden)
        route = _route(x2)
        if route == "cuda":
            h = _xorshift_proj.xorshift_projection(
                x2.contiguous(), seed, n_hidden, scale=scale, activation=activation
            )
            _count("xorshift_projection", shape)
        elif route == "cpu":
            h = _ref.xorshift_projection_ref(x2, seed, n_hidden, scale=scale,
                                             activation=activation)
        else:
            h = _meta((x2.shape[0], n_hidden))
        h = h.reshape(lead + (n_hidden,))
        _add_cost(c, "xorshift_projection", shape, h, x)
        return h


def readout(h: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Per-stream readout o[s] = h[s] @ beta[s]: h (S, N), beta (S, N, m) -> (S, m)."""
    with _census.kernel_call() as c:
        route = _route(h)
        if route == "cuda":
            o = _plan_rows.readout(h.to(torch.float32).contiguous(), beta.contiguous())
            _count("readout", tuple(beta.shape))
        elif route == "cpu":
            o = _ref.readout_ref(h, beta)
        else:
            o = _meta((beta.shape[0], beta.shape[2]))
        _add_cost(c, "readout", tuple(beta.shape), o, (h, beta))
        return o


def row_abs_mean(x: torch.Tensor) -> torch.Tensor:
    """mean(|x|) over the last axis: (..., n) -> (...) f32."""
    with _census.kernel_call() as c:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        route = _route(x2)
        if route == "cuda":
            a = _plan_rows.row_abs_mean(x2.to(torch.float32).contiguous())
            _count("row_abs_mean", tuple(x2.shape))
        elif route == "cpu":
            a = _ref.row_abs_mean_ref(x2)
        else:
            a = _meta((x2.shape[0],))
        a = a.reshape(lead)
        _add_cost(c, "row_abs_mean", tuple(x2.shape), a, x)
        return a


def plan_rows(
    h: torch.Tensor,  # (S, N)
    beta: torch.Tensor,  # (S, N, m)
    x: torch.Tensor,  # (S, n_in)
    count: torch.Tensor,  # (S,) int32
    prune,  # PruneState
    drift,  # DriftState
    meter,  # CommMeter
    cfg,  # EngineConfig
    mode: str,
    teacher_available: torch.Tensor | None = None,  # (S,) bool
    drift_active: torch.Tensor | None = None,  # (S,) bool, train_phase only
    out: tuple | None = None,  # (PruneState, DriftState, CommMeter) buffers
) -> _ref.PlanRows:
    """Everything ``plan`` does after the projection, for S streams:
    ``ref.PlanRows`` (the plan's fields and the new prune, drift and meter
    leaves).  With ``out`` the new leaves are written into those buffers."""
    with _census.kernel_call() as c:
        r = _plan_rows_routed(h, beta, x, count, prune, drift, meter, cfg, mode,
                              teacher_available, drift_active, out)
        _add_cost(c, "plan_rows", (*beta.shape, x.shape[-1]), r,
                  (h, beta, x, count, prune, drift, meter, out), mode=mode,
                  use_features=cfg.drift.use_features)
        return r


def _plan_rows_routed(h, beta, x, count, prune, drift, meter, cfg, mode, teacher_available,
                      drift_active, out):
    route = _route(h)
    if route == "cuda":
        if teacher_available is not None:
            teacher_available = teacher_available.to(torch.bool).contiguous()
        if drift_active is not None:
            drift_active = drift_active.to(torch.bool).contiguous()
        stepped = mode != "train_phase" and cfg.drift.use_features
        r = _plan_rows.plan_rows(
            h.to(torch.float32).contiguous(), beta.contiguous(),
            x.to(torch.float32).contiguous() if stepped else x,
            count, prune, drift, meter, cfg, mode, teacher_available, drift_active, out=out)
        _count("plan_rows", (*beta.shape, x.shape[-1]))
        return r
    if route == "meta":
        # The kernel wrapper's outputs: new leaves (or ``out``'s), and in
        # train_phase the detector's leaves passed through.
        s, m = beta.shape[0], beta.shape[2]

        def new(group):
            return type(group)(*(_meta((s,), t.dtype) for t in group))

        if out is None:
            out = (new(prune), new(drift) if mode != "train_phase" else drift, new(meter))
        b8 = torch.bool
        return _ref.PlanRows(
            outputs=_meta((s, m)), pred=_meta((s,), torch.int32), confidence=_meta((s,)),
            queried=_meta((s,), b8), controller_on=_meta((s,), b8), theta=_meta((s,)),
            mode_training=_meta((s,), b8), prune=out[0], drift=out[1], meter=out[2])
    r = _ref.plan_rows_ref(h, beta, x, count, prune, drift, meter, cfg, mode,
                           teacher_available, drift_active)
    if out is None:
        return r
    new = (r.prune, r.drift, r.meter)
    for dst, src in zip(out, new):
        for d, n in zip(dst, src):
            d.copy_(n)
    return r._replace(prune=out[0], drift=out[1], meter=out[2])


def rls_route(n: int, k: int, m: int) -> str:
    """``"single"`` where the single-pass kernel takes (N, k, m), else
    ``"two_stage"`` (N > 256, k > 64, N not a multiple of 4, or a layout
    that does not fit in shared memory)."""
    return "two_stage" if _oselm_update.single_pass_plan(n, k, m) is None else "single"


def _rls(P, beta, H, Y, counter, out=None):
    route = _route(P)
    if route == "meta":
        return out if out is not None else (torch.empty_like(P), torch.empty_like(beta))
    if route == "cpu":
        if P.shape[0] == 1:
            # torch's CPU batched products hand a batch of one to matrix-vector
            # routines that sum in another order: a lone stream is updated as
            # the first of two, like a stream of any larger batch.
            new = tuple(t[:1] for t in _ref.rls_update_ref(
                *(torch.cat([t, t]) for t in (P, beta, H, Y))))
        else:
            new = _ref.rls_update_ref(P, beta, H, Y)
        if out is None:
            return new
        for dst, src in zip(out, new):
            dst.copy_(src)
        return out
    P, beta = P.contiguous(), beta.contiguous()
    H, Y = H.to(torch.float32).contiguous(), Y.to(torch.float32).contiguous()
    shape = (P.shape[0], P.shape[1], H.shape[1], beta.shape[2])
    if rls_route(P.shape[1], H.shape[1], beta.shape[2]) == "single":
        new = _oselm_update.rls_single(P, beta, H, Y, out=out)
        _count(counter, shape)
    else:
        new = _oselm_update.rls_fleet(P, beta, *_oselm_update.small_operands(P, beta, H, Y),
                                      out=out)
        _count("rls_two_stage", shape)
    return new


def oselm_rls_update_fleet(
    P: torch.Tensor,
    beta: torch.Tensor,
    H: torch.Tensor,
    Y: torch.Tensor,
    out: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-k RLS update for S heads: P (S,N,N), beta (S,N,m), H (S,k,N),
    Y (S,k,m) -> (P', beta'), Pallas numerics.  With ``out`` the update is
    written into those two buffers (which must not overlap the inputs) and
    they are returned; else into new ones."""
    with _census.kernel_call() as c:
        new = _rls(P, beta, H, Y, "oselm_rls_update_fleet", out)
        _add_cost(c, "oselm_rls_update_fleet", (P.shape[0], P.shape[1], H.shape[1],
                                                beta.shape[2]), new, (P, beta, H, Y, out))
        return new


def oselm_rls_update(
    P: torch.Tensor, beta: torch.Tensor, H: torch.Tensor, Y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank-k RLS update of one head: P (N,N), beta (N,m), H (k,N), Y (k,m)
    -> (P', beta').  The S = 1 case of ``oselm_rls_update_fleet``."""
    with _census.kernel_call() as c:
        new_p, new_beta = _rls(P[None], beta[None], H[None], Y[None], "oselm_rls_update")
        new = (new_p[0], new_beta[0])
        _add_cost(c, "oselm_rls_update", (1, P.shape[0], H.shape[0], beta.shape[1]), new,
                  (P, beta, H, Y))
        return new
