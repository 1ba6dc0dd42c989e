#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. card   — name and power limit (as ``nvidia-smi`` gives them), versions;
2. build  — nvcc builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. kernel 1 (ODLHash projection, tensor cores) against its plain version on
   the card, including the generated alpha itself;
4. the RLS update against its plain version on the card, through both
   routes: the single pass (kernels 2 and 3: the fleet entry and the
   one-head entry) and the two-stage route; masked streams exact;
5. the paper path: S=1, N=128, ``run_training_phase`` with theta=1 and the
   auto ladder, held to ``tests/test_odl_system.py``'s claims;
6. the fleet path: ``har_odl.full()`` at S=16,384 streams, ``train_phase``
   for 32 ticks and ``algo1`` for 96, through ``run_fleet``; the launch
   counts show both kernels ran, and the accounting identities hold;
   then a small fleet run on the card and on the CPU must agree, and a
   profiler window shows where a tick's device time goes (the RLS update
   must be one kernel per tick there);
6c. the stream path: the same fleet through ``stream.run`` with the runners
   replayed as CUDA graphs and ticks shipped from host memory; with a
   zero-latency teacher it must equal ``run_fleet`` bit for bit, then
   ``algo1`` with a late, lossy teacher under each backpressure policy must
   keep the query accounting exact;
6d. a small stream run with latency on the card and on the CPU must agree
   (decisions and counters equal);
6e. a profiler window over graphed stream ticks: one projection and one RLS
   kernel per tick, and where the tick's device and host time go;
6f. the multiplexer: 16 tenants of 1024 streams (the fleet's 16,384 when
   stacked) through ``multiplex.run``, ``train_phase`` on HAR rows, a late,
   lossy teacher per tenant, the four policies four tenants each, 12
   tenants of 32 ticks and 4 of 24 (members detach mid-run), and a 17th
   tenant admitted after round 2 (the patch path).  Fused ``rr``, fused
   ``drr``, unfused ``rr`` and each tenant solo through ``stream.run`` must
   give every tenant bit-for-bit the same result, with exact accounting.
   Before that, one plan and one learn on 16 stacked members must equal
   each member's own at member widths 1, 3 and 1024; after it, a window of
   fused cohort ticks must replay one projection and one RLS kernel per
   tick for the whole cohort (and a profiler window gives its busy share);
7. times of each kernel and route, its plain version and its library
   yardstick, and its bound.

The line before the last is the ``kernels`` JSON summary; the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --time-port PATH

instead times the port of the checkout at PATH (``.`` for this one) with
this script's timing code and prints one JSON line: the card, the device
time of the projection and of the whole RLS update at the fleet shape,
fleet ``train_phase`` stream-ticks per second after a warm-up, the same
for the graphed stream path and for the fused multiplexer of phase 6f (each
null for a checkout without it), and the profiled tick (wall, device time
per kernel, busy share).  To compare two checkouts, run it for both in
turns on one card (A, B, B, A).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 0
FLEET_STREAMS = 16384
TRAIN_TICKS = 32
ALGO1_TICKS = 96
ALGO1_SHIFT_AT = 64  # DriftConfig.warmup: the detector is armed from here
PROFILE_TICKS = 8
# The stream path's teacher under the backpressure policies (phase 6c), and
# the card-against-CPU check's (phase 6d).
STREAM_TEACHER = dict(latency=2, jitter=2, loss_prob=0.02, partial_prob=0.05, seed=SEED)
STREAM_CAPACITY = 8
POLICIES = ("drop_oldest", "drop_newest", "block", "coalesce")
STREAM_CHECK = dict(n_streams=256, n_ticks=48, latency=3, jitter=2, capacity=4)
K1_SHAPES = [(FLEET_STREAMS, 561, 128), (8, 128, 128), (8, 256, 384), (3, 561, 128),
             (130, 100, 72), (1, 16, 16)]
K2_SHAPES = [(FLEET_STREAMS, 128, 1, 6), (512, 256, 1, 6), (1, 128, 16, 6)]
# Shapes the single pass does not take go to the two-stage route.
K2_EXTRA_SHAPES = [(64, 384, 1, 6), (4, 64, 64, 3)]
K3_SHAPE = (128, 16, 6)  # one head: N, k, m
TWO_STAGE_SHAPE = (64, 384, 1, 6)
# The kernels the fleet path launches every tick (``ops.launch_counts`` keys),
# by mode: the drift detector's feature mean runs only where the detector does.
PATH_KERNELS = ("xorshift_projection", "oselm_rls_update_fleet", "readout", "row_abs_mean")
MODE_KERNELS = {"train_phase": PATH_KERNELS[:3], "algo1": PATH_KERNELS}
# The per-stream row kernels against their plain versions: (S, N, m) of the
# readout, (S, n) of the feature mean; the first of each is the fleet's.
READOUT_SHAPES = [(FLEET_STREAMS, 128, 6), (1, 128, 6), (3, 16, 4), (1024, 100, 1), (130, 33, 7)]
ROW_MEAN_SHAPES = [(FLEET_STREAMS, 561), (1, 561), (3, 24), (130, 100)]
# Phase 6f, the multiplexer: 16 tenants of 1024 streams stack to the fleet's
# 16,384; 12 run 32 ticks and 4 run 24, and one more of 32 ticks is admitted
# after round 2.
MUX_STREAMS = 1024
MUX_TICKS = (32,) * 12 + (24,) * 4
MUX_LATE_TICKS = 32
MUX_QUANTUM = 8
MUX_WIDTHS = (1, 3, 1024)  # member widths of the row-independence check, 16 members each
MUX_WINDOW = 8  # fused cohort ticks per timed window
COUNTERS = ("ticks", "stream_steps", "tickets_issued", "queries_issued", "labels_applied",
            "tickets_dropped", "queries_dropped", "replies_orphaned", "tickets_lost",
            "queries_lost", "tickets_coalesced", "queries_coalesced", "asks_deferred",
            "tickets_reasked")
ACTIVATIONS = ("sigmoid", "relu", "tanh", "identity")

# NVIDIA H100 SXM data sheet, dense, at 700 W: f32 outside the tensor cores,
# TF32 on them, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
SLEEP_CYCLES = 400_000_000  # about 0.2 s of device time ahead of each timed batch
# Calls per timed batch of a plain version or composite: each launches tens of
# kernels, and a batch must not fill the launch queue behind the sleep.
PLAIN_REPS = 4


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _card():
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_card():
    import torch

    print(_card())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s into {build.build_dir()}")
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


def _gen(device, seed):
    import torch

    return torch.Generator(device=device).manual_seed(seed)


def phase_kernel1(device="cuda"):
    """Projection kernel vs ``ref.xorshift_projection_ref`` on the card."""
    import torch

    from repro_torch.core import xorshift
    from repro_torch.kernels import ops, ref

    g = _gen(device, SEED)
    main_err = None
    worst = (0.0, "")
    for b, n_in, n in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, n_in, generator=g, device=device).to(dtype)
            for act in ACTIVATIONS:
                got = ops.xorshift_projection(x, 0x2D2A, n, activation=act)
                want = ref.xorshift_projection_ref(x, 0x2D2A, n, activation=act)
                err = (got - want).abs().max().item()
                tol = 2e-3 if dtype == torch.bfloat16 else 1e-5
                check(got.shape == (b, n) and err <= tol,
                      f"projection {b}x{n_in}x{n} {dtype} {act}: err {err} > {tol}")
                if (b, n_in, n) == K1_SHAPES[0] and dtype == torch.float32 and act == "sigmoid":
                    main_err = err
                if dtype == torch.float32 and err > worst[0]:
                    worst = (err, f"{b}x{n_in}x{n} {act}")
    # The generated alpha itself: identity x, identity activation, scale 1.
    for n_in, n in ((561, 128), (100, 72)):
        got = ops.xorshift_projection(
            torch.eye(n_in, device=device), 0x2D2A, n, activation="identity"
        )
        want = xorshift.alpha_hash(0x2D2A, n_in, n, device=device) / torch.sqrt(
            torch.tensor(float(n_in), device=device)
        )
        err = (got - want).abs().max().item()
        check(err <= 1e-6, f"generated alpha {n_in}x{n}: err {err} > 1e-6")
    print(f"kernel 1 xorshift_projection: {len(K1_SHAPES) * 2 * len(ACTIVATIONS)} cases + "
          f"alpha pass; main-shape max |err| {main_err:.3e}, worst f32 case {worst[0]:.3e} "
          f"({worst[1]})")
    return main_err


def _rls_inputs(s, n, k, m, device, seed):
    """SPD P, beta, H, Y as the engine would give them."""
    import torch

    g = _gen(device, seed)
    a = torch.randn(s, n, n, generator=g, device=device) / n ** 0.5
    P = torch.bmm(a, a.transpose(1, 2)) + 0.1 * torch.eye(n, device=device)
    del a
    beta = 0.1 * torch.randn(s, n, m, generator=g, device=device)
    H = torch.sigmoid(torch.randn(s, k, n, generator=g, device=device))
    Y = torch.nn.functional.one_hot(
        torch.randint(0, m, (s, k), generator=g, device=device), m
    ).to(torch.float32)
    return P, beta, H, Y


def phase_kernel2(device="cuda"):
    """The RLS update vs ``ref.rls_update_ref`` on the card, through the
    dispatch (single pass or two-stage route by shape) and the one-head
    entry; a masked stream must come out exactly as it went in."""
    import torch

    from repro_torch.kernels import ops, oselm_update, ref

    errs = {}
    for s, n, k, m in K2_SHAPES + K2_EXTRA_SHAPES:
        P, beta, H, Y = _rls_inputs(s, n, k, m, device, SEED + n + k)
        H[0] = 0.0
        Y[0] = 0.0  # stream 0 masked
        route = ops.rls_route(n, k, m)
        plan = oselm_update.single_pass_plan(n, k, m)
        if plan is not None:
            check(oselm_update.kernel_smem_bytes(n, k, m, *plan)
                  == oselm_update.single_pass_smem_bytes(n, k, m, *plan),
                  f"rls N={n} k={k} m={m}: the dispatch and the kernel disagree on shared memory")
        counter = "oselm_rls_update_fleet" if route == "single" else "rls_two_stage"
        before = ops.launch_counts[counter]
        p_got, b_got = ops.oselm_rls_update_fleet(P, beta, H, Y)
        check(ops.launch_counts[counter] == before + 1, f"rls N={n} k={k}: {counter} not launched")
        p_want, b_want = ref.rls_update_ref(P, beta, H, Y)
        ep = (p_got - p_want).abs().max().item()
        eb = (b_got - b_want).abs().max().item()
        check(ep <= 2e-5 and eb <= 2e-4,
              f"rls S={s} N={n} k={k} m={m} ({route}): P err {ep} (2e-5), beta err {eb} (2e-4)")
        check(torch.equal(p_got[0], P[0]) and torch.equal(b_got[0], beta[0]),
              f"rls S={s} N={n} k={k} m={m} ({route}): masked stream changed")
        print(f"kernel 2 RLS update S={s} N={n} k={k} m={m} route={route} plan={plan}: "
              f"P |err| {ep:.3e}, beta |err| {eb:.3e}, masked stream exact")
        errs[counter] = max(errs.get(counter, 0.0), ep, eb)
        del P, beta, H, Y, p_got, b_got, p_want, b_want
    # Kernel 3: the one-head entry (S = 1, k up to 64).
    n, k, m = K3_SHAPE
    P, beta, H, Y = (a[0] for a in _rls_inputs(1, n, k, m, device, SEED + 3))
    before = ops.launch_counts["oselm_rls_update"]
    p_got, b_got = ops.oselm_rls_update(P, beta, H, Y)
    check(ops.launch_counts["oselm_rls_update"] == before + 1, "rls one head: kernel not launched")
    p_want, b_want = (a[0] for a in ref.rls_update_ref(P[None], beta[None], H[None], Y[None]))
    ep = (p_got - p_want).abs().max().item()
    eb = (b_got - b_want).abs().max().item()
    check(ep <= 2e-5 and eb <= 2e-4, f"rls one head N={n} k={k}: P err {ep}, beta err {eb}")
    print(f"kernel 3 oselm_rls_update N={n} k={k} m={m}: P |err| {ep:.3e}, beta |err| {eb:.3e}")
    errs["oselm_rls_update"] = max(ep, eb)
    return errs


def phase_kernel_rows(device="cuda"):
    """The readout and feature-mean kernels vs ``ref.readout_ref`` and
    ``ref.row_abs_mean_ref`` on the card (rtol and atol 1e-5: f32 sums of
    up to 561 terms in another order)."""
    import torch

    from repro_torch.kernels import ops, ref

    g = _gen(device, SEED + 7)
    errs = {}
    cases = [("readout", shape) for shape in READOUT_SHAPES]
    cases += [("row_abs_mean", shape) for shape in ROW_MEAN_SHAPES]
    for name, shape in cases:
        if name == "readout":
            s, n, m = shape
            h = torch.sigmoid(torch.randn(s, n, generator=g, device=device))
            beta = 0.1 * torch.randn(s, n, m, generator=g, device=device)
            before = ops.launch_counts[name]
            got, want = ops.readout(h, beta), ref.readout_ref(h, beta)
        else:
            x = 2.0 * torch.randn(*shape, generator=g, device=device)
            before = ops.launch_counts[name]
            got, want = ops.row_abs_mean(x), ref.row_abs_mean_ref(x)
        check(ops.launch_counts[name] == before + 1, f"{name} {shape}: kernel not launched")
        err = (got - want).abs().max().item()
        check(got.shape == want.shape and torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"{name} {shape}: max |err| {err} beyond rtol and atol 1e-5")
        if shape in (READOUT_SHAPES[0], ROW_MEAN_SHAPES[0]):
            errs[name] = err
    print(f"row kernels: readout {len(READOUT_SHAPES)} shapes, fleet |err| {errs['readout']:.3e}; "
          f"row_abs_mean {len(ROW_MEAN_SHAPES)} shapes, fleet |err| {errs['row_abs_mean']:.3e}")
    return errs


def _boot_core(data, theta, n_hidden, device):
    """``tests/test_odl_system.py::_boot_core`` on the port."""
    import torch

    from repro_torch.core import odl_head, oselm, pruning

    elm = oselm.OSELMConfig(
        n_in=561, n_hidden=n_hidden, n_out=6, variant="hash", seed=77, ridge=1e-2
    )
    ladder = {} if theta == "auto" else {"ladder": (theta,)}
    cfg = odl_head.ODLCoreConfig(
        elm=elm, prune=pruning.PruneConfig(min_trained=max(n_hidden, 288), **ladder)
    )
    x0 = torch.as_tensor(data.train_x, device=device)
    y0 = torch.nn.functional.one_hot(
        torch.as_tensor(data.train_y, device=device).long(), 6
    ).to(torch.float32)
    st0 = oselm.init_state_batch(elm, x0, y0)
    return cfg, odl_head.init_state(cfg, device)._replace(elm=st0)


def phase_paper(device="cuda", n_hidden=128):
    """S=1 paper path at full width; ``tests/test_odl_system.py``'s claims."""
    from repro_torch.core import odl_head, pruning
    from repro_torch.data import har

    data = har.generate(seed=SEED)
    ox, oy, tx, ty = har.odl_split(data, 0.6, 0)
    res = {}
    for theta in (1.0, "auto"):
        cfg, core = _boot_core(data, theta, n_hidden, device)
        if theta == 1.0:
            res["acc_before_drift"] = float(
                odl_head.accuracy(core, data.test0_x, data.test0_y, cfg))
            res["acc_noodl"] = float(odl_head.accuracy(core, tx, ty, cfg))
        t0 = time.perf_counter()
        core, _ = odl_head.run_training_phase(core, ox, oy, cfg)
        acc = float(odl_head.accuracy(core, tx, ty, cfg))
        secs = time.perf_counter() - t0
        tag = "full" if theta == 1.0 else "auto"
        res[f"acc_{tag}"] = acc
        res[f"comm_{tag}"] = float(pruning.comm_volume_fraction(core.prune))
        res[f"ticks_per_s_{tag}"] = len(ox) / secs
    print("paper path (S=1, N=%d, %d ticks): %s" % (n_hidden, len(ox), json.dumps(res)))
    check(res["acc_before_drift"] > 0.90, "accuracy before drift <= 0.90")
    check(res["acc_noodl"] < res["acc_before_drift"] - 0.05, "drift drop <= 5 pts")
    check(res["acc_full"] > res["acc_noodl"] + 0.025, "ODL recovery <= 2.5 pts")
    check(res["comm_full"] == 1.0, "theta=1 comm volume != 1")
    check(res["comm_auto"] < 0.70, "auto comm volume >= 0.70")
    check(res["acc_auto"] > res["acc_full"] - 0.02, "auto accuracy < full - 2 pts")
    return res


def _fleet_ticks(data, n_ticks, n_streams, shift_at, device, seed):
    """(T, S, 561) ticks gathered on the device from rows uploaded once:
    test0 rows before ``shift_at``, shifted test1 rows from it on."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    calm_x = torch.as_tensor(data.test0_x, device=device)
    calm_y = torch.as_tensor(data.test0_y, device=device)
    shift_x = torch.as_tensor(np.clip(data.test1_x * 4.0 + 2.0, -3, 3).astype(np.float32),
                              device=device)
    shift_y = torch.as_tensor(data.test1_y, device=device)
    n_calm = min(shift_at, n_ticks)
    i0 = torch.as_tensor(rng.integers(0, len(data.test0_x), (n_calm, n_streams)), device=device)
    i1 = torch.as_tensor(
        rng.integers(0, len(data.test1_x), (n_ticks - n_calm, n_streams)), device=device
    )
    xs = torch.cat([calm_x[i0], shift_x[i1]])
    ys = torch.cat([calm_y[i0], shift_y[i1]])
    return xs, ys


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _run_fleet_once(cfg, xs, ys, mode, device):
    import torch

    from repro_torch import engine
    from repro_torch.kernels import ops

    n_ticks, n_streams = ys.shape
    state = engine.init_fleet(cfg, n_streams, device)
    _sync(device)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    state, outs = engine.run_fleet(state, xs, ys, cfg, mode=mode)
    _sync(device)
    secs = time.perf_counter() - t0
    counts = dict(ops.launch_counts)
    # Accounting identities with the teacher always available.
    observed = outs.mode_training.to(torch.int32).sum(0)
    check(torch.equal(state.prune.queries + state.prune.skips, observed),
          f"{mode}: queries + skips != ticks in training mode")
    check(torch.equal(state.meter.up_bytes,
                      outs.queried.to(torch.float32).sum(0) * (cfg.elm.n_in * 4)),
          f"{mode}: up_bytes != n_in * 4 * queries")
    for name, t in (("beta", state.elm.beta), ("P", state.elm.P), ("outputs", outs.outputs)):
        check(bool(torch.isfinite(t).all()), f"{mode}: non-finite {name}")
    check(outs.pred.shape == (n_ticks, n_streams), f"{mode}: pred shape {tuple(outs.pred.shape)}")
    return state, outs, secs, counts


def phase_fleet(device="cuda", n_streams=FLEET_STREAMS, n_hidden=128,
                train_ticks=TRAIN_TICKS, algo1_ticks=ALGO1_TICKS):
    """``har_odl.full()`` fleet through ``run_fleet`` in two modes."""
    import torch

    from repro_torch.configs import har_odl
    from repro_torch.data import har

    cfg = har_odl.full(n_hidden=n_hidden)
    data = har.generate(seed=SEED)
    res = {"launches": {}}
    runs = {}
    for mode, n_ticks, shift_at in _fleet_modes(train_ticks, algo1_ticks):
        xs, ys = _fleet_ticks(data, n_ticks, n_streams, shift_at, device, SEED + n_ticks)
        state, outs, secs, counts = _run_fleet_once(cfg, xs, ys, mode, device)
        runs[mode] = (state, outs)
        for name, n in counts.items():
            if device == "cuda" and name in MODE_KERNELS[mode]:
                check(n >= n_ticks, f"{mode}: {name} launched {n} < {n_ticks} times")
            res["launches"][name] = res["launches"].get(name, 0) + n
        if device == "cuda":
            check(counts["rls_two_stage"] == 0, f"{mode}: the fleet shape took the two-stage route")
        res[f"{mode}_stream_ticks_per_s"] = n_streams * n_ticks / secs
        res[f"{mode}_secs"] = secs
        if mode == "algo1":
            training = outs.mode_training[shift_at:]
            res["algo1_streams_training"] = int(training.any(0).sum())
            res["algo1_queries_after_shift"] = int(outs.queried[shift_at:].sum())
            check(not bool(outs.mode_training[:shift_at].any()), "algo1: training before shift")
            check(res["algo1_streams_training"] > 0, "algo1: no stream entered training")
            check(res["algo1_queries_after_shift"] > 0, "algo1: no queries after shift")
        else:
            check(bool(outs.queried.all()), "train_phase: a cold head skipped a query")
        del xs, ys, state, outs
    print(f"fleet path (S={n_streams}, N={n_hidden}): {json.dumps(res)}")
    return res, runs


def _fleet_modes(train_ticks=TRAIN_TICKS, algo1_ticks=ALGO1_TICKS):
    """(mode, ticks, shift tick) of the fleet and stream paths."""
    return (("train_phase", train_ticks, train_ticks), ("algo1", algo1_ticks, ALGO1_SHIFT_AT))


def phase_cross_check(n_streams=256, n_ticks=32):
    """The same small fleet run on the card (kernels) and on the CPU (plain
    versions).  Decisions must match; weights and outputs within
    ``tests/test_kernels.py``'s tolerance for P starting at I/ridge (rtol
    and atol 2e-3); predictions may differ only at near-ties."""
    import torch

    from repro_torch.configs import har_odl
    from repro_torch.data import har

    cfg = har_odl.full()
    data = har.generate(seed=SEED)
    xs, ys = _fleet_ticks(data, n_ticks, n_streams, n_ticks, "cpu", SEED + 1)
    out = {}
    for device in ("cuda", "cpu"):
        state, outs = _run_fleet_once(cfg, xs.to(device), ys.to(device), "train_phase", device)[:2]
        out[device] = (state.elm.beta.cpu(), state.elm.P.cpu(), outs)
    (bc, pc, oc), (bp, pp, op) = out["cuda"], out["cpu"]
    for f in ("queried", "mode_training", "theta"):
        check(torch.equal(getattr(oc, f).cpu(), getattr(op, f)), f"cross-check: {f} differs")
    mismatch = (oc.pred.cpu() != op.pred).float().mean().item()
    check(mismatch <= 1e-3, f"cross-check: {mismatch:.2e} of predictions differ")
    for name, a, b in (("beta", bc, bp), ("P", pc, pp), ("outputs", oc.outputs.cpu(), op.outputs)):
        check(torch.allclose(a, b, rtol=2e-3, atol=2e-3), f"cross-check: {name} differs")
    print(f"cross-check card vs cpu (S={n_streams}, T={n_ticks}, train_phase): decisions equal, "
          f"pred mismatch {mismatch:.2e}, beta |err| {(bc - bp).abs().max().item():.3e}, "
          f"P |err| {(pc - pp).abs().max().item():.3e}")


def _train_phase_rate(device="cuda", n_streams=FLEET_STREAMS, n_ticks=TRAIN_TICKS):
    """Fleet ``train_phase`` stream-ticks per second (host clock), after a
    warm-up run that takes the first launches, the allocator's growth and
    the library handles out of the timing."""
    from repro_torch.configs import har_odl
    from repro_torch.data import har

    cfg = har_odl.full()
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks, n_streams, n_ticks, device,
                          SEED + n_ticks)
    _run_fleet_once(cfg, xs[:4], ys[:4], "train_phase", device)
    return n_streams * n_ticks / _run_fleet_once(cfg, xs, ys, "train_phase", device)[2]


def _profile_window(device="cuda", n_streams=FLEET_STREAMS, n_ticks=PROFILE_TICKS):
    """``torch.profiler`` over a short ``train_phase`` window at full width
    (every stream queries and learns): (wall ms per tick, the device-side
    events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har

    cfg = har_odl.full()
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks + 1, n_streams, n_ticks + 1, device,
                          SEED + 2)
    state = engine.init_fleet(cfg, n_streams, device)
    state, _ = engine.fleet_step(state, xs[0], ys[0], cfg, mode="train_phase")  # warm-up
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(1, n_ticks + 1):
            state, _ = engine.fleet_step(state, xs[t], ys[t], cfg, mode="train_phase")
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    # Device-side events only (kernels, copies): a CPU op's device time is
    # that of the kernels it launched, which are listed again on their own.
    return wall_ms / n_ticks, [e for e in prof.key_averages()
                               if e.device_type == DeviceType.CUDA
                               and e.self_device_time_total > 0]


def phase_profile(device="cuda", n_streams=FLEET_STREAMS, n_ticks=PROFILE_TICKS):
    """Where a fleet tick's time goes, and a check that the RLS update is
    one kernel per tick there."""
    wall_ms, events = _profile_window(device, n_streams, n_ticks)
    rows = sorted(((e.self_device_time_total / 1e3 / n_ticks, e.key) for e in events),
                  reverse=True)
    # The RLS update is one kernel per tick: no separate PHt product, no
    # k x k solve, no two-stage pass.
    rls = [e for e in events if "rls_single_kernel" in e.key]
    check(len(rls) == 1 and rls[0].count == n_ticks,
          f"profile: rls_single_kernel ran {[e.count for e in rls]} times in {n_ticks} ticks")
    stray = [e.key for e in events if any(w in e.key for w in ("trsm", "getrf", "getrs",
                                                                "rls_fleet_kernel"))]
    check(not stray, f"profile: the RLS update launched more than its kernel: {stray}")
    if not rows:
        print(f"profile (S={n_streams}): {wall_ms:.3f} ms/tick wall; the profiler "
              "recorded no device time (device busy share not measured)")
        return {"wall_ms": wall_ms, "device_ms": float("nan")}
    busy = sum(ms for ms, _ in rows)
    print(f"profile (S={n_streams}, train_phase, {n_ticks} ticks): "
          f"{wall_ms:.3f} ms/tick wall, device busy {busy:.3f} ms/tick "
          f"({100 * busy / wall_ms:.1f} % of wall)")
    for ms, name in rows[:10]:
        print(f"  {ms:8.4f} ms/tick  {100 * ms / busy:5.1f} %  {name[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy}


def _run_stream_once(cfg, ticks, labels, mode, device, teacher_kw=None, **kw):
    """One ``stream.run`` of the port over ``ticks`` (host arrays, shipped
    by the session) on ``device``: (state, outputs, stats, seconds)."""
    import torch

    from repro_torch import engine
    from repro_torch.engine import stream

    teacher = stream.LatencyTeacher(stream.array_labels(labels), **(teacher_kw or {}))
    state = engine.init_fleet(cfg, ticks.shape[1], device)
    _sync(device)
    t0 = time.perf_counter()
    state, outs, stats = stream.run(state, iter(ticks), cfg, teacher, mode=mode, **kw)
    _sync(device)
    secs = time.perf_counter() - t0
    check(stats.reconciled, f"stream {mode}: the accounting identity does not hold: "
                            f"{stats.summary()}")
    for name, t in (("beta", state.elm.beta), ("P", state.elm.P)):
        check(bool(torch.isfinite(t).all()), f"stream {mode}: non-finite {name}")
    return state, outs, stats, secs


def _state_leaves(state):
    """(name, tensor) of every leaf of an ``EngineState``."""
    return [(f"{g}.{leaf}", getattr(getattr(state, g), leaf))
            for g in ("elm", "prune", "drift", "meter") for leaf in getattr(state, g)._fields]


def _decisions_and_floats_agree(what, outs_a, outs_b, state_a, state_b):
    """The ROADMAP long-run rule: decisions exact tick by tick; predictions
    apart only at near-ties (the two classes' outputs within the float
    tolerance), and the ladder's streak and level apart only on the streams
    where one flipped (a flip turns an agreement into a mismatch); floats
    within rtol and atol 2e-3.  Returns the share of predictions apart."""
    import numpy as np
    import torch

    for f in ("queried", "trained", "mode_training", "theta"):
        check(np.array_equal(getattr(outs_a, f), getattr(outs_b, f)), f"{what}: {f} differs")
    flips = outs_a.pred != outs_b.pred
    mismatch = float(np.mean(flips))
    check(mismatch <= 1e-3, f"{what}: {mismatch:.2e} of predictions differ")
    t_idx, s_idx = np.nonzero(flips)
    o = outs_b.outputs[t_idx, s_idx]
    rows = np.arange(len(t_idx))
    gap = np.abs(o[rows, outs_a.pred[t_idx, s_idx]] - o[rows, outs_b.pred[t_idx, s_idx]])
    check(bool(np.all(gap <= 2e-3 + 2e-3 * np.abs(o).max(axis=-1, initial=0.0))),
          f"{what}: a prediction differs away from a near-tie (gaps {gap.tolist()})")
    check(np.allclose(outs_a.outputs, outs_b.outputs, rtol=2e-3, atol=2e-3),
          f"{what}: outputs differ")
    flipped = torch.as_tensor(flips.any(axis=0))
    for (name, a), (_, b) in zip(_state_leaves(state_a), _state_leaves(state_b)):
        a, b = a.cpu(), b.cpu()
        if a.dtype == torch.float32:
            ok = torch.allclose(a, b, rtol=2e-3, atol=2e-3)
        elif name in ("prune.streak", "prune.level"):
            ok = torch.equal(a[~flipped], b[~flipped])
        else:
            ok = torch.equal(a, b)
        check(ok, f"{what}: state leaf {name} differs")
    return mismatch


def phase_stream(runs, device="cuda", n_streams=FLEET_STREAMS):
    """6c: the fleet through ``stream.run`` with graphed runners, ticks
    shipped from host memory.  Zero latency must equal the eager
    ``run_fleet`` runs of phase 6 (``runs``) bit for bit; then ``algo1``
    with a late, lossy teacher under each backpressure policy."""
    import numpy as np
    import torch

    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    cfg = har_odl.full()
    data = har.generate(seed=SEED)
    res = {}
    ops.reset_launch_counts()
    graphs.reset_replay_counts()
    for mode, n_ticks, shift_at in _fleet_modes():
        xs, ys = _fleet_ticks(data, n_ticks, n_streams, shift_at, device, SEED + n_ticks)
        ticks, labels = xs.cpu().numpy(), ys.cpu().numpy()
        del xs, ys
        state, outs, stats, secs = _run_stream_once(cfg, ticks, labels, mode, device,
                                                    {"latency": 0})
        f_state, f_outs = runs[mode]
        f_host = {f: getattr(f_outs, f).cpu().numpy() for f in f_outs._fields}
        differ = [f for f in f_outs._fields if not np.array_equal(f_host[f], getattr(outs, f))]
        differ += [name for (name, a), (_, b) in zip(_state_leaves(f_state), _state_leaves(state))
                   if not torch.equal(a, b)]
        res[f"{mode}_bit_for_bit"] = not differ
        if differ:
            print(f"stream {mode}: differs from run_fleet in {differ}; holding it to the "
                  "long-run rule instead")
            _decisions_and_floats_agree(f"stream {mode} vs run_fleet", outs,
                                        f_outs._replace(**f_host), state, f_state)
        check(stats.labels_applied == stats.queries_issued == int(outs.queried.sum()),
              f"stream {mode}: a zero-latency label was not applied")
        res[f"{mode}_stream_ticks_per_s"] = n_streams * n_ticks / secs
        res[f"{mode}_tick_p50_ms"] = stats.tick_p50_ms
        res[f"{mode}_tick_p95_ms"] = stats.tick_p95_ms
        del state, outs, f_state, f_outs
    n_ticks = ticks.shape[0]
    for policy in POLICIES:
        state, outs, stats, secs = _run_stream_once(
            cfg, ticks, labels, "algo1", device, STREAM_TEACHER, capacity=STREAM_CAPACITY,
            backpressure=policy)
        check(stats.labels_applied > 0, f"stream algo1 {policy}: no label applied")
        summary = stats.summary()
        res[policy] = {k: summary[k] for k in (
            "queries_issued", "labels_applied", "queries_dropped", "queries_lost",
            "queries_coalesced", "asks_deferred", "replies_orphaned", "tick_p50_ms",
            "tick_p95_ms", "label_latency_p50", "label_latency_p95")}
        res[policy]["ticks_per_s"] = n_ticks / secs
        del state, outs
    res["launches"] = dict(ops.launch_counts)
    res["kernel_replays"] = dict(graphs.kernel_replays)
    res["runner_replays"] = dict(graphs.replay_counts)
    for name in PATH_KERNELS:
        check(device != "cuda" or res["kernel_replays"][name] >= n_ticks,
              f"stream: {name} replayed {res['kernel_replays'][name]} < {n_ticks} times")
    check(res["launches"]["rls_two_stage"] == res["kernel_replays"]["rls_two_stage"] == 0,
          "stream: the fleet shape took the two-stage route")
    print(f"stream path (S={n_streams}, graphed runners, ticks from host memory): "
          f"{json.dumps(res)}")
    return res


def phase_stream_cross_check(n_streams=STREAM_CHECK["n_streams"],
                             n_ticks=STREAM_CHECK["n_ticks"]):
    """6d: one small stream run with latency on the card (graphs, kernels)
    and on the CPU (eager, plain versions).  Counters and decisions must be
    equal; a ring entry aliasing a graph's static buffers would train on
    the wrong features and break the floats."""
    from repro_torch.configs import har_odl
    from repro_torch.data import har

    cfg = har_odl.full()
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks, n_streams, n_ticks, "cpu", SEED + 3)
    teacher = {"latency": STREAM_CHECK["latency"], "jitter": STREAM_CHECK["jitter"], "seed": SEED}
    runs = {device: _run_stream_once(cfg, xs.numpy(), ys.numpy(), "train_phase", device,
                                     teacher, capacity=STREAM_CHECK["capacity"],
                                     backpressure="drop_oldest")
            for device in ("cuda", "cpu")}
    (sc, oc, tc, _), (sh, oh, th, _) = runs["cuda"], runs["cpu"]
    sc_sum, th_sum = tc.summary(), th.summary()
    for k in sc_sum:
        if isinstance(sc_sum[k], int) and not isinstance(sc_sum[k], bool):
            check(sc_sum[k] == th_sum[k], f"stream cross-check: counter {k} differs")
    check(list(tc.label_latency_ticks) == list(th.label_latency_ticks),
          "stream cross-check: label latencies differ")
    mismatch = _decisions_and_floats_agree("stream cross-check", oc, oh, sc, sh)
    print(f"stream cross-check card vs cpu (S={n_streams}, T={n_ticks}, latency "
          f"{STREAM_CHECK['latency']}, jitter {STREAM_CHECK['jitter']}, capacity "
          f"{STREAM_CHECK['capacity']}): counters and decisions equal "
          f"(applied {tc.labels_applied}, dropped {tc.queries_dropped}, orphaned "
          f"{tc.replies_orphaned}), pred mismatch {mismatch:.2e}, beta |err| "
          f"{(sc.elm.beta.cpu() - sh.elm.beta).abs().max().item():.3e}")


def _stream_window(device="cuda", n_streams=FLEET_STREAMS, n_ticks=PROFILE_TICKS,
                   profiled=False, collect=True):
    """A graphed zero-latency ``train_phase`` session at full width, ticks on
    the card: three ticks capture its graphs, then ``n_ticks`` advances are
    timed (under ``torch.profiler`` when ``profiled``).  Returns (wall ms
    per tick, the profiler or None)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import stream

    cfg = har_odl.full()
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks + 4, n_streams, n_ticks + 4, device,
                          SEED + 5)
    teacher = stream.LatencyTeacher(stream.array_labels(ys.cpu().numpy()))
    sess = stream.StreamSession(engine.init_fleet(cfg, n_streams, device), cfg, teacher,
                                mode="train_phase", collect=collect)
    sess.start(xs[0])
    for t in range(1, 4):
        sess.advance(xs[t])
    _sync(device)
    window = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext())
    with window as prof:
        t0 = time.perf_counter()
        for t in range(4, n_ticks + 4):
            sess.advance(xs[t])
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_ticks
    sess.advance(None)
    sess.finish()
    return wall_ms, prof


def phase_stream_profile(eager, fleet, device="cuda", n_streams=FLEET_STREAMS,
                         n_ticks=PROFILE_TICKS):
    """6e: a profiler window over graphed stream ticks.  Each tick must run
    one projection and one RLS kernel; prints the tick's device time, the
    busy share (profiled, and over an unprofiled window's wall), the host's
    time by call, an unprofiled window without the ``collect`` pulls, and
    the eager fleet tick of phases 6 and 6b beside it."""
    from torch.autograd import DeviceType

    unprofiled_ms, _ = _stream_window(device, n_streams, n_ticks)
    no_collect_ms, _ = _stream_window(device, n_streams, n_ticks, collect=False)
    wall_ms, prof = _stream_window(device, n_streams, n_ticks, profiled=True)
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    for kernel in ("proj_kernel", "rls_single_kernel", "readout_kernel"):
        hits = [e for e in dev if kernel in e.key]
        check(len(hits) == 1 and hits[0].count == n_ticks,
              f"stream profile: {kernel} ran {[e.count for e in hits]} times in {n_ticks} "
              "graphed ticks")
    rows = sorted(((e.self_device_time_total / 1e3 / n_ticks, e.key) for e in dev), reverse=True)
    busy = sum(ms for ms, _ in rows)
    host = sorted(((e.self_cpu_time_total / 1e3 / n_ticks, e.key) for e in events
                   if e.device_type == DeviceType.CPU and e.self_cpu_time_total > 0),
                  reverse=True)
    eager_ms = 1e3 * fleet["train_phase_secs"] / TRAIN_TICKS
    print(f"stream profile (S={n_streams}, graphed train_phase, {n_ticks} ticks on the card): "
          f"{wall_ms:.3f} ms/tick wall profiled, {unprofiled_ms:.3f} unprofiled; device "
          f"{busy:.3f} ms/tick ({100 * busy / wall_ms:.1f} % of the profiled wall, "
          f"{100 * busy / unprofiled_ms:.1f} % of the unprofiled); one proj_kernel, one "
          f"rls_single_kernel and one readout_kernel per tick")
    print(f"  unprofiled without the collect pulls: {no_collect_ms:.3f} ms/tick "
          f"({100 * busy / no_collect_ms:.1f} % busy)")
    print(f"  eager fleet tick beside it: {eager_ms:.3f} ms unprofiled (phase 6), "
          f"{eager['wall_ms']:.3f} ms profiled with {eager['device_ms']:.3f} ms device "
          f"(phase 6b)")
    for ms, name in rows[:8]:
        print(f"  device {ms:8.4f} ms/tick  {100 * ms / busy:5.1f} %  {name[:80]}")
    for ms, name in host[:8]:
        print(f"  host   {ms:8.4f} ms/tick  {name[:80]}")
    return {"wall_ms": wall_ms, "unprofiled_ms": unprofiled_ms, "device_ms": busy,
            "no_collect_ms": no_collect_ms}


def _stacked_rows_differ(cfg, width, n_members, device, seed):
    """One ``algo1`` plan and one learn on ``n_members`` stacked members of
    ``width`` streams and on each member alone (heads warmed by two learns
    first): the plan fields and state leaves whose rows differ."""
    import torch

    from repro_torch import engine
    from repro_torch.engine import fleet
    from repro_torch.engine.types import tree_map

    g = _gen(device, seed)
    total, m = width * n_members, cfg.elm.n_out
    st = engine.init_fleet(cfg, total, device)
    for _ in range(2):
        st, p = fleet.plan(st, torch.randn(total, cfg.elm.n_in, generator=g, device=device), cfg,
                           mode="train_phase")
        lab = torch.randint(0, m, (total,), generator=g, device=device).to(torch.int32)
        st = fleet.learn(st, p.h, lab, p.pred, p.confidence, p.queried, p.controller_on, cfg,
                         theta=p.theta)
    x = 2.0 * torch.tanh(torch.randn(total, cfg.elm.n_in, generator=g, device=device))
    lab = torch.randint(0, m, (total,), generator=g, device=device).to(torch.int32)
    mask = torch.rand(total, generator=g, device=device) < 0.7
    new, p = fleet.plan(st, x, cfg, mode="algo1")
    after = fleet.learn(new, p.h, lab, p.pred, p.confidence, mask, p.controller_on, cfg,
                        theta=p.theta)
    differ = set()
    for i in range(n_members):
        lo, hi = i * width, (i + 1) * width
        new_i, p_i = fleet.plan(tree_map(lambda a: a[lo:hi].clone(), st), x[lo:hi].clone(), cfg,
                                mode="algo1")
        after_i = fleet.learn(new_i, p_i.h, lab[lo:hi].clone(), p_i.pred, p_i.confidence,
                              mask[lo:hi].clone(), p_i.controller_on, cfg, theta=p_i.theta)
        differ |= {f"plan.{f}" for f in p._fields
                   if not torch.equal(getattr(p, f)[lo:hi], getattr(p_i, f))}
        differ |= {f"state.{name}" for (name, a), (_, b) in zip(_state_leaves(after),
                                                                _state_leaves(after_i))
                   if not torch.equal(a[lo:hi], b)}
    return sorted(differ)


def _mux_inputs(device="cuda"):
    """Each tenant's ticks (on the card) and labels (host): HAR rows, as the
    fleet path draws them; the late tenant last."""
    from repro_torch.data import har

    data = har.generate(seed=SEED)
    out = []
    for i, n_ticks in enumerate(MUX_TICKS + (MUX_LATE_TICKS,)):
        xs, ys = _fleet_ticks(data, n_ticks, MUX_STREAMS, n_ticks, device, SEED + 100 + i)
        out.append((xs, ys.cpu().numpy()))
    return out


def _mux_tenant(i, xs, ys, cfg, device):
    from repro_torch import engine
    from repro_torch.engine import multiplex, stream

    teacher = stream.LatencyTeacher(stream.array_labels(ys), **{**STREAM_TEACHER, "seed": SEED + i})
    return multiplex.Tenant(
        name=f"tenant{i:02d}", state=engine.init_fleet(cfg, MUX_STREAMS, device), ticks=iter(xs),
        cfg=cfg, teacher=teacher, mode="train_phase", capacity=STREAM_CAPACITY,
        backpressure=POLICIES[i % len(POLICIES)])


def _run_mux(inputs, cfg, device, sched="rr", fuse=True):
    """One multiplexed run of the 6f tenants, the last admitted after round 2:
    (results, aggregate stats, graph captures and their host ms by runner,
    kernel replays by runner, eager launches)."""
    from repro_torch.engine import fleet, graphs, multiplex
    from repro_torch.kernels import ops

    def patch_calls():
        info = fleet.runner_cache_info()["patch_learn_runner"]
        return info["hits"] + info["misses"]

    tenants = [_mux_tenant(i, xs, ys, cfg, device) for i, (xs, ys) in enumerate(inputs)]
    _sync(device)
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    patches = patch_calls()
    mux = multiplex.Multiplexer(tenants[:-1], quantum=MUX_QUANTUM, sched=sched, fuse=fuse)
    for _ in range(2):
        mux.round()
    mux.admit(tenants[-1])
    results, agg = mux.run()
    _sync(device)
    tallies = {"captures": dict(graphs.capture_counts), "capture_ms": dict(graphs.capture_ms),
               "replays": {k: dict(v) for k, v in graphs.runner_kernel_replays.items()},
               "runner_replays": dict(graphs.replay_counts),
               "launches": dict(ops.launch_counts), "patch_learns": patch_calls() - patches}
    return results, agg, tallies


def _result_differs(a, b):
    """Names of the state leaves, outputs and counters in which two
    ``(state, outputs, stats)`` results differ."""
    import numpy as np
    import torch

    differ = [name for (name, x), (_, y) in zip(_state_leaves(a[0]), _state_leaves(b[0]))
              if not torch.equal(x, y)]
    differ += [f for f in a[1]._fields if not np.array_equal(getattr(a[1], f), getattr(b[1], f))]
    differ += [k for k in COUNTERS if getattr(a[2], k) != getattr(b[2], k)]
    if list(a[2].label_latency_ticks) != list(b[2].label_latency_ticks):
        differ.append("label_latency_ticks")
    return differ


def _check_accounting(name, state, outs, stats, n_in):
    """The identities a ``train_phase`` tenant must meet."""
    check(stats.reconciled, f"{name}: the accounting identity does not hold: {stats.summary()}")
    check(stats.queries_issued == int(outs.queried.sum()), f"{name}: queries_issued != queried")
    check(int(state.elm.count.sum()) == stats.labels_applied == int(state.prune.queries.sum()),
          f"{name}: heads trained on another number of labels than were applied")
    check(float(state.meter.up_bytes.sum()) == 4.0 * n_in * stats.queries_issued,
          f"{name}: up_bytes != n_in * 4 * queries")


def _cohort_window(cfg, device="cuda", n_ticks=MUX_WINDOW, profiled=False, fused=True):
    """16 tenants of 1024 streams with zero-latency teachers, ticks on the
    card, fused in one ``CohortSession`` (or, not ``fused``, 16 sessions
    advanced one tick each in turn): four ticks capture the graphs, then
    ``n_ticks`` ticks of all 16 are timed (under ``torch.profiler`` when
    ``profiled``).  Returns (wall ms per tick of all 16, kernel replays and
    eager launches in the window, the profiler or None)."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine
    from repro_torch.data import har
    from repro_torch.engine import cohort, graphs, stream
    from repro_torch.kernels import ops

    n = FLEET_STREAMS // MUX_STREAMS
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks + 4, FLEET_STREAMS, n_ticks + 4,
                          device, SEED + 6)
    ys = ys.cpu().numpy()
    rows = [(i * MUX_STREAMS, (i + 1) * MUX_STREAMS) for i in range(n)]
    members = [stream.StreamSession(engine.init_fleet(cfg, MUX_STREAMS, device), cfg,
                                    stream.LatencyTeacher(stream.array_labels(ys[:, lo:hi])),
                                    mode="train_phase") for lo, hi in rows]
    if fused:
        coh = cohort.CohortSession(members)

        def tick(t):
            coh.tick([None if t is None else xs[t, lo:hi] for lo, hi in rows])
    else:
        for m, (lo, hi) in zip(members, rows):
            m.start(xs[0, lo:hi])

        def tick(t):
            for m, (lo, hi) in zip(members, rows):
                m.advance(None if t is None else xs[t, lo:hi])
    for t in range(0 if fused else 1, 4):
        tick(t)
    _sync(device)
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    window = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext())
    with window as prof:
        t0 = time.perf_counter()
        for t in range(4, n_ticks + 4):
            tick(t)
        _sync(device)
        wall_ms = 1e3 * (time.perf_counter() - t0) / n_ticks
    replays, launches = dict(graphs.kernel_replays), dict(ops.launch_counts)
    tick(None)
    for m in members:
        m.finish()
    return wall_ms, replays, launches, prof


def phase_multiplex(stream_prof, device="cuda"):
    """6f: the multiplexer at the full width (see the module docstring).
    ``stream_prof`` is phase 6e's result, for the single graphed session's
    rate beside the multiplexer's."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.configs import har_odl
    from repro_torch.engine import stream

    cfg = har_odl.full()
    res = {"stacked_rows_differ": {}}
    for w in MUX_WIDTHS:
        differ = _stacked_rows_differ(cfg, w, 16, device, SEED + w)
        res["stacked_rows_differ"][str(w)] = differ
        check(not differ, f"16 stacked members of width {w}: rows differ from solo in {differ}")

    inputs = _mux_inputs(device)
    solo = []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for i, (xs, ys) in enumerate(inputs):
        t = _mux_tenant(i, xs, ys, cfg, device)
        solo.append(stream.run(t.state, t.ticks, cfg, t.teacher, mode=t.mode, capacity=t.capacity,
                               backpressure=t.backpressure))
        _check_accounting(f"solo {t.name}", *solo[-1], cfg.elm.n_in)
    runs = {}
    for label, sched, fuse in (("fused_rr", "rr", True), ("fused_drr", "drr", True),
                               ("unfused_rr", "rr", False)):
        results, agg, tallies = _run_mux(inputs, cfg, device, sched, fuse)
        for i, want in enumerate(solo):
            r = results[f"tenant{i:02d}"]
            differ = _result_differs(want, (r.state, r.outputs, r.stats))
            check(not differ, f"{label} tenant{i:02d}: differs from solo in {differ}")
            _check_accounting(f"{label} tenant{i:02d}", r.state, r.outputs, r.stats,
                              cfg.elm.n_in)
        check(agg.stream_steps == sum(st.stream_steps for _, _, st in solo),
              f"{label}: stream steps do not add up")
        cohort_caps = {k: n for k, n in tallies["captures"].items() if k.startswith("cohort.")}
        runs[label] = {
            "steps_per_s": agg.steps_per_s, "wall_s": agg.wall_s, "rounds": agg.rounds,
            "cohort_captures": sum(cohort_caps.values()),
            "session_captures": sum(tallies["captures"].values()) - sum(cohort_caps.values()),
            "cohort_capture_ms": sum(ms for k, ms in tallies["capture_ms"].items()
                                     if k.startswith("cohort.")),
            "session_capture_ms": sum(ms for k, ms in tallies["capture_ms"].items()
                                      if not k.startswith("cohort.")),
            "cohort_replays": {k: sum(v.get(k, 0) for r, v in tallies["replays"].items()
                                      if r.startswith("cohort.")) for k in tallies["launches"]},
            "runner_replays": tallies["runner_replays"],
            "eager_launches": tallies["launches"],
            "patch_learns": tallies["patch_learns"],
        }
        check(not fuse or tallies["patch_learns"] > 0,
              f"{label}: no straggler took the patch path (the late tenant did not join)")
        del results
    fused = runs["fused_rr"]
    on_card = device == "cuda"
    for name in PATH_KERNELS[:3]:
        check(not on_card or fused["cohort_replays"][name] > 0,
              f"fused rr: the cohort replayed no {name}")
    check(runs["unfused_rr"]["cohort_captures"] == 0, "unfused rr: a cohort captured a graph")
    res["runs"] = runs
    res["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None
    del solo, inputs

    window_ms, replays, launches, _ = _cohort_window(cfg, device)
    for name in PATH_KERNELS[:3]:
        check(not on_card or replays[name] == MUX_WINDOW,
              f"cohort window: {name} replayed {replays[name]} times in {MUX_WINDOW} ticks")
    check(not on_card or not any(launches.values()), f"cohort window: eager launches {launches}")
    unfused_ms, unfused_replays, _, _ = _cohort_window(cfg, device, fused=False)
    for name in PATH_KERNELS[:3]:
        check(not on_card or unfused_replays[name] == MUX_WINDOW * FLEET_STREAMS // MUX_STREAMS,
              f"unfused window: {name} replayed {unfused_replays[name]} times")
    prof_ms, _, _, prof = _cohort_window(cfg, device, profiled=True)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / MUX_WINDOW
    rows = sorted(((e.self_device_time_total / 1e3 / MUX_WINDOW, e.key) for e in dev),
                  reverse=True)
    res["window"] = {
        "replays_per_tick": {k: replays[k] / MUX_WINDOW for k in PATH_KERNELS},
        "ms_per_tick": window_ms, "stream_ticks_per_s": 1e3 * FLEET_STREAMS / window_ms,
        "profiled_ms_per_tick": prof_ms, "device_ms_per_tick": busy,
        "busy_share_unprofiled": busy / window_ms, "busy_share_profiled": busy / prof_ms,
        "unfused_ms_per_tick": unfused_ms,
        "unfused_stream_ticks_per_s": 1e3 * FLEET_STREAMS / unfused_ms,
    }
    res["single_session_stream_ticks_per_s"] = 1e3 * FLEET_STREAMS / stream_prof["unprofiled_ms"]
    print(f"multiplexer (16 tenants x {MUX_STREAMS} streams + 1 late, train_phase, HAR rows, "
          f"late lossy teachers): {json.dumps(res)}")
    print(f"  fused rr {fused['steps_per_s'] / 1e6:.3f} M stream-ticks/s, fused drr "
          f"{runs['fused_drr']['steps_per_s'] / 1e6:.3f} M, unfused rr "
          f"{runs['unfused_rr']['steps_per_s'] / 1e6:.3f} M; steady fused window "
          f"{res['window']['stream_ticks_per_s'] / 1e6:.3f} M ({window_ms:.3f} ms/tick, device "
          f"{busy:.3f} ms, busy {100 * busy / window_ms:.1f} %); the same 16 unfused "
          f"{res['window']['unfused_stream_ticks_per_s'] / 1e6:.3f} M ({unfused_ms:.3f} ms for "
          f"all 16); single graphed session (6e) "
          f"{res['single_session_stream_ticks_per_s'] / 1e6:.3f} M")
    for ms, name in rows[:8]:
        print(f"  device {ms:8.4f} ms/tick  {100 * ms / busy:5.1f} %  {name[:80]}")
    return res


def _device_ms(fn, reps=20, rounds=3):
    """Device time of one call of ``fn``: CUDA events around a batch of
    calls, the median of ``rounds`` batches.  A sleep kernel keeps the card
    busy while the host enqueues the batch, so the events see the calls back
    to back and not the host's launch overhead (which, for calls under
    0.1 ms, is what a timing of single calls measures).  The batch is cut
    below ``reps`` where the host needs more than half the sleep to enqueue
    it, and the timing raises if the host still outran the sleep (as it does
    when a batch fills the launch queue and the host waits on the card)."""
    import torch

    t0 = time.perf_counter()
    for _ in range(3):
        fn()  # warm-up, and the host's time per call
    host_call_ms = 1e3 * (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    b.record()
    b.synchronize()
    sleep_ms = a.elapsed_time(b)
    n = max(1, min(reps, int(0.5 * sleep_ms / max(host_call_ms, 1e-3))))
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        b.record()
        b.synchronize()
        check(host_ms < sleep_ms, f"timing: the host took {host_ms:.1f} ms to enqueue, "
                                  f"longer than the {sleep_ms:.1f} ms sleep")
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def _bound(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    """The least time the card could take: (ms, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _rls_bound(s, n, k, m):
    """The whole RLS update: P in and out, beta in and out, H and Y in;
    2 S N^2 (2k + m) operations (PHt, the downdate, P' W) at the f32 rate."""
    return _bound(flops=2.0 * s * n * n * (2 * k + m),
                  nbytes=4.0 * (2 * s * n * n + 2 * s * n * m + s * k * n + s * k * m))


def _rls_composite(P, beta, H, Y):
    """The torch composite of one RLS update: the small operands, then two
    ``baddbmm`` calls (the yardstick; the port never calls it)."""
    import torch

    from repro_torch.kernels import oselm_update

    pht, g, w = oselm_update.small_operands(P, beta, H, Y)
    return torch.baddbmm(beta, torch.baddbmm(P, pht, g, alpha=-1), w)


def _cycling_x(device, b, n_in):
    """A function that returns three x of (b, n_in) f32 in turn: at the
    fleet shape each is 36.8 MB, so x comes from device memory and not the
    50 MB L2, as in a fleet tick."""
    import torch

    gen = _gen(device, SEED)
    xs = [torch.randn(b, n_in, generator=gen, device=device) for _ in range(3)]
    turn = iter(range(10 ** 9))
    return lambda: xs[next(turn) % len(xs)]


def phase_times(device="cuda"):
    """Median times at the fleet path's shapes (kernel 3 and the two-stage
    route at theirs), with bounds."""
    import torch

    from repro_torch.core import xorshift
    from repro_torch.kernels import ops, oselm_update, plan_rows, ref, xorshift_proj

    rows = []
    b, n_in, n = K1_SHAPES[0]
    x = _cycling_x(device, b, n_in)
    alpha = xorshift.alpha_hash(0x2D2A, n_in, n, device=device)
    c = float(1.0 / n_in ** 0.5)
    # Three TF32 products on the tensor cores: the work at the precision the
    # kernel must deliver.
    bound_ms, bound_by = _bound(flops=3 * 2.0 * b * n_in * n, nbytes=4.0 * (b * n_in + b * n),
                                peak_flops=PEAK_TF32_FLOPS)
    rows.append(dict(
        name="xorshift_projection",
        ms=_device_ms(lambda: xorshift_proj.xorshift_projection(x(), 0x2D2A, n)),
        plain_ms=_device_ms(lambda: ref.xorshift_projection_ref(x(), 0x2D2A, n), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: torch.sigmoid(torch.matmul(x(), alpha) * c)),
        library="sigmoid(matmul(x, alpha) * c), cuBLAS f32",
        bound_ms=bound_ms,
        bound_by=bound_by,
    ))
    del x, alpha

    s, n, k, m = K2_SHAPES[0]
    P, beta, H, Y = _rls_inputs(s, n, k, m, device, SEED)
    rows.append(dict(
        name="oselm_rls_update_fleet",
        ms=_device_ms(lambda: oselm_update.rls_single(P, beta, H, Y)),
        plain_ms=_device_ms(lambda: ref.rls_update_ref(P, beta, H, Y), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: _rls_composite(P, beta, H, Y), reps=PLAIN_REPS),
        library="torch composite: small_operands + 2x baddbmm",
        two_stage_ms=_device_ms(lambda: oselm_update.rls_fleet(
            P, beta, *oselm_update.small_operands(P, beta, H, Y)), reps=PLAIN_REPS),
        **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))),
    ))
    del P, beta, H, Y

    n, k, m = K3_SHAPE
    P, beta, H, Y = (a[0] for a in _rls_inputs(1, n, k, m, device, SEED + 3))
    rows.append(dict(
        name="oselm_rls_update",
        ms=_device_ms(lambda: ops.oselm_rls_update(P, beta, H, Y)),
        plain_ms=_device_ms(lambda: ref.rls_update_ref(P[None], beta[None], H[None], Y[None]),
                            reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: _rls_composite(P[None], beta[None], H[None], Y[None]),
                              reps=PLAIN_REPS),
        library="torch composite: small_operands + 2x baddbmm",
        **dict(zip(("bound_ms", "bound_by"), _rls_bound(1, n, k, m))),
    ))

    # The two-stage route's kernel, the fused pass, on small operands made
    # beforehand (at S=64 torch's batched solve waits on the host, which no
    # batch timing can hide; the route as a whole is timed above at the
    # fleet shape).
    s, n, k, m = TWO_STAGE_SHAPE
    P, beta, H, Y = _rls_inputs(s, n, k, m, device, SEED + 4)
    check(ops.rls_route(n, k, m) == "two_stage", f"{TWO_STAGE_SHAPE} is not a two-stage shape")
    pht, g, w = oselm_update.small_operands(P, beta, H, Y)
    bound_ms, bound_by = _bound(
        flops=2.0 * s * n * n * (k + m),
        nbytes=4.0 * (2 * s * n * n + 2 * s * n * m + 2 * s * n * k + s * n * m))
    rows.append(dict(
        name="rls_two_stage",
        ms=_device_ms(lambda: oselm_update.rls_fleet(P, beta, pht, g, w)),
        plain_ms=_device_ms(lambda: ref.rls_fused_ref(P, beta, pht, g, w), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: torch.baddbmm(beta, torch.baddbmm(P, pht, g, alpha=-1), w)),
        library="2x baddbmm",
        bound_ms=bound_ms,
        bound_by=bound_by,
    ))
    # The row kernels at the fleet shape: h and beta of a tick, and x.
    s, n, m = READOUT_SHAPES[0]
    gen = _gen(device, SEED + 8)
    h = torch.sigmoid(torch.randn(s, n, generator=gen, device=device))
    beta = 0.1 * torch.randn(s, n, m, generator=gen, device=device)
    rows.append(dict(
        name="readout",
        ms=_device_ms(lambda: plan_rows.readout(h, beta)),
        plain_ms=_device_ms(lambda: ref.readout_ref(h, beta)),
        library_ms=_device_ms(lambda: torch.bmm(h[:, None, :], beta)),
        library="torch.bmm (cuBLAS batched)",
        **dict(zip(("bound_ms", "bound_by"), _bound(
            flops=2.0 * s * n * m, nbytes=4.0 * (s * n + s * n * m + s * m)))),
    ))
    del h, beta
    s, n = ROW_MEAN_SHAPES[0]
    x = _cycling_x(device, s, n)
    rows.append(dict(
        name="row_abs_mean",
        ms=_device_ms(lambda: plan_rows.row_abs_mean(x())),
        plain_ms=_device_ms(lambda: ref.row_abs_mean_ref(x())),
        library_ms=None,
        library="none (no single call; the plain version is abs, then mean)",
        **dict(zip(("bound_ms", "bound_by"), _bound(flops=2.0 * s * n,
                                                     nbytes=4.0 * (s * n + s)))),
    ))
    del x
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ({r['library']}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % of it reached)")
    print(f"time the two-stage route at the fleet shape: {rows[1]['two_stage_ms']:.4f} ms")
    return rows


def time_port(root: Path, device="cuda") -> dict:
    """``--time-port``: the same measurements for the port at ``root``,
    through its public entry points, so that two checkouts are timed by one
    piece of code."""
    from repro_torch.kernels import build, ops, xorshift_proj

    build.build_all()
    out = {"root": str(root), "card": _card()}
    b, n_in, n = K1_SHAPES[0]
    x = _cycling_x(device, b, n_in)
    out["projection_ms"] = _device_ms(lambda: xorshift_proj.xorshift_projection(x(), 0x2D2A, n))
    del x
    P, beta, H, Y = _rls_inputs(*K2_SHAPES[0], device, SEED)
    out["rls_update_ms"] = _device_ms(lambda: ops.oselm_rls_update_fleet(P, beta, H, Y))
    del P, beta, H, Y
    out["train_phase_stream_ticks_per_s"] = _train_phase_rate(device)
    # The graphed stream path (32 zero-latency train_phase ticks on the card
    # after three that capture the graphs), behind a warm-up session: the
    # first stream session of a process runs slow; null where the checkout
    # has no stream path.
    out["stream_stream_ticks_per_s"] = None
    if importlib.util.find_spec("repro_torch.engine.stream") is not None:
        _stream_window(device, n_ticks=4)
        out["stream_stream_ticks_per_s"] = (
            1e3 * FLEET_STREAMS / _stream_window(device, n_ticks=TRAIN_TICKS)[0])
    # The fused multiplexer of phase 6f (fused rr, the late tenant included),
    # behind a warm-up run; null where the checkout has no multiplexer.
    out["multiplex_fused_stream_ticks_per_s"] = None
    if importlib.util.find_spec("repro_torch.engine.multiplex") is not None:
        from repro_torch.configs import har_odl

        cfg = har_odl.full()
        inputs = _mux_inputs(device)
        _run_mux([(xs[:4], ys[:4]) for xs, ys in inputs], cfg, device)
        out["multiplex_fused_stream_ticks_per_s"] = _run_mux(inputs, cfg, device)[1].steps_per_s
        del inputs
    wall_ms, events = _profile_window(device)
    kernels = {e.key[:80]: e.self_device_time_total / 1e3 / PROFILE_TICKS for e in events}
    out["profiled_tick_wall_ms"] = wall_ms
    out["profiled_tick_device_ms"] = sum(kernels.values())
    out["profiled_busy_share"] = out["profiled_tick_device_ms"] / wall_ms
    # The profiler slows the host, so also: the profiled device time over an
    # unprofiled tick's wall (from the train_phase rate above).
    out["unprofiled_tick_ms"] = 1e3 * FLEET_STREAMS / out["train_phase_stream_ticks_per_s"]
    out["device_over_unprofiled_tick"] = (out["profiled_tick_device_ms"]
                                          / out["unprofiled_tick_ms"])
    out["profiled_kernels_ms"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--time-port", type=Path, metavar="PATH",
                    help="only time the port of the checkout at PATH; print one JSON line")
    args = ap.parse_args(argv)
    if args.time_port is not None:
        # Ahead of this checkout's src, so that PATH's repro_torch is imported.
        sys.path.insert(0, str(args.time_port.resolve() / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card", file=sys.stderr)
        return 1
    if args.time_port is not None:
        print(json.dumps(time_port(args.time_port)))
        return 0
    t_start = time.perf_counter()
    phase_card()
    phase_build()
    err1 = phase_kernel1()
    err2 = phase_kernel2()
    err_rows = phase_kernel_rows()
    phase_paper()
    fleet, runs = phase_fleet()
    phase_cross_check()
    eager = phase_profile()
    streamed = phase_stream(runs)
    del runs
    phase_stream_cross_check()
    stream_prof = phase_stream_profile(eager, fleet)
    mux = phase_multiplex(stream_prof)
    times = {r["name"]: r for r in phase_times()}

    rls_src = "src/repro_torch/kernels/csrc/oselm_update.cu"
    rows_src = "src/repro_torch/kernels/csrc/plan_rows.cu"
    meta = {
        "xorshift_projection": dict(
            source="src/repro_torch/kernels/csrc/xorshift_proj.cu",
            replaces="src/repro/kernels/xorshift_proj.py:138",
            max_abs_err=err1,
        ),
        "oselm_rls_update_fleet": dict(
            source=rls_src, replaces="src/repro/kernels/oselm_update.py:172",
            max_abs_err=err2["oselm_rls_update_fleet"],
        ),
        "oselm_rls_update": dict(
            source=rls_src, replaces="src/repro/kernels/oselm_update.py:88",
            max_abs_err=err2["oselm_rls_update"],
        ),
        "rls_two_stage": dict(
            source=rls_src, replaces="src/repro/kernels/oselm_update.py:172",
            max_abs_err=err2["rls_two_stage"],
        ),
        # Not ports of a Pallas kernel: the port's plan ops whose CUDA kernels
        # split a row's sum by S (the reference computes them in XLA).
        "readout": dict(
            source=rows_src, replaces="src/repro/engine/fleet.py:133",
            max_abs_err=err_rows["readout"],
        ),
        "row_abs_mean": dict(
            source=rows_src, replaces="src/repro/core/drift.py:64",
            max_abs_err=err_rows["row_abs_mean"],
        ),
    }
    kernels = []
    for name, info in meta.items():
        t = times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": info["source"],
            "replaces": info["replaces"],
            "launches": fleet["launches"][name],
            # The stream path (phase 6c): eager launches (the warm-up before
            # each graph's capture) and launches by graph replays.
            "stream_launches": streamed["launches"][name],
            "graph_replays": streamed["kernel_replays"][name],
            # The multiplexer (phase 6f, fused rr): replays by the cohorts' graphs.
            "cohort_replays": mux["runs"]["fused_rr"]["cohort_replays"].get(name, 0),
            "max_abs_err": info["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": t["library"],
            "ok": True,
        })
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
