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
   one-head entry) and the two-stage route; masked streams exact; then the
   plan's per-stream pass (``csrc/plan_rows.cu``) against
   ``ref.plan_rows_ref`` fed the kernel's own readout and feature mean, bit
   for bit in every output and leaf, in ``algo1``, ``serve`` and
   ``train_phase`` at every ``PLAN_SHAPES`` entry, and its reduced instances
   alone (the readout, the feature mean) within 1e-5;
5. the paper path: S=1, N=128, ``run_training_phase`` with theta=1 and the
   auto ladder, held to ``tests/test_odl_system.py``'s claims;
5b. the paper's tables: ``repro_torch.benchmarks.paper_tables`` on the card,
   one trial per drift row (18 trials, 10 distinct, of 1008 one-stream
   ticks: one repeat runs again, the other seven are served from the first
   run), Tables 2-3 at N=128 and N=256 for ODLBase and ODLHash.  Every row
   is printed beside the paper's value; Tables 1 and 4 and Fig 4's mW must
   equal the port's models, Tables 2-3 and Fig 3 must meet
   ``tests/test_odl_system.py``'s claims, the trial run twice must give the
   same result, two trials must agree with the CPU (accuracy within 1 pt,
   comm within 2 pts), and the projection, the plan's pass and the
   single-pass RLS (one per tick) must have launched at both widths.  Before it, the
   kernels are held against their plain versions at the path's own shapes
   (one stream a tick; the boot's and the accuracy sets' batches);
6. the fleet path: ``har_odl.full()`` at S=16,384 streams, ``train_phase``
   for 32 ticks and ``algo1`` for 96, through ``run_fleet``; the launch
   counts show both kernels ran, and the accounting identities hold;
   then a small fleet run on the card and on the CPU must agree, and a
   profiler window shows where a tick's device time goes (the RLS update
   must be one kernel per tick there); 6b also lists the CUDA kernels of
   one eager ``plan`` per mode, which must be the projection and the
   plan's pass and nothing else;
6c. the stream path: the same fleet through ``stream.run`` with the runners
   replayed as CUDA graphs and ticks shipped from host memory; with a
   zero-latency teacher it must equal ``run_fleet`` bit for bit, then
   ``algo1`` with a late, lossy teacher under each backpressure policy must
   keep the query accounting exact;
6d. a small stream run with latency on the card and on the CPU must agree
   (decisions and counters equal);
6e. a profiler window over graphed stream ticks: one projection, one RLS
   kernel and one plan pass per tick, and where the tick's device and host
   time go;
6f. the multiplexer: 16 tenants of 1024 streams (the fleet's 16,384 when
   stacked) through ``multiplex.run``, ``train_phase`` on HAR rows, a late,
   lossy teacher per tenant, the four policies four tenants each, 12
   tenants of 32 ticks and 4 of 24 (members detach mid-run), and a 17th
   tenant admitted after round 2 (the patch path).  Fused ``rr``, fused
   ``drr``, unfused ``rr`` and each tenant solo through ``stream.run`` must
   give every tenant bit-for-bit the same result, with exact accounting.
   Before that, one plan and one learn on 16 stacked members must equal
   each member's own at member widths 1, 3 and 1024, and one plan at width
   3 with N=33, m=7 (N m odd, rows at every alignment); after it, a window of
   fused cohort ticks must replay one projection and one RLS kernel per
   tick for the whole cohort (and a profiler window gives its busy share);
6g. durability at the same width: each policy's 6c ``algo1`` run is
   snapshotted at ticks 48 and 80 of 96 and restored into a fresh session
   on the card, and must end bit for bit as 6c's uninterrupted run;
   ``drop_oldest`` goes through the disk (a full and a delta save) and the
   wire frame, which must keep every leaf; a teacher that cannot snapshot
   re-asks or drops the in-flight ring with exact accounting.  Then 6f's
   tenants: one extracted out of the fused cohort mid-run and admitted into
   a second multiplexer, and ``run_supervised`` with cadence snapshots and
   one injected crash (exactly one restart), every tenant bit for bit its
   solo run; then ``python -m repro_torch.engine.durable --crash-smoke``
   as a subprocess.  It prints the snapshot's size, the capture, publish,
   load, restore and first-tick times and the frame's encode and decode
   times, beside the card's name and power limit;
6h. the teacher over a real loopback socket (``engine/rpc.py``, the label
   server a ``python -m repro_torch.engine.rpc`` subprocess): the graphed
   session at the fleet width taught by a v2 ``RpcTeacher`` behind the sync
   wrapper must equal the same session taught by ``LatencyTeacher(latency=0)``
   with the server's label rule bit for bit, in ``train_phase`` (16 ticks)
   and in ``algo1`` through the drift (``rpc_bit_for_bit``), with the ask
   frame's bytes and the per-ask D2H, encode and round-trip ms; the same 16
   ticks unwrapped (stream·ticks/s); a faults run (server loss and jitter,
   client deadline, telemetry on) whose accounting reconciles with queries
   lost, the scraped identity holding mid-run and at the end, and the
   server's wire-scraped counters agreeing with the client's; 4 tenants of
   4096 streams, fused, over a shared batched connection, per-tenant v2
   connections and the shared connection with zlib, every label checked;
   the port's ``rpc_bench`` at the reference bench's shape (v1 included;
   its launches and replays counted apart); and telemetry's overhead on
   6e's window, off and on in turns.  Every shape 6h calls a kernel at must
   be one phases 2-4 held against the plain version;
6i. the elastic fleet (``runtime/worker.py``, ``runtime/elastic.py``): two
   port workers spawned on the card; four 4,096-stream ``train_phase``
   tenants, one per policy, fuse on w0 into the fleet's 16,384 rows, and
   past tick 16 each is extracted, shipped through this process over the
   snapshot wire and admitted on w1; each must end bit for bit as its solo
   run in this process on the card (state, counters, label latencies, no
   re-ask).  Then four ``algo1`` tenants of 1,024 streams and one taught
   over a loopback socket drain off w0 by ``Router.scale_in``: w0 exits 0
   and the fleet's accounting reconciles per tenant and in sum.  Each
   worker's own scrape (w0 just before its scale-in, w1 at the end) must
   show every path kernel launched or replayed in that worker, and every
   shape it launched or captured a kernel at must be one phases 2-4 held.
   It prints each migration's extract, admit and ship ms and wire bytes,
   each worker's kernel counts, peak device memory (its allocator's) and
   Σ s·tick_rate_ema, nvidia-smi's compute apps, and the phase's seconds;
6j. stream-axis sharding (``engine.split_fleet``/``run_fleet_shards``,
   ``shard_fleet``/``run_fleet_sharded``, ``stream.run_sharded``) under
   ``sharding.activate`` of a mesh of four ``cuda:0`` entries (one card:
   the shards share it): (a) phase 6's two runs through the blocked path,
   one 4,096-stream block a shard and the default 512-stream block, each
   bit for bit phase 6's ``run_fleet``; (b) S=16,381 (3 dead tail rows)
   through both layouts, bit for bit ``run_fleet`` at that S, the padding
   stripped; (c) ``run_sharded`` over 4 shards: a zero-latency teacher bit
   for bit 6c's zero-latency runs, ``LatencyTeacher(latency=3)`` bit for
   bit the solo ``stream.run``, and a late, lossy ``algo1`` run whose
   accounting reconciles per shard and in sum; (d) the blocked
   ``train_phase`` run merged at tick 16, saved by ``CheckpointManager``,
   restored with ``shardings`` onto the card, split into 2 shards and run
   to tick 32, bit for bit the uninterrupted run.  It prints the path
   kernels' launches and replays on the sharded paths (each > 0), the
   shapes they ran at (each held in phases 2-4), sharded against solo
   stream·ticks/s and the phase's seconds;
6k. the dense backbone's serving path (``models/``, ``launch/serve.py``) at
   qwen3-4b's full width, weights drawn on the card from the seed: (a) the
   parameter count (4,411,424,256, ``count_params``), build seconds and the
   allocator's peak; (b) 256 streams prefilled with 15 tokens, then
   ``serve_step`` of token 16, within atol 0.15, rtol 0.05 of
   ``lm_hidden``'s logits over all 16; (c) ``lm_hidden`` over a 1,024-token
   prompt at B=2, naive against chunked attention (chunk 256), through the
   first two layers (the depth of the reference's bounds): Frobenius
   relative error < 3e-2, max abs < 0.15, and through all 36 (printed: the
   two algorithms' rounding differs and compounds with depth, in the JAX
   package as here); (d) two decodes of 16 tokens from
   one prefill, bit for bit, and the decode ms per token; (e) 64 ticks of
   ``serve_step`` + ``serve_apply_labels`` at B=256 with a synchronous
   teacher answering the queried streams (the serve cascade), each tick
   launching the projection and the plan's pass once and, with an answer,
   the RLS pass once; (h) a profiler window over 8 more such ticks: the
   device ms of the backbone decode against the ODL head, the head's
   kernels, and the device busy share; (f) ``launch.serve.serve`` at B=256,
   64 tokens, 2 tenants, latency 2, then over the loopback rpc teacher,
   each reconciled; (g) a decode tenant (B=256, 48 ticks) on two port
   workers spawned on the card, migrated after tick 16, bit for bit its solo
   run in this process, with each worker's path kernels from its own scrape.
   Every shape 6k launched a kernel at must be one phases 2-4 held;
7. times of each kernel and route, its plain version and its library
   yardstick, and its bound; the projection and the RLS update also at
   N=256 (S=16,384, P 4 GiB) and, with the plan's pass in ``serve``, at 6k's
   serving shape (256 streams, n_in 2,560); the plan's pass in ``algo1``
   (reads x) and ``train_phase`` (reads no x), in ``serve`` at n_in 8,192
   (x read from device memory), and its reduced instances alone.

The line before the last is the ``kernels`` JSON summary; the last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest
of the repository, it exits non-zero and prints no result.

    python3 chip_smoke.py --time-port PATH

instead times the port of the checkout at PATH (``.`` for this one) with
this script's timing code and prints one JSON line: the card, the device
time of the projection and of the whole RLS update at the fleet shape,
fleet ``train_phase`` stream-ticks per second after a warm-up, the same
for the graphed stream path, for the fused multiplexer of phase 6f and for
6h's unwrapped session over the wire, one paper drift trial's seconds and
the graphed stream tick's device ms (each null for a checkout without it),
and the profiled eager tick (wall, device time per kernel, busy share).  To compare two checkouts, run it for both in
turns on one card (A, B, B, A).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
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
# Phase 6j's shard blocks are here too: 4,096 rows (a shard of the fleet's
# 16,384 over SHARDS) and the default 512-stream block.
# Phase 6h's shapes are here too: its multiplexer's member (4,096 rows) and
# rpc_bench's tenant (64) and fused cohort (256) at n_in=N=64; 6h fails if
# its path calls a kernel at a shape these lists do not hold.  So are the
# shapes a 6i worker can launch at: a cohort of 1-4 members of 4,096 rows
# and of 1-4 of 1,024; 6i fails on a shape a worker reports that these do
# not hold.
K1_SHAPES = [(FLEET_STREAMS, 561, 128), (8, 128, 128), (8, 256, 384), (3, 561, 128),
             (130, 100, 72), (1, 16, 16), (4096, 561, 128), (64, 64, 64), (256, 64, 64),
             (48, 561, 33), (3, 561, 33), (8192, 561, 128), (12288, 561, 128),
             (1024, 561, 128), (2048, 561, 128), (3072, 561, 128), (512, 561, 128),
             (256, 2560, 128), (512, 2560, 128), (4, 64, 128),
             (FLEET_STREAMS, 561, 256)]
K2_SHAPES = [(FLEET_STREAMS, 128, 1, 6), (512, 256, 1, 6), (1, 128, 16, 6),
             (4096, 128, 1, 6), (64, 64, 1, 6), (256, 64, 1, 6), (8192, 128, 1, 6),
             (12288, 128, 1, 6), (1024, 128, 1, 6), (2048, 128, 1, 6), (3072, 128, 1, 6),
             (512, 128, 1, 6), (256, 128, 1, 6), (FLEET_STREAMS, 256, 1, 6)]
# Phase 7 also times the projection and the RLS update at N=256 (the
# paper's Tables 2-3 width), at the fleet's S: the last shape of each list.
K1_N256, K2_N256 = K1_SHAPES[-1], K2_SHAPES[-1]
# Phase 6k's serving shape (256 streams of qwen3-4b's d_model = 2,560; two
# fused tenants are 512 rows) and a smoke-width one (the card tests'), held
# by phases 2-4 and timed by phase 7; the plan's pass also at the widest
# dense d_model (chameleon-34b's 8,192), where x rows do not fit a stage.
K1_BACKBONE, K2_BACKBONE = (256, 2560, 128), (256, 128, 1, 6)
PLAN_BACKBONE, PLAN_WIDE = (256, 128, 6, 2560), (256, 128, 6, 8192)
# Phase 5b, the paper's tables on the card: one trial per drift row (the
# reference runs 3 for Table 2 and Fig 4, 5 for Table 3 and Fig 3), so 18
# trials of 1008 one-stream ticks; two of them run on the CPU as well.
PAPER_TRIALS = 1
PAPER_CROSS = (("hash", 256), ("base", 128))
PAPER_WIDTHS = (128, 256)
PAPER_KERNELS = ("xorshift_projection", "oselm_rls_update_fleet", "plan_rows")
# Shapes the single pass does not take go to the two-stage route.
K2_EXTRA_SHAPES = [(64, 384, 1, 6), (4, 64, 64, 3)]
K3_SHAPE = (128, 16, 6)  # one head: N, k, m
TWO_STAGE_SHAPE = (64, 384, 1, 6)
# The kernels the fleet path launches every tick (``ops.launch_counts`` keys),
# in every mode: the projection, the RLS update and the plan's per-stream pass.
PATH_KERNELS = ("xorshift_projection", "oselm_rls_update_fleet", "plan_rows")
MODE_KERNELS = {"train_phase": PATH_KERNELS, "algo1": PATH_KERNELS}
PLAN_MODES = ("algo1", "serve", "train_phase")
# The plan's per-stream pass against its plain version, (S, N, m, n_in), in
# every mode; the first is the fleet's.  Every shape of READOUT_SHAPES with
# m >= 2 is here, with 6h's (4,096 rows; rpc_bench's 64 and 256 at
# n_in = N = 64), the paper path's (one stream at N = 128 and 256), 6d's
# and 6f's, and 6f's odd cohort (N m = 231: rows at every alignment).
PLAN_SHAPES = [(FLEET_STREAMS, 128, 6, 561), (1, 128, 6, 561), (3, 16, 4, 24), (130, 33, 7, 100),
               (4096, 128, 6, 561), (64, 64, 6, 64), (256, 64, 6, 64), (1, 256, 6, 561),
               (256, 128, 6, 561), (1024, 128, 6, 561), (48, 128, 6, 561), (16, 128, 6, 561),
               (3, 128, 6, 561), (3, 33, 7, 561), (48, 33, 7, 561), (8192, 128, 6, 561),
               (12288, 128, 6, 561), (2048, 128, 6, 561), (3072, 128, 6, 561),
               (512, 128, 6, 561), (256, 128, 6, 2560), (512, 128, 6, 2560), (4, 128, 6, 64),
               (8, 128, 6, 7168), (8, 128, 6, 8192), (256, 128, 6, 8192)]
# Its reduced instances alone against theirs: (S, N, m) of the readout, (S,
# n) of the feature mean; the first of each is the fleet's.
READOUT_SHAPES = [(FLEET_STREAMS, 128, 6), (1, 128, 6), (3, 16, 4), (1024, 100, 1), (130, 33, 7),
                  (4096, 128, 6), (64, 64, 6), (256, 64, 6)]
ROW_MEAN_SHAPES = [(FLEET_STREAMS, 561), (1, 561), (3, 24), (130, 100)]
# Phase 6f's cohort at an odd N m: 16 members of 3 streams, N = 33, m = 7.
ODD_COHORT = dict(width=3, n_members=16, n_hidden=33, n_out=7)
# Phase 6f, the multiplexer: 16 tenants of 1024 streams stack to the fleet's
# 16,384; 12 run 32 ticks and 4 run 24, and one more of 32 ticks is admitted
# after round 2.
MUX_STREAMS = 1024
MUX_TICKS = (32,) * 12 + (24,) * 4
MUX_LATE_TICKS = 32
MUX_QUANTUM = 8
MUX_WIDTHS = (1, 3, 1024)  # member widths of the row-independence check, 16 members each
MUX_WINDOW = 8  # fused cohort ticks per timed window
# Phase 6g: the 6c algo1 runs are snapshotted at these ticks of 96 (before
# the drift at 64: an idle ring; after it: tickets in flight), 6f's tenant00
# is extracted once its tick reaches DURABLE_EXTRACT_TICK, and the supervised
# run snapshots every DURABLE_SNAPSHOT_EVERY ticks with one crash injected at
# DURABLE_CRASH_TICK (after the first snapshot).
DURABLE_SNAP_TICKS = (48, 80)
DURABLE_EXTRACT_TICK = 13
DURABLE_SNAPSHOT_EVERY = 12
DURABLE_CRASH_TICK = 20
# Phase 6h, the teacher over the wire: 6c's algo1 ticks, the first
# RPC_TRAIN_TICKS in train_phase (every stream asks, so every tick is one
# ask frame of S rows); the faults run's server loses RPC_FAULTS["loss_prob"]
# of the asks (its per-connection draw is seeded: with 16 asks on the first
# connection it loses two) and jitters replies, under a client deadline; the
# multiplexer runs RPC_MUX_TENANTS tenants, each a block of the fleet's rows,
# for RPC_MUX_TICKS ticks; the port's rpc_bench runs at
# the reference bench's own shape (the only place the v1 wire runs);
# telemetry's overhead is timed on 6e's window, blocks of ticks off and on in
# turns, against the reference's 2 % budget.
RPC_TRAIN_TICKS = 16
RPC_FAULTS = dict(loss_prob=0.05, jitter_s=0.005)
RPC_FAULT_TIMEOUT_S = 3.0
RPC_MUX_TENANTS = 4
RPC_BENCH = dict(tenant_counts=(4,), s=64, t=200, iters=1)
RPC_MUX_TICKS = 8
RPC_OVERHEAD_BLOCKS = 16
RPC_OVERHEAD_BLOCK_TICKS = 4
TELEMETRY_BUDGET_PCT = 2.0
# Phase 6i, the elastic fleet: two workers (quantum 1); four tenants of
# ``streams`` (one per policy, train_phase, ``ticks`` synth ticks, capacity
# 4) fuse on w0 into the fleet's 16,384 rows and each migrates to w1 once all
# are past tick ``cut``; then four algo1 tenants of ``scale_streams`` and a
# train_phase one taught by a loopback label server that answers each frame
# ``rpc_delay_s`` late drain off w0 by scale-in once past tick ``drain_at``.
# The delay keeps that tenant's tickets in flight when it moves, so its
# extract's quiesce has answers to wait for; a ticket is re-asked on w1 only
# where that wait runs out, and the re-asks are printed, not required.
# Stationary synth ticks never drift, so the algo1 tenants issue no query:
# the fifth one's queries make the fleet's accounting identity non-vacuous.
# w0 goes on ticking the tenants not yet moved while the router ships one
# (the drain takes ~3.7 s; a round of these tenants ~50-80 ms, mostly the
# host's synth draws), so ``scale_ticks`` leaves each about four times the
# ticks the drain can take.  The rpc tenant (~13 ticks a second over the
# wire) is admitted, and so drained, first, and runs ``rpc_ticks``.
ELASTIC = dict(streams=4096, ticks=64, cut=16, capacity=4, scale_streams=1024, scale_ticks=320,
               rpc_ticks=96, drain_at=8, rpc_delay_s=0.05)
# Phase 6j, sharding: SHARDS entries of one card in the mesh; S=16,381 for
# the padded case (SHARD_DEAD_ROWS dead tail rows); the blocked train_phase run is saved
# at tick SHARD_SAVE_TICK and restored onto SHARD_RESCALE shards.
SHARDS = 4
SHARD_DEAD_ROWS = 3
SHARD_SAVE_TICK = 16
SHARD_RESCALE = 2
# Phase 6k, the dense backbone's serving path at qwen3-4b's full width
# (4,411,424,256 parameters, 8.82 GB in bf16; the KV cache of 256 streams
# over 128 slots 4.83 GB): (b) and (e)-(h) at ``batch`` streams; (c) over a
# ``chunk_prompt``-token prompt at ``chunk_batch``, bounded at
# ``chunk_depth`` layers (the reference's bounds are its 2-layer smoke
# model's) and printed through all 36; (d) ``replay_ticks``
# decoded twice; (e) ``cascade_ticks``, then (h) ``profile_ticks`` profiled;
# (f) ``serve`` at ``serve_tokens``; (g) a ``worker_ticks`` decode tenant
# moved between two workers past tick ``worker_cut``.
BACKBONE = dict(arch="qwen3-4b", variant="full", params=4_411_424_256, batch=256, max_len=128, prompt_len=16,
                chunk_batch=2, chunk_prompt=1024, chunk=256, chunk_depth=2, replay_ticks=16,
                cascade_ticks=64,
                profile_ticks=8, serve_tokens=64, worker_ticks=48, worker_cut=16)
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


def _plan_inputs(s, n, m, n_in, device, gen):
    """A config of (n_in, N, m) and the plan pass's inputs for ``s`` streams
    drawn on the card: h, beta (some rows with tied outputs), x, and
    prune, drift and meter states and counts at the controllers' edges (the
    detector's boot steps and warm-up, the ladder's ends, ``min_trained``),
    a partly available teacher and a forced-drift mask."""
    import torch

    from repro_torch.core import drift as drift_mod
    from repro_torch.core import labels, oselm, pruning
    from repro_torch.engine.types import EngineConfig

    cfg = EngineConfig(elm=oselm.OSELMConfig(n_in=n_in, n_hidden=n, n_out=m))
    pc, dc, i32 = cfg.prune, cfg.drift, torch.int32

    def pick(values):
        v = torch.tensor(values, device=device)
        return v[torch.randint(0, len(values), (s,), generator=gen, device=device)]

    def ints(lo, hi):
        return torch.randint(lo, hi, (s,), generator=gen, device=device, dtype=i32)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    beta = randn(s, n, m) * pick([0.01, 0.3, 3.0])[:, None, None]
    tied = rand(s) < 0.2
    beta[tied, :, 1] = beta[tied, :, 0]
    lv = len(pc.ladder)
    return cfg, dict(
        h=torch.sigmoid(randn(s, n)), beta=beta,
        x=2.0 * randn(s, n_in) * pick([0.1, 1.0, 6.0])[:, None],
        count=pick([0, pc.min_trained - 1, pc.min_trained, 10 ** 6]).to(i32),
        prune=pruning.PruneState(ints(-1, lv + 1), ints(0, pc.x_consec + 1), ints(0, 500),
                                 ints(0, 500), ints(0, 400)),
        drift=drift_mod.DriftState(
            randn(s) * pick([0.0, 1e-6, 1.0]), randn(s).abs() * pick([1e-14, 1e-3, 1.0]),
            pick([0, 1, 7, 8, 9, dc.warmup - 1, dc.warmup, 10 ** 4]).to(i32),
            ints(0, dc.enter_hits + 1), ints(0, dc.exit_calm + 1), rand(s) < 0.4),
        meter=labels.CommMeter(ints(0, 1000).float() * (n_in * 4), ints(0, 1000).float()),
        teacher_available=rand(s) < 0.75, drift_active=rand(s) < 0.3)


def _hold_plan_rows(shape, device, gen):
    """The fused pass at (S, N, m, n_in) in every mode, with and without a
    teacher mask, against ``ref.plan_rows_ref`` fed the kernel's own readout
    and feature mean: every output and leaf bit for bit; the readout and the
    feature mean themselves against ``ref.readout_ref`` and
    ``ref.row_abs_mean_ref`` (f32 sums in another order): the readout within
    1e-5 (1 + sum |h beta|) per output, the feature mean at rtol and atol
    1e-5.  Returns the largest absolute error of the two."""
    import torch

    from repro_torch.engine.types import tree_leaves
    from repro_torch.kernels import plan_rows, ref

    s = shape[0]
    cfg, args = _plan_inputs(*shape, device, gen)
    err = 0.0
    for mode in PLAN_MODES:
        for avail in (args["teacher_available"], None):
            kw = dict(args, teacher_available=avail)
            a = (torch.empty(s, device=device) if mode != "train_phase" else None)
            got = plan_rows.plan_rows(**kw, cfg=cfg, mode=mode, feature_mean=a)
            want = ref.plan_rows_ref(**kw, cfg=cfg, mode=mode, o=got.outputs, a=a)
            differ = [f for f, g, w in zip(got._fields, got, want)
                      if any(x.dtype != y.dtype or not torch.equal(x, y)
                             for x, y in zip(tree_leaves(g), tree_leaves(w)))]
            check(not differ, f"plan_rows {mode} {shape}: {differ} differ from the plain version")
            # f32 sums in another order: within 1e-5 of the sum of the terms'
            # magnitudes (beta reaches 3 here, so o cancels), plus 1e-5.
            h, beta, x = args["h"], args["beta"], args["x"]
            scale = (h.abs()[:, :, None] * beta.abs()).sum(1)
            gap = (got.outputs - ref.readout_ref(h, beta)).abs()
            check(bool((gap <= 1e-5 * (1.0 + scale)).all()),
                  f"plan_rows {mode} {shape}: readout |err| {gap.max().item()} beyond 1e-5 of "
                  "the terms' magnitudes")
            err = max(err, gap.max().item())
            if a is not None:
                e = (a - ref.row_abs_mean_ref(x)).abs().max().item()
                check(torch.allclose(a, ref.row_abs_mean_ref(x), rtol=1e-5, atol=1e-5),
                      f"plan_rows {mode} {shape}: feature mean |err| {e} beyond rtol and atol "
                      "1e-5")
                err = max(err, e)
    return err


def phase_kernel_rows(device="cuda"):
    """Phase 4, the plan's per-stream pass: the fused kernel against
    ``ref.plan_rows_ref`` at every ``PLAN_SHAPES`` entry (``_hold_plan_rows``),
    and its reduced instances alone, the readout and the feature mean,
    against ``ref.readout_ref`` and ``ref.row_abs_mean_ref`` (rtol and atol
    1e-5: f32 sums of up to 561 terms in another order)."""
    import torch

    from repro_torch.kernels import ops, ref

    held = {(s, n, m) for s, n, m, _ in PLAN_SHAPES}
    check(all(sh in held for sh in READOUT_SHAPES if sh[2] >= 2),
          "a readout shape with m >= 2 is not held by the fused pass")
    g = _gen(device, SEED + 7)
    errs = {"plan_rows": _hold_plan_rows(PLAN_SHAPES[0], device, g)}
    for shape in PLAN_SHAPES[1:]:
        _hold_plan_rows(shape, device, g)
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
    print(f"plan rows (phase 4): the fused pass bit for bit against ref.plan_rows_ref in "
          f"{', '.join(PLAN_MODES)} at {len(PLAN_SHAPES)} shapes, fleet readout and feature "
          f"mean |err| {errs['plan_rows']:.3e}; readout alone {len(READOUT_SHAPES)} shapes, "
          f"fleet |err| {errs['readout']:.3e}; feature mean alone {len(ROW_MEAN_SHAPES)} "
          f"shapes, fleet |err| {errs['row_abs_mean']:.3e}")
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


def _paper_kernels_vs_plain(batches, device="cuda"):
    """The paper path's kernel calls at its own shapes against their plain
    versions on the card: the projection at every batch it is given (the
    boot's training set, the two accuracy sets and one row a tick), and the
    RLS update and the plan's pass at one stream a tick."""
    import torch

    from repro_torch.kernels import ops, ref

    g = _gen(device, SEED + 5)
    errs = {"xorshift_projection": 0.0, "oselm_rls_update_fleet": 0.0, "plan_rows": 0.0}
    for n in PAPER_WIDTHS:
        for b in batches:
            x = 0.3 * torch.randn(b, 561, generator=g, device=device)
            got = ops.xorshift_projection(x, 77, n)
            err = (got - ref.xorshift_projection_ref(x, 77, n)).abs().max().item()
            check(err <= 1e-5, f"paper projection {b}x561x{n}: err {err} > 1e-5")
            errs["xorshift_projection"] = max(errs["xorshift_projection"], err)
        P, beta, H, Y = _rls_inputs(1, n, 1, 6, device, SEED + 5 + n)
        check(ops.rls_route(n, 1, 6) == "single", f"paper RLS N={n} is not a single-pass shape")
        p_got, b_got = ops.oselm_rls_update_fleet(P, beta, H, Y)
        p_want, b_want = ref.rls_update_ref(P, beta, H, Y)
        ep = (p_got - p_want).abs().max().item()
        eb = (b_got - b_want).abs().max().item()
        check(ep <= 2e-5 and eb <= 2e-4, f"paper RLS S=1 N={n}: P err {ep}, beta err {eb}")
        errs["oselm_rls_update_fleet"] = max(errs["oselm_rls_update_fleet"], ep, eb)
        errs["plan_rows"] = max(errs["plan_rows"], _hold_plan_rows((1, n, 6, 561), device, g))
    return errs


def phase_paper_tables(device="cuda"):
    """Phase 5b: ``repro_torch.benchmarks.paper_tables`` on the card with
    ``PAPER_TRIALS`` per drift row, Tables 2-3 at N=128 and N=256.  Every
    row is printed beside the paper's value; the analytic rows must equal
    the port's models, the drift rows must meet ``tests/test_odl_system.py``'s
    claims, a trial run twice must give the same result, two trials must
    agree with the same trials on the CPU, and the projection, the plan's
    pass and the single-pass RLS must have launched at both widths.  Returns the
    launches and the kernels' errors at the path's shapes."""
    from repro_torch.benchmarks import common, paper_tables
    from repro_torch.core import memory_model as mm
    from repro_torch.core import power_model as pm
    from repro_torch.data import har
    from repro_torch.kernels import ops

    splits = har.generate(seed=0)
    ox, _, _, tx = har.odl_split(splits, 0.6, 0)
    n_ticks = len(ox)
    errs = _paper_kernels_vs_plain(
        sorted({1, len(splits.train_x), len(splits.test0_x), len(tx)}), device)
    trial = common.drift_trial
    runs: dict[tuple, list] = {}  # (variant, N, theta) -> results, in call order
    per_n = {n: dict.fromkeys(ops.launch_counts, 0) for n in PAPER_WIDTHS}
    trial_secs = []

    done: dict[tuple, dict] = {}  # trial arguments -> result
    served = []  # repeats answered from ``done``

    def counted(run_seed, theta, n_hidden=128, variant="hash", dataset_seed=0, device=None):
        # The tables ask for 10 distinct trials 18 times: the first repeat runs
        # again (for the determinism check below), the later ones are served.
        key = (run_seed, theta, n_hidden, variant, dataset_seed, device)
        if key in done and len(trial_secs) > len(done):
            served.append(key)
            return dict(done[key])
        before = dict(ops.launch_counts)
        t0 = time.perf_counter()
        r = trial(run_seed, theta, n_hidden, variant, dataset_seed, device)
        trial_secs.append(time.perf_counter() - t0)
        for k, v in ops.launch_counts.items():
            per_n[n_hidden][k] += v - before[k]
        runs.setdefault((variant, n_hidden, theta), []).append(r)
        done.setdefault(key, r)
        return dict(r)

    t_start = time.perf_counter()
    ops.reset_launch_counts()
    common.drift_trial = counted
    try:
        rows = (paper_tables.table1_memory() + paper_tables.table4_core()
                + paper_tables.table2_params(PAPER_TRIALS, device)
                + paper_tables.table3_drift(PAPER_TRIALS, device)
                + paper_tables.fig3_pruning(PAPER_TRIALS, device)
                + paper_tables.fig4_power(PAPER_TRIALS, device))
    finally:
        common.drift_trial = trial
    launches = dict(ops.launch_counts)
    secs = time.perf_counter() - t_start
    print(f"paper tables on {device} ({PAPER_TRIALS} trial per drift row, {len(trial_secs)} "
          f"trials of {n_ticks} ticks run and {len(served)} repeats served from them, "
          f"{secs:.1f} s; a trial {min(trial_secs):.2f}-{max(trial_secs):.2f} s):")
    for name, value, derived in rows:
        print(f"  {name},{value},{derived}")
    got = {name: value for name, value, _ in rows}

    # Tables 1 and 4, Table 2's counts and Fig 4's mW: the port's models.
    for var in ("noodl", "base", "hash"):
        for n in mm.PAPER_TABLE1["hidden"]:
            check(got[f"table1/{var}/N{n}_kB"] == mm.memory_kb(var, mm.CoreShape(N=n)),
                  f"table1 {var} N={n}")
    s = mm.CoreShape()
    t4 = {"predict_ms": pm.predict_time_ms(s), "train_ms": pm.train_time_ms(s),
          "predict_mw": pm.P_PRED_MW, "train_mw": pm.P_TRAIN_MW, "idle_mw": pm.P_IDLE_MW,
          "sleep_mw": pm.P_SLEEP_MW}
    for n in (64, 256):
        t4[f"predict_ms_N{n}"] = pm.predict_time_ms(mm.CoreShape(N=n))
        t4[f"train_ms_N{n}"] = pm.train_time_ms(mm.CoreShape(N=n))
    for k, v in t4.items():
        check(got[f"table4/{k}"] == v, f"table4 {k}")
    for n in PAPER_WIDTHS:
        check(got[f"table2/N{n}/params"] == mm.odl_param_count(mm.CoreShape(N=n)),
              f"table2 N={n} params")
    for theta in (1.0, 0.32, 0.16, 0.08, "auto"):
        comm = runs[("hash", 128, theta)][-1]["comm"]
        for period in (1.0, 5.0, 10.0):
            check(got[f"fig4/{theta}/{int(period)}s_mw"] == pm.avg_power_mw(comm, period),
                  f"fig4 theta={theta} {period}s: mW off the power model")

    # The drift rows: tests/test_odl_system.py's claims on the card.
    for n in PAPER_WIDTHS:
        for variant in ("base", "hash"):
            r = runs[(variant, n, 1.0)][-1]
            check(r["before"] > 0.90, f"table3 {variant} N={n}: accuracy before drift "
                                      f"{r['before']:.4f} <= 0.90")
            check(r["after"] > r["noodl_after"] + 0.025,
                  f"table3 {variant} N={n}: ODL after drift {r['after']:.4f} <= NoODL "
                  f"{r['noodl_after']:.4f} + 2.5 pts")
            check(r["queries"] + r["skips"] == n_ticks and r["comm"] == 1.0,
                  f"table3 {variant} N={n}: accounting")
    comm = {t: runs[("hash", 128, t)][-1]["comm"] for t in (1.0, 0.32, 0.08, "auto")}
    check(comm[1.0] > comm[0.32] > comm[0.08], f"fig3: comm not monotone in theta {comm}")
    check(comm["auto"] < 0.70, f"fig3: auto comm {comm['auto']:.4f} >= 0.70")
    auto_after, full_after = (runs[("hash", 128, t)][-1]["after"] for t in ("auto", 1.0))
    check(auto_after > full_after - 0.02,
          f"fig3: auto accuracy {auto_after:.4f} < theta=1 {full_after:.4f} - 2 pts")
    # The one trial run twice gives the same result.
    repeats = {k: v for k, v in runs.items() if len(v) > 1}
    check(len(repeats) == 1, f"{len(repeats)} trials ran twice, not one")
    for key, rs in repeats.items():
        check(all(r == rs[0] for r in rs), f"trial {key} differs between its runs: {rs}")

    # The card against the CPU (the plain versions) on two of the trials.
    cross = {}
    for variant, n in PAPER_CROSS:
        card = runs[(variant, n, 1.0)][-1]
        t0 = time.perf_counter()
        cpu = trial(0, 1.0, n, variant, device="cpu")
        cross[f"{variant}/N{n}"] = dict(card=card, cpu=cpu, cpu_secs=time.perf_counter() - t0)
        for key in ("before", "after", "noodl_after"):
            check(abs(card[key] - cpu[key]) <= 0.01,
                  f"card vs cpu {variant} N={n} {key}: {card[key]:.4f} vs {cpu[key]:.4f}")
        check(abs(card["comm"] - cpu["comm"]) <= 0.02, f"card vs cpu {variant} N={n}: comm")
    print(f"  card vs cpu: {json.dumps(cross)}")

    # The paper path went through the kernels at both widths.
    for n in PAPER_WIDTHS:
        for name in PAPER_KERNELS:
            check(per_n[n][name] > 0, f"paper path N={n}: {name} never launched")
        n_rls = sum(r["queries"] + r["skips"] for (_, w, _), rs in runs.items() if w == n
                    for r in rs)
        check(per_n[n]["oselm_rls_update_fleet"] == n_rls,
              f"paper path N={n}: {per_n[n]['oselm_rls_update_fleet']} RLS launches, "
              f"not one per tick ({n_rls})")
        check(per_n[n]["rls_two_stage"] == 0, f"paper path N={n}: two-stage route taken")
    print(f"  launches by width: {json.dumps(per_n)}; kernels vs plain at the path's shapes: "
          f"{json.dumps(errs)}")
    return dict(launches=launches, errs=errs)


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


def _plan_kernels(device="cuda", n_streams=FLEET_STREAMS):
    """The CUDA kernels one eager ``fleet.plan`` launches at the fleet width,
    by mode (``algo1`` also with a teacher mask, and ``gate``), and one
    eager ``fleet.learn`` (key ``learn``), each under ``torch.profiler``
    after a warm-up call: {call: {kernel: launches}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import fleet

    cfg = har_odl.full()
    xs, _ = _fleet_ticks(har.generate(seed=SEED), 1, n_streams, 1, device, SEED + 6)
    x, state = xs[0], engine.init_fleet(cfg, n_streams, device)
    avail = torch.arange(n_streams, device=device) % 3 != 0
    calls = {mode: (lambda mode=mode: fleet.plan(state, x, cfg, mode=mode)) for mode in PLAN_MODES}
    calls["algo1 (teacher mask)"] = lambda: fleet.plan(state, x, cfg, "algo1", avail)
    calls["gate"] = lambda: fleet.gate(state, x, cfg)
    # The other half of the tick, for the record: one learn of every stream.
    _, p = fleet.plan(state, x, cfg, mode="train_phase")
    labels = (torch.arange(n_streams, device=device) % cfg.elm.n_out).to(torch.int32)
    calls["learn"] = lambda: fleet.learn(state, p.h, labels, p.pred, p.confidence, p.queried,
                                         p.controller_on, cfg, theta=p.theta)
    out = {}
    for name, call in calls.items():
        call()
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            call()
            _sync(device)
        out[name] = {e.key: e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.count > 0}
    return out


def phase_profile(device="cuda", n_streams=FLEET_STREAMS, n_ticks=PROFILE_TICKS):
    """6b: where a fleet tick's time goes, a check that the RLS update is
    one kernel per tick there, and the CUDA kernels of one eager ``plan``
    by mode: the projection and the plan's pass, nothing else."""
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
    plan_kernels = _plan_kernels(device, n_streams)
    learn_kernels = plan_kernels.pop("learn")
    for mode, kernels in plan_kernels.items():
        check(sorted(kernels.values()) == [1, 1]
              and any("proj_kernel" in k for k in kernels)
              and any("plan_rows_kernel" in k for k in kernels),
              f"profile: an eager plan ({mode}) launched {kernels}, not the projection and the "
              "plan's pass alone")
    shown = {c: {k[:70]: n for k, n in ks.items()} for c, ks in plan_kernels.items()}
    print(f"  CUDA kernels per eager plan call (S={n_streams}), by mode: {json.dumps(shown)}")
    print(f"  CUDA kernels per eager learn call (S={n_streams}, every stream learns): "
          f"{sum(learn_kernels.values())} launches of {len(learn_kernels)} kernels")
    return {"wall_ms": wall_ms, "device_ms": busy, "plan_kernels": plan_kernels,
            "learn_launches": sum(learn_kernels.values())}


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


def _host_tree(tree):
    """A NamedTuple tree with every tensor leaf copied to host memory
    (numpy leaves stay as they are)."""
    import torch

    from repro_torch.engine.types import tree_map

    return tree_map(lambda a: a.cpu() if torch.is_tensor(a) else a, tree)


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
    with a late, lossy teacher under each backpressure policy.  Returns
    (the printed results, each policy's ``(state, outputs, stats)``, the
    ``algo1`` ticks and labels as host arrays, and each mode's zero-latency
    ``(state, outputs)`` on the host): phase 6g resumes snapshots of the
    same runs against them, phase 6j holds its sharded sessions to them."""
    import numpy as np
    import torch

    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    cfg = har_odl.full()
    data = har.generate(seed=SEED)
    res = {}
    zero_runs = {}
    ops.reset_launch_counts()
    graphs.reset_replay_counts()
    for mode, n_ticks, shift_at in _fleet_modes():
        xs, ys = _fleet_ticks(data, n_ticks, n_streams, shift_at, device, SEED + n_ticks)
        ticks, labels = xs.cpu().numpy(), ys.cpu().numpy()
        del xs, ys
        state, outs, stats, secs = _run_stream_once(cfg, ticks, labels, mode, device,
                                                    {"latency": 0})
        zero_runs[mode] = (_host_tree(state), outs)
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
    policy_runs = {}
    for policy in POLICIES:
        state, outs, stats, secs = _run_stream_once(
            cfg, ticks, labels, "algo1", device, STREAM_TEACHER, capacity=STREAM_CAPACITY,
            backpressure=policy)
        policy_runs[policy] = (state, outs, stats)
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
    return res, policy_runs, (ticks, labels), zero_runs


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
    for kernel in ("proj_kernel", "rls_single_kernel", "plan_rows_kernel"):
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
          f"rls_single_kernel and one plan_rows_kernel per tick")
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


def _stacked_rows_differ(cfg, width, n_members, device, seed, learn=True):
    """One ``algo1`` plan and one learn on ``n_members`` stacked members of
    ``width`` streams and on each member alone (heads warmed by two learns
    first): the plan fields and state leaves whose rows differ.  Without
    ``learn``: random heads, two plans to step the detectors, then the plan
    alone is compared (for shapes whose RLS update takes the two-stage
    route, whose torch operands are not held to this)."""
    import torch

    from repro_torch import engine
    from repro_torch.engine import fleet
    from repro_torch.engine.types import tree_map

    g = _gen(device, seed)
    total, m, n_in = width * n_members, cfg.elm.n_out, cfg.elm.n_in
    st = engine.init_fleet(cfg, total, device)
    if not learn:
        beta = 0.3 * torch.randn(st.elm.beta.shape, generator=g, device=device)
        st = st._replace(elm=st.elm._replace(beta=beta))
    for _ in range(2):
        x = torch.randn(total, n_in, generator=g, device=device)
        st, p = fleet.plan(st, x, cfg, mode="train_phase" if learn else "algo1")
        if learn:
            lab = torch.randint(0, m, (total,), generator=g, device=device).to(torch.int32)
            st = fleet.learn(st, p.h, lab, p.pred, p.confidence, p.queried, p.controller_on, cfg,
                             theta=p.theta)
    x = 2.0 * torch.tanh(torch.randn(total, n_in, generator=g, device=device))
    lab = torch.randint(0, m, (total,), generator=g, device=device).to(torch.int32)
    mask = torch.rand(total, generator=g, device=device) < 0.7

    def tick(state, x, lab, mask):
        new, p = fleet.plan(state, x, cfg, mode="algo1")
        if learn:
            new = fleet.learn(new, p.h, lab, p.pred, p.confidence, mask, p.controller_on, cfg,
                              theta=p.theta)
        return new, p

    after, p = tick(st, x, lab, mask)
    differ = set()
    for i in range(n_members):
        lo, hi = i * width, (i + 1) * width
        after_i, p_i = tick(tree_map(lambda a: a[lo:hi].clone(), st), x[lo:hi].clone(),
                            lab[lo:hi].clone(), mask[lo:hi].clone())
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
    rate beside the multiplexer's.  Returns (the printed results, each
    tenant's solo ``(state, outputs, stats)``, the tenants' inputs): phase
    6g migrates and supervises the same tenants against them."""
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
    # An odd N m (each beta, h and x row at another 16-byte alignment than
    # its neighbours'); the plan alone (N = 33 takes the two-stage RLS route).
    odd = har_odl.full(n_hidden=ODD_COHORT["n_hidden"])
    odd = dataclasses.replace(odd, elm=odd.elm.replace(n_out=ODD_COHORT["n_out"]))
    w = ODD_COHORT["width"]
    differ = _stacked_rows_differ(odd, w, ODD_COHORT["n_members"], device, SEED + 33, learn=False)
    key = f"{w} (N={ODD_COHORT['n_hidden']}, m={ODD_COHORT['n_out']}, plan)"
    res["stacked_rows_differ"][key] = differ
    check(not differ, f"odd cohort {key}: rows differ from solo in {differ}")

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
    return res, solo, inputs


class _NoSnapshotTeacher:
    """A teacher whose state cannot be snapshot (as a socket teacher's):
    a ``LatencyTeacher`` without ``snapshot_state``/``restore_snapshot``."""

    def __init__(self, inner):
        self.inner = inner

    def ask(self, feats, mask, tick):
        return self.inner.ask(feats, mask, tick)

    def poll(self, tick):
        return self.inner.poll(tick)

    def in_flight(self):
        return self.inner.in_flight()


class _CrashOnce:
    """A ``LatencyTeacher`` that raises once, on its first ask at or after
    ``tick``, standing in for a node failure; it snapshots like its inner
    teacher."""

    def __init__(self, inner, tick, state):
        self.inner, self.tick, self.state = inner, tick, state

    def ask(self, feats, mask, tick):
        if self.state["armed"] and tick >= self.tick:
            self.state["armed"] = False
            self.state["fired"] += 1
            raise RuntimeError("injected node failure")
        return self.inner.ask(feats, mask, tick)

    def poll(self, tick):
        return self.inner.poll(tick)

    def in_flight(self):
        return self.inner.in_flight()

    def snapshot_state(self):
        return self.inner.snapshot_state()

    def restore_snapshot(self, tree):
        self.inner.restore_snapshot(tree)


def _tree_bytes(tree):
    """Bytes of a snapshot tree's leaves."""
    from repro_torch.runtime import checkpoint

    return sum(leaf.nbytes for _, leaf in checkpoint._flatten(tree))


def _leaf_digests(tree):
    """{leaf path: blake2b digest of dtype, shape and bytes}, as the
    checkpoint manager's delta diff computes them (a 0-d leaf as the 1-d
    array it writes)."""
    import numpy as np

    from repro_torch.runtime import checkpoint

    return {"/".join(p): checkpoint._digest(np.ascontiguousarray(checkpoint.to_host(leaf)))
            for p, leaf in checkpoint._flatten(tree)}


def _dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).iterdir() if f.is_file())


def _timed(fn, device="cuda"):
    """(result, host ms) of ``fn()`` with the card synchronised on both sides."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, 1e3 * (time.perf_counter() - t0)


def _durable_streams(policy_runs, ticks, labels, tmp, device="cuda"):
    """6g part 1: each policy's 6c ``algo1`` run, snapshotted at each tick of
    ``DURABLE_SNAP_TICKS`` and restored into a fresh session on the card
    (the second restore resumes a restored session), must end bit for bit as
    6c's uninterrupted run.  ``drop_oldest`` publishes both snapshots
    through a ``CheckpointManager(full_every=2)`` (a full save, then a
    delta), restores the second from disk, and sends it through the wire
    frame.  At the last snapshot tick a teacher that cannot snapshot takes
    the in-flight ring under ``pending="reask"`` and ``"drop"``: the query
    accounting must stay exact.  At most one snapshot tree lives on the
    host at a time."""
    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.engine import snapshot, stream
    from repro_torch.runtime.checkpoint import CheckpointManager

    cfg = har_odl.full()
    n_ticks = ticks.shape[0]

    def teacher():
        return stream.LatencyTeacher(stream.array_labels(labels), **STREAM_TEACHER)

    def drive(sess, stop):
        while sess._p is not None and sess.t < stop:
            sess.advance(ticks[sess.t + 1] if sess.t + 1 < n_ticks else None)
        return sess

    res = {}
    for policy in POLICIES:
        want = policy_runs[policy]
        r = res[policy] = {"capture_ms": [], "restore_h2d_ms": [], "first_tick_ms": [],
                           "ring_entries": [], "snapshot_bytes": []}
        sess = stream.StreamSession(engine.init_fleet(cfg, ticks.shape[1], device), cfg,
                                    teacher(), mode="algo1", capacity=STREAM_CAPACITY,
                                    backpressure=policy)
        sess.start(ticks[0])
        mgr = CheckpointManager(str(tmp / policy), keep=3, full_every=2)
        for hop, stop in enumerate(DURABLE_SNAP_TICKS):
            drive(sess, stop)
            tree, ms = _timed(sess.snapshot, device)
            del sess
            check(snapshot.ticks_consumed(tree) == stop + 1, f"{policy}: cursor at {stop}")
            r["capture_ms"].append(ms)
            r["ring_entries"].append(len(tree["ring"]))
            r["snapshot_bytes"].append(_tree_bytes(tree))
            last = hop == len(DURABLE_SNAP_TICKS) - 1
            if policy == "drop_oldest":
                t0 = time.perf_counter()
                mgr.save_async(stop, tree)
                r.setdefault("save_async_return_ms", []).append(1e3 * (time.perf_counter() - t0))
                mgr.wait()
                r.setdefault("publish_ms", []).append(1e3 * (time.perf_counter() - t0))
                step_dir = tmp / policy / f"step_{stop:09d}"
                r.setdefault("kinds", []).append(mgr._manifest(stop)["kind"])
                r.setdefault("bytes_written", []).append(_dir_bytes(step_dir))
                written = [f.name for f in step_dir.iterdir() if f.suffix == ".npy"]
                r.setdefault("leaves_written", []).append(len(written))
                r.setdefault("P_written", []).append("state__elm__P.npy" in written)
            if last:
                # A teacher that cannot snapshot: re-ask or drop the ring.
                in_flight = len(tree["ring"])
                for pending in ("reask", "drop"):
                    other = stream.StreamSession.restore(
                        tree, _NoSnapshotTeacher(teacher()), cfg=cfg, pending=pending,
                        device=device)
                    _, _, st = drive(other, n_ticks).finish()
                    check(st.reconciled, f"{policy} pending={pending}: accounting broken: "
                                         f"{st.summary()}")
                    check(st.tickets_reasked == (in_flight if pending == "reask" else 0),
                          f"{policy} pending={pending}: {st.tickets_reasked} re-asks for "
                          f"{in_flight} in flight")
                    r[f"{pending}_tickets_reasked"] = st.tickets_reasked
                    r[f"{pending}_queries_lost"] = st.queries_lost
                    del other
            if last and policy == "drop_oldest":
                digests = dict(mgr._published_digests)
                frame, r["encode_ms"] = _timed(lambda: snapshot.encode_snapshot(tree), device)
                del tree
                r["frame_bytes"] = len(frame)
                decoded, r["decode_ms"] = _timed(lambda: snapshot.decode_snapshot(frame), device)
                del frame
                check(_leaf_digests(decoded) == digests,
                      f"{policy}: the wire frame changed a leaf")
                del decoded
                (step, tree), r["load_ms"] = _timed(mgr.restore, device)
                check(step == stop and _leaf_digests(tree) == digests,
                      f"{policy}: the disk round trip (full + delta) changed a leaf")
            sess, ms = _timed(lambda: stream.StreamSession.restore(tree, teacher(), cfg=cfg,
                                                                   device=device), device)
            r["restore_h2d_ms"].append(ms)
            del tree
            check(sess.device.type == device, f"{policy}: restored onto {sess.device}")
            _, ms = _timed(lambda: sess.advance(ticks[sess.t + 1]), device)
            r["first_tick_ms"].append(ms)
        got = drive(sess, n_ticks).finish()
        del sess
        differ = _result_differs(want, got)
        check(not differ, f"{policy}: resumed run differs from 6c's uninterrupted run in {differ}")
        check(got[2].tickets_reasked == 0, f"{policy}: the teacher state did not travel")
        del got
    check(any(r["ring_entries"][-1] for r in res.values()),
          f"no policy had a ticket in flight at tick {DURABLE_SNAP_TICKS[-1]}: nothing re-asked")
    return res


def _durable_mux(solo, inputs, tmp, device="cuda"):
    """6g part 2, on 6f's 16 tenants of 1024 streams: extract tenant00 out of
    the fused cohort mid-run and admit it, positioned, into a second
    multiplexer beside 6f's late tenant (it must land in a cohort slot);
    then ``run_supervised`` with cadence snapshots and one injected crash.
    Every tenant must equal its solo run of 6f bit for bit, and the
    supervisor must restart exactly as often as crashes were injected."""
    from repro_torch.configs import har_odl
    from repro_torch.engine import multiplex, snapshot, stream

    cfg = har_odl.full()
    n = len(MUX_TICKS)
    res = {}

    def compare(results, names, what):
        for i in names:
            got = results[f"tenant{i:02d}"]
            differ = _result_differs(solo[i], (got.state, got.outputs, got.stats))
            check(not differ, f"{what} tenant{i:02d}: differs from its solo run in {differ}")
            _check_accounting(f"{what} tenant{i:02d}", got.state, got.outputs, got.stats,
                              cfg.elm.n_in)

    mux_a = multiplex.Multiplexer([_mux_tenant(i, *inputs[i], cfg, device) for i in range(n)],
                                  quantum=MUX_QUANTUM)
    while mux_a.round():
        if mux_a.session("tenant00").t >= DURABLE_EXTRACT_TICK:
            break
    check(mux_a._slot("tenant00").unit is not None, "tenant00 is not fused when extracted")
    (tree, rest), res["extract_ms"] = _timed(lambda: mux_a.extract("tenant00"), device)
    res["extract_t"] = snapshot.ticks_consumed(tree) - 1
    res["extract_bytes"] = _tree_bytes(tree)
    results_a, _ = mux_a.run()
    del mux_a
    compare(results_a, range(1, n), "stay-behind")
    del results_a
    late = _mux_tenant(n, *inputs[n], cfg, device)
    mux_b = multiplex.Multiplexer([late], quantum=MUX_QUANTUM)
    migrated = _mux_tenant(0, *inputs[0], cfg, device)
    migrated = dataclasses.replace(migrated, state=None, ticks=rest, device=device)
    _, res["admit_ms"] = _timed(lambda: mux_b.admit(migrated, snapshot=tree, positioned=True),
                                device)
    del tree
    mux_b.round()
    check(mux_b._slot("tenant00").unit is not None, "the migrated tenant joined no cohort")
    results_b, _ = mux_b.run()
    compare(results_b, (0, n), "migrated")
    del results_b, mux_b

    crash = {"armed": True, "fired": 0}
    attempts = []

    def make_tenants():
        attempts.append(len(attempts))
        out = []
        for i in range(n):
            xs, ys = inputs[i]
            t = dataclasses.replace(_mux_tenant(i, xs, ys, cfg, device),
                                    ticks=snapshot.array_ticks(xs))
            if i == 0:
                t.teacher = _CrashOnce(t.teacher, DURABLE_CRASH_TICK, crash)
            out.append(t)
        return out

    t0 = time.perf_counter()
    results, agg = multiplex.run_supervised(
        make_tenants, snapshot_dir=str(tmp / "supervised"),
        snapshot_every=DURABLE_SNAPSHOT_EVERY, max_restarts=2, quantum=MUX_QUANTUM)
    _sync(device)
    res["supervised_s"] = time.perf_counter() - t0
    res["crashes_injected"] = crash["fired"]
    res["restarts"] = len(attempts) - 1
    res["snapshots_after_restart"] = agg.snapshots
    check(crash["fired"] == 1, f"{crash['fired']} crashes fired, 1 injected")
    check(res["restarts"] == crash["fired"],
          f"run_supervised restarted {res['restarts']} times for {crash['fired']} crash")
    check(agg.snapshots > 0, "the resumed attempt took no cadence snapshot")
    compare(results, range(n), "supervised")
    return res


def _crash_smoke_subprocess():
    """6g part 3: ``python -m repro_torch.engine.durable --crash-smoke`` as a
    subprocess on the card (its child, SIGKILLed mid-stream, too)."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.engine.durable", "--crash-smoke"],
                          env=env, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] + proc.stderr.strip().splitlines()[-5:]
    check(proc.returncode == 0, f"crash smoke exited {proc.returncode}: {tail}")
    return {"rc": proc.returncode, "secs": secs, "last_line": proc.stdout.strip().splitlines()[-1]}


def phase_durable(policy_runs, ticks, labels, mux_solo, mux_inputs, device="cuda"):
    """6g: durability at the fleet width (see the module docstring).
    Snapshots go under a ``tempfile.mkdtemp()`` directory, removed after."""
    import shutil
    import tempfile

    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_durable_"))
    try:
        _sync(device)
        graphs.reset_replay_counts()
        ops.reset_launch_counts()
        res = {"streams": _durable_streams(policy_runs, ticks, labels, tmp, device)}
        res["mux"] = _durable_mux(mux_solo, mux_inputs, tmp, device)
        _sync(device)
        res["kernel_replays"] = dict(graphs.kernel_replays)
        res["launches"] = dict(ops.launch_counts)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name in PATH_KERNELS:
        check(device != "cuda" or res["kernel_replays"][name] > 0,
              f"durability: restored sessions replayed no {name}")
    res["crash_smoke"] = _crash_smoke_subprocess()
    d = res["streams"]["drop_oldest"]
    print(f"durability (6g, S={ticks.shape[1]}, algo1, snapshots at ticks "
          f"{list(DURABLE_SNAP_TICKS)}) on {_card()}: {json.dumps(res)}")
    print(f"  drop_oldest: snapshot {d['snapshot_bytes']} bytes; capture "
          f"{[round(x, 3) for x in d['capture_ms']]} ms (device to host copies the tree "
          f"owns); save_async returned in {[round(x, 3) for x in d['save_async_return_ms']]} ms, "
          f"published in {[round(x, 3) for x in d['publish_ms']]} ms ({d['kinds']}, "
          f"{d['bytes_written']} bytes written); load {d['load_ms']:.3f} ms; restore (host to "
          f"device) {[round(x, 3) for x in d['restore_h2d_ms']]} ms; first restored tick "
          f"{[round(x, 3) for x in d['first_tick_ms']]} ms (graph captures included); frame "
          f"{d['frame_bytes']} bytes, encode {d['encode_ms']:.3f} ms, decode "
          f"{d['decode_ms']:.3f} ms")
    return res


class _LabelCheck:
    """A teacher wrapper that holds every reply it hands on to the rule the
    label server answers by (``rpc.expected_labels`` of the ticket's tick)
    on the streams it answered, and counts the labels it checked."""

    def __init__(self, inner, n_out):
        self.inner = inner
        self.n_out = n_out
        self.ticks = {}
        self.checked = 0

    def ask(self, feats, mask, tick):
        ticket = self.inner.ask(feats, mask, tick)
        self.ticks[ticket] = tick
        return ticket

    def poll(self, tick):
        from repro_torch.engine import rpc

        replies = self.inner.poll(tick)
        for r in replies:
            want = rpc.expected_labels(self.ticks[r.ticket], len(r.labels), self.n_out)
            check(bool((r.labels[r.answered] == want[r.answered]).all()),
                  f"rpc: ticket {r.ticket} carried a label the server's rule does not give")
            self.checked += int(r.answered.sum())
        return replies

    def in_flight(self):
        return self.inner.in_flight()


class _MeasuredSync:
    """The sync wrapper of ``tests/test_rpc.py`` (each ask waits out its
    reply, so the application schedule is the zero-latency teacher's), which
    also times, per ask: the device-to-host copy of the features as the
    client makes it (``rpc._host_feats``), the v2 encoding of that copy, and
    the round trip (the real ask, its own copy and encoding included, until
    its reply is in)."""

    def __init__(self, inner, timeout=120.0):
        self.inner = inner
        self.timeout = timeout
        self.d2h_ms, self.encode_ms, self.round_trip_ms, self.frame_bytes = [], [], [], []

    def ask(self, feats, mask, tick):
        from repro_torch.engine import rpc, wire

        t0 = time.perf_counter()
        host = rpc._host_feats(feats)
        t1 = time.perf_counter()
        frame = wire.encode_asks([(0, tick, mask, host)])
        t2 = time.perf_counter()
        self.d2h_ms.append(1e3 * (t1 - t0))
        self.encode_ms.append(1e3 * (t2 - t1))
        self.frame_bytes.append(len(frame))
        del host, frame
        t3 = time.perf_counter()
        ticket = self.inner.ask(feats, mask, tick)
        deadline = time.monotonic() + self.timeout
        while self.inner.in_flight() > 0 and time.monotonic() < deadline:
            time.sleep(2e-4)
        check(self.inner.in_flight() == 0, f"rpc: ask at tick {tick} unanswered")
        self.round_trip_ms.append(1e3 * (time.perf_counter() - t3))
        return ticket

    def poll(self, tick):
        return self.inner.poll(tick)

    def in_flight(self):
        return self.inner.in_flight()


def _pcts(xs):
    import numpy as np

    return {"p50": float(np.percentile(xs, 50)), "p95": float(np.percentile(xs, 95)),
            "n": len(xs)} if xs else None


def _rpc_teacher_runs(cfg, ticks, device, n_out):
    """6h part 1: the graphed session over the wire (v2, sync wrapper) against
    the same session taught by ``LatencyTeacher(latency=0)`` with the server's
    rule, in ``train_phase`` (the first ``RPC_TRAIN_TICKS`` ticks) and
    ``algo1`` (every tick, through the drift); then the ``train_phase`` run
    without the wrapper, timed.  Returns the printed results."""
    from repro_torch import engine
    from repro_torch.engine import graphs, rpc, stream
    from repro_torch.kernels import ops

    n_streams = ticks.shape[1]
    runs = (("train_phase", ticks[:RPC_TRAIN_TICKS]), ("algo1", ticks))
    expected = {}
    for mode, xs in runs:
        teacher = stream.LatencyTeacher(lambda t, _f: rpc.expected_labels(t, n_streams, n_out))
        expected[mode] = stream.run(engine.init_fleet(cfg, n_streams, device), iter(xs), cfg,
                                    teacher, mode=mode)
    res = {}
    with rpc.loopback_server(n_out=n_out) as (host, port):
        # 6h's path starts here: its launch and replay counts from 0.
        graphs.reset_replay_counts()
        ops.reset_launch_counts()
        for mode, xs in runs:
            with rpc.RpcTeacher(host, port, timeout_s=120.0) as inner:
                teacher = _MeasuredSync(inner)
                got = stream.run(engine.init_fleet(cfg, n_streams, device), iter(xs), cfg,
                                 teacher, mode=mode)
            differ = _result_differs(expected[mode], got)
            check(not differ, f"rpc {mode}: differs from the zero-latency teacher in {differ}")
            check(got[2].labels_applied > 0 and got[2].reconciled,
                  f"rpc {mode}: {got[2].summary()}")
            res[mode] = {"bit_for_bit": not differ, "asks": len(teacher.round_trip_ms),
                         "labels_applied": got[2].labels_applied,
                         "ask_frame_bytes": teacher.frame_bytes[0] if teacher.frame_bytes else 0,
                         "wire_bytes": inner.wire_bytes, "wire_messages": inner.wire_messages,
                         "d2h_ms": _pcts(teacher.d2h_ms), "encode_ms": _pcts(teacher.encode_ms),
                         "round_trip_ms": _pcts(teacher.round_trip_ms)}
            del got
        del expected
        # The same train_phase ticks without the wrapper: replies land when
        # they land, so only the accounting and the labels are checked.
        xs = ticks[:RPC_TRAIN_TICKS]
        with rpc.RpcTeacher(host, port, timeout_s=120.0) as inner:
            teacher = _LabelCheck(inner, n_out)
            state = engine.init_fleet(cfg, n_streams, device)
            _sync(device)
            t0 = time.perf_counter()
            state, outs, stats = stream.run(state, iter(xs), cfg, teacher, mode="train_phase")
            _sync(device)
            secs = time.perf_counter() - t0
        check(stats.reconciled and stats.labels_applied == teacher.checked > 0,
              f"rpc unwrapped: {stats.summary()}")
        res["unwrapped"] = {"stream_ticks_per_s": n_streams * len(xs) / secs,
                            "tick_p50_ms": stats.tick_p50_ms, "tick_p95_ms": stats.tick_p95_ms,
                            "label_latency_p50": stats.label_latency_p50,
                            "label_latency_p95": stats.label_latency_p95,
                            "labels_applied": stats.labels_applied}
    return res


def _rpc_faults(cfg, ticks, device, n_out):
    """6h part 2: the same session without the wrapper against a server that
    loses asks and jitters replies, under a client deadline, with telemetry
    on: the accounting reconciles exactly with queries lost, every applied
    label is the server's rule, the scraped identity holds mid-run and at the
    end, and the server's counters (scraped over the wire) agree with the
    client's meters."""
    from repro_torch import engine
    from repro_torch.engine import rpc, stream
    from repro_torch.runtime import telemetry

    xs = ticks[:RPC_TRAIN_TICKS]
    n_streams = xs.shape[1]
    tel = telemetry.enable()
    tel.registry.clear()
    scrapes = {}

    def scrape(when, sess, inner):
        sess.sync_telemetry()
        inner.sync_telemetry(tenant="faults")
        parsed = telemetry.parse_prometheus(tel.registry.prometheus_text())
        ident = telemetry.check_stream_identity(parsed)
        check(ident and all(ident.values()), f"rpc faults: scraped identity fails {when}: {ident}")
        key = (("tenant", "faults"),)
        scrapes[when] = {"queries_issued": parsed[("odl_stream_queries_issued", key)],
                         "queries_pending": parsed[("odl_stream_queries_pending", key)],
                         "identity": True}

    try:
        with rpc.loopback_server(n_out=n_out, **RPC_FAULTS) as (host, port):
            with rpc.RpcTeacher(host, port, timeout_s=RPC_FAULT_TIMEOUT_S) as inner:
                teacher = _LabelCheck(inner, n_out)
                sess = stream.StreamSession(engine.init_fleet(cfg, n_streams, device), cfg,
                                            teacher, mode="train_phase")
                sess.telemetry_labels = {"tenant": "faults"}
                sess.start(xs[0])
                for t in range(1, len(xs)):
                    sess.advance(xs[t])
                    if t == len(xs) // 2:
                        scrape("mid-run", sess, inner)
                sess.advance(None)
                _, _, stats = sess.finish()
                scrape("end", sess, inner)
                server = rpc.server_stats(host, port)
                meters = {"wire_messages": inner.wire_messages, "wire_bytes": inner.wire_bytes,
                          "timed_out": inner.timed_out}
    finally:
        telemetry.disable()
    check(stats.reconciled and stats.queries_lost > 0,
          f"rpc faults: want exact accounting with losses: {stats.summary()}")
    check(stats.labels_applied == teacher.checked > 0, "rpc faults: unchecked labels applied")
    check(server["frames_v2"] == meters["wire_messages"] == stats.tickets_issued
          and server["asks_served"] == stats.tickets_issued and server["frame_errors"] == 0,
          f"rpc faults: server {server} against client {meters} and {stats.summary()}")
    return {k: getattr(stats, k) for k in ("queries_issued", "labels_applied", "queries_lost",
                                           "tickets_lost", "queries_dropped")} | {
        "scrapes": scrapes, "server": {k: server[k] for k in ("frames_v2", "asks_served",
                                                              "frame_errors", "loss_prob",
                                                              "jitter_s")},
        "client": meters, "spans": len(tel.tracer.spans())}


def _rpc_mux(cfg, ticks, device, n_out, n_tenants=RPC_MUX_TENANTS):
    """6h part 3: ``n_tenants`` tenants, each a block of the fleet's rows
    (4,096 at S=16,384), fused ``rr``, ``train_phase``, through
    ``rpc_bench.run_once`` against a subprocess server, over each transport:
    one shared batched connection, one v2 connection per tenant, and the
    shared connection with zlib envelopes.  Every tenant reconciles and
    every applied label is checked."""
    from repro_torch.benchmarks import rpc_bench
    from repro_torch.engine import rpc

    width = ticks.shape[1] // n_tenants
    data = [ticks[:RPC_MUX_TICKS, i * width:(i + 1) * width] for i in range(n_tenants)]
    res = {}
    for name, transport, compress in (("batched", "batched", False),
                                      ("per_tenant", "per_tenant", False),
                                      ("batched_zlib", "batched", True)):
        checks = []

        def wrap(inner, checks=checks):
            checks.append(_LabelCheck(inner, n_out))
            return checks[-1]

        secs, results, msgs, nbytes, server = rpc_bench.run_once(
            transport, cfg, data, device, timeout_s=120.0,
            window_s=rpc.DEFAULT_BATCH_WINDOW_S, batch_max=rpc.DEFAULT_BATCH_MAX,
            compress=compress, wrap=wrap, subprocess_server=True)
        for tenant, r in results.items():
            check(r.stats.labels_applied > 0, f"rpc mux {name} {tenant}: {r.stats.summary()}")
        labels = sum(r.stats.labels_applied for r in results.values())
        queries = sum(r.stats.queries_issued for r in results.values())
        check(labels == sum(c.checked for c in checks), f"rpc mux {name}: unchecked labels")
        check(server["asks_served"] == sum(r.stats.tickets_issued for r in results.values()),
              f"rpc mux {name}: {server}")
        res[name] = {
            "wire_messages": msgs, "wire_bytes": nbytes, "bytes_per_query": nbytes / queries,
            "messages_per_label": msgs / labels, "labels_applied": labels,
            "raw_bytes_in": server["raw_bytes_in"],
            "compressed_bytes_in": server["compressed_bytes_in"],
            "frames_compressed": server["frames_compressed"],
            "stream_ticks_per_s": n_tenants * width * RPC_MUX_TICKS / secs}
    return res


class _ShapeLog:
    """While active, notes the shape of every call of the path kernels'
    wrappers in ``kernels.ops`` (eager launches and graph captures alike),
    keyed as phases 2-4 key their cases; ``missing`` names those phases
    2-4 did not hold against the plain versions."""

    KEYS = {
        "xorshift_projection": lambda a, out: (math.prod(a[0].shape[:-1]), a[0].shape[-1],
                                               out.shape[-1]),
        "oselm_rls_update_fleet": lambda a, out: (a[0].shape[0], a[0].shape[1], a[2].shape[1],
                                                  a[1].shape[2]),
        "plan_rows": lambda a, out: (*a[1].shape, a[2].shape[-1]),
        "readout": lambda a, out: tuple(a[1].shape),
        "row_abs_mean": lambda a, out: (math.prod(a[0].shape[:-1]), a[0].shape[-1]),
    }
    HELD = {"xorshift_projection": K1_SHAPES, "oselm_rls_update_fleet": K2_SHAPES,
            "plan_rows": PLAN_SHAPES, "readout": READOUT_SHAPES,
            "row_abs_mean": ROW_MEAN_SHAPES}

    def __enter__(self):
        from repro_torch.kernels import ops

        self.shapes = {name: set() for name in self.KEYS}
        self._saved = {name: getattr(ops, name) for name in self.KEYS}
        for name, key in self.KEYS.items():
            setattr(ops, name, self._logged(self._saved[name], key, self.shapes[name]))
        return self

    @staticmethod
    def _logged(fn, key, into):
        def logged(*a, **kw):
            out = fn(*a, **kw)
            into.add(key(a, out))
            return out
        return logged

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for name, fn in self._saved.items():
            setattr(ops, name, fn)

    def missing(self):
        return {name: sorted(got - set(self.HELD[name]))
                for name, got in self.shapes.items() if got - set(self.HELD[name])}


def _telemetry_overhead(device="cuda", n_streams=FLEET_STREAMS, blocks=RPC_OVERHEAD_BLOCKS,
                        block_ticks=RPC_OVERHEAD_BLOCK_TICKS):
    """6h part 4: 6e's graphed zero-latency window (ticks on the card, three
    ticks capture the graphs first), its timed ticks in ``blocks`` blocks of
    ``block_ticks`` with telemetry off and on in turns (off, on, off, ...),
    so both halves share one session, its graphs and its card.  Returns the
    ms per tick of every block and the median and best of each half."""
    import statistics

    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import stream
    from repro_torch.runtime import telemetry

    cfg = har_odl.full()
    n_ticks = blocks * block_ticks
    xs, ys = _fleet_ticks(har.generate(seed=SEED), n_ticks + 4, n_streams, n_ticks + 4, device,
                          SEED + 5)
    teacher = stream.LatencyTeacher(stream.array_labels(ys.cpu().numpy()))
    sess = stream.StreamSession(engine.init_fleet(cfg, n_streams, device), cfg, teacher,
                                mode="train_phase")
    off, on = [], []
    spans = 0
    try:
        telemetry.disable()
        sess.start(xs[0])
        for t in range(1, 4):
            sess.advance(xs[t])
        t = 4
        for b in range(blocks):
            tel = telemetry.enable() if b % 2 else None
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(block_ticks):
                sess.advance(xs[t])
                t += 1
            _sync(device)
            (on if tel is not None else off).append(1e3 * (time.perf_counter() - t0) / block_ticks)
            if tel is not None:
                spans += sum(1 for s in tel.tracer.spans() if s[0] == "stream.tick")
                telemetry.disable()
        sess.advance(None)
        sess.finish()
    finally:
        telemetry.disable()
    check(spans == len(on) * block_ticks, f"telemetry: {spans} stream.tick spans in "
                                          f"{len(on) * block_ticks} instrumented ticks")
    # The host cost of one tick's instrumentation alone (the span ``advance``
    # records), which the windows above cannot resolve under their spread.
    tracer = telemetry.SpanTracer()
    n = 100_000
    t0 = time.perf_counter()
    for i in range(n):
        tok = tracer.begin("stream.tick")
        tracer.end(tok, t=i, queries=n_streams)
    span_us = 1e6 * (time.perf_counter() - t0) / n
    med_off, med_on = statistics.median(off), statistics.median(on)
    return {"off_ms": off, "on_ms": on, "median_off_ms": med_off, "median_on_ms": med_on,
            "best_off_ms": min(off), "best_on_ms": min(on), "overhead_ms": med_on - med_off,
            "overhead_pct": 100.0 * (med_on - med_off) / med_off,
            "best_overhead_pct": 100.0 * (min(on) - min(off)) / min(off),
            "span_us": span_us, "span_pct": 100.0 * span_us / 1e3 / med_off,
            "budget_pct": TELEMETRY_BUDGET_PCT}


def phase_rpc(ticks, device="cuda", cfg=None):
    """6h: the teacher over a real loopback socket (see the module
    docstring).  ``ticks`` are 6c's ``algo1`` ticks, host arrays."""
    from repro_torch.benchmarks import rpc_bench
    from repro_torch.configs import har_odl
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    cfg = cfg or har_odl.full()
    n_out = cfg.elm.n_out
    card = _card() if device == "cuda" else "cpu"
    lines = []
    with _ShapeLog() as shapes:
        res = {"streams": _rpc_teacher_runs(cfg, ticks, device, n_out)}
        res["faults"] = _rpc_faults(cfg, ticks, device, n_out)
        res["mux"] = _rpc_mux(cfg, ticks, device, n_out)
        _sync(device)
        res["launches"] = dict(ops.launch_counts)
        res["kernel_replays"] = dict(graphs.kernel_replays)
        # The bench's launches and replays, counted from 0 on their own.
        graphs.reset_replay_counts()
        ops.reset_launch_counts()
        res["bench"] = rpc_bench.bench(device, log=lines.append, **RPC_BENCH)
        _sync(device)
        res["bench_launches"] = dict(ops.launch_counts)
        res["bench_replays"] = dict(graphs.kernel_replays)
        n_streams = ticks.shape[1]
        res["telemetry_overhead"] = _telemetry_overhead(device, n_streams)
    for name in PAPER_KERNELS:
        for what, launches, replays in (("path", "launches", "kernel_replays"),
                                         ("bench", "bench_launches", "bench_replays")):
            check(device != "cuda" or res[launches][name] + res[replays][name] > 0,
                  f"rpc {what}: {name} ran neither eagerly nor by a replay")
    res["shapes"] = {name: sorted(got) for name, got in shapes.shapes.items()}
    check(not shapes.missing(), f"rpc: kernels called at shapes phases 2-4 did not hold: "
                                f"{shapes.missing()}")
    s = res["streams"]
    print(f"rpc (6h, S={n_streams}, n_in={cfg.elm.n_in}, N={cfg.elm.n_hidden}, v2 over loopback) "
          f"on {card}: {json.dumps(res)}")
    print(f"  rpc_bit_for_bit: {str(s['train_phase']['bit_for_bit'] and s['algo1']['bit_for_bit']).lower()}"
          f" (train_phase {s['train_phase']['asks']} asks, algo1 {s['algo1']['asks']} asks); "
          f"ask frame {s['train_phase']['ask_frame_bytes']} bytes; per ask (train_phase): "
          f"D2H {s['train_phase']['d2h_ms']} ms, encode {s['train_phase']['encode_ms']} ms, "
          f"round trip {s['train_phase']['round_trip_ms']} ms; unwrapped "
          f"{s['unwrapped']['stream_ticks_per_s']:.1f} stream·ticks/s ({card})")
    f = res["faults"]
    print(f"  faults: issued {f['queries_issued']} = applied {f['labels_applied']} + lost "
          f"{f['queries_lost']} + dropped {f['queries_dropped']}; identity at "
          f"{sorted(f['scrapes'])}; server frames {f['server']['frames_v2']} = client messages "
          f"{f['client']['wire_messages']} ({card})")
    for transport, m in res["mux"].items():
        print(f"  mux {transport:>12}: {m['wire_messages']} msgs, {m['bytes_per_query']:.1f} "
              f"B/query, {m['messages_per_label']:.6f} msg/label, raw/compressed in "
              f"{m['raw_bytes_in']}/{m['compressed_bytes_in']}, "
              f"{m['stream_ticks_per_s']:.1f} stream·ticks/s ({card})")
    for line in lines:
        print(f"  bench {line} ({card})")
    print(f"  kernel shapes on 6h's path, each held in phases 2-4: {res['shapes']}")
    o = res["telemetry_overhead"]
    print(f"  telemetry overhead: {o['overhead_ms']:.4f} ms per tick "
          f"({o['overhead_pct']:.2f} % against a {o['budget_pct']} % budget; median off "
          f"{o['median_off_ms']:.4f} ms, on {o['median_on_ms']:.4f} ms over "
          f"{len(o['off_ms'])} blocks each of {RPC_OVERHEAD_BLOCK_TICKS} ticks, in turns; best "
          f"{o['best_off_ms']:.4f} against {o['best_on_ms']:.4f} ms); one tick's span alone "
          f"{o['span_us']:.3f} us on the host ({o['span_pct']:.4f} % of a tick) ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6i: the elastic fleet (runtime/worker.py, runtime/elastic.py)
# ---------------------------------------------------------------------------


class _GpuMemory:
    """While active, samples ``nvidia-smi --query-compute-apps`` every
    ``period_s`` and keeps each listed pid's largest ``used_memory`` (MiB).
    Printed for information only: where the card is shared through a
    container's proxy, the pids listed are not this machine's (one row for
    every process of the container, this one included), so the rows cannot
    say which process held what."""

    def __init__(self, period_s=0.25):
        import threading

        self.period_s = period_s
        self.peak_mib: dict = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def sample(self):
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout
        for line in out.strip().splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 2 or not parts[0].isdigit():
                continue
            mib = float(parts[1].split()[0])
            pid = int(parts[0])
            self.peak_mib[pid] = max(self.peak_mib.get(pid, 0.0), mib)

    def _loop(self):
        while not self._stop.wait(self.period_s):
            self.sample()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.sample()


def _elastic_spec(name, policy, seed, s, t_total, mode, teacher=None):
    """A 6i tenant: ``har_odl.full()``, synth ticks seeded per tick, and the
    latency teacher of ``tests/test_elastic.py`` (or ``teacher``)."""
    from repro_torch.configs import har_odl
    from repro_torch.runtime import worker as worker_mod

    cfg = har_odl.full()
    return worker_mod.tenant_spec(
        name, cfg, s=s, mode=mode, capacity=ELASTIC["capacity"], backpressure=policy,
        ticks=worker_mod.synth_ticks_spec(seed=seed, t_total=t_total),
        teacher=teacher or worker_mod.latency_teacher_spec(
            n_out=cfg.elm.n_out, latency=2, jitter=2, loss=0.2, partial=0.15, seed=seed),
    )


def _elastic_solo(spec, device):
    """The uninterrupted run a migrated tenant must reproduce, in this
    process, from the spec builders the workers use."""
    from repro_torch import engine
    from repro_torch.engine import snapshot, stream
    from repro_torch.runtime import worker as worker_mod

    it = iter(worker_mod._build_ticks(spec))
    cfg = snapshot.config_from_dict(spec["cfg"])
    sess = stream.StreamSession(
        engine.init_fleet(cfg, spec["s"], device), cfg, worker_mod._build_teacher(spec, {}),
        mode=spec["mode"], capacity=spec["capacity"], backpressure=spec["backpressure"],
        collect=spec["collect"])
    sess.start(next(it))
    while sess._p is not None:
        sess.advance(next(it, None))
    sess.drain_replies()
    state, _, stats = sess.finish()
    return snapshot.state_to_tree(state), stats


def _note_rate(rates, worker, live):
    """Note a worker's Σ s·tick_rate_ema (the router's load signal) while
    it has tenants that still tick."""
    ticking = [t for t in live if not t["draining"]]
    if ticking:
        rates.setdefault(worker, []).append(sum(t["s"] * t["tick_rate_ema"] for t in ticking))


def _wait_live_at(client, names, tick, rates, timeout_s=120.0):
    """Poll ``client``'s status until every named tenant is live at ``tick``
    or later (a tenant that finished first fails the phase); notes the
    worker's Σ s·tick_rate_ema in ``rates``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        live = client.status()["live"]
        rows = {t["name"]: t for t in live}
        _note_rate(rates, client.name, live)
        check(all(n in rows for n in names),
              f"elastic: a tenant finished before its cut (live {sorted(rows)})")
        if all(rows[n]["t"] >= tick for n in names):
            return rows
        time.sleep(0.05)
    raise TimeoutError(f"elastic: {names} never reached tick {tick}")


def _elastic_wait(router, names, rates, timeout_s=300.0):
    """``Router.wait_finished``, noting each worker's Σ s·tick_rate_ema."""
    remaining = set(names)
    deadline = time.monotonic() + timeout_s
    while remaining:
        for w in router.workers:
            st = w.status()
            _note_rate(rates, w.name, st["live"])
            remaining -= set(st["finished"])
        check(time.monotonic() < deadline, f"elastic: never finished: {sorted(remaining)}")
        time.sleep(0.05)


def _worker_scrape(client):
    """A worker's own counts, from its ``metrics`` scrape: its peak device
    memory (``odl_worker_device_peak_bytes``), and by kernel its eager
    launches, its launches by graph replays and the shapes it launched or
    captured the kernel at (all 0 or empty when the worker started)."""
    gauges = client.metrics()[0]["metrics"]["gauges"]

    def by_kernel(name):
        return {r["labels"]["kernel"]: int(r["value"]) for r in gauges[name]}

    shapes = {}
    for r in gauges.get("odl_worker_kernel_shape", []):
        shapes.setdefault(r["labels"]["kernel"], set()).add(
            tuple(int(d) for d in r["labels"]["shape"].split(",")))
    return {"peak_bytes": int(gauges["odl_worker_device_peak_bytes"][0]["value"]),
            "launches": by_kernel("odl_worker_kernel_launches"),
            "replays": by_kernel("odl_worker_kernel_replays"), "shapes": shapes}


def phase_elastic(device="cuda"):
    """6i: the elastic fleet on the card (see the module docstring)."""
    import statistics

    import torch

    from repro_torch.engine import graphs, rpc
    from repro_torch.kernels import ops
    from repro_torch.runtime import elastic
    from repro_torch.runtime import worker as worker_mod

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    e = ELASTIC
    p_bytes = 128 * 128 * 4  # one stream's P
    res = {"migrations": [], "rates": {}}
    workers = []
    try:
        with _GpuMemory() as mem:
            workers = [elastic.spawn_worker(f"w{i}", quantum=1) for i in range(2)]
            w0, w1 = workers
            res["spawn_s"] = time.perf_counter() - t_phase
            pids = {w.name: w.proc.pid for w in workers}
            # (a) migration: four tenants, one per policy, fuse on w0 into
            # one cohort of the fleet's width; each moves to w1 mid-stream.
            specs = [_elastic_spec(f"mig_{p}", p, SEED + 600 + i, e["streams"], e["ticks"],
                                   "train_phase") for i, p in enumerate(POLICIES)]
            for spec in specs:
                w0.admit(spec)
            names = [s["name"] for s in specs]
            rows = _wait_live_at(w0, names, e["cut"], res["rates"])
            check(all(r["fused"] for r in rows.values()), f"elastic: not fused on w0: {rows}")
            res["fused_rows"] = sum(r["s"] for r in rows.values())
            res["cut_status_t"] = {n: r["t"] for n, r in rows.items()}
            # Every extract first, back to back, so that the source's other
            # tenants cannot run out while the router ships one; then every
            # admit.  A tenant's ship is its extract and its admit.
            shipped = []
            for spec in specs:
                t0 = time.perf_counter()
                sent, wire = w0.extract(spec["name"])
                shipped.append((sent, wire, 1e3 * (time.perf_counter() - t0)))
            for sent, wire, extract_ms in shipped:
                t0 = time.perf_counter()
                reply = w1.admit(sent, wire)
                admit_ms = 1e3 * (time.perf_counter() - t0)
                check(reply["migrated"] is True, f"elastic: {reply}")
                res["migrations"].append(dict(
                    tenant=sent["name"], extract_ms=extract_ms, admit_ms=admit_ms,
                    ship_ms=extract_ms + admit_ms, wire_bytes=len(wire)))
            del shipped
            router = elastic.Router(workers)
            _elastic_wait(router, names, res["rates"])
            finished = {n: w1.result(n) for n in names}
            res["migration_part_s"] = time.perf_counter() - t_phase - res["spawn_s"]
            t_b = time.perf_counter()
            # (b) scale-in: four algo1 tenants and one taught over the wire
            # drain off w0 onto w1; w0 exits.
            with rpc.loopback_server(n_out=6, delay_s=e["rpc_delay_s"]) as (host, port):
                specs_b = [_elastic_spec(
                    "drain_rpc", "drop_oldest", SEED + 704, e["scale_streams"],
                    e["rpc_ticks"], "train_phase",
                    teacher=worker_mod.rpc_teacher_spec(host, port, timeout_s=30.0))]
                specs_b += [_elastic_spec(f"drain{i}", "drop_oldest", SEED + 700 + i,
                                          e["scale_streams"], e["scale_ticks"], "algo1")
                            for i in range(4)]
                names_b = [s["name"] for s in specs_b]
                for spec in specs_b:
                    w0.admit(spec)
                _wait_live_at(w0, names_b, e["drain_at"], res["rates"])
                scrapes = {"w0": _worker_scrape(w0)}
                t0 = time.perf_counter()
                migrated, finished_there = router.scale_in(w0)
                res["scale_in_ms"] = 1e3 * (time.perf_counter() - t0)
                check(sorted(migrated) == sorted(names_b) and not finished_there,
                      f"elastic: scale-in moved {migrated}, finished there {finished_there}")
                check(w0.proc.wait(timeout=60) == 0, "elastic: the drained worker did not exit 0")
                check(router.workers == [w1], "elastic: the drained worker is still in the fleet")
                _elastic_wait(router, names_b, res["rates"])
                results_b = {n: st for n, st in router.fleet_results().items() if n in names_b}
                scrapes["w1"] = _worker_scrape(w1)
            router.close()
            res["scale_in_part_s"] = time.perf_counter() - t_b
    finally:
        for w in workers:
            if w.proc.poll() is None:
                w.close(shutdown=True)
    # Peak memory per worker: its allocator's own peak (the worker's
    # metrics); nvidia-smi's rows are printed as they are.
    held = {"w0": 4 * e["streams"] * p_bytes, "w1": 4 * e["streams"] * p_bytes}
    peak = {name: sc["peak_bytes"] for name, sc in scrapes.items()}
    res["peak_bytes"] = peak
    res["smi_rows"] = {str(pid): mib for pid, mib in mem.peak_mib.items()}
    for name in pids:
        check(peak[name] >= held[name], f"elastic: worker {name} peaked at {peak[name]} bytes, "
                                        f"below the {held[name]} bytes of P it held")
    # The path ran through the kernels in each worker, by its own counts.
    res["worker_launches"] = {name: sc["launches"] for name, sc in scrapes.items()}
    res["worker_replays"] = {name: sc["replays"] for name, sc in scrapes.items()}
    for name, sc in scrapes.items():
        for kernel in PATH_KERNELS:
            check(sc["launches"][kernel] + sc["replays"][kernel] > 0,
                  f"elastic: worker {name} ran {kernel} neither eagerly nor by a replay")
    res["launches"] = {k: sum(sc["launches"][k] for sc in scrapes.values())
                       for k in scrapes["w0"]["launches"]}
    res["kernel_replays"] = {k: sum(sc["replays"][k] for sc in scrapes.values())
                             for k in scrapes["w0"]["replays"]}
    # The migrated tenants against their solo runs in this process, on the
    # card (``ops.launch_shapes`` notes their shapes).
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    t_solo = time.perf_counter()
    for spec in specs:
        solo_tree, solo_stats = _elastic_solo(spec, device)
        stats_wire, tree = finished[spec["name"]]
        got = _leaf_digests(tree["state"])
        differ = [p for p, leaf in _leaf_digests(solo_tree).items() if got.get(p) != leaf]
        check(not differ, f"elastic {spec['name']}: state leaves {differ} differ from solo")
        bad = [f for f in COUNTERS if stats_wire[f] != getattr(solo_stats, f)]
        check(not bad, f"elastic {spec['name']}: counters {bad} differ from solo")
        check(stats_wire["label_latency_ticks"] == list(solo_stats.label_latency_ticks),
              f"elastic {spec['name']}: label latency history differs from solo")
        check(stats_wire["reconciled"] and stats_wire["tickets_reasked"] == 0,
              f"elastic {spec['name']}: {stats_wire}")
    _sync(device)
    res["solo_s"] = time.perf_counter() - t_solo
    res["solo_launches"] = dict(ops.launch_counts)
    res["solo_replays"] = dict(graphs.kernel_replays)
    for name in PATH_KERNELS:
        check(res["solo_launches"][name] + res["solo_replays"][name] > 0,
              f"elastic solo runs: {name} ran neither eagerly nor by a replay")
    # Scale-in accounting: per tenant and fleet-wide.
    agg = elastic.reconcile(results_b)
    check(sorted(results_b) == sorted(names_b), f"elastic: results of {sorted(results_b)}")
    check(agg["reconciled"] and all(agg["per_tenant"].values()) and agg["queries_issued"] > 0,
          f"elastic: scale-in accounting {agg}")
    res["scale_in"] = {k: v for k, v in agg.items() if k != "per_tenant"}
    res["rpc_tenant"] = {k: results_b["drain_rpc"][k] for k in
                         ("queries_issued", "labels_applied", "queries_lost", "tickets_issued",
                          "tickets_reasked", "tickets_lost", "reconciled")}
    # Every shape a worker launched or captured a kernel at, by its own
    # report, and the solo runs' shapes, each held in phases 2-4.
    ran = {}
    for got_by_kernel in [sc["shapes"] for sc in scrapes.values()] + [ops.launch_shapes]:
        for name, got in got_by_kernel.items():
            ran.setdefault(name, set()).update(got)
    check(all(sc["shapes"].get(name) for sc in scrapes.values() for name in PATH_KERNELS),
          f"elastic: a worker reported no shape for a path kernel: {ran}")
    missing = {name: sorted(got - set(_ShapeLog.HELD.get(name, ())))
               for name, got in ran.items() if got - set(_ShapeLog.HELD.get(name, ()))}
    check(not missing, f"elastic: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {name: sorted(got) for name, got in ran.items() if got}
    res["stream_ticks_per_s"] = {w: {"median": statistics.median(r), "max": max(r),
                                     "polls": len(r)} for w, r in res["rates"].items()}
    res["seconds"] = time.perf_counter() - t_phase
    del res["rates"]
    print(f"elastic (6i, 2 workers, S={e['streams']}x4 fused to {res['fused_rows']} rows, "
          f"n_in=561, N=128, m=6) on {card}: {json.dumps(res)}")
    for m in res["migrations"]:
        print(f"  migrate {m['tenant']}: extract {m['extract_ms']:.1f} ms, admit "
              f"{m['admit_ms']:.1f} ms, ship {m['ship_ms']:.1f} ms, {m['wire_bytes']} wire "
              f"bytes ({card})")
    print("  migrated tenants bit for bit their solo runs on the card (state, counters, label "
          "latency history; tickets_reasked 0)")
    for name, nbytes in peak.items():
        ran_here = {k: res["worker_launches"][name][k] + res["worker_replays"][name][k]
                    for k in PATH_KERNELS}
        print(f"  worker {name} (pid {pids[name]}) ran, by its own scrape (launches + "
              f"replays): {ran_here}; peak memory {nbytes} bytes (its allocator, "
              f"odl_worker_device_peak_bytes), P held {held[name]} bytes; stream·ticks/s "
              f"(status, Σ s·tick_rate_ema) median "
              f"{res['stream_ticks_per_s'][name]['median']:.1f}, max "
              f"{res['stream_ticks_per_s'][name]['max']:.1f} ({card})")
    print(f"  nvidia-smi compute apps, peak MiB by pid (information: the container's "
          f"processes may share one row): {res['smi_rows']}")
    print(f"  scale-in: {len(names_b)} tenants drained in {res['scale_in_ms']:.1f} ms, worker "
          f"exit 0, fleet reconciled (issued {agg['queries_issued']} = applied "
          f"{agg['labels_applied']} + dropped {agg['queries_dropped']} + lost "
          f"{agg['queries_lost']} + coalesced {agg['queries_coalesced']}); rpc tenant "
          f"{res['rpc_tenant']}")
    print(f"  kernel shapes the workers and the solo runs launched at, each held in phases "
          f"2-4: {res['shapes']}")
    print(f"  phase 6i took {res['seconds']:.1f} s: spawning the workers {res['spawn_s']:.1f}, "
          f"migration {res['migration_part_s']:.1f}, scale-in {res['scale_in_part_s']:.1f}, "
          f"the solo runs {res['solo_s']:.1f} ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6j: stream-axis sharding (engine.split_fleet, stream.run_sharded)
# ---------------------------------------------------------------------------


def _named_leaves(tree, prefix=""):
    """(dotted name, leaf) of a NamedTuple tree, in field order."""
    if hasattr(tree, "_fields"):
        return [nl for f in tree._fields
                for nl in _named_leaves(getattr(tree, f), prefix + f + ".")]
    return [(prefix[:-1], tree)]


def _bitwise_differs(a, b):
    """Names of the leaves where two NamedTuple trees (tensors on any
    device or numpy arrays) differ in dtype, shape or any bit."""
    import numpy as np
    import torch

    def host(x):
        return x.cpu() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))

    out = []
    for (name, x), (_, y) in zip(_named_leaves(a), _named_leaves(b), strict=True):
        x, y = host(x), host(y)
        if x.dtype != y.dtype or not torch.equal(x, y):
            out.append(name)
    return out


def _sharded_window(acc, fn, device="cuda"):
    """Run ``fn`` (one sharded run) with the kernels' launch and replay
    counts set to 0 just before and read just after, added into ``acc``
    with the shapes its kernels were called at; returns (result, seconds)."""
    from repro_torch.engine import graphs
    from repro_torch.kernels import ops

    _sync(device)
    ops.reset_launch_counts()
    graphs.reset_replay_counts()
    with _ShapeLog() as log:
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        secs = time.perf_counter() - t0
    for key, counts in (("launches", ops.launch_counts), ("replays", graphs.kernel_replays)):
        for name, n in counts.items():
            acc[key][name] = acc[key].get(name, 0) + n
    for name, got in log.shapes.items():
        acc["shapes"].setdefault(name, set()).update(got)
    return out, secs


def _shard_teachers(labels, n_shards=SHARDS, **kw):
    """A factory ``k -> LatencyTeacher`` over shard k's label columns; a
    ``seed`` in ``kw`` becomes ``seed + k``."""
    from repro_torch.engine import stream

    width = labels.shape[1] // n_shards

    def make(k):
        kk = dict(kw, seed=kw["seed"] + k) if "seed" in kw else kw
        return stream.LatencyTeacher(
            stream.array_labels(labels[:, k * width:(k + 1) * width]), **kk)

    return make


def _check_shard_accounting(what, stats_list):
    """Per shard and in sum: the accounting identity, and every aggregate
    counter the sum of the shards' own."""
    from repro_torch.engine import stream

    agg = stream.aggregate_stats(stats_list)
    check(all(s.reconciled for s in stats_list) and agg["queries_reconciled"],
          f"sharding {what}: a shard does not reconcile: {agg['per_shard']}")
    for c in COUNTERS[1:]:
        check(sum(p[c] for p in agg["per_shard"]) == agg[c],
              f"sharding {what}: the shards' {c} do not sum to the aggregate")
    return agg


def phase_sharding(fleet_res, fleet_runs, stream_res, zero_runs, device="cuda",
                   n_streams=FLEET_STREAMS):
    """6j: stream-axis sharding on one card (see the module docstring).
    ``fleet_runs`` are phase 6's ``run_fleet`` results and ``zero_runs``
    6c's zero-latency stream runs, by mode, on the host; ``fleet_res`` and
    ``stream_res`` their printed results (for the solo rates)."""
    import shutil
    import tempfile

    import torch

    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.distributed import sharding
    from repro_torch.engine import snapshot, stream
    from repro_torch.engine.types import EngineState
    from repro_torch.launch.mesh import make_fleet_mesh
    from repro_torch.runtime.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    cfg = har_odl.full()
    data = har.generate(seed=SEED)
    card = _card() if device == "cuda" else "cpu"
    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = make_fleet_mesh(SHARDS, devices=[dev] * SHARDS)
    width = n_streams // SHARDS
    acc = {"launches": {}, "replays": {}, "shapes": {}}
    res = {"blocked": {}, "padded": {}, "stream": {}, "rescale": {}}
    with sharding.activate(mesh):
        check(sharding.fleet_axis_size() == SHARDS, "sharding: the mesh's fleet axis")
        # (a) phase 6's runs through the blocked path.
        for mode, n_ticks, shift_at in _fleet_modes():
            xs, ys = _fleet_ticks(data, n_ticks, n_streams, shift_at, device, SEED + n_ticks)
            ref_state, ref_outs = fleet_runs[mode]
            for block in (width, None):
                sh = engine.split_fleet(engine.init_fleet(cfg, n_streams, device), cfg, block=block)
                (sh, outs), secs = _sharded_window(
                    acc, lambda: engine.run_fleet_shards(sh, xs, ys, cfg, mode=mode), device)
                merged = engine.merge_fleet(sh)
                differ = _bitwise_differs(ref_state, merged) + _bitwise_differs(ref_outs, outs)
                check(not differ, f"sharding (a) {mode} block={block}: {differ} differ from "
                                  "run_fleet")
                res["blocked"][f"{mode}_block{block or engine.DEFAULT_STREAM_BLOCK}"] = {
                    "blocks": len(sh.states), "bit_for_bit": True, "secs": secs,
                    "stream_ticks_per_s": n_streams * n_ticks / secs,
                    "solo_stream_ticks_per_s": fleet_res[f"{mode}_stream_ticks_per_s"]}
                del sh, outs, merged
            if mode == "train_phase":
                train = (xs, ys)
            del xs, ys

        # (b) S=16,381: three dead tail rows through both layouts.
        s_b = n_streams - SHARD_DEAD_ROWS
        xs, ys = _fleet_ticks(data, TRAIN_TICKS, s_b, TRAIN_TICKS, device, SEED + 1)
        ref_state, ref_outs = engine.run_fleet(engine.init_fleet(cfg, s_b, device), xs, ys, cfg,
                                               mode="train_phase")
        ref_state, ref_outs = _host_tree(ref_state), _host_tree(ref_outs)
        sh = engine.split_fleet(engine.init_fleet(cfg, s_b, device), cfg, block=width)
        check(sh.n_pad == SHARD_DEAD_ROWS and len(sh.states) == SHARDS,
              f"sharding (b): n_pad {sh.n_pad}, {len(sh.states)} blocks")
        (sh, outs), secs_split = _sharded_window(
            acc, lambda: engine.run_fleet_shards(sh, xs, ys, cfg, mode="train_phase"), device)
        merged = engine.merge_fleet(sh)
        check(merged.elm.P.shape[0] == s_b, "sharding (b): merge_fleet kept the padding")
        differ = _bitwise_differs(ref_state, merged) + _bitwise_differs(ref_outs, outs)
        check(not differ, f"sharding (b) split_fleet: {differ} differ from run_fleet")
        placed, n_pad = engine.shard_fleet(engine.init_fleet(cfg, s_b, device), cfg)
        check(n_pad == SHARD_DEAD_ROWS and placed.elm.P.shape[0] == n_streams,
              f"sharding (b): shard_fleet padded by {n_pad}")
        (st, outs), secs_gspmd = _sharded_window(
            acc, lambda: engine.run_fleet_sharded(placed, xs, ys, cfg, mode="train_phase"), device)
        differ = (_bitwise_differs(ref_state, engine.slice_streams(st, 0, s_b))
                  + _bitwise_differs(ref_outs, outs))
        check(not differ, f"sharding (b) shard_fleet: {differ} differ from run_fleet")
        res["padded"] = {"streams": s_b, "n_pad": n_pad, "bit_for_bit": True,
                         "split_secs": secs_split, "sharded_secs": secs_gspmd}
        del xs, ys, ref_state, ref_outs, sh, merged, placed, st, outs

        # (c) run_sharded over SHARDS sessions, ticks from host memory.
        tr_ticks, tr_labels = (a.cpu().numpy() for a in train)
        xs, ys = _fleet_ticks(data, ALGO1_TICKS, n_streams, ALGO1_SHIFT_AT, device,
                              SEED + ALGO1_TICKS)
        ticks = {"train_phase": (tr_ticks, tr_labels),
                 "algo1": (xs.cpu().numpy(), ys.cpu().numpy())}
        del xs, ys
        for mode, (tk, lb) in ticks.items():
            (st, outs, stats), secs = _sharded_window(acc, lambda: stream.run_sharded(
                engine.init_fleet(cfg, n_streams, device), iter(tk), cfg,
                _shard_teachers(lb, latency=0), mode=mode), device)
            z_state, z_outs = zero_runs[mode]
            differ = _bitwise_differs(z_state, st) + _bitwise_differs(z_outs, outs)
            check(not differ, f"sharding (c) {mode} latency 0: {differ} differ from 6c")
            agg = _check_shard_accounting(f"(c) {mode} latency 0", stats)
            check(agg["labels_applied"] == agg["queries_issued"] > 0,
                  f"sharding (c) {mode}: a zero-latency label was not applied")
            res["stream"][f"{mode}_latency0"] = {
                "bit_for_bit": True, "secs": secs,
                "stream_ticks_per_s": n_streams * len(tk) / secs,
                "solo_stream_ticks_per_s": stream_res[f"{mode}_stream_ticks_per_s"],
                "tick_p50_ms": agg["tick_p50_ms"], "tick_p95_ms": agg["tick_p95_ms"]}
            del st, outs, stats
        solo_state, solo_outs, solo_stats, solo_secs = _run_stream_once(
            cfg, tr_ticks, tr_labels, "train_phase", device, {"latency": 3})
        solo_state = _host_tree(solo_state)
        (st, outs, stats), secs = _sharded_window(acc, lambda: stream.run_sharded(
            engine.init_fleet(cfg, n_streams, device), iter(tr_ticks), cfg,
            _shard_teachers(tr_labels, latency=3), mode="train_phase"), device)
        differ = _bitwise_differs(solo_state, st) + _bitwise_differs(solo_outs, outs)
        check(not differ, f"sharding (c) latency 3: {differ} differ from the solo stream.run")
        agg = _check_shard_accounting("(c) latency 3", stats)
        same = ("stream_steps", "queries_issued", "labels_applied", "queries_dropped",
                "queries_lost", "queries_coalesced", "replies_orphaned")
        check(all(agg[c] == getattr(solo_stats, c) for c in same),
              "sharding (c) latency 3: query counters differ from the solo run")
        res["stream"]["train_phase_latency3"] = {
            "bit_for_bit": True, "secs": secs, "stream_ticks_per_s": n_streams * TRAIN_TICKS / secs,
            "solo_stream_ticks_per_s": n_streams * TRAIN_TICKS / solo_secs,
            "label_latency_p50": agg["label_latency_p50"]}
        del solo_state, solo_outs, st, outs
        tk, lb = ticks["algo1"]
        (st, outs, stats), secs = _sharded_window(acc, lambda: stream.run_sharded(
            engine.init_fleet(cfg, n_streams, device), iter(tk), cfg,
            _shard_teachers(lb, **STREAM_TEACHER), mode="algo1", capacity=STREAM_CAPACITY,
            backpressure="drop_oldest"), device)
        agg = _check_shard_accounting("(c) lossy algo1", stats)
        check(agg["labels_applied"] > 0, f"sharding (c) lossy algo1: no label applied: {agg}")
        res["stream"]["algo1_lossy_drop_oldest"] = {
            k: agg[k] for k in ("queries_issued", "labels_applied", "queries_dropped",
                                "queries_lost", "replies_orphaned", "queries_reconciled",
                                "tick_p50_ms", "tick_p95_ms", "label_latency_p50")}
        res["stream"]["algo1_lossy_drop_oldest"]["per_shard_issued"] = [
            p["queries_issued"] for p in agg["per_shard"]]
        res["stream"]["algo1_lossy_drop_oldest"]["secs"] = secs
        del ticks, tk, lb, st, outs, stats

        # (d) merged at tick SHARD_SAVE_TICK, saved, restored with shardings
        # onto the card, split into SHARD_RESCALE shards, run to the end.
        xs, ys = train
        cut = SHARD_SAVE_TICK
        tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharding_"))
        try:
            sh = engine.split_fleet(engine.init_fleet(cfg, n_streams, device), cfg, block=width)
            (sh, outs_a), _ = _sharded_window(
                acc, lambda: engine.run_fleet_shards(sh, xs[:cut], ys[:cut], cfg,
                                                     mode="train_phase"), device)
            tree = snapshot.state_to_tree(engine.merge_fleet(sh))
            del sh
            t0 = time.perf_counter()
            CheckpointManager(str(tmp)).save(cut, tree)
            save_ms = 1e3 * (time.perf_counter() - t0)
            shardings = {g: {k: dev for k in leaves} for g, leaves in tree.items()}
            del tree
            t0 = time.perf_counter()
            step, restored = CheckpointManager(str(tmp)).restore(shardings=shardings)
            _sync(device)
            restore_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ref_state, ref_outs = fleet_runs["train_phase"]
        state = EngineState(*(type(getattr(ref_state, g))(**restored[g])
                              for g in EngineState._fields))
        check(step == cut and all(a.device == dev for _, a in _named_leaves(state)),
              "sharding (d): the restore did not place every leaf on the card")
        sh = engine.split_fleet(state, cfg, n_shards=SHARD_RESCALE)
        del state, restored
        (sh, outs_b), _ = _sharded_window(
            acc, lambda: engine.run_fleet_shards(sh, xs[cut:], ys[cut:], cfg, mode="train_phase"),
            device)
        outs = type(outs_a)(*(torch.cat(p, dim=0) for p in zip(outs_a, outs_b)))
        differ = _bitwise_differs(ref_state, engine.merge_fleet(sh)) + _bitwise_differs(
            ref_outs, outs)
        check(not differ, f"sharding (d): {differ} differ from the uninterrupted run")
        res["rescale"] = {"from_shards": SHARDS, "to_shards": SHARD_RESCALE,
                          "blocks_after": len(sh.states), "cut": cut, "bit_for_bit": True,
                          "save_ms": save_ms, "restore_ms": restore_ms}
        del sh, train, xs, ys
    for name in PATH_KERNELS:
        check(device != "cuda" or acc["launches"][name] + acc["replays"][name] > 0,
              f"sharding: {name} ran neither eagerly nor by a replay on the sharded paths")
    res["launches"], res["replays"] = acc["launches"], acc["replays"]
    res["shapes"] = {name: sorted(got) for name, got in acc["shapes"].items() if got}
    missing = {name: sorted(got - set(_ShapeLog.HELD[name]))
               for name, got in acc["shapes"].items() if got - set(_ShapeLog.HELD[name])}
    check(device != "cuda" or not missing,
          f"sharding: kernels called at shapes phases 2-4 did not hold: {missing}")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"sharding (6j, mesh of {SHARDS} x {dev}, S={n_streams}, n_in={cfg.elm.n_in}, "
          f"N={cfg.elm.n_hidden}, m={cfg.elm.n_out}) on {card}: "
          f"{json.dumps({k: v for k, v in res.items() if k != 'shapes'})}")
    for key, r in list(res["blocked"].items()) + [(k, v) for k, v in res["stream"].items()
                                                  if "solo_stream_ticks_per_s" in v]:
        print(f"  {key}: bit for bit; sharded {r['stream_ticks_per_s']:.1f} against solo "
              f"{r['solo_stream_ticks_per_s']:.1f} stream·ticks/s ({card})")
    print(f"  padded S={n_streams - SHARD_DEAD_ROWS}: split_fleet and shard_fleet bit for bit "
          f"run_fleet, the {res['padded']['n_pad']} dead rows stripped; rescale "
          f"{SHARDS} -> {SHARD_RESCALE} shards at tick {SHARD_SAVE_TICK} bit for bit (save "
          f"{res['rescale']['save_ms']:.1f} ms, restore onto {dev} "
          f"{res['rescale']['restore_ms']:.1f} ms) ({card})")
    print("  kernels on the sharded paths (launches + replays): "
          f"{ {k: res['launches'][k] + res['replays'][k] for k in PATH_KERNELS} }")
    print(f"  kernel shapes on the sharded paths, each held in phases 2-4: {res['shapes']}")
    print(f"  phase 6j took {res['seconds']:.1f} s ({card})")
    return res


# ---------------------------------------------------------------------------
# Phase 6k: the dense backbone's serving path (models/, launch/serve.py)
# ---------------------------------------------------------------------------


def _model_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _model_leaves(v)
        else:
            yield v


def _first_layers(stacked, depth):
    """The first ``depth`` layers of a stacked layer tree (views)."""
    return {k: _first_layers(v, depth) if isinstance(v, dict) else v[:depth]
            for k, v in stacked.items()}


def _within(got, want, atol, rtol):
    """max |got - want| - (atol + rtol |want|), <= 0 where within (f32)."""
    g, w = got.float(), want.float()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


def _fro_and_max(got, want):
    """(Frobenius relative error, max abs difference) of got against want."""
    import torch

    g, w = got.double(), want.double()
    return (float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w)),
            float((g - w).abs().max()))


def _serve_report(out):
    """The aggregate stream·ticks/s and each tenant's tick p50/p95 (ms) of
    a ``launch.serve.serve`` printout."""
    import re

    rate = re.search(r"aggregate: .* steps in ([0-9.]+)s \(([0-9,]+) steps/s\)", out)
    ticks = re.findall(r"  (tenant\d+): tick p50/p95 ([0-9.]+)/([0-9.]+) ms", out)
    return {"steps_per_s": float(rate.group(2).replace(",", "")), "wall_s": float(rate.group(1)),
            "tick_ms": {n: [float(a), float(b)] for n, a, b in ticks},
            "reconciled": out.count("accounting ok"), "broken": out.count("BROKEN")}


def _head_split(prof, n_ticks, wall_ms):
    """6k (h): device ms per tick of the backbone decode and of the ODL head,
    each kernel (and copy) attributed to the ``model`` range it ran under:
    the device-side spans of ``serve.backbone`` and ``serve.head`` (the
    profiler's GPU annotations of those ``record_function`` ranges); the
    head's kernels by name, and the device busy share of the window (every
    kernel and copy, annotations excluded)."""
    from torch.autograd import DeviceType

    spans = {"serve.backbone": [], "serve.head": []}
    work = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name in spans:
            spans[e.name].append((e.time_range.start, e.time_range.end))
        else:
            work.append((e.name, e.time_range.start, e.time_range.end - e.time_range.start))
    ms = {name: 0.0 for name in spans}
    head = {"projection": 0.0, "plan_pass": 0.0, "rls": 0.0, "rest_of_head": 0.0}
    for name, start, dur in work:
        where = next((r for r, ss in spans.items() if any(a <= start < b for a, b in ss)), None)
        if where is None:
            continue
        ms[where] += dur / 1e3
        if where == "serve.head":
            part = ("projection" if "proj_kernel" in name else "plan_pass"
                    if "plan_rows_kernel" in name else "rls" if "rls_single_kernel" in name
                    else "rest_of_head")
            head[part] += dur / 1e3
    busy = sum(dur for _, _, dur in work) / 1e3
    return {"backbone_ms": ms["serve.backbone"] / n_ticks, "head_ms": ms["serve.head"] / n_ticks,
            "head": {k: v / n_ticks for k, v in head.items()},
            "annotated": all(spans.values()), "busy_ms": busy / n_ticks,
            "wall_ms": wall_ms / n_ticks, "busy_share": busy / wall_ms if wall_ms else float("nan")}


def phase_backbone(device="cuda"):
    """6k: the dense GQA backbone's serving path at qwen3-4b's full width
    (see the module docstring)."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs, engine
    from repro_torch.data.tokens import TokenStream, TokenStreamConfig
    from repro_torch.engine import graphs, snapshot, stream
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import layers, transformer
    from repro_torch.models import model as model_lib
    from repro_torch.runtime import elastic
    from repro_torch.runtime import worker as worker_mod

    t_phase = time.perf_counter()
    card = _card()
    torch.cuda.empty_cache()
    bb = BACKBONE
    cfg = configs.get_config(bb["arch"], bb["variant"])
    b, max_len = bb["batch"], bb["max_len"]
    res = {}
    graphs.reset_replay_counts()
    ops.reset_launch_counts()
    with _ShapeLog() as log:
        # (a) build the model on the card from the seed; count it.
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model_lib.build_params(cfg, SEED, device)
        _sync(device)
        res["build_s"] = time.perf_counter() - t0
        res["build_peak_bytes"] = torch.cuda.max_memory_allocated()
        res["params"] = sum(t.numel() for t in _model_leaves(params))
        schema_count = layers.count_params(model_lib.build_schema(cfg))
        check(res["params"] == schema_count == bb["params"],
              f"backbone: {res['params']} params built, schema {schema_count}")
        print(f"backbone (6k, {bb['arch']} {bb['variant']}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}) "
              f"on {card}: {res['params']} parameters (count_params {schema_count}), built in "
              f"{res['build_s']:.2f} s, allocator peak {res['build_peak_bytes']} bytes")

        # (b) decode equals prefill: prefill 15 tokens, serve_step token 16,
        # against lm_hidden over all 16.
        gen = torch.Generator().manual_seed(SEED)
        toks = torch.randint(0, cfg.vocab_size, (b, bb["prompt_len"]), generator=gen).to(device)
        _, st = model_lib.prefill(params, toks[:, :-1], cfg, max_len=max_len)
        logits, st, _ = model_lib.serve_step(params, st, toks[:, -1:], cfg)
        h_all, _ = transformer.lm_hidden(params, toks, cfg)
        full = transformer.lm_logits(params, h_all[:, -1:], cfg)[:, 0]
        over = _within(logits, full, 0.15, 0.05)
        res["decode_vs_prefill"] = dict(zip(("fro_rel", "max_abs"), _fro_and_max(logits, full)),
                                        excess_over_bound=over)
        check(over <= 0, f"backbone (b): decode beyond prefill's logits by {over} past the bound")
        del st, logits, h_all, full
        print(f"  (b) decode equals prefill at B={b}: logits within atol 0.15, rtol 0.05 "
              f"(Frobenius rel {res['decode_vs_prefill']['fro_rel']:.4f}, max abs "
              f"{res['decode_vs_prefill']['max_abs']:.4f})")

        # (c) naive against chunked attention over a 1,024-token prompt, at
        # the depth the reference's bounds come from (its 2-layer smoke
        # model: the first two layers, at full width), then through all 36
        # layers: the two algorithms round the softmax at different points,
        # and the difference compounds with depth in the reference as here
        # (tests/test_torch_models.py holds the port's divergence with depth
        # to the JAX package's), so the deep run is printed, not bounded.
        long = torch.randint(0, cfg.vocab_size, (bb["chunk_batch"], bb["chunk_prompt"]),
                             generator=gen).to(device)
        chunked = dict(attention_impl="chunked", attention_chunk=bb["chunk"])
        res["naive_vs_chunked"] = {}
        for depth in (bb["chunk_depth"], cfg.n_layers):
            cut = cfg.replace(n_layers=depth)
            p_cut = dict(params, layers=_first_layers(params["layers"], depth))
            h_naive, _ = transformer.lm_hidden(p_cut, long, cut)
            h_chunk, _ = transformer.lm_hidden(p_cut, long, cut.replace(**chunked))
            fro, worst = _fro_and_max(h_chunk, h_naive)
            res["naive_vs_chunked"][depth] = {"fro_rel": fro, "max_abs": worst}
            del h_naive, h_chunk
        del long
        shallow = res["naive_vs_chunked"][bb["chunk_depth"]]
        deep = res["naive_vs_chunked"][cfg.n_layers]
        check(shallow["fro_rel"] < 3e-2 and shallow["max_abs"] < 0.15,
              f"backbone (c): chunked against naive at {bb['chunk_depth']} layers: {shallow}")
        print(f"  (c) naive against chunked attention (B={bb['chunk_batch']}, "
              f"{bb['chunk_prompt']} tokens, chunk {bb['chunk']}, full width): at "
              f"{bb['chunk_depth']} layers Frobenius rel {shallow['fro_rel']:.4f} < 3e-2, max abs "
              f"{shallow['max_abs']:.4f} < 0.15; through all {cfg.n_layers} layers Frobenius rel "
              f"{deep['fro_rel']:.4f}, max abs {deep['max_abs']:.4f} (printed)")

        # (d) replay determinism, and decode ms per token on the host clock.
        prompts = torch.randint(0, cfg.vocab_size, (b, bb["prompt_len"]), generator=gen).to(device)
        _, state = model_lib.prefill(params, prompts, cfg, max_len=max_len)
        token_ms = []
        first = []
        _sync(device)
        t0 = time.perf_counter()
        for f in serve_lib._decode_feats(params, state, prompts, cfg, bb["replay_ticks"]):
            _sync(device)
            token_ms.append(1e3 * (time.perf_counter() - t0))
            first.append(f)
            t0 = time.perf_counter()
        again = list(serve_lib._decode_feats(params, state, prompts, cfg, bb["replay_ticks"]))
        same = all(torch.equal(x, y) for x, y in zip(first, again))
        check(same and len(again) == bb["replay_ticks"], "backbone (d): the replayed decode differs")
        token_ms.sort()
        res["decode_ms_per_token"] = {"p50": token_ms[len(token_ms) // 2],
                                      "p95": token_ms[int(0.95 * (len(token_ms) - 1))],
                                      "first": token_ms[0]}
        del first, again, state
        print(f"  (d) two decodes of {bb['replay_ticks']} tokens from one prefill: bit for bit; "
              f"decode ms per token at B={b} (host clock, synchronised) p50 "
              f"{res['decode_ms_per_token']['p50']:.2f}, p95 "
              f"{res['decode_ms_per_token']['p95']:.2f} ({card})")

        # (e) the cascade: serve_step + serve_apply_labels, a synchronous
        # teacher answering every queried stream with its domain.
        n_dom = cfg.odl.n_out
        domains = torch.arange(b) % n_dom
        tables = TokenStream(TokenStreamConfig(cfg.vocab_size, 1, 1, n_domains=n_dom))._tables
        top_ids = torch.as_tensor(tables.argsort(axis=1)[:, -100:].copy())
        labels = domains.to(torch.int32).to(device)
        st = model_lib.init_serve_state(cfg, b, bb["cascade_ticks"] + bb["profile_ticks"] + 8,
                                        device)

        def cascade_tick(t, st, counts=None):
            tok = top_ids[domains, (t + torch.arange(b)) % 100][:, None].to(device)
            before = dict(ops.launch_counts)
            _, st, odl = model_lib.serve_step(params, st, tok, cfg)
            st = model_lib.serve_apply_labels(st, odl, labels, odl.queried, cfg)
            if counts is not None:
                q = int(odl.queried.sum())
                counts.append(q)
                d = {k: ops.launch_counts[k] - before.get(k, 0) for k in PATH_KERNELS}
                check(d["xorshift_projection"] == 1 and d["plan_rows"] == 1
                      and (d["oselm_rls_update_fleet"] == 1 if q
                           else d["oselm_rls_update_fleet"] <= 1),
                      f"backbone (e): tick {t} launched {d} with {q} streams answered")
            return st

        queried = []
        t0 = time.perf_counter()
        for t in range(bb["cascade_ticks"]):
            st = cascade_tick(t, st, queried)
        _sync(device)
        res["cascade"] = {"ticks": bb["cascade_ticks"], "queried": queried,
                          "tick_ms": 1e3 * (time.perf_counter() - t0) / bb["cascade_ticks"],
                          "meter_bytes": float(st.odl.meter.total.sum()),
                          "labels": int(st.odl.elm.count.sum())}
        check(res["cascade"]["labels"] == sum(queried), "backbone (e): labels applied != queried")
        print(f"  (e) cascade, {bb['cascade_ticks']} ticks at B={b}: queried per tick "
              f"{queried}; comm volume {res['cascade']['meter_bytes']:.0f} bytes metered "
              f"({sum(queried)} queries of {b * bb['cascade_ticks']} stream ticks); "
              f"{res['cascade']['tick_ms']:.2f} ms a tick (host clock) ({card})")

        # (h) the split of a serve tick, continuing the cascade.
        for t in range(bb["cascade_ticks"], bb["cascade_ticks"] + 2):
            st = cascade_tick(t, st)  # warm-up
        _sync(device)
        n = bb["profile_ticks"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(bb["cascade_ticks"] + 2, bb["cascade_ticks"] + 2 + n):
                st = cascade_tick(t, st)
            _sync(device)
            wall_ms = 1e3 * (time.perf_counter() - t0)
        res["split"] = _head_split(prof, n, wall_ms)
        del st, params, prof
        torch.cuda.empty_cache()
        sp = res["split"]
        if not sp["annotated"]:
            print("  (h) the split: not measured (the profiler gave no device-side spans of "
                  "serve.backbone and serve.head)")
        print(f"  (h) a serve tick at B={b} ({n} ticks profiled): device ms backbone decode "
              f"{sp['backbone_ms']:.3f}, ODL head {sp['head_ms']:.3f} (projection "
              f"{sp['head']['projection']:.4f}, plan's pass {sp['head']['plan_pass']:.4f}, RLS "
              f"{sp['head']['rls']:.4f}, the rest of the head {sp['head']['rest_of_head']:.4f}); "
              f"head share {100 * sp['head_ms'] / max(sp['backbone_ms'] + sp['head_ms'], 1e-9):.2f} "
              f"%; device busy {sp['busy_ms']:.3f} of {sp['wall_ms']:.3f} ms wall "
              f"({100 * sp['busy_share']:.1f} %) ({card})")

        # (f) launch.serve.serve: two tenants under the latency teacher, then over
        # the loopback rpc server.
        res["serve"] = {}
        for teacher in ("latency", "rpc"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                queries, skips = serve_lib.serve(
                    arch=bb["arch"], variant=bb["variant"], batch=b, gen_tokens=bb["serve_tokens"],
                    tenants=2, teacher_latency=2, teacher=teacher, seed=SEED, device=device)
            out = buf.getvalue()
            print("\n".join("    " + line for line in out.splitlines()))
            rep = _serve_report(out)
            rep.update(queries=queries, skips=skips)
            check(rep["reconciled"] == 2 and rep["broken"] == 0
                  and queries + skips == 2 * b * bb["serve_tokens"],
                  f"backbone (f): serve ({teacher}) did not reconcile: {rep}")
            res["serve"][teacher] = rep
            torch.cuda.empty_cache()
        lat = res["serve"]["latency"]
        print(f"  (f) serve({bb['arch']} {bb['variant']}, B={b}, {bb['serve_tokens']} tokens, 2 tenants, "
              f"latency 2): reconciled; {lat['steps_per_s']:.0f} stream·ticks/s aggregate; "
              f"tenant tick p50/p95 ms {lat['tick_ms']}; teacher=rpc reconciled, "
              f"{res['serve']['rpc']['steps_per_s']:.0f} stream·ticks/s ({card})")
    res["launches"] = dict(ops.launch_counts)
    res["replays"] = dict(graphs.kernel_replays)
    for k in PATH_KERNELS:
        check(res["launches"].get(k, 0) + res["replays"].get(k, 0) > 0,
              f"backbone: {k} ran neither eagerly nor by a replay on 6k's path")
    missing = log.missing()
    check(not missing, f"backbone: shapes phases 2-4 did not hold: {missing}")
    res["shapes"] = {k: sorted(v) for k, v in log.shapes.items() if v}

    # (g) a decode tenant on two port workers, migrated after tick 16,
    # against its solo run in this process.
    spec = worker_mod.tenant_spec(
        "decoder", model_lib.core_config(cfg), s=b, mode="serve", capacity=8,
        backpressure="drop_oldest",
        ticks=serve_lib.decode_ticks_spec(bb["arch"], bb["variant"], b, SEED, bb["worker_ticks"],
                                          tick_sleep_ms=20.0, max_len=max_len),
        teacher=worker_mod.latency_teacher_spec(n_out=cfg.odl.n_out, latency=2, jitter=1,
                                                seed=SEED))
    workers = []
    t_g = time.perf_counter()
    try:
        workers = [elastic.spawn_worker(f"b{i}", quantum=1) for i in range(2)]
        w0, w1 = workers
        w0.admit(spec)
        _wait_live_at(w0, ["decoder"], bb["worker_cut"], {}, timeout_s=300)
        sent, wire = w0.extract("decoder")
        cut = snapshot.ticks_consumed(snapshot.decode_snapshot(wire))
        check(bb["worker_cut"] <= cut < bb["worker_ticks"], f"backbone (g): cut at {cut}")
        check(w1.admit(sent, wire)["migrated"] is True, "backbone (g): admit on b1 refused")
        _elastic_wait(elastic.Router([w1]), ["decoder"], {}, timeout_s=300)
        stats_wire, tree = w1.result("decoder")
        scrapes = {w.name: _worker_scrape(w) for w in workers}
    finally:
        for w in workers:
            if w.proc.poll() is None:
                w.close(shutdown=True)
    solo_spec = dict(spec, ticks=dict(spec["ticks"], tick_sleep_ms=0.0))
    it = iter(worker_mod._build_ticks(solo_spec, {}, device))
    ecfg = snapshot.config_from_dict(spec["cfg"])
    sess = stream.StreamSession(
        engine.init_fleet(ecfg, b, device), ecfg,
        worker_mod._build_teacher(spec, {}), mode="serve", capacity=spec["capacity"],
        backpressure=spec["backpressure"], collect=spec["collect"])
    sess.start(next(it))
    while sess._p is not None:
        sess.advance(next(it, None))
    sess.drain_replies()
    solo_state, _, solo_stats = sess.finish()
    del it, sess
    got = _leaf_digests(tree["state"])
    differ = [p for p, leaf in _leaf_digests(snapshot.state_to_tree(solo_state)).items()
              if got.get(p) != leaf]
    check(not differ, f"backbone (g): state leaves {differ} differ from the solo run")
    bad = [f for f in COUNTERS if stats_wire[f] != getattr(solo_stats, f)]
    check(not bad and stats_wire["label_latency_ticks"] == list(solo_stats.label_latency_ticks),
          f"backbone (g): counters {bad} (or label latencies) differ from the solo run")
    check(stats_wire["stream_steps"] == b * bb["worker_ticks"] and stats_wire["reconciled"],
          f"backbone (g): {stats_wire}")
    res["worker"] = {"cut": cut, "wire_bytes": len(wire), "seconds": time.perf_counter() - t_g,
                     "peak_bytes": {n: sc["peak_bytes"] for n, sc in scrapes.items()}}
    res["worker_launches"] = {k: sum(sc["launches"].get(k, 0) for sc in scrapes.values())
                              for k in scrapes["b0"]["launches"]}
    res["worker_replays"] = {k: sum(sc["replays"].get(k, 0) for sc in scrapes.values())
                             for k in scrapes["b0"]["replays"]}
    for name, sc in scrapes.items():
        for k in PATH_KERNELS:
            check(sc["launches"].get(k, 0) + sc["replays"].get(k, 0) > 0,
                  f"backbone (g): worker {name} ran {k} neither eagerly nor by a replay")
        miss = {k: sorted(v - set(_ShapeLog.HELD.get(k, ()))) for k, v in sc["shapes"].items()
                if v - set(_ShapeLog.HELD.get(k, ()))}
        check(not miss, f"backbone (g): worker {name} ran shapes phases 2-4 did not hold: {miss}")
        for k, v in sc["shapes"].items():
            res["shapes"].setdefault(k, [])
            res["shapes"][k] = sorted(set(map(tuple, res["shapes"][k])) | v)
    del solo_state, tree
    torch.cuda.empty_cache()
    print(f"  (g) a decode tenant (B={b}, {bb['worker_ticks']} ticks) on two port workers, "
          f"migrated b0 -> b1 at tick {cut} ({len(wire)} wire bytes): bit for bit its solo run "
          f"in this process (state, counters, label latencies); path kernels by each worker's "
          f"own scrape (launches + replays): "
          + "; ".join(f"{n} " + str({k: sc['launches'].get(k, 0) + sc['replays'].get(k, 0)
                                     for k in PATH_KERNELS}) for n, sc in scrapes.items())
          + f"; worker peaks {res['worker']['peak_bytes']} bytes ({card})")
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  kernel shapes on 6k's path (this process and the workers), each held in phases "
          f"2-4: {res['shapes']}")
    print(f"  kernels on 6k's path in this process (launches + replays): "
          + str({k: res['launches'].get(k, 0) + res['replays'].get(k, 0) for k in PATH_KERNELS}))
    print(f"  phase 6k took {res['seconds']:.1f} s ({card})")
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


def _call_ms(fn, reps=5):
    """Device time of one call of ``fn`` where the call makes the host wait
    for the card, so that ``_device_ms``'s sleep cannot hide the host: CUDA
    events around each call from an idle card, the median of ``reps``.  The
    card's idle gaps inside a call count, as they do for the caller.  (At
    N=256 torch's batched ``lu_solve`` inside the plain RLS update
    synchronises the stream, so the N=256 RLS kernel is timed this way too:
    its row compares one measure.  The profiler does not list that kernel,
    which is launched on a cluster.)"""
    import torch

    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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
    # The same at N=256 (Tables 2-3's width), on the same fleet of x.
    b, n_in, n = K1_N256
    x = _cycling_x(device, b, n_in)
    alpha = xorshift.alpha_hash(0x2D2A, n_in, n, device=device)
    rows[-1]["n256"] = dict(
        shape=list(K1_N256),
        ms=_device_ms(lambda: xorshift_proj.xorshift_projection(x(), 0x2D2A, n)),
        plain_ms=_device_ms(lambda: ref.xorshift_projection_ref(x(), 0x2D2A, n), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: torch.sigmoid(torch.matmul(x(), alpha) * c)),
        **dict(zip(("bound_ms", "bound_by"), _bound(
            flops=3 * 2.0 * b * n_in * n, nbytes=4.0 * (b * n_in + b * n),
            peak_flops=PEAK_TF32_FLOPS))),
    )
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
    # N=256: P is 4 GiB, and the single pass runs with clusters sharing
    # distributed shared memory.
    s, n, k, m = K2_N256
    check(ops.rls_route(n, k, m) == "single", f"{K2_N256} is not a single-pass shape")
    P, beta, H, Y = _rls_inputs(s, n, k, m, device, SEED + 9)
    rows[-1]["n256"] = dict(
        shape=list(K2_N256),
        plan=list(oselm_update.single_pass_plan(n, k, m)),
        ms=_call_ms(lambda: oselm_update.rls_single(P, beta, H, Y)),
        plain_ms=_call_ms(lambda: ref.rls_update_ref(P, beta, H, Y)),
        library_ms=_call_ms(lambda: _rls_composite(P, beta, H, Y)),
        batched_ms=_device_ms(lambda: oselm_update.rls_single(P, beta, H, Y)),
        timed="all three by CUDA events around single calls (the plain and library "
              "versions' batched lu_solve makes the host wait at N=256); batched_ms is "
              "the kernel by _device_ms",
        **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))),
    )
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
    # The plan's per-stream pass at the fleet shape, in its two byte classes:
    # algo1 reads x for the drift feature mean, train_phase reads no x. The
    # teacher is always available (no mask), as in run_fleet.
    def nbytes(*trees):
        from repro_torch.engine.types import tree_leaves

        return float(sum(t.numel() * t.element_size() for t in tree_leaves(trees)
                         if t is not None))

    def pass_times(shape, modes, seed):
        """The fused pass at (S, N, m, n_in) by mode: kernel, plain and bound."""
        s, n, m, n_in = shape
        cfg, args = _plan_inputs(s, n, m, n_in, device, _gen(device, seed))
        args["teacher_available"] = args["drift_active"] = None
        x = _cycling_x(device, s, n_in)
        out = {}
        for mode in modes:
            def kernel(mode=mode):
                return plan_rows.plan_rows(**dict(args, x=x()), cfg=cfg, mode=mode)

            def plain(mode=mode):
                return ref.plan_rows_ref(**dict(args, x=x()), cfg=cfg, mode=mode)

            r = kernel()
            reads_x = mode != "train_phase"
            reads = nbytes(args["h"], args["beta"], args["count"], args["prune"], args["drift"],
                           args["meter"]) + (nbytes(args["x"]) if reads_x else 0.0)
            writes = nbytes(tuple(r[:7]), r.prune, r.meter) + (
                nbytes(r.drift) if reads_x else 0.0)
            ops_ = 2.0 * s * n * m + (2.0 * s * n_in if reads_x else 0.0)
            out[mode] = dict(
                shape=list(shape), ms=_device_ms(kernel),
                plain_ms=_device_ms(plain, reps=PLAIN_REPS), bytes=reads + writes,
                **dict(zip(("bound_ms", "bound_by"), _bound(flops=ops_, nbytes=reads + writes))))
        return out, args, x

    fused, args, x = pass_times(PLAN_SHAPES[0], ("algo1", "train_phase"), SEED + 8)
    s, n, m, n_in = PLAN_SHAPES[0]
    h, beta = args["h"], args["beta"]
    rows.append(dict(
        name="plan_rows", **fused["algo1"], library_ms=None,
        library="none (no one call computes the pass; readout and feature mean alone below)",
        train_phase=fused["train_phase"],
    ))
    # Its reduced instances alone: the readout (h and beta of a tick) and the
    # feature mean (x).
    rows.append(dict(
        name="readout",
        ms=_device_ms(lambda: plan_rows.readout(h, beta)),
        plain_ms=_device_ms(lambda: ref.readout_ref(h, beta)),
        library_ms=_device_ms(lambda: torch.bmm(h[:, None, :], beta)),
        library="torch.bmm (cuBLAS batched)",
        **dict(zip(("bound_ms", "bound_by"), _bound(
            flops=2.0 * s * n * m, nbytes=4.0 * (s * n + s * n * m + s * m)))),
    ))
    rows.append(dict(
        name="row_abs_mean",
        ms=_device_ms(lambda: plan_rows.row_abs_mean(x())),
        plain_ms=_device_ms(lambda: ref.row_abs_mean_ref(x())),
        library_ms=_device_ms(lambda: torch.mean(x().abs(), -1)),
        library="torch.mean(x.abs(), -1)",
        **dict(zip(("bound_ms", "bound_by"), _bound(flops=2.0 * s * n_in,
                                                     nbytes=4.0 * (s * n_in + s)))),
    ))
    del h, beta, x, args
    # The three path kernels at the dense backbone's serving shape (phase
    # 6k: 256 streams of qwen3-4b's d_model), and the plan's pass at the
    # widest dense d_model, whose x rows are read from device memory.
    by_name = {r["name"]: r for r in rows}
    b, n_in, n = K1_BACKBONE
    x = _cycling_x(device, b, n_in)
    alpha = xorshift.alpha_hash(0x2D2A, n_in, n, device=device)
    c = float(1.0 / n_in ** 0.5)
    by_name["xorshift_projection"]["backbone"] = dict(
        shape=list(K1_BACKBONE),
        ms=_device_ms(lambda: xorshift_proj.xorshift_projection(x(), 0x2D2A, n)),
        plain_ms=_device_ms(lambda: ref.xorshift_projection_ref(x(), 0x2D2A, n), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: torch.sigmoid(torch.matmul(x(), alpha) * c)),
        **dict(zip(("bound_ms", "bound_by"), _bound(
            flops=3 * 2.0 * b * n_in * n, nbytes=4.0 * (b * n_in + b * n),
            peak_flops=PEAK_TF32_FLOPS))),
    )
    del x, alpha
    s, n, k, m = K2_BACKBONE
    P, beta, H, Y = _rls_inputs(s, n, k, m, device, SEED + 10)
    by_name["oselm_rls_update_fleet"]["backbone"] = dict(
        shape=list(K2_BACKBONE),
        ms=_device_ms(lambda: oselm_update.rls_single(P, beta, H, Y)),
        plain_ms=_device_ms(lambda: ref.rls_update_ref(P, beta, H, Y), reps=PLAIN_REPS),
        library_ms=_device_ms(lambda: _rls_composite(P, beta, H, Y), reps=PLAIN_REPS),
        **dict(zip(("bound_ms", "bound_by"), _rls_bound(s, n, k, m))),
    )
    del P, beta, H, Y
    served, _, _ = pass_times(PLAN_BACKBONE, ("serve",), SEED + 11)
    wide, _, _ = pass_times(PLAN_WIDE, ("serve",), SEED + 12)
    by_name["plan_rows"]["backbone"] = dict(served["serve"], library_ms=None)
    by_name["plan_rows"]["wide"] = dict(wide["serve"], library_ms=None)
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"time {r['name']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib} ({r['library']}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % of it reached)")
    t = rows[-3]["train_phase"]
    print(f"time plan_rows in train_phase (no x): kernel {t['ms']:.4f} ms, plain "
          f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
          f"{100 * t['bound_ms'] / t['ms']:.1f} % of it reached); bytes per call: algo1 "
          f"{rows[-3]['bytes']:.0f}, train_phase {t['bytes']:.0f}")
    print(f"time the two-stage route at the fleet shape: {rows[1]['two_stage_ms']:.4f} ms")
    for name in ("xorshift_projection", "oselm_rls_update_fleet", "plan_rows"):
        for key in ("backbone", "wide"):
            w = by_name[name].get(key)
            if w is None:
                continue
            lib = "none" if w["library_ms"] is None else f"{w['library_ms']:.4f} ms"
            print(f"time {name} at the backbone's {'serve' if key == 'backbone' else 'widest'} "
                  f"shape {w['shape']}: kernel {w['ms']:.4f} ms, plain {w['plain_ms']:.4f} ms, "
                  f"library {lib}, bound {w['bound_ms']:.4f} ms ({w['bound_by']}, "
                  f"{100 * w['bound_ms'] / w['ms']:.1f} % of it reached)")
    for r in rows[:2]:
        w = r["n256"]
        events = f" (batched {w['batched_ms']:.4f} ms)" if "batched_ms" in w else ""
        print(f"time {r['name']} at N=256 {w['shape']}: kernel {w['ms']:.4f} ms{events}, plain "
              f"{w['plain_ms']:.4f} ms, library {w['library_ms']:.4f} ms ({r['library']}), "
              f"bound {w['bound_ms']:.4f} ms ({w['bound_by']}, "
              f"{100 * w['bound_ms'] / w['ms']:.1f} % of it reached)")
    return rows


def _rpc_unwrapped_rate(device="cuda"):
    """``--time-port``: stream·ticks/s of 6h's unwrapped run (the fleet's
    16 train_phase ticks over a loopback socket), behind a warm-up run."""
    from repro_torch import engine
    from repro_torch.configs import har_odl
    from repro_torch.data import har
    from repro_torch.engine import rpc, stream

    cfg = har_odl.full()
    xs, _ = _fleet_ticks(har.generate(seed=SEED), RPC_TRAIN_TICKS, FLEET_STREAMS, ALGO1_SHIFT_AT,
                         "cpu", SEED + ALGO1_TICKS)
    xs = xs.numpy()
    rate = None
    with rpc.loopback_server(n_out=cfg.elm.n_out) as (host, port):
        for n in (4, len(xs)):
            with rpc.RpcTeacher(host, port, timeout_s=120.0) as teacher:
                state = engine.init_fleet(cfg, FLEET_STREAMS, device)
                _sync(device)
                t0 = time.perf_counter()
                stream.run(state, iter(xs[:n]), cfg, teacher, mode="train_phase")
                _sync(device)
                rate = FLEET_STREAMS * n / (time.perf_counter() - t0)
    return rate


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
    # Phase 6h's first run without the sync wrapper: 16 train_phase ticks of
    # the fleet taught over a loopback socket; null where the checkout has no
    # teacher transport.
    out["rpc_stream_ticks_per_s"] = None
    if importlib.util.find_spec("repro_torch.engine.rpc") is not None:
        out["rpc_stream_ticks_per_s"] = _rpc_unwrapped_rate(device)
    # One drift trial of the paper's tables (1,008 one-stream eager ticks at
    # N=128, theta=1) behind a warm-up trial; null without the harness.
    out["paper_trial_s"] = None
    if importlib.util.find_spec("repro_torch.benchmarks.common") is not None:
        from repro_torch.benchmarks import common

        common.drift_trial(0, 1.0, 128, "hash", 0, device)
        t0 = time.perf_counter()
        common.drift_trial(1, 1.0, 128, "hash", 0, device)
        out["paper_trial_s"] = time.perf_counter() - t0
    # The graphed stream tick's device time (6e's profiled window).
    out["stream_tick_device_ms"] = None
    if importlib.util.find_spec("repro_torch.engine.stream") is not None:
        from torch.autograd import DeviceType

        _, prof = _stream_window(device, profiled=True)
        out["stream_tick_device_ms"] = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA) / 1e3 / PROFILE_TICKS
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
    paper = phase_paper_tables()
    fleet, runs = phase_fleet()
    phase_cross_check()
    eager = phase_profile()
    streamed, policy_runs, (ticks, labels), zero_runs = phase_stream(runs)
    fleet_runs = {mode: (_host_tree(st), _host_tree(outs)) for mode, (st, outs) in runs.items()}
    del runs
    phase_stream_cross_check()
    stream_prof = phase_stream_profile(eager, fleet)
    mux, mux_solo, mux_inputs = phase_multiplex(stream_prof)
    durable = phase_durable(policy_runs, ticks, labels, mux_solo, mux_inputs)
    del policy_runs, labels, mux_solo, mux_inputs
    rpc_res = phase_rpc(ticks)
    del ticks
    elastic_res = phase_elastic()
    sharded = phase_sharding(fleet, fleet_runs, streamed, zero_runs)
    del fleet_runs, zero_runs
    backbone = phase_backbone()
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
        # Not ports of a Pallas kernel: the plan's per-stream pass after the
        # projection (the reference computes it in XLA ops), and its two
        # reduced instances alone, on no path of the engine.
        "plan_rows": dict(
            source=rows_src, replaces="src/repro/engine/fleet.py:151",
            max_abs_err=err_rows["plan_rows"],
        ),
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
            # Durability (phase 6g): graph replays and eager launches of the
            # restored, migrated and supervised sessions and cohorts.
            "durable_replays": durable["kernel_replays"].get(name, 0),
            "durable_launches": durable["launches"].get(name, 0),
            # The teacher over the wire (phase 6h): eager launches and graph
            # replays of the RPC-taught sessions and cohorts.
            "rpc_launches": rpc_res["launches"].get(name, 0),
            "rpc_replays": rpc_res["kernel_replays"].get(name, 0),
            # 6h's rpc_bench at the reference's shape, counted on its own.
            "rpc_bench_launches": rpc_res["bench_launches"].get(name, 0),
            "rpc_bench_replays": rpc_res["bench_replays"].get(name, 0),
            # The elastic fleet (phase 6i): eager launches and graph replays
            # in the two worker processes, summed from their own scrapes;
            # and, apart, this process's solo runs of 6i's migrated tenants.
            "elastic_launches": elastic_res["launches"].get(name, 0),
            "elastic_replays": elastic_res["kernel_replays"].get(name, 0),
            "elastic_solo_launches": elastic_res["solo_launches"].get(name, 0),
            "elastic_solo_replays": elastic_res["solo_replays"].get(name, 0),
            # Sharding (phase 6j): eager launches and graph replays of the
            # sharded runs (blocked, padded, streamed and rescaled), counted
            # from 0 around each; the unsharded runs they are held to apart.
            "sharded_launches": sharded["launches"].get(name, 0),
            "sharded_replays": sharded["replays"].get(name, 0),
            # The dense backbone's serving path (phase 6k): eager launches and
            # graph replays in this process, and, apart, in its two workers
            # (summed from their own scrapes).
            "backbone_launches": backbone["launches"].get(name, 0),
            "backbone_replays": backbone["replays"].get(name, 0),
            "backbone_worker_launches": backbone["worker_launches"].get(name, 0),
            "backbone_worker_replays": backbone["worker_replays"].get(name, 0),
            # The paper's tables (phase 5b): eager launches, both widths.
            "paper_launches": paper["launches"].get(name, 0),
            "paper_max_abs_err": paper["errs"].get(name),
            "max_abs_err": info["max_abs_err"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": t["library"],
            # Phase 7 at N=256 (the paper's Tables 2-3 width), where timed.
            "n256": t.get("n256"),
            # The plan's pass in train_phase (no x read), where timed.
            "train_phase": t.get("train_phase"),
            # Phase 7 at the backbone's serving shape (6k), and the plan's
            # pass at the widest dense d_model, where timed.
            "backbone": t.get("backbone"),
            "wide": t.get("wide"),
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
